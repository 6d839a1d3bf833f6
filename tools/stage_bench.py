"""Per-stage GPU times of the LM pipeline, and the reduced-solve routes.

Times each jitted stage in isolation (median of 5 after a warm-up, each
call ended by ``block_until_ready``) — the analogue of the reference's
ProfileItem stage table (reference src/block_solver.h:27-39) — and
times the reduced camera system on every route: the dense Cholesky with an
f32 factor plus f64 refinement (``solver_precision="mixed"``), the dense f64
factor, and block-Jacobi PCG.  Each line names the card and its power limit.

Run on the GPU:  python tools/stage_bench.py [config ...]
(configs from bench.py; default kitti07_mono kitti00_mono)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def timeit(fn, *args, n=5):
    """(median ms, output) of ``fn(*args)`` after one warm-up call."""
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3, out


def bench_config(config: str, card: str) -> None:
    from bench import make_problem
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu.solver.pcg import build_pcg_plan

    problem, kwargs = make_problem(config)
    opt = optimizer_from_problem(problem, **kwargs)
    solver = opt.solver
    t0 = time.perf_counter()
    solver.build_structure()
    host_ms = (time.perf_counter() - t0) * 1e3

    metas, Pa, La = solver.metas, solver.Pa, solver.La
    plan, nnz = solver.plan, solver.schur.nnz_blocks
    graph, packed, dtype = solver.graph, solver.packed, solver.dtype
    route = "pcg" if plan.pcg is not None else "dense"
    print(f"[{config}] P={Pa} L={La} E={solver.nedges()} nnz_blocks={nnz} "
          f"T={solver.schur.nmul_blocks} dtype={jnp.dtype(dtype).name} "
          f"mixed={solver.mixed} route={route} card={card}")

    def line(label, ms):
        print(f"[{config}] {label:40s} {ms:10.3f} ms")

    line("build_structure (host symbolic)", host_ms)
    ms, _ = timeit(jax.jit(lambda g, p: bs.compute_chi(g, p, metas)),
                   graph, packed)
    line("compute_chi", ms)
    ms, sys_ = timeit(
        jax.jit(lambda g, p, pl: bs.build_system(g, p, metas, Pa, La, pl)),
        graph, packed, plan,
    )
    line("build_system", ms)
    lam = jnp.asarray(1e-4, dtype) * bs.max_diagonal(sys_)
    ms, (blocks, bsc, invHll) = timeit(
        jax.jit(lambda s, l, pl: bs.schur_reduce(s, l, pl, Pa, La, nnz)),
        sys_, lam, plan,
    )
    line("schur_reduce", ms)

    def solve_fn(mixed, pcg):
        return jax.jit(lambda b, r, pl, pc: bs._solve_reduced_blocks(
            b, pl.blk_row, pl.blk_col, pl.diag_pos, r, Pa, mixed,
            pl.blk_row_plan, pl.blk_col_plan, pc,
        ))

    s = solver.schur
    pcg_plan = build_pcg_plan(s.blk_row, s.blk_col, Pa)
    xp = None
    for label, mixed, pc in (
        ("reduced solve: dense f32+refine (mixed)", True, None),
        ("reduced solve: dense f64", False, None),
        ("reduced solve: pcg", solver.mixed, pcg_plan),
    ):
        if dtype == jnp.float32 and label.endswith("f64"):
            continue
        ms, (x, ok) = timeit(solve_fn(mixed, pc), blocks, bsc, plan, pc)
        line(f"{label} ok={bool(ok)}", ms)
        if xp is None:
            xp = x
    ms, xl = timeit(
        jax.jit(lambda s_, i, x, pl: bs.schur_back_substitute(s_, i, x, pl, Pa)),
        sys_, invHll, xp, plan,
    )
    line("schur_back_substitute", ms)
    ms, _ = timeit(jax.jit(lambda g, x, y: bs.apply_update(g, x, y, Pa, La)),
                   graph, xp, xl)
    line("apply_update", ms)

    opt = optimizer_from_problem(problem, **kwargs)
    opt.optimize(10)  # compile
    ts = []
    for _ in range(3):
        opt = optimizer_from_problem(problem, **kwargs)
        opt.solver.build_structure()  # structure cache: no host symbolic
        t0 = time.perf_counter()
        opt.optimize(10)
        jax.block_until_ready(opt.solver.graph.q)
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    n_it = len(opt.batch_statistics().get())
    line(f"fused optimize(10) [{n_it} iterations]", ts[1])


def main(argv: list[str]) -> int:
    from cuda_bundle_adjustment_tpu.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
        set_xla_gpu_flags,
    )

    set_xla_gpu_flags()
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devices = require_gpu()
    card = gpu_name_and_power_limit().splitlines()[0]
    print(f"device: {devices[0].device_kind} x{len(devices)}; {card}")
    for config in argv or ["kitti07_mono", "kitti00_mono"]:
        bench_config(config, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
