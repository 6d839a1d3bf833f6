"""Smoke test of the bundle adjuster on NVIDIA GPUs, through its user-facing
entry points, at the full widths of the benchmark problems.

Usage:
    python chip_smoke.py          # one card: every phase below but the last
    python chip_smoke.py --four   # four cards: the sharded LM path only

Phases (one card):
  1. device: JAX's devices and the card's name and power limit; no GPU -> exit 1
  2. main path: all five bench.py configs at full width, each
     ``optimizer_from_problem(...)`` + ``optimize(10)`` after one warm-up; the
     object API on the dense-oracle sample's graph; kitti07_mono once more
     with the 9-stage TimeProfile
  3. parity with the CPU backend in this process: build_system,
     schur_reduce, the reduced solve and compute_chi at kitti07 width (f64
     and f32), the kitti07_mono 10-iteration trace, the kitti00 initial chi2,
     the dense-oracle sample, and whether two GPU runs are bitwise equal
Phase (four cards, ``--four``): ``distributed_optimize`` for 3 iterations and
``distributed_update_edges`` on ``city_scale_problem`` over a 1-D mesh of the
four cards, against the same code on a 1-device mesh.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

CONFIGS = (
    "kitti00_mono",
    "kitti00_stereo",
    "kitti00_mixed",
    "kitti00_huber_f32",
    "kitti07_mono",
)
F64_TOL = 1e-10  # stage parity, relative to the largest term
F32_TOL = 1e-4
TRACE_RTOL = 1e-9
CHI0_RTOL = 1e-12
MIXED_SOLVE_TOL = 1e-6  # f32 factor + refinement to a 1e-8 residual
ORACLE_RMSE = 1e-9
FOUR_RTOL = 1e-9


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"{time.perf_counter() - _T0:8.1f}s {msg}", flush=True)


# -- 1. device ---------------------------------------------------------------


def phase_device():
    """Print the devices and the card line; raise NoGpuError without a GPU."""
    import jax

    from cuda_bundle_adjustment_tpu.utils.runtime import (
        gpu_name_and_power_limit,
        require_gpu,
    )

    devices = require_gpu()
    d0 = devices[0]
    log(f"[device] jax.devices() = {devices}")
    log(f"[device] platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devices)} jax={jax.__version__}")
    card = gpu_name_and_power_limit()
    log(f"[device] nvidia-smi name, power.limit: {card}")
    return devices, card.splitlines()[0]


# -- 2. main path ------------------------------------------------------------


def _chi0(opt) -> float:
    from cuda_bundle_adjustment_tpu.solver import block_solver as bs

    s = opt.solver
    return float(bs._jit_chi_only(s.graph, s.packed, s.metas))


def _trace(opt) -> list[float]:
    return [s.chi2 for s in opt.batch_statistics().get()]


def _lower_fused(opt, niters: int):
    """The fused LM program that ``opt.optimize(niters)`` runs, lowered
    (``opt.solver.build_structure()`` must have run)."""
    from cuda_bundle_adjustment_tpu.solver.fused import optimize_fused

    s = opt.solver
    return optimize_fused.lower(
        s.graph, tuple(s.packed), s.plan, metas=s.metas, Pa=s.Pa, La=s.La,
        nnz=s.schur.nnz_blocks if s.schur is not None else 0,
        do_schur=s.do_schur, niterations=niters, mixed=s.mixed,
    )


def _fused_memory_analysis(opt, niters: int) -> str:
    opt.solver.build_structure()
    m = _lower_fused(opt, niters).compile().memory_analysis()
    if m is None:
        return "not reported"
    return (f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
            f"temp={m.temp_size_in_bytes} "
            f"code={m.generated_code_size_in_bytes} bytes")


def run_main_path(name, problem, kwargs, card, niters: int = 10,
                  with_chi0: bool = False) -> dict:
    """Warm-up ``optimize(niters)``, then a timed ``optimizer_from_problem``
    + ``optimize(niters)``; checks the chi2 trace is finite and falls.  The
    initial chi2 (one more program to compile) only ``with_chi0``."""
    import jax

    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    t0 = time.perf_counter()
    opt = optimizer_from_problem(problem, **kwargs)
    chi0 = _chi0(opt) if with_chi0 else None
    opt.optimize(niters)
    jax.block_until_ready(opt.solver.graph.q)
    cold = time.perf_counter() - t0
    warm_trace = _trace(opt)

    t0 = time.perf_counter()
    opt = optimizer_from_problem(problem, **kwargs)
    opt.optimize(niters)
    jax.block_until_ready(opt.solver.graph.q)
    warm = time.perf_counter() - t0
    trace = _trace(opt)

    s = opt.solver
    log(f"[{name}] P={s.Pa} L={s.La_real} E={s.nedges()} "
        f"dtype={np.dtype(s.dtype).name} route="
        f"{'pcg' if s.plan is not None and s.plan.pcg is not None else 'dense'}")
    log(f"[{name}] initial chi2 "
        f"{'not computed' if chi0 is None else repr(chi0)}; chi2 trace {trace}")
    log(f"[{name}] initialize()+optimize({niters}): {warm:.4f} s warm, "
        f"{cold:.4f} s first run (compile included); {card}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{name}] peak_bytes_in_use (process so far) = "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    log(f"[{name}] fused step memory_analysis: "
        f"{_fused_memory_analysis(opt, niters)}")
    seq = ([] if chi0 is None else [chi0]) + trace
    check(len(seq) > 1 and all(np.isfinite(seq)), f"{name}: trace {trace}")
    check(all(b <= a for a, b in zip(seq, seq[1:])),
          f"{name}: chi2 trace rises")
    check(seq[-1] < seq[0], f"{name}: chi2 did not fall")
    return dict(chi0=chi0, trace=trace, warm_trace=warm_trace, seconds=warm)


def object_api_graph():
    """The dense-oracle sample's graph built through the object API (create /
    add_vertex_set / add_edge_set / initialize).  It packs to the same
    shapes as the sample's array path, so the two share one compiled
    program."""
    import cuda_bundle_adjustment_tpu as tba

    p = dense_oracle_problem()
    poses, landmarks = tba.PoseVertexSet(), tba.LandmarkVertexSet()
    for i in range(p.pose_q.shape[0]):
        poses.add_vertex(tba.PoseVertex(i, tba.Se3(p.pose_q[i], p.pose_t[i]),
                                        i >= p.num_active_poses))
    for j in range(p.landmarks.shape[0]):
        landmarks.add_vertex(tba.LandmarkVertex(j, p.landmarks[j]))
    edges = tba.MonoEdgeSet()
    edges.set_camera(tba.Camera(*p.cam.tolist()))
    edges.set_information(1.0)
    for e in range(p.pose_idx.size):
        edge = tba.MonoEdge()
        edge.set_vertex(poses.get_vertex(int(p.pose_idx[e])), 0)
        edge.set_vertex(landmarks.get_vertex(int(p.lm_idx[e])), 1)
        edge.set_measurement(p.meas[e])
        edges.add_edge(edge)
    opt = tba.TpuGraphOptimisation.create()
    opt.add_vertex_set(poses)
    opt.add_vertex_set(landmarks)
    opt.add_edge_set(edges)
    opt.initialize()
    return opt, poses


def phase_object_api() -> None:
    """``optimize(10)`` on :func:`object_api_graph`: chi2 must fall."""
    opt, poses = object_api_graph()
    opt.optimize(10)
    trace = _trace(opt)
    log(f"[object_api] {opt.solver.nedges()} edges; chi2 trace {trace}")
    check(len(trace) > 1 and all(np.isfinite(trace)) and trace[-1] < trace[0],
          "object API: chi2 did not fall")
    check(np.all(np.isfinite(poses.get_vertex(0).estimate.q)),
          "object API: non-finite pose written back")


def phase_profile(problem, card, niters: int = 10) -> None:
    """kitti07_mono with ``set_profile(True)``: the reference's 9 stages,
    after a profiled ``optimize(1)`` that compiles every stage program."""
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    for n in (1, niters):
        opt = optimizer_from_problem(problem)
        opt.set_profile(True)
        opt.optimize(n)
    log(f"[profile] kitti07_mono optimize({niters}) TimeProfile (ms), "
        f"stage-synchronised host loop; {card}:")
    for stage, ms in opt.time_profile().items():
        log(f"[profile]   {stage:28s} {ms:10.3f}")


# -- 3. parity -----------------------------------------------------------------


def _max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    return float(np.abs(got - want).max() / (scale or 1.0)) if want.size else 0.0


def _summed_magnitudes(s, graph, packed) -> dict:
    """For each build_system output, the largest summed-term magnitude of
    one of its entries: the per-edge quadratic-form terms summed in absolute
    value over each pose (Hpp, bp) and each landmark (Hll, bl); Hpl is per
    edge, so its own magnitude."""
    import jax.numpy as jnp
    from jax.ops import segment_sum

    from cuda_bundle_adjustment_tpu.models import MODEL_REGISTRY

    pose = lm = 0.0
    hpl = []
    for data, meta in zip(packed, s.metas):
        p, lt, h = MODEL_REGISTRY[meta.kind].terms(graph, data, meta.rk,
                                                   meta.delta)
        pose = pose + segment_sum(jnp.abs(p), data.pose_idx,
                                  num_segments=s.Pa)
        lm = lm + segment_sum(jnp.abs(lt), data.lm_idx, num_segments=s.La)
        hpl.append(jnp.abs(h))
    return {"build_system.Hpp": float(pose[:, :36].max()),
            "build_system.bp": float(pose[:, 36:].max()),
            "build_system.Hll": float(lm[:, :9].max()),
            "build_system.bl": float(lm[:, 9:].max()),
            "build_system.Hpl": float(jnp.concatenate(hpl).max())}


def stage_parity(name, problem, kwargs, tol, gpu, cpu) -> None:
    """Each stage on the GPU against the same function on the CPU backend,
    fed the CPU's inputs: compute_chi, build_system, schur_reduce and the
    reduced solve, at a damping of 1e-2 of the largest Hessian diagonal.

    A difference counts relative to the output's summed-term magnitude: for
    build_system's sums over edges, the largest sum of |term| that forms
    one entry (:func:`_summed_magnitudes`; a gradient such as ``bl`` is a
    sum of terms that largely cancel, so its own largest entry is far
    smaller); for every other output, its largest entry, which is never
    more than that magnitude, so the bound is at least as strict.

    The reduced solve is compared in the working precision's own factor
    (``tol``); under ``solver_precision="mixed"`` its f32-factor route is
    compared too, at :data:`MIXED_SOLVE_TOL`: that route stops refining at a
    residual of 1e-8 of the right-hand side, so two devices agree only to
    about the system's condition number times that.

    The stage programs are those of the profiled host loop
    (:func:`phase_profile`), so a profiled run before this compiles them."""
    import jax
    import jax.numpy as jnp

    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.solver import block_solver as bs

    def stages(s, sys_in=None, red_in=None):
        graph, packed = s.graph, s.packed
        chi = bs._jit_chi_only(graph, packed, s.metas)
        sys_ = bs.build_system_jit(graph, packed, s.plan, s.metas, s.Pa, s.La)
        lam_ = 1e-2 * float(bs._jit_maxdiag(sys_)) if lam is None else lam
        sys_in = sys_ if sys_in is None else sys_in
        red = bs._jit_reduce(sys_in, jnp.asarray(lam_, graph.q.dtype), s.plan,
                             s.metas, s.Pa, s.La, s.schur.nnz_blocks)
        red_in = red if red_in is None else red_in
        out = {"compute_chi": chi}
        out.update({f"build_system.{f}": getattr(sys_, f)
                    for f in ("Hpp", "bp", "Hll", "bl", "Hpl")})
        out.update(zip(("schur_reduce.blocks", "schur_reduce.bsc",
                        "schur_reduce.invHll"), red))
        ok = {}
        for m in mixeds:
            k = f"reduced_solve.xp[{'mixed' if m else 'exact'}]"
            out[k], ok[k] = bs._jit_solve_reduced(red_in[0], red_in[1], s.plan,
                                                  s.Pa, m)
        return lam_, jax.device_get((out, ok, sys_, red))

    lam = None
    with jax.default_device(cpu):
        sc = optimizer_from_problem(problem, **kwargs).solver
        sc.build_structure()
        mixeds = sorted({False, sc.mixed})
        lam, (out_c, ok_c, sys_c, red_c) = stages(sc)
        magnitude = _summed_magnitudes(sc, sc.graph, sc.packed)

    with jax.default_device(gpu):
        sg = optimizer_from_problem(problem, **kwargs).solver
        sg.build_structure()
        check((sg.plan.pcg is None) == (sc.plan.pcg is None),
              f"{name}: CPU and GPU chose different reduced-solve routes")
        _, (out_g, ok_g, _, _) = stages(sg, jax.device_put(sys_c, gpu),
                                        jax.device_put(red_c, gpu))
    for k in ok_c:
        check(bool(ok_g[k]) and bool(ok_c[k]), f"{name}: {k} failed")
    for label, c in out_c.items():
        t = MIXED_SOLVE_TOL if "mixed" in label else tol
        g = np.asarray(out_g[label], np.float64)
        c = np.asarray(c, np.float64)
        diff = float(np.abs(g - c).max())
        largest = float(np.abs(c).max())
        scale = magnitude.get(label, largest) or 1.0
        r = diff / scale
        summed = label in magnitude
        log(f"[parity:{name}] {label:28s} max|gpu-cpu| = {diff:.3e} = "
            f"{r:.3e} x {scale:.3e} "
            f"({'summed |terms|' if summed else 'largest entry'}; tol {t:g})"
            + (f"; {diff / (largest or 1.0):.3e} of max|cpu|" if summed
               else ""))
        check(r <= t, f"{name}: {label} differs by {r:.3e}")


def trace_parity(name, problem, kwargs, gpu_trace, cpu, niters: int = 10):
    import jax

    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    with jax.default_device(cpu):
        opt = optimizer_from_problem(problem, **kwargs)
        opt.optimize(niters)
        cpu_trace = _trace(opt)
    r = max(abs(a - b) / abs(b) for a, b in zip(gpu_trace, cpu_trace))
    log(f"[parity:{name}] chi2 trace GPU {gpu_trace}")
    log(f"[parity:{name}] chi2 trace CPU {cpu_trace}")
    log(f"[parity:{name}] max relative trace difference {r:.3e} "
        f"(rtol {TRACE_RTOL:g})")
    check(len(gpu_trace) == len(cpu_trace) and r <= TRACE_RTOL,
          f"{name}: trace differs from the CPU backend")


def chi0_parity(name, problem, kwargs, gpu_chi0, cpu) -> None:
    import jax

    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    with jax.default_device(cpu):
        cpu_chi0 = _chi0(optimizer_from_problem(problem, **kwargs))
    r = abs(gpu_chi0 - cpu_chi0) / abs(cpu_chi0)
    log(f"[parity:{name}] initial chi2 GPU {gpu_chi0!r} CPU {cpu_chi0!r} "
        f"relative difference {r:.3e} (tol {CHI0_RTOL:g})")
    check(r <= CHI0_RTOL, f"{name}: initial chi2 differs from the CPU backend")


def dense_oracle_problem():
    from samples.sample_comparison_with_cpu import synthetic_problem

    return synthetic_problem()


def dense_oracle_parity() -> None:
    """samples/sample_comparison_with_cpu.py --synthetic: PARITY: OK and
    every RMSE against the dense f64 oracle <= 1e-9."""
    from samples.sample_comparison_with_cpu import main as compare

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = compare(["--synthetic"])
    out = buf.getvalue()
    for ln in out.splitlines():
        log(f"[oracle] {ln}")
    rmse = [float(x) for x in re.findall(
        r"^(?:rotation|translation|landmark)\s*:\s*(\S+)", out, re.M)]
    check(rc == 0 and "PARITY: OK" in out, "dense oracle: PARITY not OK")
    check(len(rmse) == 3 and max(rmse) <= ORACLE_RMSE,
          f"dense oracle: RMSE {rmse} above {ORACLE_RMSE:g}")


def log_precision() -> None:
    log("[precision] f32 contractions on the main path: ops/lie.py se3_exp "
        "einsum and solver/segments.py pair-product einsum, both "
        "Precision.HIGHEST (no TF32); the reduced solve's Cholesky and "
        "triangular solves (cuSOLVER/cuBLAS calls, f32 only in the f32 mode "
        "and the mixed factor); ops/components.py is elementwise")


# -- 4. four cards ---------------------------------------------------------------


def phase_four(problem, devices, niters: int = 3, threshold: float = 5.991):
    """distributed_optimize + distributed_update_edges over a 1-D mesh of
    ``devices`` against a 1-device mesh of the first of them."""
    import jax
    from jax.sharding import Mesh

    from cuda_bundle_adjustment_tpu.parallel.distributed import (
        distributed_optimize,
        gather_landmarks,
        make_distributed_update_edges,
        shard_problem,
    )

    meshes, sps = {}, {}
    for devs in (list(devices), list(devices[:1])):
        t0 = time.perf_counter()
        meshes[len(devs)] = Mesh(np.array(devs), ("d",))
        sps[len(devs)] = shard_problem(problem, len(devs),
                                       outlier_threshold=threshold)
        log(f"[four] shard_problem over {len(devs)}: "
            f"{time.perf_counter() - t0:.2f} s")

    results = {}
    for n, sp in sps.items():
        t0 = time.perf_counter()
        trace, (q, t, Xw) = distributed_optimize(meshes[n], sp, niters)
        jax.block_until_ready(q)
        t_opt = time.perf_counter() - t0
        active, n_new = make_distributed_update_edges(meshes[n], sp)(
            q, t, Xw, sp.active
        )
        results[n] = dict(
            trace=trace, q=np.asarray(q), t=np.asarray(t),
            Xw=gather_landmarks(sp, Xw)[: problem.landmarks.shape[0]],
            n_new=int(n_new),
        )
        log(f"[four] mesh of {n}: distributed_optimize({niters}) "
            f"{t_opt:.2f} s; trace {trace}; distributed_update_edges "
            f"flagged {int(n_new)} edges")
    a, b = results[len(devices)], results[1]
    check(len(a["trace"]) == len(b["trace"]) == niters, "four: trace length")
    r = {k: _max_rel(a[k], b[k]) for k in ("trace", "q", "t", "Xw")}
    log(f"[four] max relative difference, {len(devices)} cards vs 1: "
        + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
        + f" (rtol {FOUR_RTOL:g}); flagged {a['n_new']} vs {b['n_new']}")
    check(all(v <= FOUR_RTOL for v in r.values()), "four: results differ")
    check(a["trace"][-1] < a["trace"][0], "four: chi2 did not fall")
    check(a["n_new"] == b["n_new"], "four: outlier counts differ")


# -- entry point -----------------------------------------------------------------


def run_one_card(devices, card) -> None:
    """Every one-card phase, one program compiled at a time (programs that
    several phases run are compiled once: the profiled loop's stage
    programs serve the stage parity, the object API graph shares the dense
    oracle's)."""
    import jax

    from bench import make_problem

    gpu, cpu = devices[0], jax.devices("cpu")[0]
    t0 = time.perf_counter()
    problems = {name: make_problem(name) for name in CONFIGS}
    log(f"[setup] problems made in {time.perf_counter() - t0:.1f} s")

    k07, _ = problems["kitti07_mono"]
    results = {"kitti07_mono": run_main_path("kitti07_mono", k07, {}, card,
                                             with_chi0=True)}
    phase_profile(k07, card)
    log_precision()
    stage_parity("kitti07_mono", k07, {}, F64_TOL, gpu, cpu)
    trace_parity("kitti07_mono", k07, {}, results["kitti07_mono"]["trace"], cpu)
    stage_parity("kitti07_huber_f32", k07,
                 dict(problems["kitti00_huber_f32"][1]), F32_TOL, gpu, cpu)
    phase_object_api()
    dense_oracle_parity()

    for name in CONFIGS:
        if name not in results:
            results[name] = run_main_path(name, *problems[name], card,
                                          with_chi0=name == "kitti00_mono")
    chi0_parity("kitti00_mono", *problems["kitti00_mono"],
                results["kitti00_mono"]["chi0"], cpu)
    for name in ("kitti07_mono", "kitti00_mono"):
        r = results[name]
        same = r["trace"] == r["warm_trace"]
        log(f"[determinism] {name}: two GPU runs' chi2 traces bitwise "
            f"{'equal' if same else 'DIFFERENT'}"
            + ("" if same else f" (max relative difference "
               f"{_max_rel(r['trace'], r['warm_trace']):.3e})"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    from cuda_bundle_adjustment_tpu.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        set_xla_gpu_flags,
    )

    flags = set_xla_gpu_flags()
    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devices, card = phase_device()
    log(f"[device] XLA_FLAGS={flags!r}; compile cache {cache}")
    t0 = time.perf_counter()
    if args.four:
        from cuda_bundle_adjustment_tpu.io.synthetic import city_scale_problem

        check(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        problem = city_scale_problem(seed=0)
        log(f"[four] city_scale_problem(): "
            f"P={problem.pose_q.shape[0]} L={problem.landmarks.shape[0]} "
            f"E={problem.pose_idx.size}")
        phase_four(problem, devices)
    else:
        devices = devices[:1]
        run_one_card(devices, card)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(gpu_name_and_power_limit(), flush=True)
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
