"""JAX equivalent of the reference's ``sample_ba_from_file``.

Loads a BA graph (OpenCV JSON FileStorage layout, the reference's input
format: /root/reference/samples/sample_ba_from_file/main.cpp:78-165) or a
named synthetic graph, runs a 1-iteration warm-up, then times
``initialize(); optimize(N)`` and prints the per-iteration chi2 trace and
the 9-stage time profile — the same output shape as the reference sample
(main.cpp:167-198).

Usage:
    python samples/sample_ba_from_file.py path/to/ba_graph.json [niterations]
    python samples/sample_ba_from_file.py --synthetic kitti00 [niterations]
    python samples/sample_ba_from_file.py --synthetic kitti07 [niterations]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402


def load(arg: str, which: str):
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    if arg == "--synthetic":
        from cuda_bundle_adjustment_tpu.io import synthetic

        maker = {
            "kitti00": synthetic.kitti00_scale_problem,
            "kitti07": synthetic.kitti07_scale_problem,
        }[which]
        return lambda: optimizer_from_problem(maker(kind="mono", seed=0))
    from cuda_bundle_adjustment_tpu.io.opencv_json import read_problem

    problem = read_problem(arg)
    return lambda: optimizer_from_problem(problem)

def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "--synthetic":
        make, rest = load(argv[0], argv[1]), argv[2:]
    else:
        make, rest = load(argv[0], ""), argv[1:]
    niter = int(rest[0]) if rest else 10

    # warm-up (compiles every stage; the reference warm-ups too, main.cpp:167)
    opt = make()
    opt.set_profile(True)  # warm the per-stage jits used by profile mode
    opt.optimize(niter)
    jax.block_until_ready(opt.solver.graph.q)
    _ = opt.batch_statistics().get()[-1].chi2  # force the pipeline

    opt = make()
    opt.set_profile(True)
    t0 = time.perf_counter()
    opt.optimize(niter)  # arrays are pre-packed; initialize() is implicit
    jax.block_until_ready(opt.solver.graph.q)
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    elapsed = time.perf_counter() - t0

    print(f"=== Bundle Adjustment: {niter} iterations ===\n")
    print(f"num poses      : {opt.solver.P}")
    print(f"num landmarks  : {opt.solver.L}")
    print(f"num edges      : {opt.solver.nedges()}")
    print(f"total time     : {elapsed:.3f}[sec]\n")
    print("chi2 per iteration:")
    for i, c in enumerate(trace, 1):
        print(f"iter= {i:2d}   chi2= {c:.1f}")
    print("\ntime profile:")
    for name, ms in opt.time_profile().items():
        print(f"{name:28s}: {ms:9.2f}[msec]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
