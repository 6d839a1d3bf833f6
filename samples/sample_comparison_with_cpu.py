"""Device-vs-CPU parity harness: the analogue of ``sample_comparison_with_g2o``.

The reference compares its GPU optimiser against g2o on the same graph and
prints a side-by-side chi2 table plus RMSE between the two solutions
(/root/reference/samples/sample_comparison_with_g2o/main.cpp:101-148,
expected output README.md:144-179: identical chi2 to 0.1 and RMSE
~1e-13..1e-16).  Here the CPU side is the packaged dense numpy
implementation of the same g2o-convention math
(cuda_bundle_adjustment_tpu/utils/dense_reference.py), run in real f64.

Usage:
    python samples/sample_comparison_with_cpu.py [graph.json] [niterations]
    python samples/sample_comparison_with_cpu.py --synthetic [niterations]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def quat_canon(q):
    return q * np.where(q[..., 3:4] < 0, -1.0, 1.0)


def synthetic_problem():
    """The ``--synthetic`` graph."""
    from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem

    return make_ba_problem(
        num_poses=60, num_landmarks=900, mean_obs_per_landmark=4.2,
        kind="mono", seed=0,
    )


def main(argv: list[str]) -> int:
    if argv and argv[0] != "--synthetic":
        from cuda_bundle_adjustment_tpu.io.opencv_json import read_problem

        problem = read_problem(argv[0])
        rest = argv[1:]
    else:
        problem = synthetic_problem()
        rest = argv[1:] if argv else []
    niter = int(rest[0]) if rest else 10

    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.utils.dense_reference import DenseLM

    print("Running CPU (dense f64 reference, g2o-equivalent math)...")
    cpu = DenseLM(problem)
    t0 = time.perf_counter()
    cpu.optimize(niter)
    t_cpu = time.perf_counter() - t0

    print("Running device engine...")
    opt = optimizer_from_problem(problem)
    opt.optimize(niter)  # warm-up/compile
    opt = optimizer_from_problem(problem)
    t0 = time.perf_counter()
    opt.optimize(niter)
    import jax

    jax.block_until_ready(opt.solver.graph.q)
    dev_trace = [s.chi2 for s in opt.batch_statistics().get()]
    t_dev = time.perf_counter() - t0

    platform = jax.devices()[0].platform
    print(f"\n=== {niter} iterations:  CPU {t_cpu:.2f}s   {platform} {t_dev:.2f}s "
          f"(host clock) ===\n")
    print("iteration        chi2(CPU)     chi2(device)")
    n = min(len(cpu.chi_trace), len(dev_trace))
    for i in range(n):
        print(f"{i + 1:9d} {cpu.chi_trace[i]:16.1f} {dev_trace[i]:16.1f}")

    q_cpu, t_cpu_a, X_cpu = cpu.q, cpu.t, cpu.Xw
    g = opt.solver.graph
    q_dev = np.asarray(g.q, dtype=np.float64)
    t_dev_a = np.asarray(g.t, dtype=np.float64)
    X_dev = opt.solver.result_landmarks()

    rmse_r = np.sqrt(np.mean((quat_canon(q_cpu) - quat_canon(q_dev)) ** 2))
    rmse_t = np.sqrt(np.mean((t_cpu_a - t_dev_a) ** 2))
    rmse_l = np.sqrt(np.mean((X_cpu - X_dev) ** 2))
    print("\nRMSE between CPU and device estimates")
    print(f"rotation    : {rmse_r:.2e}")
    print(f"translation : {rmse_t:.2e}")
    print(f"landmark    : {rmse_l:.2e}")

    drift = max(abs(a - b) for a, b in zip(cpu.chi_trace[:n], dev_trace[:n]))
    print(f"\nmax |chi2 CPU - chi2 device| over trace: {drift:.3g}")
    ok = (
        drift <= 0.1 * max(1.0, cpu.chi_trace[0] / 334210.0)
        and max(rmse_r, rmse_t, rmse_l) <= 1e-9
    )
    print("PARITY:", "OK" if ok else "DIVERGED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
