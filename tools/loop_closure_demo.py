"""VERDICT acceptance run: loop-closure robustness at scale.

A 5000-pose trajectory graph with 5% random long-range co-visibility —
the shape that defeats any banded ordering (the reference handles it with
METIS + general sparse Cholesky, cholesky.hpp:292-297).  The solver must
never build the O(Pa^2) dense matrix: RCM is attempted, found insufficient,
and block-Jacobi preconditioned CG on the sparse Hsc blocks engages
(solver/pcg.py).  The in-suite twin runs at 1100 poses for CI time
(tests/test_ordering.py::test_loop_closure_graph_solves_without_dense);
this tool is the full-size artifact run.

    python tools/loop_closure_demo.py | tee artifacts/LOOP_CLOSURE.log
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.io.synthetic import make_loop_closure_problem

    t0 = time.perf_counter()
    p = make_loop_closure_problem(
        num_poses=5000, num_landmarks=60_000, long_range_fraction=0.05, seed=7
    )
    print(f"problem: P={p.pose_q.shape[0]} L={p.landmarks.shape[0]} "
          f"E={p.meas.shape[0]} (5% long-range co-visibility) "
          f"[{time.perf_counter() - t0:.1f}s to generate]")

    opt = optimizer_from_problem(p)
    s = opt.solver
    t0 = time.perf_counter()
    s.build_structure()
    print(f"build_structure: {time.perf_counter() - t0:.2f}s")
    from cuda_bundle_adjustment_tpu.solver.ordering import plan_pose_order

    _, bw0, bw1 = plan_pose_order(
        p.pose_idx, p.lm_idx, p.num_active_poses, p.num_active_landmarks
    )
    print(f"block bandwidth: natural {bw0}, after-RCM {bw1} "
          f"-> pcg={'engaged' if s.plan.pcg is not None else 'no'}")
    assert s.plan.pcg is not None, "PCG fallback must engage, never dense"

    t0 = time.perf_counter()
    opt.optimize(8)
    import jax

    jax.block_until_ready(s.graph.q)
    trace = [x.chi2 for x in opt.batch_statistics().get()]
    print(f"optimize(8): {time.perf_counter() - t0:.2f}s")
    for i, c in enumerate(trace):
        print(f"iter= {i:2d}   chi2= {c:.3f}")
    assert trace[-1] < 0.05 * trace[0], "did not converge"
    print("LOOP-CLOSURE (5k poses, PCG, no dense build): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
