"""RCM pose ordering + PCG fallback for non-banded (loop-closure) graphs."""

import numpy as np
import pytest

from cuda_bundle_adjustment_tpu.solver.ordering import (
    block_bandwidth,
    plan_pose_order,
    pose_pairs,
    rcm_order,
)


def test_pose_pairs_small():
    # landmark 0 seen by poses {0, 2}, landmark 1 by {1}, landmark 2 by {0, 1, 3}
    pose_idx = np.array([0, 2, 1, 0, 1, 3])
    lm_idx = np.array([0, 0, 1, 2, 2, 2])
    keys = pose_pairs(pose_idx, lm_idx, 4, 3)
    got = {(int(k // 4), int(k % 4)) for k in keys}
    assert got == {(0, 0), (0, 2), (2, 2), (1, 1), (0, 1), (0, 3), (1, 3), (3, 3)}


def test_rcm_rescues_a_shuffled_chain():
    # a chain graph whose vertex ids are randomly shuffled: natural order has
    # huge bandwidth, RCM recovers bw=1
    n = 200
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    a = perm[:-1]
    b = perm[1:]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keys = np.unique(lo * n + hi)
    assert block_bandwidth(keys, n) > 50
    order = rcm_order(keys, n)
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order] = np.arange(n)
    bw = int(np.max(np.abs(new_of_old[lo] - new_of_old[hi])))
    assert bw <= 2


def test_plan_keeps_identity_for_banded_graphs():
    from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem

    p = make_ba_problem(num_poses=60, num_landmarks=500, seed=1)
    perm, bw0, bw1 = plan_pose_order(
        p.pose_idx, p.lm_idx, p.num_active_poses, p.num_active_landmarks
    )
    assert perm is None  # trajectory order is already banded


def test_loop_closure_graph_solves_without_dense(monkeypatch):
    """Random long-range co-visibility defeats any banded order; at or above
    PCG_MIN_POSES the solver must engage PCG, never the dense build."""
    import cuda_bundle_adjustment_tpu.solver.block_solver as bs
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.io.synthetic import make_loop_closure_problem

    monkeypatch.setattr(bs, "PCG_MIN_POSES", 1024)

    p = make_loop_closure_problem(num_poses=1100, num_landmarks=6000, seed=2)
    opt = optimizer_from_problem(p)
    s = opt.solver
    s.build_structure()
    assert s.plan.pcg is not None, "PCG fallback did not engage"
    opt.optimize(4)
    tr = [x.chi2 for x in opt.batch_statistics().get()]
    assert tr[-1] < 0.05 * tr[0]


def test_rcm_permutation_results_unpermuted():
    """Results come back in the caller's pose order even when RCM reorders."""
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu.io.synthetic import make_loop_closure_problem

    p = make_loop_closure_problem(num_poses=1100, num_landmarks=6000, seed=3)
    opt = optimizer_from_problem(p)
    if opt.solver.pose_perm is None:
        pytest.skip("RCM did not trigger on this seed")
    q0, t0 = opt.solver.result_poses()
    # before optimization the (un-permuted) estimates equal the input
    np.testing.assert_allclose(q0, p.pose_q, atol=0)
    np.testing.assert_allclose(t0, p.pose_t, atol=0)
