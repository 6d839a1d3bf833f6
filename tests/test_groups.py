"""Co-visibility group layout (solver/groups.py) tests."""

import numpy as np

from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu.solver.groups import build_group_layout


def test_layout_invariants():
    problem = make_ba_problem(
        num_poses=20, num_landmarks=200, mean_obs_per_landmark=5.0,
        kind="mono", seed=11,
    )
    Pa, La = problem.num_active_poses, problem.num_active_landmarks
    E = problem.pose_idx.size
    lay = build_group_layout(problem.pose_idx, problem.lm_idx, Pa, La)
    m = lay.meta

    perm = lay.edge_perm
    real = perm >= 0
    # a permutation of the original edges (dummies aside)
    assert np.array_equal(np.sort(perm[real]), np.arange(E))
    # every real free landmark placed exactly once
    lo = lay.lm_order
    assert np.array_equal(np.sort(lo[lo >= 0]), np.arange(La))
    # slot-major consistency: slot a of class d holds each landmark's a-th
    # both-free edge at the landmark's own layout position
    for cm in m.classes:
        S = cm.gc * cm.nc_pad
        for a in range(cm.d):
            seg = perm[cm.e_start + a * S : cm.e_start + (a + 1) * S]
            rows = np.nonzero(seg >= 0)[0]
            pos = cm.lm_start + rows
            lm_old = problem.lm_idx[seg[seg >= 0]]
            assert np.array_equal(lay.lm_renumber[lm_old], pos)
    # output keys of real chunks lie in the upper-triangular key space
    ok = lay.out_key[lay.out_key >= 0]
    assert np.all(ok // Pa <= ok % Pa)


def test_result_landmarks_round_trip():
    problem = make_ba_problem(
        num_poses=10, num_landmarks=80, mean_obs_per_landmark=4.0,
        kind="mono", seed=17,
    )
    opt = optimizer_from_problem(problem)
    solver = opt.solver
    # before any optimisation the accessor must return the input landmarks
    np.testing.assert_allclose(
        solver.result_landmarks(), problem.landmarks, rtol=0, atol=0
    )


def test_pattern_from_layout_matches_symbolic():
    """The layout's group pair keys (``out_key``) describe exactly the Hsc
    pattern that triple enumeration finds."""
    from cuda_bundle_adjustment_tpu.solver.symbolic import build_schur_structure

    problem = make_ba_problem(
        num_poses=24, num_landmarks=300, mean_obs_per_landmark=5.0,
        kind="mono", seed=19,
    )
    Pa, La = problem.num_active_poses, problem.num_active_landmarks
    lay = build_group_layout(problem.pose_idx, problem.lm_idx, Pa, La)

    # permuted indices as the solver would see them
    perm = lay.edge_perm
    dummy = perm < 0
    src = np.where(dummy, 0, perm)
    pi = problem.pose_idx[src].astype(np.int64)
    pi[dummy] = Pa
    li_new = lay.lm_renumber[problem.lm_idx.astype(np.int64)]
    li = li_new[src]
    li[dummy] = 0
    s = build_schur_structure(pi, li, Pa, lay.meta.la_pad)

    diag_keys = np.arange(Pa, dtype=np.int64) * (Pa + 1)
    keys = np.unique(np.concatenate([lay.out_key[lay.out_key >= 0], diag_keys]))
    np.testing.assert_array_equal(
        keys, s.blk_row.astype(np.int64) * Pa + s.blk_col
    )
