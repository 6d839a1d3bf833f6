"""The reduced camera system: the dense and PCG routes on banded and wide Hsc
patterns against numpy, and the rule that chooses between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cuda_bundle_adjustment_tpu.solver.block_solver as bs
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu.solver.pcg import build_pcg_plan

from test_pcg import _random_block_system

PATTERNS = {"banded": 0, "wide": 60}


def _solve(Pa, pattern, mixed, pcg):
    A, blocks, rows, cols, diag_pos, b = _random_block_system(
        Pa, PATTERNS[pattern], seed=7
    )
    pc = build_pcg_plan(rows, cols, Pa) if pcg else None
    i32 = lambda a: jnp.asarray(a.astype(np.int32))  # noqa: E731
    xp, ok = bs._solve_reduced_blocks(
        jnp.asarray(blocks), i32(rows), i32(cols), i32(diag_pos),
        jnp.asarray(b), Pa, mixed, pcg=pc,
    )
    want = np.linalg.solve(A, b.reshape(-1)).reshape(Pa, 6)
    return np.asarray(xp), bool(ok), want


@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_dense_reduced_solve_matches_numpy(pattern, mixed):
    """Dense route: f64 factor, or f32 factor + f64 refinement (mixed)."""
    xp, ok, want = _solve(40, pattern, mixed, pcg=False)
    assert ok
    np.testing.assert_allclose(xp, want, rtol=0, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_pcg_reduced_solve_matches_numpy(pattern):
    # Pa > PC_CHUNK so the chunk preconditioner is not the exact factor
    xp, ok, want = _solve(96, pattern, False, pcg=True)
    assert ok
    np.testing.assert_allclose(xp, want, rtol=0, atol=1e-8 * np.abs(want).max())


def test_mixed_rejects_an_indefinite_system():
    """A system the f32 factor cannot solve reports failure (the LM loop
    then re-damps), never a finite wrong answer."""
    A, blocks, rows, cols, diag_pos, b = _random_block_system(16, 10, 1)
    blocks = blocks.copy()
    blocks[diag_pos] *= -1.0
    i32 = lambda a: jnp.asarray(a.astype(np.int32))  # noqa: E731
    _, ok = bs._solve_reduced_blocks(
        jnp.asarray(blocks), i32(rows), i32(cols), i32(diag_pos),
        jnp.asarray(b), 16, True,
    )
    assert not bool(ok)


@pytest.mark.parametrize(
    "Pa, dtype, mixed, limit, want",
    [
        (248, jnp.float64, True, None, "dense"),  # KITTI-07: small, no limit
        (bs.PCG_MIN_POSES, jnp.float64, True, None, "pcg"),  # at threshold
        (bs.PCG_MIN_POSES - 1, jnp.float64, True, 80 * 2**30, "dense"),
        # dense operands 3 * (6 Pa)^2 * 4 bytes over a quarter of the card
        (900, jnp.float64, True, 4 * 3 * (6 * 900) ** 2 * 4 - 1, "pcg"),
        # the f64 factor holds twice the bytes of the mixed one
        (900, jnp.float64, False, 4 * 3 * (6 * 900) ** 2 * 4, "pcg"),
        (900, jnp.float32, False, 4 * 3 * (6 * 900) ** 2 * 4, "dense"),
    ],
)
def test_reduced_solver_route(Pa, dtype, mixed, limit, want):
    assert bs.reduced_solver_route(Pa, dtype, mixed, bytes_limit=limit) == want


@pytest.mark.parametrize("min_poses, want_pcg", [(10_000, False), (0, True)])
def test_build_structure_follows_the_route(monkeypatch, min_poses, want_pcg):
    monkeypatch.setattr(bs, "PCG_MIN_POSES", min_poses)
    p = make_ba_problem(num_poses=12, num_landmarks=80, seed=4)
    opt = optimizer_from_problem(p)
    opt.solver.build_structure()
    assert (opt.solver.plan.pcg is not None) == want_pcg
    opt.optimize(3)
    tr = [s.chi2 for s in opt.batch_statistics().get()]
    assert tr[-1] < tr[0]


def test_device_bytes_limit_is_none_on_cpu():
    assert bs._device_bytes_limit() is None


def test_structure_cache_is_keyed_by_device():
    """Cached device arrays live on one device: the same structure under
    another default device must not share them."""
    p = make_ba_problem(num_poses=8, num_landmarks=40, seed=5)
    specs = [dict(kind=p.kind, pose_idx=p.pose_idx, lm_idx=p.lm_idx)]
    args = (specs, 8, 7, 40, 40)
    d0 = bs._struct_digest(*args)
    with jax.default_device(jax.devices()[1]):
        d1 = bs._struct_digest(*args)
    assert d0 != d1 and d0 == bs._struct_digest(*args)
