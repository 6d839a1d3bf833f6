"""Bucketed scatter-free segment reductions vs jax.ops.segment_sum."""

import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum

from cuda_bundle_adjustment_tpu.solver.segments import (
    build_bucket_plan,
    reduce_pair_products,
    reduce_rows,
)


def test_reduce_rows_matches_segment_sum():
    rng = np.random.default_rng(0)
    N, M, K = 5000, 37, 7
    ids = rng.integers(0, M, N)
    X = rng.standard_normal((N, K))
    plan = build_bucket_plan(ids, M)
    got = np.asarray(reduce_rows(jnp.asarray(X), plan))
    want = np.asarray(segment_sum(jnp.asarray(X), jnp.asarray(ids), num_segments=M))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_reduce_rows_drops_out_of_range_ids():
    rng = np.random.default_rng(1)
    N, M, K = 200, 11, 3
    ids = rng.integers(0, M + 5, N)  # some ids >= M must be dropped
    X = rng.standard_normal((N, K))
    plan = build_bucket_plan(ids, M)
    got = np.asarray(reduce_rows(jnp.asarray(X), plan))
    want = np.zeros((M, K))
    for i, s in enumerate(ids):
        if s < M:
            want[s] += X[i]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_reduce_rows_two_level_wide_segments():
    rng = np.random.default_rng(2)
    N, M, K = 3000, 4, 5
    ids = np.concatenate([np.zeros(2500, np.int64), rng.integers(1, M, 500)])
    X = rng.standard_normal((N, K))
    plan = build_bucket_plan(ids, M, max_bucket=256)
    assert plan.second is not None
    got = np.asarray(reduce_rows(jnp.asarray(X), plan))
    want = np.asarray(segment_sum(jnp.asarray(X), jnp.asarray(ids), num_segments=M))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_reduce_rows_empty_segments_and_empty_input():
    plan = build_bucket_plan(np.zeros(0, np.int64), 5)
    got = np.asarray(reduce_rows(jnp.zeros((0, 4)), plan))
    np.testing.assert_array_equal(got, np.zeros((5, 4)))


def test_reduce_pair_products_matches_dense():
    rng = np.random.default_rng(3)
    E, M, T = 300, 9, 1200
    A = rng.standard_normal((E, 18))
    B = rng.standard_normal((E, 18))
    ei = rng.integers(0, E, T)
    ej = rng.integers(0, E, T)
    k = np.sort(rng.integers(0, M, T))
    plan = build_bucket_plan(k, M, payloads=(ei, ej), sentinel=E)
    got = np.asarray(reduce_pair_products(jnp.asarray(A), jnp.asarray(B), plan))
    want = np.zeros((M, 36))
    for t in range(T):
        want[k[t]] += (
            A[ei[t]].reshape(6, 3) @ B[ej[t]].reshape(6, 3).T
        ).reshape(36)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def _full_mantissa_rows(rng, N, K):
    """f64 rows whose significands use all 53 bits (no f32 pair holds them)."""
    return (1.0 + rng.random((N, K))) * np.exp2(rng.integers(-30, 30, (N, 1)))


def test_reduce_rows_singletons_are_bit_exact_in_f64():
    """A segment of one row returns that row bit for bit: the reduction runs
    in native f64 with no precision split of the rows."""
    rng = np.random.default_rng(42)
    N, K = 4096, 12
    X = _full_mantissa_rows(rng, N, K)
    ids = rng.permutation(N)
    plan = build_bucket_plan(ids, N)
    got = np.asarray(reduce_rows(jnp.asarray(X), plan))
    assert got.dtype == np.float64
    want = np.empty_like(X)
    want[ids] = X
    np.testing.assert_array_equal(got, want)


def test_reduce_rows_two_level_f64_matches_exact_sum():
    """Wide (two-level) segments of full-mantissa f64 rows agree with the
    correctly rounded sum to a few f64 ulps per summand."""
    import math

    rng = np.random.default_rng(43)
    N, M, K = 3000, 4, 6
    ids = np.concatenate([np.zeros(2500, np.int64), rng.integers(1, M, 500)])
    X = _full_mantissa_rows(rng, N, K)
    plan = build_bucket_plan(ids, M, max_bucket=256)
    assert plan.second is not None
    got = np.asarray(reduce_rows(jnp.asarray(X), plan))
    for m in range(M):
        rows = X[ids == m]
        for k in range(K):
            exact = math.fsum(rows[:, k])
            bound = 4 * rows.shape[0] * np.finfo(np.float64).eps * np.abs(
                rows[:, k]
            ).sum()
            assert abs(got[m, k] - exact) <= bound


def test_reduce_rows_keeps_f32_rows_in_f32():
    rng = np.random.default_rng(44)
    N, M, K = 500, 9, 4
    ids = rng.integers(0, M, N)
    X = rng.standard_normal((N, K)).astype(np.float32)
    got = reduce_rows(jnp.asarray(X), build_bucket_plan(ids, M))
    assert got.dtype == jnp.float32
    want = np.asarray(
        segment_sum(jnp.asarray(X), jnp.asarray(ids), num_segments=M)
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
