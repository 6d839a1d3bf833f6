"""Scatter-free segment reductions via build-time bucket plans.

``jax.ops.segment_sum`` lowers to a scatter-add, which on the GPU is an
atomic add in an order that changes from run to run, so its sums are not
bit-reproducible.  This module converts every hot segment reduction into

    build time (numpy):  group segment members, pad each segment to a
                         power-of-two bucket width, emit per-bucket gather
                         index matrices ``[n_b, S_b]`` (pad = sentinel row);
    run time   (XLA):    gather rows -> dense ``sum(axis=1)`` per bucket ->
                         concatenate -> one tiny out-gather to segment order.

No scatter appears anywhere; summation order within a segment is fixed by
the plan, so reductions are bit-deterministic (the property the reference
had to pin kernel block sizes for, cuda_block_solver.cu:2633-2638).

Used for the quadratic-form accumulations (replacing the reference's
ACCUM_ATOMIC scatter, cuda_block_solver.cu:1202-1213) and the Schur-product
reduction over multiply triples (cuda_block_solver.cu:1327-1345).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class _Handle:
    """Deferred device array: a slice of an :class:`UploadPool` buffer."""

    __slots__ = ("pool", "offset", "shape")

    def __init__(self, pool, offset, shape):
        self.pool = pool
        self.offset = offset
        self.shape = shape

    def get(self):
        return self.pool.resolve(self)


class UploadPool:
    """Batches many small int32 plan arrays into ONE host->device upload.

    A structure build creates ~20 plan arrays; the pool concatenates them
    into one flat int32 buffer, uploads it once, and splits it back into
    views with a single jitted slice program (one dispatch).
    """

    def __init__(self):
        self._arrays: list[np.ndarray] = []
        self._shapes: list[tuple] = []
        self._offsets: list[int] = [0]
        self._device: tuple | None = None

    def add(self, a) -> _Handle:
        if self._device is not None:
            raise RuntimeError("UploadPool already committed")
        a = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
        h = _Handle(self, len(self._arrays), a.shape)
        self._arrays.append(a.reshape(-1))
        self._shapes.append(a.shape)
        self._offsets.append(self._offsets[-1] + a.size)
        return h

    def commit(self) -> None:
        if self._device is not None:
            return
        flat = (
            np.concatenate(self._arrays)
            if self._arrays
            else np.zeros(0, dtype=np.int32)
        )
        dev = jnp.asarray(flat)  # the ONE upload
        shapes = tuple(
            tuple(int(d) for d in s) for s in self._shapes
        )
        offs = tuple(self._offsets[:-1])
        self._device = _pool_split(dev, offs, shapes)

    def resolve(self, h: _Handle):
        if self._device is None:
            self.commit()
        return self._device[h.offset]


@functools.partial(jax.jit, static_argnames=("offs", "shapes"))
def _pool_split(flat, offs, shapes):
    # reshapes happen INSIDE the one split program: an eager per-array
    # .reshape() would be a separate tiny dispatch each
    import math

    return tuple(
        jax.lax.slice_in_dim(
            flat, o, o + math.prod(s)
        ).reshape(s)
        for o, s in zip(offs, shapes)
    )


def _resolve_plan(plan: "BucketPlan") -> "BucketPlan":
    """Replace deferred handles in a plan tree with real device arrays."""
    buckets = tuple(
        tuple(s.get() if isinstance(s, _Handle) else s for s in streams)
        for streams in plan.payload_buckets
    )
    og = plan.out_gather
    if isinstance(og, _Handle):
        og = og.get()
    second = _resolve_plan(plan.second) if plan.second is not None else None
    return BucketPlan(buckets, og, plan.num_segments, second)


class BucketPlan(NamedTuple):
    """Build-time plan for one segment reduction.

    ``payload_buckets`` holds, per bucket, a tuple of int32 ``[n_b, S_b]``
    index matrices (one per payload stream — e.g. one for a plain row
    reduction, two (ei, ej) for the Schur pair product).  Pad entries point
    at ``sentinel`` (callers append a zero row at that index).
    ``out_gather[m]`` maps segment id m to its bucket-concatenation position;
    when segments wider than ``max_bucket`` exist, ``second`` reduces the
    per-chunk partial rows first (recursively, but depth is log-bounded).
    """

    payload_buckets: tuple  # tuple[bucket] of tuple[stream] of jnp int32 [n_b, S_b]
    out_gather: jnp.ndarray  # [M] int32
    num_segments: int
    second: "BucketPlan | None" = None


def build_bucket_plan(
    ids: np.ndarray,
    num_segments: int,
    payloads: Sequence[np.ndarray] | None = None,
    sentinel: int | None = None,
    min_bucket: int = 4,
    max_bucket: int = 1 << 14,
    sorted_ids: bool = False,
    host_out: dict | None = None,
    pool: UploadPool | None = None,
) -> BucketPlan:
    """Plan a reduction of ``len(ids)`` rows into ``num_segments`` segments.

    ``payloads`` (default: row positions ``arange(N)``) are the values placed
    in the gather matrices.  ``sentinel`` (default ``N``) fills padding.
    Segments larger than ``max_bucket`` are split into multiple rows of the
    widest bucket plus a remainder bucket (their partial sums are summed by
    emitting the same segment id multiple times — handled via a second-level
    plan below, so arbitrary segment sizes are safe).
    """
    conv = pool.add if pool is not None else jnp.asarray
    ids = np.asarray(ids, dtype=np.int64)
    N = ids.size
    M = int(num_segments)
    if payloads is None:
        payloads = (np.arange(N, dtype=np.int64),)
    if sentinel is None:
        sentinel = N

    if sorted_ids:
        order = np.arange(N, dtype=np.int64)
        ids_s = ids
    else:
        order = np.argsort(ids, kind="stable")
        ids_s = ids[order]
    starts = np.searchsorted(ids_s, np.arange(M))
    ends = np.searchsorted(ids_s, np.arange(M) + 1)
    counts = ends - starts

    # second level handles over-wide segments: first level reduces chunks of
    # max_bucket, second level sums the per-chunk partials (tiny)
    nchunks = np.maximum(1, -(-counts // max_bucket))
    total_rows = int(nchunks.sum())
    two_level = bool(np.any(nchunks > 1))

    # per first-level row: owning segment, chunk offset, chunk length
    seg_of_row = np.repeat(np.arange(M), nchunks)
    chunk_idx = np.arange(total_rows) - np.repeat(
        np.cumsum(nchunks) - nchunks, nchunks
    )
    row_start = starts[seg_of_row] + chunk_idx * max_bucket
    row_len = np.minimum(counts[seg_of_row] - chunk_idx * max_bucket, max_bucket)

    # bucket width per row: next pow2 >= len (>= min_bucket)
    width = np.maximum(min_bucket, 1 << np.ceil(np.log2(np.maximum(row_len, 1))).astype(np.int64))
    width[row_len == 0] = min_bucket

    bucket_sizes = np.unique(width)
    payload_buckets = []
    row_order = []  # first-level rows in bucket-concatenation order
    for S in bucket_sizes:
        rows = np.nonzero(width == S)[0]
        row_order.append(rows)
        n_b = rows.size
        offs = np.arange(S, dtype=np.int64)
        pos = row_start[rows][:, None] + offs[None, :]
        valid = offs[None, :] < row_len[rows][:, None]
        streams = []
        host_streams = []
        for p in payloads:
            if N == 0:
                g = np.full(pos.shape, sentinel, dtype=np.int32)
            else:
                from .native_symbolic import native_fill_bucket

                g = native_fill_bucket(
                    p,
                    None if sorted_ids else order,
                    row_start[rows],
                    row_len[rows],
                    S,
                    sentinel,
                )
                if g is None:  # native lib absent: vectorised numpy fallback
                    g = np.where(
                        valid, p[order[np.minimum(pos, N - 1)]], sentinel
                    ).astype(np.int32)
            host_streams.append(g)
            streams.append(conv(host_streams[-1]))
        payload_buckets.append(tuple(streams))
        if host_out is not None:
            host_out.setdefault("buckets", []).append(tuple(host_streams))
    row_order = np.concatenate(row_order) if row_order else np.zeros(0, np.int64)
    pos_of_row = np.empty(total_rows, dtype=np.int64)
    pos_of_row[row_order] = np.arange(total_rows)

    if not two_level:
        out_gather = conv(pos_of_row.astype(np.int32))  # rows == segments
        return BucketPlan(tuple(payload_buckets), out_gather, M, None)

    # second level: reduce the per-chunk partial rows by owning segment
    # (total_rows is barely above M, so this plan is tiny)
    row_seg = seg_of_row[row_order]
    second = build_bucket_plan(
        row_seg, M, payloads=None, sentinel=total_rows,
        min_bucket=min_bucket, max_bucket=max_bucket, pool=pool,
    )
    out_gather = conv(np.arange(M, dtype=np.int32))
    return BucketPlan(tuple(payload_buckets), out_gather, M, second)


def reduce_rows(X: jnp.ndarray, plan: BucketPlan) -> jnp.ndarray:
    """Apply a single-payload plan: ``out[m] = sum of X rows in segment m``.

    ``X`` is ``[N, K]``; a zero sentinel row is appended internally.
    """
    X_ext = jnp.concatenate([X, jnp.zeros((1, X.shape[1]), X.dtype)], axis=0)
    parts = [X_ext[streams[0]].sum(axis=1) for streams in plan.payload_buckets]
    cat = jnp.concatenate(parts, axis=0)
    if plan.second is not None:
        return reduce_rows(cat, plan.second)[plan.out_gather]
    return cat[plan.out_gather]


def reduce_pair_products(
    A: jnp.ndarray, B: jnp.ndarray, plan: BucketPlan
) -> jnp.ndarray:
    """Apply a two-payload plan computing ``out[m] = sum_r A[ei_r] @ B[ej_r]^T``
    over 6x3 blocks stored flat ``[N, 18]`` -> ``[M, 36]`` flat 6x6 blocks.

    This is the Schur multiply stage (cuda_block_solver.cu:1327-1345) as a
    per-bucket batched contraction instead of a 1-thread-per-triple atomic
    kernel.
    """
    Ae = jnp.concatenate([A, jnp.zeros((1, 18), A.dtype)], axis=0)
    Be = jnp.concatenate([B, jnp.zeros((1, 18), B.dtype)], axis=0)
    parts = []
    for ei, ej in plan.payload_buckets:
        # one batched contraction per bucket: [n_b, S, 6, 3] x [n_b, S, 6, 3]
        # over (S, 3) -> [n_b, 6, 6]; HIGHEST keeps f32 operands out of TF32
        Ag = Ae[ei].reshape(*ei.shape, 6, 3)
        Bg = Be[ej].reshape(*ej.shape, 6, 3)
        prod = jnp.einsum(
            "nsik,nsjk->nij", Ag, Bg, precision=jax.lax.Precision.HIGHEST
        )
        parts.append(prod.reshape(-1, 36))
    cat = jnp.concatenate(parts, axis=0)
    if plan.second is not None:
        return reduce_rows(cat, plan.second)[plan.out_gather]
    return cat[plan.out_gather]
