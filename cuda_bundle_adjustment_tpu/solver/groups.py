"""Co-visibility group layout for the Schur product (host symbolic stage).

The Schur triple product ``Hsc[s,t] -= sum_l W[e_{l,s}] Hpl[e_{l,t}]^T``
(reference: cuda_block_solver.cu:1327-1345) is the hottest stage.  This
module chooses the *edge storage order* at build time so that the
landmark-side reductions need no gather at all:

* landmarks are classed by their number of both-free observations ``d``
  (degree), grouped by their exact observing pose tuple (real SLAM maps have
  strong co-visibility: consecutively-created landmarks see the same poses),
  and groups are cut into chunks of ``Gc`` members;
* edges are stored class-major, then **slot-major** (a landmark's a-th
  observation), then chunk-member, then chunk: the per-(class, slot) column
  ``X_a`` of any per-edge array is one contiguous slice, and every
  landmark-indexed reduction becomes a sum of ``d`` contiguous slices —
  no gather, no scatter, bit-deterministic;
* free landmarks are renumbered to their layout position so landmark state
  reads are contiguous too (dummy padding slots stay inert: their edges have
  ``active = omega = 0`` and their lambda-damped Hll inverts to ``I/lam``);
* for each (class, pair-of-slots, chunk) the pair product summed over the
  chunk members is ONE output row (``out_key``); the pose-side reductions
  pre-sum chunk members, which share their slot's pose (``chunk_pose``).

The Hsc block pattern and the triple plan come from :mod:`.symbolic`
applied to the permuted indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ClassMeta(NamedTuple):
    """Static (hashable) per-degree-class constants."""

    d: int  # both-free observations per landmark
    nc_pad: int  # chunk count padded to a multiple of tile_n
    e_start: int  # first edge row of this class's region
    lm_start: int  # first landmark position of this class
    npairs: int  # d * (d + 1) // 2
    out_start: int  # first flat output row (p * nc_pad + c ordering)
    gc: int = 8  # chunk width of THIS class (see _choose_gc)


class GroupLayoutMeta(NamedTuple):
    """Static (hashable) layout summary, passed through jit as a static arg."""

    classes: tuple[ClassMeta, ...]
    gc: int  # maximum chunk width (per-class widths live in ClassMeta.gc)
    e_classes: int  # total class-region edge rows (dummies included)
    e_total: int  # class rows + extras rows
    la_pad: int  # landmark positions incl. dummies and the d=0 region
    n_extras: int  # edges outside the class regions (single-free edges)
    n_out: int  # total flat pair-output rows


# GroupLayoutMeta rides inside the (traced) SchurPlan pytree, but every field
# is compile-time constant: register it as a LEAFLESS pytree whose content is
# aux data, so jit keys the compiled program on it without tracing the ints
# (same trick as solver/pcg.py's PcgPlan).
import jax.tree_util as _jtu

_jtu.register_pytree_node(
    GroupLayoutMeta,
    lambda m: ((), m),
    lambda aux, _: aux,
)


class GroupLayout(NamedTuple):
    meta: GroupLayoutMeta
    edge_perm: np.ndarray  # [e_total] original edge row, or -1 (dummy slot)
    lm_order: np.ndarray  # [la_pad] original free-landmark id, or -1 (dummy)
    lm_renumber: np.ndarray  # [La] old free-landmark id -> new position
    a_lut: tuple  # per class: int32 [npairs] first slot of each pair
    b_lut: tuple  # per class: int32 [npairs] second slot (a <= b)
    out_key: np.ndarray  # [n_out] int64 s_a * Pa + s_b, or -1 (dummy chunk)
    fix_rows: np.ndarray  # flat output rows needing a transposed duplicate
    chunk_pose: np.ndarray = None  # [sum_d d*nc_pad] pose of each (class,
    # slot, chunk) row — every chunk member shares it, so pose-side
    # reductions pre-sum members densely; -1 for dummy chunks
    # (pairs a != b whose chunk pose tuple has s_a == s_b: they hit a
    # diagonal block, which densify never mirrors — symbolic.py:117-128)


def _choose_gc(gsizes: np.ndarray, d: int, gc_max: int, tile_n: int) -> int:
    """Chunk width per class: ALWAYS ``gc_max`` (8).  Wide chunks mean
    fewer chunk rows in the pose-side pre-sums; the native layout code
    (native/layout.cpp) uses the same constant, so the two stay
    bit-identical."""
    return gc_max


def build_group_layout(
    pose_idx: np.ndarray,
    lm_idx: np.ndarray,
    num_active_poses: int,
    num_active_landmarks: int,
    gc: int = 8,
    tile_n: int = 128,
    native: bool = True,
) -> GroupLayout:
    if native:
        # C++ single-pass builder (native/layout.cpp): bit-identical output,
        # ~2.5x faster at KITTI-00 scale; this numpy path is the fallback
        # and the parity oracle (tests/test_native_layout.py)
        from .native_layout import native_group_layout

        lay = native_group_layout(
            pose_idx, lm_idx, num_active_poses, num_active_landmarks,
            gc=gc, tile_n=tile_n,
        )
        if lay is not None:
            return lay
    pose_idx = np.asarray(pose_idx, dtype=np.int64)
    lm_idx = np.asarray(lm_idx, dtype=np.int64)
    Pa, La = int(num_active_poses), int(num_active_landmarks)
    E = pose_idx.size

    both_free = (pose_idx < Pa) & (lm_idx < La)
    free_rows = np.nonzero(both_free)[0]
    extra_rows = np.nonzero(~both_free)[0]

    # per-landmark runs with poses ascending (order inside a run = slot order).
    # Single combined int64 key + STABLE argsort (numpy radix-sorts integer
    # keys: 0.8 ms vs 33.5 ms for the 3-key lexsort at KITTI-00 scale); the
    # free_rows tiebreak comes free because the key array is in row order.
    # Guard the combine against int64 wrap (max key < La*(Pa+1)); fall back
    # to the stable lexsort when it cannot fit, mirroring the tuple-key path.
    if La == 0 or np.log2(max(La, 1)) + np.log2(Pa + 1) < 62:
        order = np.argsort(
            lm_idx[free_rows] * np.int64(Pa + 1) + pose_idx[free_rows],
            kind="stable",
        )
    else:
        order = np.lexsort((pose_idx[free_rows], lm_idx[free_rows]))
    fr = free_rows[order]
    fl = lm_idx[free_rows][order]
    fp = pose_idx[free_rows][order]

    deg = np.bincount(fl, minlength=La)  # both-free degree per free landmark
    run_start = np.concatenate([[0], np.cumsum(deg)])  # indexed by landmark? no:
    # deg is per landmark id; fl is sorted by landmark so the run of landmark
    # l starts at sum(deg[:l])
    dmax = int(deg.max()) if La else 0

    classes = []
    a_luts, b_luts = [], []
    chunk_pose_parts = []
    lm_order_parts = []
    lm_renumber = np.full(La, -1, dtype=np.int64)
    perm_parts = []
    out_key_parts = []
    fix_parts = []

    e_cursor = 0
    lm_cursor = 0
    out_cursor = 0
    for d in range(1, dmax + 1):
        lms = np.nonzero(deg == d)[0]
        if lms.size == 0:
            continue
        # pose tuple per landmark: [Ld, d] (ascending within each landmark)
        starts = run_start[lms]
        tup = fp[starts[:, None] + np.arange(d)[None, :]]  # [Ld, d]
        eid = fr[starts[:, None] + np.arange(d)[None, :]]  # [Ld, d] edge rows
        # group landmarks by pose tuple: combine the tuple into one int64 key
        # when it fits ((Pa+1)^d < 2^63) for a radix sort; lexsort only for
        # the few high-degree classes where it cannot
        if d * np.log2(Pa + 1) < 62:
            key = tup[:, 0].astype(np.int64)
            for j in range(1, d):
                key = key * np.int64(Pa + 1) + tup[:, j]
            g_order = np.argsort(key, kind="stable")
        else:
            g_order = np.lexsort(tup.T[::-1])
        tup_s = tup[g_order]
        eid_s = eid[g_order]
        lms_s = lms[g_order]
        Ld = lms.size
        new_group = np.ones(Ld, dtype=bool)
        if Ld > 1:
            new_group[1:] = np.any(tup_s[1:] != tup_s[:-1], axis=1)
        gid = np.cumsum(new_group) - 1
        gsizes = np.bincount(gid)
        g = _choose_gc(gsizes, d, gc, tile_n)  # THIS class's chunk width
        # member index within group, then chunk id / member-within-chunk
        g_start_pos = np.nonzero(new_group)[0]
        member = np.arange(Ld) - g_start_pos[gid]
        chunk_of_group = member // g  # chunk index *within* the group
        m = member % g
        # global chunk ids: groups contribute ceil(G/g) chunks each, in order
        chunks_per_group = -(-gsizes // g)
        chunk_base = np.concatenate([[0], np.cumsum(chunks_per_group)])
        c = chunk_base[gid] + chunk_of_group
        nc = int(chunk_base[-1])
        nc_pad = -(-nc // tile_n) * tile_n

        npairs = d * (d + 1) // 2
        aa, bb = np.triu_indices(d)
        a_luts.append(aa.astype(np.int32))
        b_luts.append(bb.astype(np.int32))

        # landmark positions: lm_start + m * nc_pad + c
        pos = lm_cursor + m * nc_pad + c
        lm_renumber[lms_s] = pos
        lo = np.full(g * nc_pad, -1, dtype=np.int64)
        lo[pos - lm_cursor] = lms_s
        lm_order_parts.append(lo)

        # edge rows: e_start + a * (g * nc_pad) + m * nc_pad + c
        ep = np.full(d * g * nc_pad, -1, dtype=np.int64)
        slot_stride = g * nc_pad
        for a in range(d):
            ep[a * slot_stride + (m * nc_pad + c)] = eid_s[:, a]
        perm_parts.append(ep)

        # output keys per (pair, chunk): the chunk's pose tuple decides the
        # target block; dummy chunks (beyond nc) keep key -1
        first_of_chunk = np.zeros(nc, dtype=np.int64)
        first_of_chunk[c] = np.arange(Ld)  # any member works: same tuple
        keys = np.full((npairs, nc_pad), -1, dtype=np.int64)
        ct = tup_s[first_of_chunk]  # [nc, d]
        keys[:, :nc] = (ct[:, aa] * Pa + ct[:, bb]).T
        out_key_parts.append(keys.reshape(-1))
        cp = np.full((d, nc_pad), -1, dtype=np.int64)
        cp[:, :nc] = ct.T  # slot-major chunk poses
        chunk_pose_parts.append(cp.reshape(-1))

        # duplicate-pose fix rows: a != b but s_a == s_b (diagonal block)
        dup = (aa != bb)[:, None] & (ct[:, aa] == ct[:, bb]).T[:, :nc]
        if np.any(dup):
            pr, cr = np.nonzero(dup)
            fix_parts.append(out_cursor + pr * nc_pad + cr)

        classes.append(
            ClassMeta(
                d=d,
                nc_pad=nc_pad,
                e_start=e_cursor,
                lm_start=lm_cursor,
                npairs=npairs,
                out_start=out_cursor,
                gc=g,
            )
        )
        e_cursor += d * g * nc_pad
        lm_cursor += g * nc_pad
        out_cursor += npairs * nc_pad

    # d = 0 region: free landmarks with no both-free observations
    d0 = np.nonzero(deg == 0)[0]
    if d0.size:
        lm_renumber[d0] = lm_cursor + np.arange(d0.size)
        lm_order_parts.append(d0)
        lm_cursor += d0.size

    e_classes = e_cursor
    edge_perm = np.concatenate(
        perm_parts + [extra_rows]
        if perm_parts or extra_rows.size
        else [np.zeros(0, dtype=np.int64)]
    )
    lm_order = (
        np.concatenate(lm_order_parts)
        if lm_order_parts
        else np.zeros(0, dtype=np.int64)
    )
    out_key = (
        np.concatenate(out_key_parts)
        if out_key_parts
        else np.zeros(0, dtype=np.int64)
    )
    fix_rows = (
        np.concatenate(fix_parts) if fix_parts else np.zeros(0, dtype=np.int64)
    )
    chunk_pose = (
        np.concatenate(chunk_pose_parts)
        if chunk_pose_parts
        else np.zeros(0, dtype=np.int64)
    )

    meta = GroupLayoutMeta(
        classes=tuple(classes),
        gc=gc,
        e_classes=e_classes,
        e_total=int(edge_perm.size),
        la_pad=int(lm_cursor),
        n_extras=int(extra_rows.size),
        n_out=int(out_cursor),
    )
    return GroupLayout(
        meta=meta,
        edge_perm=edge_perm,
        lm_order=lm_order,
        lm_renumber=lm_renumber,
        a_lut=tuple(a_luts),
        b_lut=tuple(b_luts),
        out_key=out_key,
        fix_rows=fix_rows,
        chunk_pose=chunk_pose,
    )
