"""Shared array-container types (pytrees) passed between solver stages."""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class PackedEdges(NamedTuple):
    """Struct-of-arrays packed edge set (device resident, statically shaped).

    The static-shape analogue of the reference's single-arena edge payload
    (/root/reference/src/optimisable_graph.hpp:475-601): measurements, vertex
    indices, weights and camera intrinsics for every *packed* edge (edges whose
    vertices are all fixed are dropped at pack time, like the reference's
    active-edge filter, optimisable_graph.hpp:487-504).

    ``active`` is a float mask (1.0 = active, 0.0 = deactivated/outlier) —
    masking replaces the reference's dynamic edge removal + structure rebuild
    (optimisable_graph.hpp:604-640) so shapes stay static under jit.

    CONTRACT: ``meas`` of rows with ``active == 0`` is UNDEFINED. The compact
    upload path restores inactive rows as zeros while the padded path keeps
    their last values; every consumer must multiply by ``active`` (all current
    ones do). Do not read ``meas`` of an inactive edge for diagnostics or
    re-activation without first re-packing.
    """

    meas: jnp.ndarray  # [K, E] measurement payload, component-FIRST (lane = edge)
    omega: jnp.ndarray  # [E] scalar information
    cam: jnp.ndarray  # [5, E] fx fy cx cy bf, component-first
    pose_idx: jnp.ndarray  # [E] int32 dense pose index
    lm_idx: jnp.ndarray  # [E] int32 dense landmark index (0 if pose-only)
    both_free: jnp.ndarray  # [E] float mask: BOTH vertices free (pose not
    # fixed AND landmark not fixed); the only consumer of per-vertex freedom
    # is the Hpl block (single-free contributions drop via index range in the
    # reductions), so one combined mask replaces two (HBM + loop-copy diet)
    active: jnp.ndarray  # [E] float mask: 1.0 active, 0.0 outlier
    mask3: object = None  # Optional [E]: 1.0 = stereo row, 0.0 = mono row.
    # A merged mono+stereo edge set runs the stereo model with the third
    # residual component and Jacobian row masked per edge — the masked math
    # reduces EXACTLY to the mono model (the mono Jacobian is stereo's rows
    # 0-1), so one co-visibility group layout covers both sets (the
    # reference's real inputs carry both, samples/sample_ba_from_file/
    # main.cpp:121-165)


class GraphArrays(NamedTuple):
    """Packed vertex state: the device 'solution vector'.

    Poses are quaternion+translation (7 scalars) and landmarks 3, in the same
    active-first order as the reference solution layout
    (/root/reference/src/block_solver.cpp:59-77).
    """

    q: jnp.ndarray  # [P, 4] pose quaternions (xyzw), active first
    t: jnp.ndarray  # [P, 3] pose translations
    Xw: jnp.ndarray  # [L, 3] landmarks, active first


class SystemBlocks(NamedTuple):
    """The assembled block system for one LM iteration (undamped).

    Large per-landmark / per-edge blocks are stored FLAT (row-major last
    axis, ``[N, 9]`` rather than ``[N, 3, 3]``); the flat algebra in
    ops/components.py never re-expands them.
    """

    Hpp: jnp.ndarray  # [Pa, 6, 6] (small: Pa ~ 1e3)
    bp: jnp.ndarray  # [Pa, 6]
    Hll: Optional[jnp.ndarray]  # [La, 9] flat symmetric blocks or None
    bl: Optional[jnp.ndarray]  # [La, 3] or None
    Hpl: Optional[jnp.ndarray]  # [Eba, 18] flat 6x3 per-edge blocks or None
