"""Component-form (structure-of-arrays) math for the per-edge hot path.

The hot path computes with *components*: every per-edge quantity is a plain
``[E]`` vector, so XLA fuses each chain of elementwise operations into one
pass, and rank-2 per-edge blocks exist only as flat ``[E, K]`` stacks
created at the last moment before a segment reduction.

This is the same computation the reference performs per CUDA thread with
unrolled scalar code (cuda_block_solver.cu:64-842) — vectorised over lanes
instead of threads.  The array-form functions in ops/lie.py, ops/projection.py
and ops/jacobians.py are the semantic reference; tests/test_components.py
pins this module to them.
"""

from __future__ import annotations

import jax.numpy as jnp


def rotmat_comps(qx, qy, qz, qw):
    """Quaternion components -> 9 rotation-matrix components (row-major)."""
    tx, ty, tz = 2 * qx, 2 * qy, 2 * qz
    twx, twy, twz = tx * qw, ty * qw, tz * qw
    txx, txy, txz = tx * qx, ty * qx, tz * qx
    tyy, tyz, tzz = ty * qy, tz * qy, tz * qz
    return (
        1 - (tyy + tzz), txy - twz, txz + twy,
        txy + twz, 1 - (txx + tzz), tyz - twx,
        txz - twy, tyz + twx, 1 - (txx + tyy),
    )


def rotate_comps(R, vx, vy, vz):
    """Apply a rotation given as 9 components to vector components."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    return (
        r00 * vx + r01 * vy + r02 * vz,
        r10 * vx + r11 * vy + r12 * vz,
        r20 * vx + r21 * vy + r22 * vz,
    )


def project_w2c_comps(R, tx, ty, tz, Xx, Xy, Xz):
    """World->camera: ``Xc = R Xw + t`` in components."""
    cx, cy, cz = rotate_comps(R, Xx, Xy, Xz)
    return cx + tx, cy + ty, cz + tz


def mono_residual_comps(Xc, cam, m0, m1, inv_z):
    """Mono residual components; ``inv_z`` passed in (masked at the caller)."""
    Xx, Xy, _ = Xc
    fx, fy, cx, cy, _ = cam
    e0 = fx * inv_z * Xx + cx - m0
    e1 = fy * inv_z * Xy + cy - m1
    return e0, e1


def stereo_residual_comps(Xc, cam, m0, m1, m2, inv_z):
    Xx, Xy, _ = Xc
    fx, fy, cx, cy, bf = cam
    u = fx * inv_z * Xx + cx
    e0 = u - m0
    e1 = fy * inv_z * Xy + cy - m1
    e2 = u - bf * inv_z - m2
    return e0, e1, e2


def depth_residual_comps(Xc, cam, m0, m1, m2, inv_z):
    """Depth residual ``meas - proj`` (flipped sign; cuda_block_solver.cu:2340)."""
    Xx, Xy, _ = Xc
    fx, fy, cx, cy, _ = cam
    e0 = m0 - (fx * inv_z * Xx + cx)
    e1 = m1 - (fy * inv_z * Xy + cy)
    e2 = m2 - inv_z
    return e0, e1, e2


def mono_jacobian_comps(Xc, R, cam, inv_z):
    """g2o-convention mono Jacobians as nested component tuples.

    Returns ``(JP [2][6], JL [2][3])`` of ``[E]`` vectors (see
    ops/jacobians.py:jacobians_mono for the array-form reference).
    """
    Xx, Xy, _ = Xc
    fx, fy, _, _, _ = cam
    x = inv_z * Xx
    y = inv_z * Xy
    fx_iz = fx * inv_z
    fy_iz = fy * inv_z
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R

    jl0 = (
        -fx_iz * (r00 - x * r20),
        -fx_iz * (r01 - x * r21),
        -fx_iz * (r02 - x * r22),
    )
    jl1 = (
        -fy_iz * (r10 - y * r20),
        -fy_iz * (r11 - y * r21),
        -fy_iz * (r12 - y * r22),
    )
    zero = jnp.zeros_like(x)
    jp0 = (fx * x * y, -fx * (1 + x * x), fx * y, -fx_iz, zero, fx_iz * x)
    jp1 = (fy * (1 + y * y), -fy * x * y, -fy * x, zero, -fy_iz, fy_iz * y)
    return (jp0, jp1), (jl0, jl1)


def stereo_jacobian_comps(Xc, R, cam, inv_z):
    """g2o-convention stereo Jacobians ``(JP [3][6], JL [3][3])``."""
    Xx, Xy, _ = Xc
    fx, fy, _, _, bf = cam
    inv_zz = inv_z * inv_z
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R

    jl0 = (
        -fx * r00 * inv_z + fx * Xx * r20 * inv_zz,
        -fx * r01 * inv_z + fx * Xx * r21 * inv_zz,
        -fx * r02 * inv_z + fx * Xx * r22 * inv_zz,
    )
    jl1 = (
        -fy * r10 * inv_z + fy * Xy * r20 * inv_zz,
        -fy * r11 * inv_z + fy * Xy * r21 * inv_zz,
        -fy * r12 * inv_z + fy * Xy * r22 * inv_zz,
    )
    jl2 = (
        jl0[0] - bf * r20 * inv_zz,
        jl0[1] - bf * r21 * inv_zz,
        jl0[2] - bf * r22 * inv_zz,
    )
    zero = jnp.zeros_like(inv_z)
    jp0 = (
        Xx * Xy * inv_zz * fx,
        -(1 + Xx * Xx * inv_zz) * fx,
        Xy * inv_z * fx,
        -inv_z * fx,
        zero,
        Xx * inv_zz * fx,
    )
    jp1 = (
        (1 + Xy * Xy * inv_zz) * fy,
        -Xx * Xy * inv_zz * fy,
        -Xx * inv_z * fy,
        zero,
        -inv_z * fy,
        Xy * inv_zz * fy,
    )
    jp2 = (
        jp0[0] - bf * Xy * inv_zz,
        jp0[1] + bf * Xx * inv_zz,
        jp0[2],
        jp0[3],
        zero,
        jp0[5] - bf * inv_zz,
    )
    return (jp0, jp1, jp2), (jl0, jl1, jl2)


def weighted_block_stacks(JP, JL, e, w):
    """Flat weighted quadratic-form contributions from component Jacobians.

    Returns ``(hpp_bp [E, 42], hll_bl [E, 12], hpl [E, 18])`` where
    ``hpp = w JP^T JP`` (row-major 36), ``bp = w JP^T e`` (6),
    ``hll = w JL^T JL`` (9), ``bl = w JL^T e`` (3), ``hpl = w JP^T JL`` (18).
    ``JL`` may be None for pose-only models (-> returns (pose_stack, None, None)).
    """
    M = len(JP)
    cols = []
    for i in range(6):
        for j in range(6):
            s = sum(JP[m][i] * JP[m][j] for m in range(M))
            cols.append(w * s)
    for i in range(6):
        s = sum(JP[m][i] * e[m] for m in range(M))
        cols.append(w * s)
    pose_stack = jnp.stack(cols, axis=-1)

    if JL is None:
        return pose_stack, None, None

    cols_l = []
    for i in range(3):
        for j in range(3):
            s = sum(JL[m][i] * JL[m][j] for m in range(M))
            cols_l.append(w * s)
    for i in range(3):
        s = sum(JL[m][i] * e[m] for m in range(M))
        cols_l.append(w * s)
    lm_stack = jnp.stack(cols_l, axis=-1)

    cols_pl = []
    for i in range(6):
        for j in range(3):
            s = sum(JP[m][i] * JL[m][j] for m in range(M))
            cols_pl.append(s)  # weight applied by caller (needs both-free mask)
    hpl_stack = jnp.stack(cols_pl, axis=-1)
    return pose_stack, lm_stack, hpl_stack


# ---------------------------------------------------------------------------
# flat small-block algebra ([N, K] stacks; row-major block layout)
# ---------------------------------------------------------------------------


def flat_sym3x3_inv(H9):
    """Inverse of symmetric 3x3 blocks stored flat ``[N, 9]`` (row-major).

    Same adjugate formula as ops/linalg.py:sym3x3_inv.
    """
    A00, A01, A02 = H9[..., 0], H9[..., 1], H9[..., 2]
    A11, A12, A22 = H9[..., 4], H9[..., 5], H9[..., 8]
    det = (
        A00 * A11 * A22
        + A01 * A12 * A02
        + A02 * A01 * A12
        - A00 * A12 * A12
        - A02 * A11 * A02
        - A01 * A01 * A22
    )
    inv_det = 1.0 / det
    B00 = inv_det * (A11 * A22 - A12 * A12)
    B01 = inv_det * (A02 * A12 - A01 * A22)
    B11 = inv_det * (A00 * A22 - A02 * A02)
    B02 = inv_det * (A01 * A12 - A02 * A11)
    B12 = inv_det * (A02 * A01 - A00 * A12)
    B22 = inv_det * (A00 * A11 - A01 * A01)
    return jnp.stack([B00, B01, B02, B01, B11, B12, B02, B12, B22], axis=-1)


def flat_mm_6x3_3x3(A18, B9):
    """``C = A @ B`` for flat blocks: A ``[N,18]`` (6x3), B ``[N,9]`` (3x3)."""
    cols = []
    for i in range(6):
        for j in range(3):
            s = sum(A18[..., i * 3 + c] * B9[..., c * 3 + j] for c in range(3))
            cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_mv_6x3(A18, v3):
    """``y = A @ v`` for flat 6x3 blocks and ``[N,3]`` vectors -> ``[N,6]``."""
    cols = []
    for i in range(6):
        s = sum(A18[..., i * 3 + c] * v3[..., c] for c in range(3))
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_mtv_6x3(A18, v6):
    """``y = A^T @ v`` for flat 6x3 blocks and ``[N,6]`` vectors -> ``[N,3]``."""
    cols = []
    for j in range(3):
        s = sum(A18[..., c * 3 + j] * v6[..., c] for c in range(6))
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_mv_3x3(B9, v3):
    """``y = B @ v`` for flat 3x3 blocks -> ``[N,3]``."""
    cols = []
    for i in range(3):
        s = sum(B9[..., i * 3 + c] * v3[..., c] for c in range(3))
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_mv_6x6(A36, v6):
    """``y = A @ v`` for flat 6x6 blocks (row-major) and ``[N,6]`` vectors."""
    cols = []
    for i in range(6):
        s = sum(A36[..., i * 6 + c] * v6[..., c] for c in range(6))
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_mtv_6x6(A36, v6):
    """``y = A^T @ v`` for flat 6x6 blocks (row-major) and ``[N,6]`` vectors."""
    cols = []
    for j in range(6):
        s = sum(A36[..., c * 6 + j] * v6[..., c] for c in range(6))
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def flat_abt_6x3(A18, B18):
    """``C = A @ B^T`` for flat 6x3 blocks -> ``[N,36]`` (6x6 row-major)."""
    cols = []
    for i in range(6):
        for j in range(6):
            s = sum(A18[..., i * 3 + c] * B18[..., j * 3 + c] for c in range(3))
            cols.append(s)
    return jnp.stack(cols, axis=-1)
