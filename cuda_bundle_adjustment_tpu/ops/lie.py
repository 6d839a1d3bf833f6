"""Batched quaternion / SE(3) operations for the bundle-adjustment engine.

All functions are pure, statically shaped, and batched over a leading axis so
XLA can vectorise them on the VPU.  Quaternions use the ``[x, y, z, w]`` layout
and SE(3) elements are ``(quat [.., 4], trans [.., 3])`` pairs representing the
world->camera transform ``Xc = R(q) @ Xw + t``.

Semantics (not code) follow the reference CUDA device library so that the LM
traces match bit-for-bit in structure:

* rotation by quaternion:      /root/reference/src/cuda/cuda_block_solver.cu:316-332
* SE3 exponential map:         /root/reference/src/cuda/cuda_block_solver.cu:781-809
  (Rodrigues with a theta < 1e-5 Taylor branch)
* left-multiplicative update:  /root/reference/src/cuda/cuda_block_solver.cu:811-823
* signed quaternion normalise: /root/reference/src/cuda/cuda_block_solver.cu:764-775
* quat <-> rotation matrix:    /root/reference/src/cuda/cuda_block_solver.cu:449-478,721-754
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of two quaternion arrays ``[..., 4]`` (xyzw)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v [..., 3]`` by quaternions ``q [..., 4]``.

    Uses the two-cross-product form ``v + w*(2 qv x v) + qv x (2 qv x v)`` so the
    floating-point operation order matches the reference's ``quatMulVec``.
    """
    qv = q[..., :3]
    w = q[..., 3:4]
    uv = jnp.cross(qv, v)
    uv = uv + uv
    return v + w * uv + jnp.cross(qv, uv)


def se3_apply(q: jnp.ndarray, t: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply SE(3) ``(q, t)`` to points ``v``: ``R(q) v + t``."""
    return quat_rotate(q, v) + t


def quat_normalize_signed(q: jnp.ndarray) -> jnp.ndarray:
    """Normalise quaternions, flipping sign so the scalar part is >= 0."""
    invn = 1.0 / jnp.linalg.norm(q, axis=-1, keepdims=True)
    invn = jnp.where(q[..., 3:4] < 0, -invn, invn)
    return q * invn


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    r00 = 1 - (tyy + tzz)
    r01 = txy - twz
    r02 = txz + twy
    r10 = txy + twz
    r11 = 1 - (txx + tzz)
    r12 = tyz - twx
    r20 = txz - twy
    r21 = tyz + twx
    r22 = 1 - (txx + tyy)
    row0 = jnp.stack([r00, r01, r02], axis=-1)
    row1 = jnp.stack([r10, r11, r12], axis=-1)
    row2 = jnp.stack([r20, r21, r22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (xyzw).

    Branchless re-expression of the classic Shepperd selection: all four
    candidate quaternions are evaluated and the one the reference's branch
    structure would pick is selected with ``where``.
    """
    r = lambda i, j: R[..., i, j]
    trace = r(0, 0) + r(1, 1) + r(2, 2)

    def _safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-300))

    # branch: trace > 0
    t0 = _safe_sqrt(trace + 1.0)
    w0 = 0.5 * t0
    s0 = 0.5 / t0
    q_tr = jnp.stack(
        [(r(2, 1) - r(1, 2)) * s0, (r(0, 2) - r(2, 0)) * s0, (r(1, 0) - r(0, 1)) * s0, w0],
        axis=-1,
    )

    def _branch(i):
        j = (i + 1) % 3
        k = (j + 1) % 3
        t = _safe_sqrt(r(i, i) - r(j, j) - r(k, k) + 1.0)
        qi = 0.5 * t
        s = 0.5 / t
        qw = (r(k, j) - r(j, k)) * s
        qj = (r(j, i) + r(i, j)) * s
        qk = (r(k, i) + r(i, k)) * s
        out = [None, None, None, qw]
        out[i], out[j], out[k] = qi, qj, qk
        return jnp.stack(out, axis=-1)

    q0, q1, q2 = _branch(0), _branch(1), _branch(2)
    # reference tie-breaking: i=1 if R11 > R00; i=2 if R22 > R(i,i)
    i_is_1 = r(1, 1) > r(0, 0)
    q_major = jnp.where(i_is_1[..., None], q1, q0)
    diag_major = jnp.where(i_is_1, r(1, 1), r(0, 0))
    q_major = jnp.where((r(2, 2) > diag_major)[..., None], q2, q_major)
    return jnp.where((trace > 0)[..., None], q_tr, q_major)


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrices ``[..., 3, 3]`` from vectors ``[..., 3]``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([zero, -z, y], axis=-1)
    row1 = jnp.stack([z, zero, -x], axis=-1)
    row2 = jnp.stack([-y, x, zero], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def _skew_sq(v: jnp.ndarray) -> jnp.ndarray:
    """``skew(v) @ skew(v)`` computed in closed form (reference ``skew2``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    row0 = jnp.stack([-yy - zz, xy, zx], axis=-1)
    row1 = jnp.stack([xy, -zz - xx, yz], axis=-1)
    row2 = jnp.stack([zx, yz, -xx - yy], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def se3_exp(xi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SE(3) exponential of twists ``xi [..., 6]`` = ``[omega(3), upsilon(3)]``.

    Returns ``(quat [..., 4], trans [..., 3])``.  Uses the same Rodrigues
    coefficients and the same ``theta < 1e-5`` Taylor fallback as the reference
    so small-angle steps produce identical floats.
    """
    omega = xi[..., :3]
    upsilon = xi[..., 3:6]
    theta = jnp.linalg.norm(omega, axis=-1)

    O1 = _skew(omega)
    O2 = _skew_sq(omega)

    small = theta < 1e-5
    # guard against 0/0 in the untaken branch
    theta_safe = jnp.where(small, 1.0, theta)
    sin_t = jnp.sin(theta_safe)
    cos_t = jnp.cos(theta_safe)
    a1 = jnp.where(small, 1.0, sin_t / theta_safe)
    a2 = jnp.where(small, 0.5, (1.0 - cos_t) / (theta_safe * theta_safe))
    a3 = jnp.where(
        small, 1.0 / 6.0, (theta_safe - sin_t) / (theta_safe * theta_safe * theta_safe)
    )
    v1 = jnp.where(small, 0.5, a2)
    v2 = jnp.where(small, 1.0 / 6.0, a3)

    eye = jnp.eye(3, dtype=xi.dtype)
    R = eye + a1[..., None, None] * O1 + a2[..., None, None] * O2
    V = eye + v1[..., None, None] * O1 + v2[..., None, None] * O2

    q = rotmat_to_quat(R)
    # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU
    t = jnp.einsum(
        "...ij,...j->...i", V, upsilon, precision=jax.lax.Precision.HIGHEST
    )
    return q, t


def se3_update_left(
    dq: jnp.ndarray, dt: jnp.ndarray, q: jnp.ndarray, t: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Left-compose an increment onto poses: ``T <- exp(xi) o T``.

    ``t_new = dt + R(dq) t``; ``q_new = signed_normalize(dq * q)``.
    """
    t_new = dt + quat_rotate(dq, t)
    q_new = quat_normalize_signed(quat_mul(dq, q))
    return q_new, t_new


def se3_inverse(q: jnp.ndarray, t: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of SE(3) ``(q, t)`` for unit quaternions: ``(q*, -R(q*) t)``."""
    q_inv = jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)
    t_inv = -quat_rotate(q_inv, t)
    return q_inv, t_inv
