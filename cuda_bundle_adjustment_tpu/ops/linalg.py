"""Small batched linear-algebra helpers for the block system.

These replace the reference's per-thread unrolled device math
(reference src/cuda/cuda_block_solver.cu:64-234,639-669) with batched
array operations.
"""

from __future__ import annotations

import jax.numpy as jnp


def sym3x3_inv(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of symmetric 3x3 blocks ``[..., 3, 3]``.

    Mirrors the reference's adjugate formula (``Sym3x3Inv``) so the float
    rounding matches; only the upper triangle of ``A`` is read.
    """
    A00 = A[..., 0, 0]
    A01 = A[..., 0, 1]
    A11 = A[..., 1, 1]
    A02 = A[..., 2, 0]
    A12 = A[..., 1, 2]
    A22 = A[..., 2, 2]

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

    row0 = jnp.stack([B00, B01, B02], axis=-1)
    row1 = jnp.stack([B01, B11, B12], axis=-1)
    row2 = jnp.stack([B02, B12, B22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def add_lambda(H: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Add ``lam`` to the diagonal of each block of ``H [..., D, D]``."""
    D = H.shape[-1]
    eye = jnp.eye(D, dtype=H.dtype)
    return H + lam * eye


def block_diag_solve(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve of per-block systems ``H [..., D, D] x = b [..., D]``.

    Used for the pose-only (no-Schur) path where Hpp is block-diagonal: the
    reference densifies Hpp and runs a dense cuSOLVER factorization
    (reference src/cuda_linear_solver.cpp:85-107); per-block Cholesky
    gives the identical solution.
    """
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(H)
    z = solve_triangular(L, b[..., None], lower=True)
    x = solve_triangular(jnp.swapaxes(L, -1, -2), z, lower=False)
    return x[..., 0]
