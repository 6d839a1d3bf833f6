"""Chunked-block-Jacobi preconditioned CG on flat Hsc blocks.

The scalable pose solve for reduced camera systems too large to densify
(block_solver.reduced_solver_route): O(nnz) memory, batched preconditioner
factorisation, no sequential factorization at all.  Plays the
role of the reference's general sparse Cholesky path (METIS ordering +
cusolverSp csrchol, /root/reference/src/cholesky.hpp:292-297,
cuda_linear_solver.cpp:27-42) for graphs whose bandwidth cannot be rescued
by reordering (solver/ordering.py).

Used by the single-chip solver (solver/block_solver.py) when the Hsc block
pattern is too wide for the band kernel and too large to densify, and by the
distributed layer (parallel/distributed.py) where the reduced system is
replicated in block form after the psum.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum

from ..ops.components import flat_mtv_6x6, flat_mv_6x6

PC_CHUNK = 64  # pose-chunk width: 6*PC_CHUNK scalar rows per dense chunk
CG_MAXITER = 200
CG_TOL = 1e-10


class PcgPlan(NamedTuple):
    """Host-built scatter plan for the chunk-diagonal preconditioner.

    ``tol``/``maxiter`` are captured at build time from the module constants
    and ride the pytree AUX data: jitted programs key on them, so a solver
    built under different CG settings (tests, tuning) can never hit a stale
    compiled loop with the old constants baked in."""

    src: jnp.ndarray  # [n_in] nnz block ids inside a diagonal chunk
    dst: jnp.ndarray  # [n_in, 36] flat scalar scatter position
    src_m: jnp.ndarray  # [n_mir] off-diagonal in-chunk block ids (mirrored)
    dst_m: jnp.ndarray  # [n_mir, 36] flat position of the transposed value
    nch: int  # number of pose chunks
    tol: float = CG_TOL
    maxiter: int = CG_MAXITER


# leafless static ints + device arrays: register so it can ride a jitted plan
jax.tree_util.register_pytree_node(
    PcgPlan,
    lambda p: ((p.src, p.dst, p.src_m, p.dst_m), (p.nch, p.tol, p.maxiter)),
    lambda aux, ch: PcgPlan(*ch, *aux),
)


def build_pcg_plan(
    blk_row: np.ndarray, blk_col: np.ndarray, Pa: int, ch: int = PC_CHUNK,
    pool=None,
) -> PcgPlan:
    """Scatter targets of every Hsc block inside a diagonal [ch*6, ch*6]
    chunk (upper block + its mirror)."""
    conv = pool.add if pool is not None else jnp.asarray
    blk_row = np.asarray(blk_row, dtype=np.int64)
    blk_col = np.asarray(blk_col, dtype=np.int64)
    nch = max(1, -(-int(Pa) // ch))
    same = (blk_row // ch) == (blk_col // ch)
    src = np.nonzero(same)[0]
    r_in = blk_row[src] % ch
    c_in = blk_col[src] % ch
    chid = blk_row[src] // ch
    w = ch * 6
    ij = np.arange(36, dtype=np.int64)
    ii, jj = ij // 6, ij % 6
    base = chid * (w * w)
    dst = (
        base[:, None] + (r_in[:, None] * 6 + ii[None, :]) * w
        + c_in[:, None] * 6 + jj[None, :]
    )
    off = blk_row[src] != blk_col[src]
    src_m = src[off]
    # mirror of an off-diagonal in-chunk block: value component (i, j) of
    # block (r, c) lands at scalar (c*6+j, r*6+i) — the transpose — so the
    # destination uses (jj, ii) and the VALUES need no transposing
    dst_m = (
        base[off][:, None] + (c_in[off][:, None] * 6 + jj[None, :]) * w
        + r_in[off][:, None] * 6 + ii[None, :]
    )
    return PcgPlan(
        src=conv(src.astype(np.int32)),
        dst=conv(dst.astype(np.int32)),
        src_m=conv(src_m.astype(np.int32)),
        dst_m=conv(dst_m.astype(np.int32)),
        nch=nch,
        tol=CG_TOL,
        maxiter=CG_MAXITER,
    )


def solve_blocks_pcg(
    blocks: jnp.ndarray,
    bsc: jnp.ndarray,
    Pa: int,
    blk_row: jnp.ndarray,
    blk_col: jnp.ndarray,
    diag_pos: jnp.ndarray,
    pc: PcgPlan,
    tol: float | None = None,
    maxiter: int | None = None,
    row_plan=None,
    col_plan=None,
):
    """Solve ``Hsc xp = bsc`` on flat upper-tri 6x6 blocks ``[nnz, 36]``.

    Never materialises a dense operand.  Returns ``(xp [Pa, 6], ok)`` where
    ``ok`` requires actual convergence (an unconverged CG means the damped
    system is pathological — the LM loop re-damps, exactly like the
    reference treats a zero pivot, cuda_linear_solver.cpp:48-52)."""
    from jax.scipy.linalg import solve_triangular

    tol = pc.tol if tol is None else tol
    maxiter = pc.maxiter if maxiter is None else maxiter
    nnz = blocks.shape[0]
    dtype = blocks.dtype
    w = PC_CHUNK * 6

    # symmetric Jacobi scaling (same rationale as the dense/band paths)
    diag = blocks[diag_pos][:, jnp.array([0, 7, 14, 21, 28, 35])]  # [Pa,6]
    s = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-300))
    # materialised once (barrier): every CG iteration's matvec gathers it
    bl_s = jax.lax.optimization_barrier(
        blocks * (s[blk_row][:, :, None] * s[blk_col][:, None, :]).reshape(
            nnz, 36
        )
    )
    b = (bsc * s).reshape(-1)

    # chunk-diagonal preconditioner, assembled by scatter-add and factored
    # batched in f32 (preconditioner accuracy does not affect the answer)
    ext = jnp.concatenate([bl_s, jnp.zeros((1, 36), dtype)], axis=0)
    flat = jnp.zeros((pc.nch * w * w,), jnp.float32)
    flat = flat.at[pc.dst.reshape(-1)].add(
        ext[pc.src].astype(jnp.float32).reshape(-1)
    )
    flat = flat.at[pc.dst_m.reshape(-1)].add(
        ext[pc.src_m].astype(jnp.float32).reshape(-1)
    )
    chunks = flat.reshape(pc.nch, w, w)
    # rows beyond Pa*6 get an identity diagonal so the factor exists
    rows = jnp.arange(pc.nch * w).reshape(pc.nch, w)
    padr = (rows >= Pa * 6).astype(jnp.float32)
    chunks = chunks + jnp.eye(w, dtype=jnp.float32)[None] * padr[:, :, None]
    Lc = jnp.linalg.cholesky(chunks)

    def precond(r):
        rq = jnp.pad(r, (0, pc.nch * w - Pa * 6)).reshape(pc.nch, w, 1)
        rq = rq.astype(jnp.float32)
        y = solve_triangular(Lc, rq, lower=True)
        z = solve_triangular(jnp.swapaxes(Lc, -1, -2), y, lower=False)
        return z.reshape(-1)[: Pa * 6].astype(dtype)

    offm = (blk_row != blk_col).astype(dtype)[:, None]

    def matvec(xv):
        # scatter-free bucketed reduction (fixed summation order) when the
        # caller built the blk_row/blk_col plans (single-device
        # build_structure does); the sharded path's segment_sum is a
        # scatter-add, atomic on the GPU
        x2 = xv.reshape(Pa, 6)
        if row_plan is not None:
            from .segments import reduce_rows

            y = reduce_rows(flat_mv_6x6(bl_s, x2[blk_col]), row_plan)
            y = y + reduce_rows(flat_mtv_6x6(bl_s * offm, x2[blk_row]), col_plan)
            return y.reshape(-1)
        y = segment_sum(
            flat_mv_6x6(bl_s, x2[blk_col]), blk_row, num_segments=Pa
        )
        y = y + segment_sum(
            flat_mtv_6x6(bl_s * offm, x2[blk_row]), blk_col, num_segments=Pa
        )
        return y.reshape(-1)

    bnorm = jnp.linalg.norm(b)
    atol = tol * (bnorm + 1e-300)

    def cond(c):
        x, r, z, p, rz, it = c
        return (jnp.linalg.norm(r) > atol) & (it < maxiter)

    def body(c):
        x, r, z, p, rz, it = c
        q = matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, q), 1e-300)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_n = jnp.vdot(r, z)
        p = z + (rz_n / jnp.maximum(rz, 1e-300)) * p
        return x, r, z, p, rz_n, it + 1

    x0 = jnp.zeros_like(b)
    z0 = precond(b)
    x, r, z, p, rz, it = jax.lax.while_loop(
        cond, body, (x0, b, z0, z0, jnp.vdot(b, z0), jnp.asarray(0, jnp.int32))
    )
    ok = (jnp.linalg.norm(r) <= atol) & jnp.all(jnp.isfinite(x))
    xp = (x.reshape(Pa, 6)) * s
    return xp, ok
