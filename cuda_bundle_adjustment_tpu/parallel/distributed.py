"""Multi-chip distributed bundle adjustment via shard_map + collectives.

New scope over the single-GPU reference (SURVEY.md section 2.3): the scaling
axes are edges (largest) and landmarks.  The decomposition is the standard
distributed Schur reduction:

* poses are REPLICATED over the mesh (the reduced camera system is linear in
  P: it is kept as flat sparse 6x6 blocks, never as a dense matrix);
* landmarks are SHARDED; every edge lives on its landmark's shard, so
  Hll/bl/Hpl and the per-landmark Schur pair products are shard-local;
* per-shard partial Hpp/bp/bsc/Hsc-blocks are combined with ``psum`` over the
  mesh (an all-reduce over NVLink on GPUs), after which every device holds
  the replicated reduced system in BLOCK-SPARSE form;
* the pose solve is chunked-block-Jacobi preconditioned CG on the flat
  blocks — O(nnz) memory and batched preconditioner factorisation, so the
  BASELINE city-scale config (~10k poses / 1M landmarks) fits: a dense
  ``[Pa, Pa, 6, 6]`` replicated solve would be ~29 GB/device at 10k poses;
* the landmark back-substitution is embarrassingly shard-local.

Two entry points:

* :func:`make_distributed_lm_step` — one jitted damped LM trial step
  (used by the driver dryrun and the parity tests);
* :func:`distributed_optimize` — the FULL LM loop (outer iterations, inner
  damping, accept/reject, termination) fused into ONE dispatch via
  ``lax.while_loop`` under ``shard_map`` (same control flow as
  solver/fused.py, which itself matches
  /root/reference/src/cuda_graph_optimisation.cpp:48-154).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum
from jax.sharding import Mesh, PartitionSpec as P

from ..models import MODEL_REGISTRY
from ..ops.components import (
    flat_abt_6x3,
    flat_mm_6x3_3x3,
    flat_mtv_6x3,
    flat_mv_3x3,
    flat_mv_6x3,
    flat_sym3x3_inv,
)
from ..ops.linalg import add_lambda
from ..ops.lie import se3_exp, se3_update_left
from ..solver.pcg import PcgPlan, build_pcg_plan, solve_blocks_pcg
from ..solver.symbolic import build_schur_structure
from ..types import GraphArrays

MAXQ = 10  # inner damping trials, cuda_graph_optimisation.cpp:50
TAU = 1e-5  # initial-lambda factor, cuda_graph_optimisation.cpp:51


class ShardedProblem(NamedTuple):
    """Device-sharded BA problem (leading axis = mesh shards, flattened)."""

    # replicated
    pose_q: jnp.ndarray  # [P, 4]
    pose_t: jnp.ndarray  # [P, 3]
    # sharded (edge/landmark arrays; edges sharded on the LAST axis so the
    # component-first [K, E] layout keeps edges on lanes)
    Xw: jnp.ndarray  # [D*Ls, 3]
    meas: jnp.ndarray  # [M, D*Es]
    omega: jnp.ndarray  # [D*Es]
    cam: jnp.ndarray  # [5, D*Es]
    pose_idx: jnp.ndarray  # [D*Es] global pose index
    lm_local: jnp.ndarray  # [D*Es] shard-local landmark index
    active: jnp.ndarray  # [D*Es] 1.0 real edge, 0.0 padding
    tri_ei: jnp.ndarray  # [D*Ts] shard-local edge index
    tri_ej: jnp.ndarray  # [D*Ts]
    tri_k: jnp.ndarray  # [D*Ts] global Hsc block id (nnz => padding)
    # static
    num_shards: int
    edges_per_shard: int
    lms_per_shard: int
    tris_per_shard: int
    num_active_poses: int
    nnz_blocks: int
    blk_row: jnp.ndarray  # [nnz] replicated
    blk_col: jnp.ndarray
    diag_pos: jnp.ndarray  # [Pa]
    kind: str
    # chunked block-Jacobi preconditioner plan (replicated; solver/pcg.py)
    pc: PcgPlan = None
    # [D*Es] 1.0 = stereo row, 0.0 = mono row, for MERGED mono+stereo inputs
    # (same masked-stereo trick as the single-chip path, types.py:mask3);
    # None for single-kind problems
    mask3: jnp.ndarray = None
    # per-edge outlier threshold (scalar > 0 enables distributed_update_edges;
    # 0 = feature off, matching EdgeSet.setOutlierThreshold semantics,
    # /root/reference/src/optimisable_graph.hpp:415-419)
    outlier_threshold: float = 0.0


def shard_problem(
    problem,
    num_shards: int,
    outlier_threshold: float = 0.0,
) -> ShardedProblem:
    """Partition a :class:`~..io.synthetic.BAProblem` (or a
    :class:`~..io.synthetic.MixedBAProblem` — mono+stereo merge onto the
    masked-stereo path first) by landmark.

    Landmarks are dealt round-robin to shards; each edge follows its
    landmark.  All per-shard arrays are padded to the max shard size with
    inert entries.  Fully vectorised (no per-edge or per-shard Python loops)
    so city-scale inputs (~4M edges) shard in seconds.
    """
    mask3_full = None
    if hasattr(problem, "specs"):  # MixedBAProblem
        from ..solver.block_solver import _merge_ba_specs

        merged = _merge_ba_specs([dict(s) for s in problem.specs])
        if len(merged) != 1:
            raise ValueError(
                "distributed path needs mergeable edge sets (mono+stereo "
                "with one robust-kernel config)"
            )
        m = merged[0]
        from ..io.synthetic import BAProblem

        E_m = m["meas"].shape[0]
        mask3_full = np.asarray(m["mask3"], dtype=np.float64)
        problem = BAProblem(
            pose_q=problem.pose_q,
            pose_t=problem.pose_t,
            num_active_poses=problem.num_active_poses,
            landmarks=problem.landmarks,
            num_active_landmarks=problem.num_active_landmarks,
            meas=m["meas"],
            pose_idx=np.asarray(m["pose_idx"], dtype=np.int32),
            lm_idx=np.asarray(m["lm_idx"], dtype=np.int32),
            omega=m["omega"],
            cam=m["cam"],
            kind="stereo",
        )

    D = num_shards
    Pa = problem.num_active_poses
    La = problem.num_active_landmarks
    L = problem.landmarks.shape[0]
    E = problem.meas.shape[0]

    lm_shard = np.arange(L) % D  # shard of each landmark
    lm_local = np.arange(L) // D  # local slot of each landmark
    Ls = int(lm_local.max()) + 1 if L else 1

    edge_shard = lm_shard[problem.lm_idx]
    order = np.argsort(edge_shard, kind="stable")
    counts = np.bincount(edge_shard, minlength=D)
    Es = int(counts.max()) if E else 1
    starts = np.zeros(D, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])

    # flat slot of each (ordered) edge: shard * Es + position-within-shard
    es_sorted = edge_shard[order]
    pos_within = np.arange(E, dtype=np.int64) - starts[es_sorted]
    slot = es_sorted * Es + pos_within

    M = problem.meas.shape[1]
    meas = np.zeros((D * Es, M))
    omega = np.zeros(D * Es)
    cam = np.zeros((D * Es, 5))
    pose_idx = np.full(D * Es, Pa, dtype=np.int32)  # pad -> dropped by segsum
    lml = np.zeros(D * Es, dtype=np.int32)
    active = np.zeros(D * Es)

    cam_arr = np.asarray(problem.cam).reshape(-1, 5)
    cam_full = (
        cam_arr if cam_arr.shape[0] == E else np.broadcast_to(cam_arr, (E, 5))
    )
    omega_full = np.broadcast_to(np.asarray(problem.omega).reshape(-1), (E,))
    meas[slot] = problem.meas[order]
    omega[slot] = omega_full[order]
    cam[slot] = cam_full[order]
    pose_idx[slot] = problem.pose_idx[order]
    lml[slot] = lm_local[problem.lm_idx[order]]
    active[slot] = 1.0
    mask3 = None
    if mask3_full is not None:
        m3 = np.zeros(D * Es)
        m3[slot] = mask3_full[order]
        mask3 = jnp.asarray(m3)

    # landmarks: [D, Ls, 3]
    Xw = np.zeros((D, Ls, 3))
    Xw[lm_shard, lm_local] = problem.landmarks

    # global Hsc pattern + multiply triples from ALL edges.  Each triple's
    # two edges share a landmark, so every triple is shard-local by
    # construction: shard it by its landmark's shard and remap the edge ids
    # to shard-local slots.
    s = build_schur_structure(problem.pose_idx, problem.lm_idx, Pa, La)
    slot_of_edge = np.empty(E, dtype=np.int64)
    slot_of_edge[order] = slot
    tri_slot_i = slot_of_edge[s.tri_ei]  # flat [D*Es] slot
    tri_slot_j = slot_of_edge[s.tri_ej]
    tri_shard = tri_slot_i // Es
    t_order = np.argsort(tri_shard, kind="stable")
    t_counts = np.bincount(tri_shard, minlength=D)
    Ts = max(int(t_counts.max()) if s.tri_k.size else 1, 1)
    t_starts = np.zeros(D, dtype=np.int64)
    np.cumsum(t_counts[:-1], out=t_starts[1:])
    t_pos = np.arange(s.tri_k.size, dtype=np.int64) - t_starts[tri_shard[t_order]]
    t_slot = tri_shard[t_order] * Ts + t_pos
    tri_ei = np.full(D * Ts, Es, dtype=np.int32)  # pad slot Es -> zero row
    tri_ej = np.full(D * Ts, Es, dtype=np.int32)
    tri_k = np.full(D * Ts, s.nnz_blocks, dtype=np.int32)  # pad -> dropped
    tri_ei[t_slot] = (tri_slot_i % Es)[t_order]
    tri_ej[t_slot] = (tri_slot_j % Es)[t_order]
    tri_k[t_slot] = s.tri_k[t_order]

    # replicated pose solve: block-Jacobi PCG on the flat Hsc blocks
    pc = build_pcg_plan(s.blk_row, s.blk_col, Pa)

    return ShardedProblem(
        pose_q=jnp.asarray(problem.pose_q),
        pose_t=jnp.asarray(problem.pose_t),
        Xw=jnp.asarray(Xw.reshape(D * Ls, 3)),
        meas=jnp.asarray(np.ascontiguousarray(meas.T)),
        omega=jnp.asarray(omega),
        cam=jnp.asarray(np.ascontiguousarray(cam.T)),
        pose_idx=jnp.asarray(pose_idx),
        lm_local=jnp.asarray(lml),
        active=jnp.asarray(active),
        tri_ei=jnp.asarray(tri_ei),
        tri_ej=jnp.asarray(tri_ej),
        tri_k=jnp.asarray(tri_k),
        num_shards=D,
        edges_per_shard=Es,
        lms_per_shard=Ls,
        tris_per_shard=Ts,
        num_active_poses=Pa,
        nnz_blocks=s.nnz_blocks,
        blk_row=jnp.asarray(s.blk_row),
        blk_col=jnp.asarray(s.blk_col),
        diag_pos=jnp.asarray(s.diag_pos),
        kind=problem.kind,
        pc=pc,
        mask3=mask3,
        outlier_threshold=float(outlier_threshold),
    )


# ---------------------------------------------------------------------------
# shard-local stage functions (run inside shard_map)
# ---------------------------------------------------------------------------


class _EdgeData:
    """PackedEdges-shaped adapter for the model stage functions."""

    def __init__(self, sp: ShardedProblem, meas, omega, cam, pose_idx,
                 lm_local, active, mask3=None):
        self.meas, self.omega, self.cam = meas, omega, cam
        self.pose_idx, self.lm_idx, self.active = pose_idx, lm_local, active
        self.mask3 = mask3
        # landmarks are never fixed in the sharded path (padding edges carry
        # active = 0), so both_free is just the pose-freedom mask
        self.both_free = (pose_idx < sp.num_active_poses).astype(omega.dtype)


def _make_shard_fns(mesh: Mesh, sp: ShardedProblem, rk: int, delta: float):
    """Shard-local chi/system/trial closures shared by the step and the
    fused loop."""
    axis = mesh.axis_names[0]
    model = MODEL_REGISTRY[sp.kind]
    Pa = sp.num_active_poses
    Ls = sp.lms_per_shard
    nnz = sp.nnz_blocks

    def chi_and_system(q, t, Xw, ed: _EdgeData):
        graph = GraphArrays(q=q, t=t, Xw=Xw)
        chi_part = jnp.sum(model.chi(graph, ed, rk, delta))
        pose_stack, lm_stack, Hpl = model.terms(graph, ed, rk, delta)
        # ONE combined psum for the independent chi scalar + pose partials
        # (see the trial's combined psum)
        chi, pose_acc = jax.lax.psum(
            (chi_part,
             segment_sum(pose_stack, ed.pose_idx, num_segments=Pa)),
            axis,
        )
        Hpp = pose_acc[:, :36].reshape(Pa, 6, 6)
        bp = pose_acc[:, 36:]
        lm_acc = segment_sum(lm_stack, ed.lm_idx, num_segments=Ls)
        return chi, (Hpp, bp, lm_acc[:, :9], lm_acc[:, 9:], Hpl)

    def chi_only(q, t, Xw, ed: _EdgeData):
        graph = GraphArrays(q=q, t=t, Xw=Xw)
        return jax.lax.psum(jnp.sum(model.chi(graph, ed, rk, delta)), axis)

    def trial(q, t, Xw, sys, lam, ed, tri_ei, tri_ej, tri_k,
              blk_row, blk_col, diag_pos, pc):
        Hpp, bp, Hll, bl, Hpl = sys
        dtype = bp.dtype
        Hpp_d = add_lambda(Hpp, lam)
        diag9 = jnp.zeros((9,), dtype).at[jnp.array([0, 4, 8])].set(1.0)
        Hll_d = Hll + lam * diag9
        invHll = flat_sym3x3_inv(Hll_d)  # [Ls,9]

        W = flat_mm_6x3_3x3(Hpl, invHll[ed.lm_idx])  # [Es,18]
        bsc_part = segment_sum(
            flat_mv_6x3(W, bl[ed.lm_idx]), ed.pose_idx, num_segments=Pa
        )
        We = jnp.concatenate([W, jnp.zeros((1, 18), dtype)], axis=0)
        He = jnp.concatenate([Hpl, jnp.zeros((1, 18), dtype)], axis=0)
        prod = flat_abt_6x3(We[tri_ei], He[tri_ej])  # [Ts,36]
        blocks_part = segment_sum(prod, tri_k, num_segments=nnz)
        # ONE combined psum for both shard-partial reductions (they have no
        # data dependence): a single all-reduce of ~nnz*36+Pa*6 doubles pay
        # one collective latency instead of two — pinned by
        # tests/test_distributed.py::test_trial_psums_are_combined
        bsc_sum, blocks_sum = jax.lax.psum((bsc_part, blocks_part), axis)
        bsc = bp - bsc_sum
        blocks = (-blocks_sum).at[diag_pos].add(Hpp_d.reshape(Pa, 36))

        xp, success = solve_blocks_pcg(
            blocks, bsc, Pa, blk_row, blk_col, diag_pos, pc
        )

        # shard-local landmark back-substitution
        xp_e = xp[jnp.minimum(ed.pose_idx, Pa - 1)]
        cl = bl - segment_sum(
            flat_mtv_6x3(Hpl, xp_e), ed.lm_idx, num_segments=Ls
        )
        xl = flat_mv_3x3(invHll, cl)

        dq, dt = se3_exp(xp)
        q_new, t_new = se3_update_left(dq, dt, q[:Pa], t[:Pa])
        q2 = jnp.concatenate([q_new, q[Pa:]], axis=0)
        t2 = jnp.concatenate([t_new, t[Pa:]], axis=0)
        Xw2 = Xw + xl

        scale = jnp.sum(xp * (lam * xp + bp)) + jax.lax.psum(
            jnp.sum(xl * (lam * xl + bl)), axis
        )
        return q2, t2, Xw2, scale, success

    def max_diag(sys):
        Hpp, bp, Hll, bl, Hpl = sys
        m = jnp.max(jnp.diagonal(Hpp, axis1=-2, axis2=-1))
        m = jnp.maximum(m, jnp.max(Hll[:, (0, 4, 8)]))
        return jax.lax.pmax(m, axis)

    return chi_and_system, chi_only, trial, max_diag


def make_distributed_lm_step(mesh: Mesh, sp: ShardedProblem, rk: int = 0, delta: float = 1.0):
    """Build the jitted full distributed LM trial step over ``mesh``.

    Returns ``step(q, t, Xw_sh, lam) -> (q', t', Xw_sh', chi_before, chi_after,
    scale, success)`` where the state arrays carry the shardings described in
    the module docstring.
    """
    axis = mesh.axis_names[0]
    chi_and_system, chi_only, trial, _ = _make_shard_fns(mesh, sp, rk, delta)
    has_m3 = sp.mask3 is not None

    def _step(
        q, t, Xw, meas, omega, cam, pose_idx, lm_local, active, mask3,
        tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos, pc, lam,
    ):
        ed = _EdgeData(sp, meas, omega, cam, pose_idx, lm_local, active,
                       mask3 if has_m3 else None)
        chi0, sys = chi_and_system(q, t, Xw, ed)
        q2, t2, Xw2, scale, success = trial(
            q, t, Xw, sys, lam, ed, tri_ei, tri_ej, tri_k,
            blk_row, blk_col, diag_pos, pc,
        )
        chi1 = chi_only(q2, t2, Xw2, ed)
        return q2, t2, Xw2, chi0, chi1, scale, success

    sharded = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis), P(None, axis), P(axis), P(None, axis), P(axis),
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P(axis), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(q, t, Xw_sh, lam):
        return sharded(
            q, t, Xw_sh, sp.meas, sp.omega, sp.cam, sp.pose_idx, sp.lm_local,
            sp.active, sp.mask3 if has_m3 else sp.active,
            sp.tri_ei, sp.tri_ej, sp.tri_k, sp.blk_row, sp.blk_col,
            sp.diag_pos, sp.pc, lam,
        )

    return step


def make_distributed_optimize_fused(
    mesh: Mesh, sp: ShardedProblem, niterations: int, rk: int = 0, delta: float = 1.0
):
    """The FULL distributed LM loop as one dispatch: outer iterations, inner
    damping trials, accept/reject, lambda adaptation and termination run as
    ``lax`` control flow inside ``shard_map`` (all loop scalars are
    replicated, so every device takes identical branches).  The linearised
    system is built once per outer iteration and reused across damping
    retries — the round-1 host loop rebuilt it every trial.
    """
    axis = mesh.axis_names[0]
    chi_and_system, chi_only, trial, max_diag = _make_shard_fns(
        mesh, sp, rk, delta
    )

    has_m3 = sp.mask3 is not None

    def _opt(
        q, t, Xw, meas, omega, cam, pose_idx, lm_local, active, mask3,
        tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos, pc,
    ):
        ed = _EdgeData(sp, meas, omega, cam, pose_idx, lm_local, active,
                       mask3 if has_m3 else None)
        dtype = omega.dtype

        def run_trial(q_c, t_c, Xw_c, sys, lam):
            q2, t2, Xw2, scale_raw, success = trial(
                q_c, t_c, Xw_c, sys, lam, ed, tri_ei, tri_ej, tri_k,
                blk_row, blk_col, diag_pos, pc,
            )
            Fhat = chi_only(q2, t2, Xw2, ed)
            return q2, t2, Xw2, Fhat, scale_raw + 1e-3, success

        def inner_damping(q0, t0, Xw0, sys, lam, nu, F):
            def cond(c):
                *_state, rho, qq, stop = c
                return (~stop) & (qq < MAXQ) & (rho < 0)

            def body(c):
                q_c, t_c, Xw_c, lam_c, nu_c, F_c, rho, qq, stop = c
                q2, t2, Xw2, Fhat, scale, success = run_trial(
                    q_c, t_c, Xw_c, sys, lam_c
                )
                Fdiff = Fhat - F_c
                rho_t = jnp.where(
                    success, (F_c - Fhat) / scale, jnp.asarray(-1.0, dtype)
                )
                accept = rho_t > 0
                x = 2.0 * rho_t - 1.0
                att = jnp.clip(1.0 - x * x * x, 1.0 / 3.0, 2.0 / 3.0)
                lam_n = jnp.where(accept, lam_c * att, lam_c * nu_c)
                nu_n = jnp.where(accept, 2.0, nu_c * 2.0)
                sel = lambda a, b: jnp.where(accept, a, b)
                q_n, t_n = sel(q2, q_c), sel(t2, t_c)
                Xw_n = sel(Xw2, Xw_c)
                F_n = jnp.where(accept, Fhat, F_c)
                bail = (~jnp.isfinite(lam_n)) | (Fdiff < 1e-4)
                stop_n = accept | bail
                qq_n = jnp.where(stop_n, qq, qq + 1)
                return q_n, t_n, Xw_n, lam_n, nu_n, F_n, rho_t, qq_n, stop_n

            init = (
                q0, t0, Xw0, lam, nu, F,
                jnp.asarray(-1.0, dtype), jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
            )
            q_f, t_f, Xw_f, lam_f, nu_f, F_f, rho_f, qq_f, _ = (
                jax.lax.while_loop(cond, body, init)
            )
            return q_f, t_f, Xw_f, lam_f, nu_f, F_f, rho_f, qq_f

        def one_iteration(it, carry):
            q_c, t_c, Xw_c, F, lam, nu, done, trace, n_done, rho_last = carry

            def run(args):
                q_c, t_c, Xw_c, F0, lam, nu, trace, n_done = args
                _chi, sys = chi_and_system(q_c, t_c, Xw_c, ed)
                lam0 = jnp.where(it == 0, TAU * max_diag(sys), lam)
                q_n, t_n, Xw_n, lam_n, nu_n, F_n, rho, qq = inner_damping(
                    q_c, t_c, Xw_c, sys, lam0, nu, F0
                )
                trace = trace.at[it].set(F_n)
                done_now = (qq == MAXQ) | (rho < 1e-6) | (~jnp.isfinite(lam_n))
                return (
                    q_n, t_n, Xw_n, F_n, lam_n, nu_n, done_now, trace,
                    n_done + 1, rho,
                )

            def skip(args):
                q_c, t_c, Xw_c, F, lam, nu, trace, n_done = args
                return (
                    q_c, t_c, Xw_c, F, lam, nu, jnp.asarray(True), trace,
                    n_done, rho_last,
                )

            return jax.lax.cond(
                done, skip, run, (q_c, t_c, Xw_c, F, lam, nu, trace, n_done)
            )

        F0 = chi_only(q, t, Xw, ed)
        trace0 = jnp.zeros((niterations,), dtype)
        carry = (
            q, t, Xw, F0, jnp.asarray(0.0, dtype), jnp.asarray(2.0, dtype),
            jnp.asarray(False), trace0, jnp.asarray(0, jnp.int32),
            jnp.asarray(-1.0, dtype),
        )
        q_f, t_f, Xw_f, F_f, lam_f, nu_f, done, trace, n_done, rho = (
            jax.lax.fori_loop(0, niterations, one_iteration, carry)
        )
        return q_f, t_f, Xw_f, trace, n_done

    sharded = jax.shard_map(
        _opt,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis), P(None, axis), P(axis), P(None, axis), P(axis),
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P(axis), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def optimize(q, t, Xw_sh, active=None):
        return sharded(
            q, t, Xw_sh, sp.meas, sp.omega, sp.cam, sp.pose_idx, sp.lm_local,
            sp.active if active is None else active,
            sp.mask3 if has_m3 else sp.active,
            sp.tri_ei, sp.tri_ej, sp.tri_k, sp.blk_row, sp.blk_col,
            sp.diag_pos, sp.pc,
        )

    return optimize


def distributed_optimize(
    mesh: Mesh, sp: ShardedProblem, niterations: int, rk: int = 0, delta: float = 1.0
):
    """Distributed LM loop (same accept/reject semantics as the single-chip
    optimiser), fused into ONE device dispatch.  Returns the chi2 trace and
    the final state."""
    opt = make_distributed_optimize_fused(mesh, sp, niterations, rk, delta)
    q, t, Xw, trace, n_done = opt(sp.pose_q, sp.pose_t, sp.Xw)
    n = int(n_done)
    return [float(x) for x in trace[:n]], (q, t, Xw)


def make_distributed_update_edges(mesh: Mesh, sp: ShardedProblem, rk: int = 0, delta: float = 1.0):
    """Distributed outlier thresholding (gpu::computeOutliers + edge
    deactivation, cuda_block_solver.cu:1135-1149 / optimisable_graph.hpp:604-640,
    recast as masking like the single-chip path): edges whose robustified chi2
    exceeds ``sp.outlier_threshold`` get ``active = 0`` for subsequent
    optimize calls.  Returns ``update(q, t, Xw_sh, active) -> (active', n_new)``.
    """
    axis = mesh.axis_names[0]
    model = MODEL_REGISTRY[sp.kind]
    thr = float(sp.outlier_threshold)
    has_m3 = sp.mask3 is not None

    def _upd(q, t, Xw, meas, omega, cam, pose_idx, lm_local, active, mask3):
        ed = _EdgeData(sp, meas, omega, cam, pose_idx, lm_local, active,
                       mask3 if has_m3 else None)
        graph = GraphArrays(q=q, t=t, Xw=Xw)
        chi_e = model.chi(graph, ed, rk, delta)  # [Es]; 0 for inactive rows
        was = active > 0
        keep = was & (chi_e <= thr)
        n_new = jax.lax.psum(jnp.sum(was & ~keep), axis)
        return keep.astype(active.dtype), n_new

    sharded = jax.shard_map(
        _upd,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis), P(None, axis), P(axis), P(None, axis), P(axis),
            P(axis), P(axis), P(axis),
        ),
        out_specs=(P(axis), P()),
        check_vma=False,
    )

    @jax.jit
    def update(q, t, Xw_sh, active):
        return sharded(
            q, t, Xw_sh, sp.meas, sp.omega, sp.cam, sp.pose_idx, sp.lm_local,
            active, sp.mask3 if has_m3 else active,
        )

    return update


def gather_landmarks(sp: ShardedProblem, Xw_sh) -> np.ndarray:
    """Undo the round-robin landmark sharding: ``[D*Ls, 3]`` -> original order."""
    D, Ls = sp.num_shards, sp.lms_per_shard
    Xw = np.asarray(Xw_sh).reshape(D, Ls, 3)
    lm_shard = np.arange(D * Ls) % D
    lm_local = np.arange(D * Ls) // D
    return Xw[lm_shard, lm_local]
