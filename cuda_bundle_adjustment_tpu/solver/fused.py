"""Fully device-resident LM optimisation loop (one jit dispatch per optimize).

The host LM loop (optimizer.py) syncs chi2/scale/success to the host twice per
iteration, reproducing the reference's own sync points
(cuda_block_solver.cu:1721-1728).  This module re-expresses the ENTIRE
loop — outer iterations, inner damping trials, accept/reject, lambda
adaptation, termination tests — as ``lax.while_loop``/``lax.cond`` control
flow under one jit, so an ``optimize(n)`` is one dispatch with no host sync.  The produced chi2 trace is bit-identical to the host
loop's (verified in tests/test_fused.py).

Control-flow parity with CudaGraphOptimisationImpl::optimize
(/root/reference/src/cuda_graph_optimisation.cpp:48-154):

* ``maxq = 10`` inner trials, ``tau = 1e-5`` initial-lambda factor;
* accept: ``lam *= clamp(1-(2 rho-1)^3, 1/3, 2/3)``, ``nu = 2``;
* reject: ``lam *= nu; nu *= 2``; bail out on non-finite lambda or
  ``Fhat - F < 1e-4``;
* outer termination: ``q == maxq`` or ``rho < 1e-6`` or non-finite lambda.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import GraphArrays
from .block_solver import (
    apply_update,
    build_system,
    compute_chi,
    compute_scale,
    max_diagonal,
    solve_pose_only,
    solve_schur,
)

MAXQ = 10
TAU = 1e-5
# outer-termination rho threshold (cuda_graph_optimisation.cpp:141); the host
# loop (optimizer.py) imports THIS constant so the two loops cannot drift
RHO_DONE = 1e-6


class FusedResult(NamedTuple):
    graph: GraphArrays
    trace: jnp.ndarray  # [niterations] chi2 after each executed iteration
    num_iterations: jnp.ndarray  # scalar int32: iterations actually executed
    lam: jnp.ndarray
    rho: jnp.ndarray


@functools.partial(
    jax.jit,
    static_argnames=("metas", "Pa", "La", "nnz", "do_schur", "niterations", "mixed"),
)
def optimize_fused(
    graph: GraphArrays,
    packed,
    plan,
    metas,
    Pa: int,
    La: int,
    nnz: int,
    do_schur: bool,
    niterations: int,
    mixed: bool = False,
) -> FusedResult:
    dtype = graph.q.dtype

    # the carry holds no large state: each pass gathers the per-edge state
    # from its own graph (deterministic, so the chi2 trace is unchanged)

    def trial(graph, sys, lam):
        if do_schur:
            xp, xl, success = solve_schur(sys, lam, plan, Pa, La, nnz, mixed=mixed)
        else:
            xp, success = solve_pose_only(sys, lam)
            xl = None
        new_graph = apply_update(graph, xp, xl, Pa, La)
        Fhat = compute_chi(new_graph, packed, metas)
        scale = compute_scale(xp, xl, sys, lam)
        return new_graph, Fhat, scale, success

    def inner_damping(graph, sys, lam, nu, F):
        """The reject/re-damp loop.  Carry mirrors the host loop's locals."""

        def cond(c):
            graph_c, lam_c, nu_c, F_c, rho, q, stop = c
            return (~stop) & (q < MAXQ) & (rho < 0)

        def body(c):
            graph_c, lam_c, nu_c, F_c, rho, q, stop = c
            new_graph, Fhat, scale_raw, success = trial(graph_c, sys, lam_c)
            scale = scale_raw + 1e-3
            Fdiff = Fhat - F_c
            rho_t = jnp.where(success, (F_c - Fhat) / scale, jnp.asarray(-1.0, dtype))
            accept = rho_t > 0

            x = 2.0 * rho_t - 1.0
            att = jnp.clip(1.0 - x * x * x, 1.0 / 3.0, 2.0 / 3.0)
            lam_acc = lam_c * att
            lam_rej = lam_c * nu_c
            lam_n = jnp.where(accept, lam_acc, lam_rej)
            nu_n = jnp.where(accept, 2.0, nu_c * 2.0)

            graph_n = jax.tree.map(
                lambda a, b: jnp.where(accept, a, b), new_graph, graph_c
            )
            F_n = jnp.where(accept, Fhat, F_c)

            bail = (~jnp.isfinite(lam_n)) | (Fdiff < 1e-4)
            stop_n = accept | bail
            q_n = jnp.where(stop_n, q, q + 1)
            return (graph_n, lam_n, nu_n, F_n, rho_t, q_n, stop_n)

        init = (
            graph,
            lam,
            nu,
            F,
            jnp.asarray(-1.0, dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
        )
        graph_f, lam_f, nu_f, F_f, rho_f, q_f, _ = jax.lax.while_loop(
            cond, body, init
        )
        return graph_f, lam_f, nu_f, F_f, rho_f, q_f

    def one_iteration(it, carry):
        graph, F, lam, nu, done, trace, n_done, rho_last = carry

        def run(args):
            graph, F0, lam, nu, trace, n_done = args
            # F0 is carried from the previous iteration's accepted trial —
            # recomputing on the same graph is deterministic and equal, so
            # carrying the SCALAR saves one full residual pass per iteration
            sys = build_system(graph, packed, metas, Pa, La, plan)
            lam0 = jnp.where(it == 0, TAU * max_diagonal(sys), lam)
            graph, lam, nu, F, rho, q = inner_damping(graph, sys, lam0, nu, F0)
            trace = trace.at[it].set(F)
            done_now = (q == MAXQ) | (rho < RHO_DONE) | (~jnp.isfinite(lam))
            return graph, F, lam, nu, done_now, trace, n_done + 1, rho

        def skip(args):
            graph, F, lam, nu, trace, n_done = args
            return (
                graph, F, lam, nu, jnp.asarray(True), trace, n_done,
                rho_last,
            )

        graph, F, lam, nu, done, trace, n_done, rho = jax.lax.cond(
            done, skip, run, (graph, F, lam, nu, trace, n_done)
        )
        return graph, F, lam, nu, done, trace, n_done, rho

    trace0 = jnp.zeros((niterations,), dtype)
    carry = (
        graph,
        compute_chi(graph, packed, metas),
        jnp.asarray(0.0, dtype),
        jnp.asarray(2.0, dtype),
        jnp.asarray(False),
        trace0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(-1.0, dtype),
    )
    graph, F, lam, nu, done, trace, n_done, rho = jax.lax.fori_loop(
        0, niterations, one_iteration, carry
    )
    return FusedResult(
        graph=graph, trace=trace, num_iterations=n_done, lam=lam, rho=rho
    )
