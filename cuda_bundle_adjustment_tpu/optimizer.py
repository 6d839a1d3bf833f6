"""The Levenberg-Marquardt graph optimiser: the top-level user API.

:class:`TpuGraphOptimisation` mirrors the reference's
``CudaGraphOptimisation`` surface — ``create() / initialize() / optimize(n) /
batch_statistics() / time_profile() / set_verbose / set_profile``
(/root/reference/include/cuda_graph_optimisation.h:132-239) — and its LM
control flow reproduces ``CudaGraphOptimisationImpl::optimize`` statement for
statement (/root/reference/src/cuda_graph_optimisation.cpp:48-154): adaptive
damping with ``maxq = 10`` inner trials, ``tau = 1e-5`` initial-lambda factor,
the ``clamp(1 - (2 rho - 1)^3, 1/3, 2/3)`` attenuation, the ``+1e-3`` scale
epsilon and the same termination tests.

Unlike the reference there is no device push/pop of the solution vector: the
pipeline is functional, so a rejected trial simply discards the candidate
state (and ``restoreDiagonal`` is unnecessary because damping never mutates
the assembled system).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

from .graph import EdgeSet, GraphOptimisationOptions, VertexSet
from .solver.block_solver import BlockSolver
from .utils import profiling as prof
from .utils.stats import BatchInfo, BatchStatistics

MAX_INNER_ITERATIONS = 10  # maxq, cuda_graph_optimisation.cpp:50
TAU = 1e-5  # initial lambda factor, cuda_graph_optimisation.cpp:51
# outer-termination rho threshold: single source of truth in solver/fused.py
# (both loops must terminate identically for trace parity)
from .solver.fused import RHO_DONE  # noqa: E402


def attenuation(rho: float) -> float:
    """Lambda attenuation on an accepted step (cuda_graph_optimisation.h:255)."""
    x = 2.0 * rho - 1.0
    return 1.0 - x * x * x


class TpuGraphOptimisation:
    """Graph optimiser holding vertex/edge sets and a block solver."""

    def __init__(self, options: Optional[GraphOptimisationOptions] = None):
        self.options = options or GraphOptimisationOptions()
        self.vertex_sets: list[VertexSet] = []
        self.edge_sets: list[EdgeSet] = []
        self.solver = BlockSolver(self.options)
        self.stats = BatchStatistics()
        self.timer = prof.StageTimer()
        self.verbose = False
        self.should_profile = False
        self.use_fused_loop = True

    # -- construction -----------------------------------------------------------

    @classmethod
    def create(cls, options: Optional[GraphOptimisationOptions] = None):
        return cls(options)

    def add_vertex_set(self, vset: VertexSet) -> None:
        self.vertex_sets.append(vset)

    def add_edge_set(self, eset: EdgeSet) -> None:
        self.edge_sets.append(eset)

    def n_vertices(self, set_id: int) -> int:
        return len(self.vertex_sets[set_id])

    def get_edge_sets(self) -> Sequence[EdgeSet]:
        return self.edge_sets

    # -- lifecycle ---------------------------------------------------------------

    def initialize(self) -> None:
        t0 = time.perf_counter()
        self.solver.initialize(self.edge_sets, self.vertex_sets)
        self.stats.clear()
        self.timer.clear()
        self.timer.add(prof.PROF_INITIALIZE, (time.perf_counter() - t0) * 1e3)

    def optimize(self, niterations: int) -> None:
        solver = self.solver
        if solver.graph is None:
            raise RuntimeError("optimize() called before initialize()")

        t0 = time.perf_counter()
        solver.build_structure()
        total_ms = (time.perf_counter() - t0) * 1e3
        self.timer.add(prof.PROF_SYMBOLIC_DECOMP, solver.symbolic_ms)
        self.timer.add(prof.PROF_BUILD_STRUCTURE, total_ms - solver.symbolic_ms)

        # the fused device-resident loop avoids per-iteration host syncs; the
        # host loop is kept for verbose/profile introspection (identical trace)
        if self.use_fused_loop and not (self.verbose or self.should_profile):
            self._optimize_fused(niterations)
            return
        self._optimize_host(niterations)

    def _optimize_fused(self, niterations: int) -> None:
        import jax

        from .solver.fused import optimize_fused

        solver = self.solver
        res = optimize_fused(
            solver.graph,
            solver.packed,
            solver.plan,
            solver.metas,
            solver.Pa,
            solver.La,
            solver.schur.nnz_blocks if solver.schur is not None else 0,
            solver.do_schur,
            int(niterations),
            solver.mixed,
        )
        solver.accept(res.graph)
        # ONE device->host fetch for the whole trace (element iteration over
        # a device array would sync once PER SCALAR)
        trace_np, n_np = jax.device_get((res.trace, res.num_iterations))
        n = int(n_np)
        trace = [float(x) for x in trace_np[:n]]
        for it, chi2 in enumerate(trace):
            self.stats.add_stat(BatchInfo(it, chi2))
        solver.update_edges()
        solver.finalize()

    def _optimize_host(self, niterations: int) -> None:
        solver = self.solver

        nu = 2.0
        lam = 0.0
        F = 0.0
        rho = -1.0
        q = 0

        for iteration in range(niterations):
            it_t0 = time.perf_counter()

            if self.should_profile:
                chi_dev, sys = solver.head_profiled(self.timer)
            else:
                chi_dev, sys = solver.head()
            F = float(chi_dev)

            if iteration == 0:
                lam = TAU * solver.max_diagonal(sys)

            q = 0
            rho = -1.0
            while q < MAX_INNER_ITERATIONS and rho < 0:
                if self.should_profile:
                    new_graph, Fhat_dev, scale_dev, success_dev = (
                        solver.trial_profiled(sys, lam, self.timer)
                    )
                else:
                    new_graph, Fhat_dev, scale_dev, success_dev = solver.trial(
                        sys, lam
                    )
                Fhat = float(Fhat_dev)
                scale = float(scale_dev) + 1e-3
                success = bool(success_dev)
                Fdiff = Fhat - F
                rho = (F - Fhat) / scale if success else -1.0

                if rho > 0:
                    lam *= min(max(attenuation(rho), 1.0 / 3.0), 2.0 / 3.0)
                    nu = 2.0
                    F = Fhat
                    solver.accept(new_graph)
                    break
                else:
                    lam *= nu
                    nu *= 2.0
                    if not math.isfinite(lam) or Fdiff < 1e-4:
                        break
                    q += 1

            time_taken = (time.perf_counter() - it_t0) * 1e3
            self.stats.add_stat(BatchInfo(iteration, F))

            if self.verbose:
                outlier_count = sum(es.get_outlier_count() for es in self.edge_sets)
                print(
                    f"iteration= {iteration};   time(ms): {time_taken:.4f}   "
                    f"chi2= {F:f};   lambda= {lam:f}   rho= {rho:f}\t   "
                    f"nedges= {solver.nedges()}    levenberg iterations = {q}   "
                    f"outliers = {outlier_count}"
                )

            if q == MAX_INNER_ITERATIONS or rho < RHO_DONE or not math.isfinite(lam):
                break

        solver.update_edges()
        solver.finalize()

    # -- introspection -------------------------------------------------------------

    def batch_statistics(self) -> BatchStatistics:
        return self.stats

    def time_profile(self) -> prof.TimeProfile:
        return dict(self.timer.profile)

    def set_verbose(self, flag: bool = True) -> None:
        self.verbose = bool(flag)

    def set_profile(self, flag: bool = True) -> None:
        self.should_profile = bool(flag)

    # camelCase aliases matching the reference API
    addVertexSet = add_vertex_set
    addEdgeSet = add_edge_set
    nVertices = n_vertices
    getEdgeSets = get_edge_sets
    batchStatistics = batch_statistics
    timeProfile = time_profile
    setVerbose = set_verbose
    setProfile = set_profile


# The reference names its impl class CudaGraphOptimisationImpl; offer a
# familiar alias for users porting code.
TpuGraphOptimisationImpl = TpuGraphOptimisation
