"""The fused device-resident LM loop must reproduce the host loop exactly."""

import numpy as np
import pytest

from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_fused_trace_equals_host_trace(kind):
    problem = make_ba_problem(
        num_poses=10, num_landmarks=60, mean_obs_per_landmark=4.0, kind=kind, seed=51
    )

    opt_host = optimizer_from_problem(problem)
    opt_host.use_fused_loop = False
    opt_host.optimize(6)
    trace_host = [s.chi2 for s in opt_host.batch_statistics().get()]

    opt_fused = optimizer_from_problem(problem)
    opt_fused.use_fused_loop = True
    opt_fused.optimize(6)
    trace_fused = [s.chi2 for s in opt_fused.batch_statistics().get()]

    assert len(trace_host) == len(trace_fused)
    np.testing.assert_allclose(trace_fused, trace_host, rtol=1e-12)

    np.testing.assert_allclose(
        np.asarray(opt_fused.solver.graph.q),
        np.asarray(opt_host.solver.graph.q),
        atol=1e-14,
    )
    np.testing.assert_allclose(
        np.asarray(opt_fused.solver.graph.Xw),
        np.asarray(opt_host.solver.graph.Xw),
        atol=1e-14,
    )


def test_fused_termination_parity():
    # noise-free problem: whether or not early termination triggers, the fused
    # loop must execute exactly as many iterations as the host loop
    problem = make_ba_problem(
        num_poses=8, num_landmarks=40, mean_obs_per_landmark=4.0, kind="mono",
        seed=53, noise_px=0.0, landmark_noise=0.02, pose_noise=0.001,
        num_fixed_poses=2,
    )
    opt_h = optimizer_from_problem(problem)
    opt_h.use_fused_loop = False
    opt_h.optimize(25)
    opt_f = optimizer_from_problem(problem)
    opt_f.use_fused_loop = True
    opt_f.optimize(25)
    th = [s.chi2 for s in opt_h.batch_statistics().get()]
    tf = [s.chi2 for s in opt_f.batch_statistics().get()]
    assert len(tf) == len(th)
    # at deep convergence chi2 ~ 1e-9 is pure rounding noise; the two paths
    # are separate XLA compilations (different fusion/FMA choices), so only
    # absolute agreement at the noise floor is meaningful here
    np.testing.assert_allclose(tf, th, rtol=1e-6, atol=1e-12)


def test_fused_pose_only():
    import numpy as np

    import cuda_bundle_adjustment_tpu as tba

    rng = np.random.default_rng(57)
    poses = tba.PoseVertexSet()
    q0 = np.array([0.01, -0.02, 0.005, 1.0])
    q0 /= np.linalg.norm(q0)
    poses.add_vertex(tba.PoseVertex(0, tba.Se3(q0, [0.05, -0.02, 0.1]), False))
    plane_set = tba.PlaneEdgeSet()
    plane_set.set_information(1.0)
    for _ in range(40):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        d = rng.normal()
        p = n * d + np.cross(n, rng.normal(size=3))
        e = tba.PlaneEdge()
        e.set_vertex(poses.get_vertex(0), 0)
        e.set_measurement(tba.PointToPlaneMatch(n, d, p))
        e.set_information(1.0)
        plane_set.add_edge(e)

    opt = tba.TpuGraphOptimisation.create()
    opt.use_fused_loop = True
    opt.add_vertex_set(poses)
    opt.add_edge_set(plane_set)
    opt.initialize()
    opt.optimize(10)
    assert opt.batch_statistics().get()[-1].chi2 < 1e-10


def test_fused_carry_invariant_under_rejections(monkeypatch):
    """A rejected trial's state must never leak into the next linearisation
    under ANY outer termination rule.  The fused loop carries NO large state
    (each pass gathers from its own graph, see solver/fused.py), which closes
    the hazard by construction; this test keeps it closed: disable the rho
    termination (RHO_DONE -> -2 in both loops) and force mid-run LARGE-step
    rejections by failing the solve whenever lambda drops below 1000
    (success=False -> rho=-1 -> Fdiff<1e-4 bail, with the rejected candidate
    far from the rolled-back graph).  The fused loop must match the host
    loop."""
    import cuda_bundle_adjustment_tpu.optimizer as opt_mod
    import cuda_bundle_adjustment_tpu.solver.block_solver as bs
    import cuda_bundle_adjustment_tpu.solver.fused as fused_mod
    from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem as mk

    problem = mk(
        num_poses=9, num_landmarks=55, mean_obs_per_landmark=4.0, kind="mono",
        seed=91, noise_px=1.0, landmark_noise=0.3, pose_noise=0.05,
        num_fixed_poses=2,
    )

    monkeypatch.setattr(fused_mod, "RHO_DONE", -2.0)
    monkeypatch.setattr(opt_mod, "RHO_DONE", -2.0)

    # lambda decays ~6.4e5 -> 692 by iteration 11 on this problem; failing
    # the solve below 1000 yields an alternating reject(bail)/accept tail —
    # every bail is a rejected GOOD step whose candidate state is far from
    # the rolled-back graph
    real_solve = bs.solve_schur

    def failing_solve(sys, lam, plan, Pa, La, nnz, mixed=False):
        xp, xl, success = real_solve(sys, lam, plan, Pa, La, nnz, mixed=mixed)
        return xp, xl, success & (lam > 1000.0)

    monkeypatch.setattr(bs, "solve_schur", failing_solve)
    monkeypatch.setattr(fused_mod, "solve_schur", failing_solve)

    def run(fused):
        opt = optimizer_from_problem(problem)
        opt.use_fused_loop = fused
        opt.optimize(20)
        return [s.chi2 for s in opt.batch_statistics().get()]

    th = run(fused=False)  # host oracle
    tn = run(fused=True)

    # witness: at least one bail (chi2 unchanged) FOLLOWED by an accepted
    # iteration (chi2 changed) — the exact pattern that reads a stale state
    # if the carry is wrong
    rejects = [i for i in range(1, len(th)) if th[i] == th[i - 1]]
    assert rejects and any(
        th[j] != th[j - 1] for j in range(rejects[0] + 1, len(th))
    ), th
    assert len(tn) == len(th)
    np.testing.assert_allclose(tn, th, rtol=1e-9)
