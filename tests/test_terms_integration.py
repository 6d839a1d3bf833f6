"""Linearisation and chi on the solver path (``build_system``,
``compute_chi``, ``solve_schur``) against the dense f64 oracle
(utils/dense_reference.py), over the edge kinds, robust kernels and the f32
mode the solver runs in production.

Tolerances are relative to the largest term of each compared quantity:
1e-10 in f64 (summation order differs from the oracle's) and 1e-4 in f32."""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import cuda_bundle_adjustment_tpu.solver.block_solver as bs  # noqa: E402
from cuda_bundle_adjustment_tpu.io.arrays import (  # noqa: E402
    optimizer_from_problem,
)
from cuda_bundle_adjustment_tpu.io.synthetic import (  # noqa: E402
    make_ba_problem,
    make_mixed_ba_problem,
)
from reference_impl import DenseLM  # noqa: E402

F64_TOL = 1e-10
F32_TOL = 1e-4


def _problem(kind, seed=23):
    # small and constant-degree: the co-visibility layout collapses to one
    # or two classes (front-of-camera culling still drops a few edges)
    if kind == "mixed":
        return make_mixed_ba_problem(
            num_poses=10, num_landmarks=70, mean_obs_per_landmark=3.0,
            exact_obs_per_landmark=3, stereo_fraction=0.5, seed=seed,
        )
    return make_ba_problem(
        num_poses=10, num_landmarks=70, mean_obs_per_landmark=3.0,
        exact_obs_per_landmark=3, kind=kind, seed=seed,
    )


def _solver(problem, **kwargs):
    solver = optimizer_from_problem(problem, **kwargs).solver
    solver.build_structure()
    return solver


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0, atol=tol * scale,
        err_msg=what,
    )


def _check_system(solver, ref, sys, tol, what):
    """Compare Hpp/bp, Hll/bl and the per-(pose, landmark) Hpl blocks with
    the oracle's dense H, b (landmarks and edge rows mapped through the
    group layout)."""
    H, b = ref.build_dense_system()
    Pa, La = solver.Pa, solver.La_real
    lay = solver.group_layout
    lm_row = lay.lm_renumber if lay is not None else np.arange(La)

    Hpp_ref = np.stack([H[6 * p:6 * p + 6, 6 * p:6 * p + 6] for p in range(Pa)])
    bp_ref = b[: 6 * Pa].reshape(Pa, 6)
    _close(sys.Hpp, Hpp_ref, tol, f"Hpp [{what}]")
    _close(sys.bp, bp_ref, tol, f"bp [{what}]")

    off = 6 * Pa
    Hll_ref = np.stack(
        [H[off + 3 * l:off + 3 * l + 3, off + 3 * l:off + 3 * l + 3]
         for l in range(La)]
    ).reshape(La, 9)
    bl_ref = b[off:].reshape(La, 3)
    _close(np.asarray(sys.Hll)[lm_row], Hll_ref, tol, f"Hll [{what}]")
    _close(np.asarray(sys.bl)[lm_row], bl_ref, tol, f"bl [{what}]")

    Hpl = np.asarray(sys.Hpl, np.float64).reshape(-1, 6, 3)
    edge_src = lay.edge_perm if lay is not None else np.arange(Hpl.shape[0])
    acc = {}
    for row, e in enumerate(edge_src):
        if e < 0:
            continue
        iP, iL = int(ref.pose_idx[e]), int(ref.lm_idx[e])
        if iP < Pa and iL < La:
            acc.setdefault((iP, iL), np.zeros((6, 3)))
            acc[(iP, iL)] += Hpl[row]
    got = np.stack(list(acc.values()))
    want = np.stack(
        [H[6 * p:6 * p + 6, off + 3 * l:off + 3 * l + 3] for p, l in acc]
    )
    _close(got, want, tol, f"Hpl [{what}]")


@pytest.mark.parametrize("kind", ["mono", "mixed"])
def test_chi_kernel_matches_xla(kind):
    """compute_chi on the solver's packed (merged, layout-permuted) edges
    equals the oracle's chi."""
    problem = _problem(kind)
    solver = _solver(problem)
    got = float(bs.compute_chi(solver.graph, solver.packed, solver.metas))
    assert got == pytest.approx(DenseLM(problem).compute_chi(), rel=F64_TOL)


@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_kernel_build_system_matches_xla(kind):
    problem = _problem(kind)
    solver = _solver(problem)
    sys = bs.build_system(
        solver.graph, solver.packed, solver.metas, solver.Pa, solver.La,
        solver.plan,
    )
    _check_system(solver, DenseLM(problem), sys, F64_TOL, kind)


def test_kernel_full_solve_matches_xla():
    """schur_reduce + reduced solve + back-substitution equal the oracle's
    full dense damped solve on a mixed mono+stereo problem."""
    problem = _problem("mixed")
    solver = _solver(problem)
    lam = 1e-2
    sys = bs.build_system(
        solver.graph, solver.packed, solver.metas, solver.Pa, solver.La,
        solver.plan,
    )
    xp, xl, ok = bs.solve_schur(
        sys, jnp.asarray(lam, solver.dtype), solver.plan, solver.Pa,
        solver.La, solver.schur.nnz_blocks, mixed=False,
    )
    assert bool(ok)

    ref = DenseLM(problem)
    H, b = ref.build_dense_system()
    x = np.linalg.solve(H + lam * np.eye(H.shape[0]), b)
    Pa, La = solver.Pa, solver.La_real
    lay = solver.group_layout
    lm_row = lay.lm_renumber if lay is not None else np.arange(La)
    _close(np.asarray(xp).reshape(-1), x[: 6 * Pa], F64_TOL, "xp")
    _close(np.asarray(xl)[lm_row].reshape(-1), x[6 * Pa:], F64_TOL, "xl")


def _per_edge_x(solver):
    """Per-edge x = omega * ||e||^2 from the model (unrobustified)."""
    model = bs.MODEL_REGISTRY[solver.metas[0].kind]
    return np.asarray(model.chi(solver.graph, solver.packed[0], 0, 1.0))


def _robust_solver(problem, rk, delta):
    solver = _solver(problem, rk=rk, delta=delta)
    assert solver.metas[0].rk == rk
    # the delta must split the live edges so BOTH rho branches execute
    x = _per_edge_x(solver)
    live = np.asarray(solver.packed[0].active) > 0
    assert (x[live] > delta * delta).any() and (x[live] <= delta * delta).any()
    return solver


@pytest.mark.parametrize("rk", [1, 2, 3], ids=["tukey", "cauchy", "huber"])
def test_chi_kernel_robust_matches_xla(rk):
    """Robustified chi: rho(x) per edge (reference robustifies in-kernel,
    cuda_block_solver.cu:1085-1097)."""
    delta = 2.0
    problem = _problem("mono")
    solver = _robust_solver(problem, rk, delta)
    got = float(bs.compute_chi(solver.graph, solver.packed, solver.metas))
    want = DenseLM(problem, rk=rk, delta=delta).compute_chi()
    assert got == pytest.approx(want, rel=F64_TOL)


@pytest.mark.parametrize("rk", [1, 3], ids=["tukey", "huber"])
def test_kernel_build_system_robust_matches_xla(rk):
    """Robustified linearisation: the weight scales by rho'(x) (reference
    scales in-kernel, cuda_block_solver.cu:1188-1197)."""
    delta = 2.0
    problem = _problem("mono")
    solver = _robust_solver(problem, rk, delta)
    sys = bs.build_system(
        solver.graph, solver.packed, solver.metas, solver.Pa, solver.La,
        solver.plan,
    )
    ref = DenseLM(problem, rk=rk, delta=delta)
    _check_system(solver, ref, sys, F64_TOL, f"rk={rk}")


def test_kernel_build_system_f32_matches_xla():
    """f32 mode (the USE_FLOAT32 analogue) with a robust kernel: the f32
    system and chi agree with the f64 oracle to f32 accuracy."""
    from cuda_bundle_adjustment_tpu.graph import GraphOptimisationOptions

    problem = _problem("mono", seed=29)
    solver = _solver(
        problem, options=GraphOptimisationOptions(dtype="float32"),
        rk=3, delta=2.0,
    )
    assert solver.packed[0].meas.dtype == jnp.float32
    sys = bs.build_system(
        solver.graph, solver.packed, solver.metas, solver.Pa, solver.La,
        solver.plan,
    )
    assert sys.Hpl.dtype == jnp.float32
    ref = DenseLM(problem, rk=3, delta=2.0)
    _check_system(solver, ref, sys, F32_TOL, "f32")
    chi = float(bs.compute_chi(solver.graph, solver.packed, solver.metas))
    assert chi == pytest.approx(ref.compute_chi(), rel=F32_TOL)
