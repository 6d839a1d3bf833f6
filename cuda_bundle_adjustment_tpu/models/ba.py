"""Bundle-adjustment measurement models: mono, stereo and depth edges.

Each model provides two pure, batched stage functions used by the block
solver under jit:

* ``chi(graph, data, rk, delta)``   -> per-edge robustified chi2 ``[E]``
* ``terms(graph, data, rk, delta)`` -> flat weighted quadratic-form stacks
  ``(pose_stack [E,42], lm_stack [E,12], hpl [E,18])`` — see
  :func:`..ops.components.weighted_block_stacks`.

The compute is component-form SoA (every intermediate is an ``[E]`` lane
vector; see ops/components.py for why), with the g2o Jacobian convention
``J = -d(proj)/d(state)`` so ``b = sum w J^T e`` is the negative gradient.

Functional parity with the reference kernels:

* mono/stereo error+chi:  cuda_block_solver.cu:1059-1110 (``e = proj - meas``,
  ``chi = rho(omega ||e||^2)``)
* mono/stereo quadratic form: cuda_block_solver.cu:1151-1220
* depth error: cuda_block_solver.cu:2302-2374 (``e = meas - proj_depth``);
  the reference reuses the *stereo* Jacobian kernel for depth edges
  (ba_types.h:204-233) and we reproduce that behaviour.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph import BaseEdge, EdgeSet
from ..ops import components as C
from ..ops.robust import robust_derivative, robustify
from ..types import GraphArrays, PackedEdges


def _pose_state_table(graph: GraphArrays, dtype):
    """[P, 12] per-pose state in ``dtype``: translation + rotation matrix
    (row-major).

    Rotations are computed once per POSE here — not per edge — saving ~24
    ops per edge in both the chi and quadratic-form passes (the reference
    evaluates R(q) per edge, cuda_block_solver.cu:449-478).
    """
    q = graph.q.astype(dtype)
    R = C.rotmat_comps(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
    return jnp.concatenate([graph.t.astype(dtype)] + [r[:, None] for r in R],
                           axis=1)


def _geometry_dtype(dtype):
    """The precision of the per-edge geometry: f64 whenever JAX has it.

    ``R Xw + t`` cancels (world coordinates of hundreds of metres, camera
    depths of tens), and so does ``proj - meas``: in f32 the rounding of
    R, of each product and of each sum lands on the small result, about
    1e-4 of a gradient at KITTI width, and XLA:CPU and XLA:GPU round
    differently there (one contracts the multiply-adds into FMAs, the
    other does not).  Formed in f64 from the f32 state and rounded once,
    the camera-frame point, 1/z and the residual are the correctly rounded
    f32 values on every backend; the Jacobians and quadratic forms, which
    do not cancel, stay in ``dtype``."""
    return jnp.float64 if jax.config.jax_enable_x64 else dtype


def _edge_geometry(kind: str, graph: GraphArrays, data: PackedEdges):
    """Per-edge ``(R, Xc, cam, inv_z, e)`` component vectors (all [E], in
    the graph's dtype) from row gathers of the ``[12, P]`` pose table and
    the landmarks; see :func:`_geometry_dtype` for the precision."""
    dtype = graph.q.dtype
    wide = _geometry_dtype(dtype)
    sT = _pose_state_table(graph, wide).T  # [12, P] — tiny transpose
    XT = graph.Xw.T.astype(wide)
    pi, li = data.pose_idx, data.lm_idx
    t = tuple(sT[i][pi] for i in range(3))
    R = tuple(sT[3 + i][pi] for i in range(9))
    Xw = tuple(XT[i][li] for i in range(3))
    cam = tuple(data.cam[i] for i in range(5))
    Xc = C.project_w2c_comps(R, t[0], t[1], t[2], Xw[0], Xw[1], Xw[2])
    # mask 1/z at the source: inert/padding edges with degenerate geometry
    # must not inject inf/NaN anywhere downstream.  The float ``active``
    # factor (exactly 1.0 for live rows) replaces a bool ``active > 0``
    # predicate.  The guard is a MAGNITUDE test, not ``!= 0``: a padding row
    # with a tiny |z| would make 1/z = inf and 0*inf = NaN, which poisons
    # the summed chi for the whole step; |z| > 1e-30 keeps inv_z an exact 0
    # for every degenerate row (NaN z also fails the comparison)
    safe_z = jnp.abs(Xc[2]) > 1e-30
    inv_z = data.active * jnp.where(
        safe_z, 1.0 / jnp.where(safe_z, Xc[2], 1.0), 0.0
    )
    e = _residual(kind, Xc, cam, data.meas, inv_z)
    narrow = lambda cs: tuple(c.astype(dtype) for c in cs)  # noqa: E731
    return (narrow(R), narrow(Xc), cam, inv_z.astype(dtype), narrow(e))


def _residual(kind: str, Xc, cam, meas, inv_z):
    if kind == "mono":
        return C.mono_residual_comps(Xc, cam, meas[0], meas[1], inv_z)
    if kind == "stereo":
        return C.stereo_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z)
    if kind == "depth":
        return C.depth_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z)
    raise ValueError(kind)


def _chi_projective(kind, graph, data, rk, delta):
    # no per-component masking: inactive rows produce FINITE garbage (inv_z
    # is zeroed at the source) and the trailing ``* data.active`` zeroes
    # their chi exactly; live rows are bit-identical to the masked form
    _, _, _, _, e = _edge_geometry(kind, graph, data)
    if data.mask3 is not None:
        # merged mono+stereo set: mono rows (mask3 = 0) drop the third
        # residual component, which makes the stereo math EXACTLY mono's
        e = e[:2] + (e[2] * data.mask3,)
    x = data.omega * sum(c * c for c in e)
    return robustify(rk, delta, x) * data.active


def _terms_projective(
    kind, jac_fn, graph, data, rk, delta, with_chi=False
):
    R, Xc, cam, inv_z, e = _edge_geometry(kind, graph, data)
    if data.mask3 is not None:
        e = e[:2] + (e[2] * data.mask3,)
    x = data.omega * sum(c * c for c in e)
    # ``* active`` in w zeroes every stack contribution of inactive rows
    # (their e/x are finite garbage, never NaN — see _edge_geometry)
    w = data.omega * robust_derivative(rk, delta, x) * data.active
    JP, JL = jac_fn(Xc, R, cam, inv_z)
    if data.mask3 is not None:
        # zero the third Jacobian row too: J^T J and J^T e then reduce to
        # the mono quadratic form for mono rows
        m3 = data.mask3
        JP = (JP[0], JP[1], tuple(m3 * c for c in JP[2]))
        if JL is not None:
            JL = (JL[0], JL[1], tuple(m3 * c for c in JL[2]))
    pose_stack, lm_stack, hpl = C.weighted_block_stacks(JP, JL, e, w)
    both_free = (w * data.both_free)[..., None]
    if with_chi:
        # chi rides the same residual pass: one state expansion + residual
        # evaluation instead of two per LM trial (terms for the next
        # linearisation, chi for the accept test share everything up to x)
        chi = robustify(rk, delta, x) * data.active
        return pose_stack, lm_stack, hpl * both_free, chi
    return pose_stack, lm_stack, hpl * both_free


class MonoModel:
    MDIM = 2
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta):
        return _chi_projective("mono", graph, data, rk, delta)

    @staticmethod
    def terms(graph, data, rk, delta):
        return _terms_projective(
            "mono", C.mono_jacobian_comps, graph, data, rk, delta
        )

    @staticmethod
    def terms_chi(graph, data, rk, delta):
        return _terms_projective(
            "mono", C.mono_jacobian_comps, graph, data, rk, delta, with_chi=True
        )


class StereoModel:
    MDIM = 3
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta):
        return _chi_projective("stereo", graph, data, rk, delta)

    @staticmethod
    def terms(graph, data, rk, delta):
        return _terms_projective(
            "stereo", C.stereo_jacobian_comps, graph, data, rk, delta
        )

    @staticmethod
    def terms_chi(graph, data, rk, delta):
        return _terms_projective(
            "stereo", C.stereo_jacobian_comps, graph, data, rk, delta, with_chi=True
        )


class DepthModel:
    """Inverse-depth BA edge; reuses the stereo Jacobian like the reference."""

    MDIM = 3
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta):
        return _chi_projective("depth", graph, data, rk, delta)

    @staticmethod
    def terms(graph, data, rk, delta):
        return _terms_projective(
            "depth", C.stereo_jacobian_comps, graph, data, rk, delta
        )

    @staticmethod
    def terms_chi(graph, data, rk, delta):
        return _terms_projective(
            "depth", C.stereo_jacobian_comps, graph, data, rk, delta, with_chi=True
        )


# ---------------------------------------------------------------------------
# user-facing edge / edge-set classes
# ---------------------------------------------------------------------------


class MonoEdge(BaseEdge):
    """Monocular projection edge (pose, landmark) with a 2D pixel measurement."""

    NVERTS = 2


class StereoEdge(BaseEdge):
    """Stereo projection edge with a ``[u_l, v, u_r]`` measurement."""

    NVERTS = 2


class DepthEdge(BaseEdge):
    """Depth edge with a ``[u, v, 1/z]`` measurement."""

    NVERTS = 2


class MonoEdgeSet(EdgeSet):
    KIND = "mono"
    MDIM = 2
    NVERTS = 2


class StereoEdgeSet(EdgeSet):
    KIND = "stereo"
    MDIM = 3
    NVERTS = 2


class DepthEdgeSet(EdgeSet):
    KIND = "depth"
    MDIM = 3
    NVERTS = 2
