"""The per-trial damped landmark 3x3 inversion and product of the Schur
stage (ops/components.py flat_sym3x3_inv / flat_mv_3x3) against numpy."""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cuda_bundle_adjustment_tpu.ops.components import (  # noqa: E402
    flat_mv_3x3,
    flat_sym3x3_inv,
)

DIAG9 = np.zeros(9)
DIAG9[[0, 4, 8]] = 1.0


@pytest.mark.parametrize("lam", [1e-6, 0.37, 1e4])
def test_lminv_matches_adjugate_oracle(lam):
    rng = np.random.default_rng(3)
    La = 512
    G = rng.normal(size=(La, 3, 3))
    H = np.einsum("nij,nkj->nik", G, G) + np.eye(3) * 1e-3
    H9 = H.reshape(La, 9)
    bl = rng.normal(size=(La, 3))
    # padding slots: ZERO blocks (the layout's dummy landmark slots) — the
    # damping must keep them invertible (lam * I)
    H9[::17] = 0.0
    bl[::17] = 0.0
    Hd = H9 + lam * DIAG9

    inv = np.asarray(flat_sym3x3_inv(jnp.asarray(Hd)))
    y = np.asarray(flat_mv_3x3(jnp.asarray(inv), jnp.asarray(bl)))

    ref_inv = np.linalg.inv(Hd.reshape(La, 3, 3)).reshape(La, 9)
    ref_y = np.einsum("nij,nj->ni", ref_inv.reshape(La, 3, 3), bl)
    assert np.all(np.isfinite(inv))
    # barely-damped blocks (cond ~1e4 at lam=1e-6) carry ~cond * eps of
    # relative error in any inversion: compare to the largest entry
    np.testing.assert_allclose(
        inv, ref_inv, atol=1e-12 * np.abs(ref_inv).max(), rtol=1e-9
    )
    np.testing.assert_allclose(
        y, ref_y, atol=1e-12 * (np.abs(ref_y).max() or 1.0), rtol=1e-9
    )
    # dummy slots invert to I / lam exactly enough
    np.testing.assert_allclose(inv[::17], np.tile(DIAG9 / lam, (inv[::17].shape[0], 1)),
                               rtol=1e-14)


def test_sym3x3_mv_matches_oracle():
    rng = np.random.default_rng(5)
    La = 256
    G = rng.normal(size=(La, 3, 3))
    H9 = (np.einsum("nij,nkj->nik", G, G) + np.eye(3)).reshape(La, 9)
    inv = np.asarray(flat_sym3x3_inv(jnp.asarray(H9)))
    c = rng.normal(size=(La, 3))
    x = np.asarray(flat_mv_3x3(jnp.asarray(inv), jnp.asarray(c)))
    ref = np.einsum("nij,nj->ni", inv.reshape(La, 3, 3), c)
    np.testing.assert_allclose(
        x, ref, atol=1e-14 * (np.abs(ref).max() or 1.0), rtol=1e-12
    )
    # and the product really solves the undamped system
    np.testing.assert_allclose(
        np.einsum("nij,nj->ni", H9.reshape(La, 3, 3), x), c, atol=1e-9
    )
