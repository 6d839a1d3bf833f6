"""Bit-parity of the native (C++) group-layout builder + edge packer against
the numpy implementations they replace (solver/groups.py, the `_take` packing
block in block_solver.initialize_from_arrays).

The native path is the production path whenever libtba_symbolic.so is built;
numpy is the fallback AND the oracle, so every emitted array must be
BIT-identical — layout order feeds the deterministic reduction plans, and any
divergence would silently change summation order (breaking the repo's
bit-determinism invariant)."""

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from cuda_bundle_adjustment_tpu.io.arrays import (  # noqa: E402
    optimizer_from_problem,
)
from cuda_bundle_adjustment_tpu.io.synthetic import (  # noqa: E402
    make_ba_problem,
    make_mixed_ba_problem,
)
from cuda_bundle_adjustment_tpu.solver.groups import (  # noqa: E402
    build_group_layout,
)
from cuda_bundle_adjustment_tpu.solver.native_layout import (  # noqa: E402
    _load,
    native_group_layout,
)

pytestmark = pytest.mark.skipif(
    _load() is None, reason="native library not built"
)

ARRAYS = ("edge_perm", "lm_order", "lm_renumber", "out_key", "fix_rows",
          "chunk_pose")


@pytest.mark.parametrize("seed", [0, 3])
def test_layout_bit_parity(seed):
    p = make_ba_problem(
        num_poses=40, num_landmarks=900, mean_obs_per_landmark=4.0,
        kind="mono", seed=seed,
    )
    Pa, La = p.num_active_poses, p.num_active_landmarks
    ref = build_group_layout(p.pose_idx, p.lm_idx, Pa, La, native=False)
    got = native_group_layout(p.pose_idx, p.lm_idx, Pa, La)
    assert got is not None
    assert ref.meta == got.meta
    for name in ARRAYS:
        assert np.array_equal(
            np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        ), name
    for a, b in zip(ref.a_lut, got.a_lut):
        assert np.array_equal(a, b)
    for a, b in zip(ref.b_lut, got.b_lut):
        assert np.array_equal(a, b)


def test_layout_duplicate_pose_edges():
    """Duplicate (pose, lm) edges exercise the fix-row (diagonal) path."""
    rng = np.random.default_rng(7)
    p = make_ba_problem(
        num_poses=12, num_landmarks=200, mean_obs_per_landmark=3.0,
        kind="mono", seed=1,
    )
    # duplicate a sample of edges so some landmarks see a pose twice
    dup = rng.choice(p.meas.shape[0], 40, replace=False)
    pi = np.concatenate([p.pose_idx, p.pose_idx[dup]])
    li = np.concatenate([p.lm_idx, p.lm_idx[dup]])
    Pa, La = p.num_active_poses, p.num_active_landmarks
    ref = build_group_layout(pi, li, Pa, La, native=False)
    got = native_group_layout(pi, li, Pa, La)
    assert ref.meta == got.meta
    assert ref.fix_rows.size > 0  # the path actually engaged
    for name in ARRAYS:
        assert np.array_equal(
            np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        ), name


def _packed_arrays(problem, monkeypatch, force_numpy, **kwargs):
    if force_numpy:
        import cuda_bundle_adjustment_tpu.solver.block_solver as bs

        monkeypatch.setattr(
            bs, "_pack_device_cm", bs._pack_device_cm, raising=True
        )
        import cuda_bundle_adjustment_tpu.solver.native_layout as nl

        monkeypatch.setattr(nl, "native_pack_edges", lambda *a, **k: None)
    opt = optimizer_from_problem(problem, **kwargs)
    out = []
    for d in opt.solver.packed:
        out.append({
            "meas": np.asarray(d.meas),
            "omega": np.asarray(d.omega),
            "cam": np.asarray(d.cam),
            "pose_idx": np.asarray(d.pose_idx),
            "lm_idx": np.asarray(d.lm_idx),
            "both_free": np.asarray(d.both_free),
            "active": np.asarray(d.active),
            "mask3": None if d.mask3 is None else np.asarray(d.mask3),
        })
    return out, [m.nedges for m in opt.solver.metas]


def test_native_index_matches_unique_searchsorted():
    """native_index's counting pass equals np.unique + searchsorted on a
    real layout's out_key (the Hsc pattern from the group pair keys)."""
    from cuda_bundle_adjustment_tpu.solver.native_symbolic import native_index

    p = make_ba_problem(
        num_poses=30, num_landmarks=600, mean_obs_per_landmark=4.0,
        kind="mono", seed=5,
    )
    Pa, La = p.num_active_poses, p.num_active_landmarks
    lay = build_group_layout(p.pose_idx, p.lm_idx, Pa, La)
    real = lay.out_key >= 0
    real_keys = lay.out_key[real]

    diag_keys = np.arange(Pa, dtype=np.int64) * (Pa + 1)
    keys = np.unique(np.concatenate([real_keys, diag_keys]))
    want_row = (keys // Pa).astype(np.int32)
    want_col = (keys % Pa).astype(np.int32)
    want_diag = np.searchsorted(keys, diag_keys).astype(np.int32)
    want_ids = np.searchsorted(keys, real_keys)

    tri_k, blk_row, blk_col, diag_pos = native_index(real_keys, Pa)
    assert np.array_equal(blk_row, want_row)
    assert np.array_equal(blk_col, want_col)
    assert np.array_equal(diag_pos, want_diag)
    assert np.array_equal(tri_k, want_ids)
    # fix-row ranks: ids[:n_out][fix_rows] must equal the old direct
    # searchsorted on out_key[fix_rows]
    if lay.fix_rows.size:
        ids = np.full(lay.meta.n_out, keys.size, dtype=np.int64)
        ids[real] = tri_k
        assert np.array_equal(
            ids[lay.fix_rows],
            np.searchsorted(keys, lay.out_key[lay.fix_rows]),
        )


def test_pack_scalar_active_broadcast():
    """A size-1 active array (the "all edges share one flag" shorthand the
    numpy path's nedges branch accepts) must NOT reach tba_pack_edges
    unbroadcast — the C++ reads active[src] per real row and would read out
    of bounds.  native_pack_edges broadcasts internally; pin bit-parity of
    the scalar call against the explicitly broadcast call."""
    from cuda_bundle_adjustment_tpu.solver.native_layout import (
        native_pack_edges,
    )

    p = make_ba_problem(
        num_poses=20, num_landmarks=300, mean_obs_per_landmark=3.0,
        kind="mono", seed=4,
    )
    Pa, La = p.num_active_poses, p.num_active_landmarks
    lay = build_group_layout(p.pose_idx, p.lm_idx, Pa, La)
    E = p.meas.shape[0]
    lm_tbl = lay.lm_renumber  # all landmarks active in this problem
    common = dict(Pa=Pa, M_out=p.meas.shape[1], use_int16=True)
    got_scalar = native_pack_edges(
        lay, p.meas, None, np.ones(1), None,
        p.pose_idx.astype(np.int64), p.lm_idx.astype(np.int64), lm_tbl,
        **common,
    )
    got_full = native_pack_edges(
        lay, p.meas, None, np.ones(E), None,
        p.pose_idx.astype(np.int64), p.lm_idx.astype(np.int64), lm_tbl,
        **common,
    )
    assert got_scalar is not None and got_full is not None
    for a, b in zip(got_scalar, got_full):
        if a is None:
            assert b is None
            continue
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed", "omega"])
def test_pack_bit_parity(kind, monkeypatch):
    if kind == "mixed":
        problem = make_mixed_ba_problem(
            num_poses=25, num_landmarks=500, mean_obs_per_landmark=3.5,
            stereo_fraction=0.4, seed=2,
        )
    else:
        problem = make_ba_problem(
            num_poses=25, num_landmarks=500, mean_obs_per_landmark=3.5,
            kind="stereo" if kind == "stereo" else "mono", seed=2,
        )
    if kind == "omega":  # per-edge information exercises the omega gather
        problem = problem._replace(
            omega=np.linspace(0.5, 2.0, problem.meas.shape[0])
        )
    ref, ref_ne = _packed_arrays(problem, monkeypatch, force_numpy=True)
    monkeypatch.undo()
    got, got_ne = _packed_arrays(problem, monkeypatch, force_numpy=False)
    assert ref_ne == got_ne
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        live = r["active"] > 0
        for k in r:
            if r[k] is None:
                assert g[k] is None, k
                continue
            if k == "meas":
                # compact meas upload: inactive/dummy rows restore as ZERO
                # on the native path (the numpy path keeps a real-but-
                # inactive edge's measurement; it is never consumed
                # unmasked either way)
                assert np.array_equal(r[k][:, live], g[k][:, live]), k
                assert np.all(g[k][:, ~live] == 0.0), k
                continue
            if k in ("pose_idx", "both_free"):
                # the native path DERIVES class-region indices on device
                # (_pack_device_cm_derived): ragged dummy members carry
                # their chunk's real pose where the host pack wrote the Pa
                # sentinel.  Dummies are masked by active = 0 everywhere
                # (types.py PackedEdges), so parity is required on LIVE
                # rows only; dummy-row divergence must stay inside the
                # documented contract (a valid pose index, never garbage)
                assert np.array_equal(r[k][live], g[k][live]), k
                if k == "pose_idx":
                    Pa_sent = int(r[k].max())  # sentinel = Pa on dummies
                    assert np.all(
                        (g[k][~live] >= 0) & (g[k][~live] <= Pa_sent)
                    ), k
                continue
            assert np.array_equal(r[k], g[k]), k
