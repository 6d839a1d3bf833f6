"""Synthetic BA problem generators.

Produces KITTI-like bundle-adjustment graphs at arbitrary scale, both as raw
arrays (fast path for benchmarks; no per-edge Python objects) and as graph
objects (exercises the user-facing API).  The KITTI BA inputs shipped with the
reference are absent from its snapshot (samples/ba_input.7z is listed in
.MISSING_LARGE_BLOBS), so synthetic graphs with matched dimensions
(P=1322, L=133383, E=561116 for ba_kitti_00; P=248, L=26127, E=95037 for
ba_kitti_07) are the benchmark workload.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BAProblem(NamedTuple):
    """Raw-array BA problem (world->camera poses, landmarks, observations)."""

    pose_q: np.ndarray  # [P, 4] xyzw
    pose_t: np.ndarray  # [P, 3]
    num_active_poses: int  # first pose(s) fixed => appended at the end
    landmarks: np.ndarray  # [L, 3]
    num_active_landmarks: int
    meas: np.ndarray  # [E, M]
    pose_idx: np.ndarray  # [E]
    lm_idx: np.ndarray  # [E]
    omega: np.ndarray  # [E]
    cam: np.ndarray  # [5]
    kind: str  # "mono" | "stereo" | "depth"


class MixedBAProblem(NamedTuple):
    """A BA problem with SEVERAL edge sets over shared vertices — the shape
    of the reference's real inputs, which carry both a monocular and a
    stereo edge list (samples/sample_ba_from_file/main.cpp:121-165)."""

    pose_q: np.ndarray  # [P, 4]
    pose_t: np.ndarray  # [P, 3]
    num_active_poses: int
    landmarks: np.ndarray  # [L, 3]
    num_active_landmarks: int
    cam: np.ndarray  # [5]
    specs: tuple  # per edge set: dict(kind, meas, pose_idx, lm_idx, omega)


DEFAULT_CAM = np.array([718.856, 718.856, 607.1928, 185.2157, 386.1448], dtype=np.float64)


def _axis_angle_quat(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * angle[..., None]
    return np.concatenate([axis * np.sin(half), np.cos(half)], axis=-1)


def _quat_rotate_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv, w = q[..., :3], q[..., 3:4]
    uv = 2.0 * np.cross(qv, v)
    return v + w * uv + np.cross(qv, uv)


def make_ba_problem(
    num_poses: int = 100,
    num_landmarks: int = 2000,
    mean_obs_per_landmark: float = 4.0,
    kind: str = "mono",
    noise_px: float = 1.0,
    landmark_noise: float = 0.05,
    pose_noise: float = 0.002,
    num_fixed_poses: int = 1,
    seed: int = 0,
    exact_obs_per_landmark: int | None = None,
) -> BAProblem:
    """Generate a forward-moving camera observing a point cloud.

    Each landmark is observed by a random contiguous window of poses (like
    feature tracks), measurements are exact projections plus pixel noise, and
    the initial estimates perturb the ground truth so LM has work to do.
    """
    rng = np.random.default_rng(seed)
    P, L = num_poses, num_landmarks
    cam = DEFAULT_CAM.copy()

    # ground-truth trajectory: forward motion with slight turning
    t_gt = np.zeros((P, 3))
    t_gt[:, 2] = np.arange(P) * 1.0
    t_gt[:, 0] = np.sin(np.arange(P) * 0.02) * 5.0
    yaw = np.cos(np.arange(P) * 0.02) * 0.05
    q_gt = _axis_angle_quat(np.tile(np.array([0.0, 1.0, 0.0]), (P, 1)), yaw)

    # landmarks spread around the trajectory, in front of their anchor poses;
    # anchors are SORTED: real SLAM maps create landmarks sequentially as the
    # camera moves, so landmark ids correlate with trajectory position (true
    # of the KITTI BA graphs) — downstream, this gives the per-edge state
    # gathers their locality
    anchor = np.sort(rng.integers(0, P, size=L))
    local = np.stack(
        [
            rng.uniform(-15.0, 15.0, L),
            rng.uniform(-5.0, 5.0, L),
            rng.uniform(4.0, 40.0, L),
        ],
        axis=-1,
    )
    Xw_gt = t_gt[anchor] + local

    # observations: a contiguous pose window per landmark
    if exact_obs_per_landmark is not None:
        # constant-degree variant: collapses the co-visibility layout to a
        # single degree class — used by the interpret-mode kernel tests,
        # where every class compiles its own (slow) interpret kernel
        n_obs = np.full(L, exact_obs_per_landmark, dtype=np.int64)
    else:
        n_obs = np.maximum(
            1, rng.poisson(mean_obs_per_landmark, size=L)
        ).astype(np.int64)
    n_obs = np.minimum(n_obs, 12)
    start = np.maximum(0, anchor - rng.integers(0, 3, size=L))
    lm_idx = np.repeat(np.arange(L, dtype=np.int64), n_obs)
    offsets = np.concatenate([np.arange(n) for n in n_obs])
    pose_idx = np.minimum(start[lm_idx] + offsets, P - 1).astype(np.int64)

    # world->camera: Xc = R(q_cw) (Xw - C); we store q_cw = conj(q_wc), t = -R C
    q_cw = q_gt.copy()
    q_cw[:, :3] *= -1.0
    t_cw = -_quat_rotate_np(q_cw, t_gt)

    Xc = _quat_rotate_np(q_cw[pose_idx], Xw_gt[lm_idx]) + t_cw[pose_idx]
    # keep only points safely in front of the camera
    ok = Xc[:, 2] > 1.0
    pose_idx, lm_idx, Xc = pose_idx[ok], lm_idx[ok], Xc[ok]
    E = pose_idx.size

    inv_z = 1.0 / Xc[:, 2]
    u = cam[0] * Xc[:, 0] * inv_z + cam[2]
    v = cam[1] * Xc[:, 1] * inv_z + cam[3]
    if kind == "mono":
        meas = np.stack([u, v], axis=-1)
    elif kind == "stereo":
        meas = np.stack([u, v, u - cam[4] * inv_z], axis=-1)
    elif kind == "depth":
        meas = np.stack([u, v, inv_z], axis=-1)
    else:
        raise ValueError(kind)
    meas = meas + rng.normal(0.0, noise_px, size=meas.shape)
    if kind == "depth":
        meas[:, 2] = np.abs(meas[:, 2])

    # initial estimates: perturbed ground truth (first `num_fixed_poses` exact)
    q_est = q_cw + rng.normal(0.0, pose_noise, size=q_cw.shape)
    q_est /= np.linalg.norm(q_est, axis=-1, keepdims=True)
    q_est[q_est[:, 3] < 0] *= -1.0
    t_est = t_cw + rng.normal(0.0, pose_noise * 50, size=t_cw.shape)
    q_est[:num_fixed_poses] = q_cw[:num_fixed_poses]
    t_est[:num_fixed_poses] = t_cw[:num_fixed_poses]
    Xw_est = Xw_gt + rng.normal(0.0, landmark_noise, size=Xw_gt.shape)

    # active-first layout: fixed poses go to the END of the packed arrays
    nf = num_fixed_poses
    Pa = P - nf
    perm = np.concatenate([np.arange(nf, P), np.arange(nf)])  # actives then fixed
    inv_perm = np.empty(P, dtype=np.int64)
    inv_perm[perm] = np.arange(P)
    q_packed, t_packed = q_est[perm], t_est[perm]
    pose_idx_packed = inv_perm[pose_idx]

    return BAProblem(
        pose_q=q_packed,
        pose_t=t_packed,
        num_active_poses=Pa,
        landmarks=Xw_est,
        num_active_landmarks=L,
        meas=meas,
        pose_idx=pose_idx_packed.astype(np.int32),
        lm_idx=lm_idx.astype(np.int32),
        omega=np.ones(E, dtype=np.float64),
        cam=cam,
        kind=kind,
    )


def make_mixed_ba_problem(
    stereo_fraction: float = 0.5, seed: int = 0, **kwargs
) -> MixedBAProblem:
    """Mono + stereo edge sets over one vertex set: generate a stereo
    problem and demote a random subset of observations to mono (dropping
    the disparity component), mirroring real VSLAM inputs where only some
    features carry stereo matches."""
    p = make_ba_problem(kind="stereo", seed=seed, **kwargs)
    rng = np.random.default_rng(seed + 1)
    E = p.meas.shape[0]
    is_stereo = rng.random(E) < stereo_fraction
    mono = dict(
        kind="mono",
        meas=p.meas[~is_stereo][:, :2],
        pose_idx=p.pose_idx[~is_stereo],
        lm_idx=p.lm_idx[~is_stereo],
        omega=p.omega[~is_stereo],
        cam=p.cam,
    )
    stereo = dict(
        kind="stereo",
        meas=p.meas[is_stereo],
        pose_idx=p.pose_idx[is_stereo],
        lm_idx=p.lm_idx[is_stereo],
        omega=p.omega[is_stereo],
        cam=p.cam,
    )
    return MixedBAProblem(
        pose_q=p.pose_q,
        pose_t=p.pose_t,
        num_active_poses=p.num_active_poses,
        landmarks=p.landmarks,
        num_active_landmarks=p.num_active_landmarks,
        cam=p.cam,
        specs=(mono, stereo),
    )


def kitti00_scale_problem(kind: str = "mono", seed: int = 0) -> BAProblem:
    """A problem with ba_kitti_00's dimensions (README.md:36).

    The noise levels put the graph in the near-converged regime of the
    reference benchmark (its KITTI-00 input is the output of a VSLAM run:
    chi2 only drops 334210 -> 320086 over 10 iterations, ~1 LM trial per
    iteration), so per-iteration work is comparable."""
    return make_ba_problem(
        num_poses=1322,
        num_landmarks=133383,
        mean_obs_per_landmark=561116 / 133383,
        kind=kind,
        landmark_noise=0.01,
        pose_noise=0.0005,
        seed=seed,
    )


def kitti00_scale_mixed_problem(seed: int = 0) -> MixedBAProblem:
    """ba_kitti_00 dimensions with BOTH mono and stereo edge sets — the
    reference's real input shape (main.cpp:121-165)."""
    return make_mixed_ba_problem(
        num_poses=1322,
        num_landmarks=133383,
        mean_obs_per_landmark=561116 / 133383,
        landmark_noise=0.01,
        pose_noise=0.0005,
        stereo_fraction=0.5,
        seed=seed,
    )


def kitti07_scale_problem(kind: str = "mono", seed: int = 0) -> BAProblem:
    """A problem with ba_kitti_07's dimensions (README.md:35)."""
    return make_ba_problem(
        num_poses=248,
        num_landmarks=26127,
        mean_obs_per_landmark=95037 / 26127,
        kind=kind,
        seed=seed,
    )


def make_loop_closure_problem(
    num_poses: int = 5000,
    num_landmarks: int = 50_000,
    mean_obs_per_landmark: float = 4.0,
    long_range_fraction: float = 0.05,
    kind: str = "mono",
    seed: int = 0,
) -> BAProblem:
    """A trajectory graph where a fraction of landmarks is re-observed by a
    RANDOM far-away pose — long-range co-visibility that defeats any banded
    ordering (the workload class the reference handles with METIS + general
    sparse Cholesky, cholesky.hpp:292-297; here it exercises the RCM->PCG
    fallback chain)."""
    p = make_ba_problem(
        num_poses=num_poses,
        num_landmarks=num_landmarks,
        mean_obs_per_landmark=mean_obs_per_landmark,
        kind=kind,
        seed=seed,
        landmark_noise=0.01,
        pose_noise=0.0005,
    )
    rng = np.random.default_rng(seed + 7)
    L = p.landmarks.shape[0]
    lc = np.nonzero(rng.random(L) < long_range_fraction)[0]
    far_pose = rng.integers(0, p.pose_q.shape[0], size=lc.size)
    # project the (estimated) landmark into the far pose for a consistent
    # extra measurement
    q = p.pose_q[far_pose]
    t = p.pose_t[far_pose]
    Xc = _quat_rotate_np(q, p.landmarks[lc]) + t
    ok = Xc[:, 2] > 1.0
    lc, far_pose, Xc = lc[ok], far_pose[ok], Xc[ok]
    cam = p.cam
    inv_z = 1.0 / Xc[:, 2]
    u = cam[0] * Xc[:, 0] * inv_z + cam[2]
    v = cam[1] * Xc[:, 1] * inv_z + cam[3]
    if kind == "mono":
        meas = np.stack([u, v], axis=-1)
    else:
        meas = np.stack([u, v, u - cam[4] * inv_z], axis=-1)
    return p._replace(
        meas=np.concatenate([p.meas, meas], axis=0),
        pose_idx=np.concatenate([p.pose_idx, far_pose.astype(np.int32)]),
        lm_idx=np.concatenate([p.lm_idx, lc.astype(np.int32)]),
        omega=np.concatenate([p.omega, np.ones(lc.size)]),
    )


def city_scale_problem(
    kind: str = "mono", seed: int = 0, scale: float = 1.0
) -> BAProblem:
    """The BASELINE distributed config: a city-scale graph (~10k poses /
    1M landmarks at ``scale=1``) for multi-host Schur benchmarks.  ``scale``
    shrinks it proportionally for CPU-mesh validation runs."""
    return make_ba_problem(
        num_poses=max(8, int(10_000 * scale)),
        num_landmarks=max(64, int(1_000_000 * scale)),
        mean_obs_per_landmark=4.2,
        kind=kind,
        landmark_noise=0.01,
        pose_noise=0.0005,
        seed=seed,
    )
