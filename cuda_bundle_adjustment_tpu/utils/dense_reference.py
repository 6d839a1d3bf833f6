"""Dense numpy reference implementation of the cugo/g2o LM pipeline.

The role of g2o in the reference's comparison sample
(/root/reference/samples/sample_comparison_with_g2o/main.cpp): an independent
CPU implementation of the same math used for chi2-trace and RMSE parity
checks, both in the test suite and in samples/sample_comparison_with_cpu.py.

Independent oracle for the device solver: same math (residuals, g2o-convention
Jacobians, robust kernels, damping, Schur elimination via a full dense solve,
SE3-exp update, gain-ratio control flow), written with straightforward dense
linear algebra so any indexing/masking bug in the packed solver shows up as a
trace divergence.
"""

from __future__ import annotations

import numpy as np


def quat_rotate(q, v):
    qv, w = q[..., :3], q[..., 3:4]
    uv = 2.0 * np.cross(qv, v)
    return v + w * uv + np.cross(qv, uv)


def quat_to_rotmat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def se3_exp(xi):
    omega, upsilon = xi[:3], xi[3:]
    theta = np.linalg.norm(omega)
    Ox = np.array(
        [
            [0, -omega[2], omega[1]],
            [omega[2], 0, -omega[0]],
            [-omega[1], omega[0], 0],
        ]
    )
    O2 = Ox @ Ox
    if theta < 1e-5:
        R = np.eye(3) + Ox + 0.5 * O2
        V = np.eye(3) + 0.5 * Ox + O2 / 6.0
    else:
        a1 = np.sin(theta) / theta
        a2 = (1 - np.cos(theta)) / theta**2
        a3 = (theta - np.sin(theta)) / theta**3
        R = np.eye(3) + a1 * Ox + a2 * O2
        V = np.eye(3) + a2 * Ox + a3 * O2
    return R, V @ upsilon


def rotmat_to_quat(R):
    t = np.trace(R)
    q = np.empty(4)
    if t > 0:
        s = np.sqrt(t + 1.0)
        q[3] = 0.5 * s
        s = 0.5 / s
        q[0] = (R[2, 1] - R[1, 2]) * s
        q[1] = (R[0, 2] - R[2, 0]) * s
        q[2] = (R[1, 0] - R[0, 1]) * s
    else:
        i = 0
        if R[1, 1] > R[0, 0]:
            i = 1
        if R[2, 2] > R[i, i]:
            i = 2
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0)
        q[i] = 0.5 * s
        s = 0.5 / s
        q[3] = (R[k, j] - R[j, k]) * s
        q[j] = (R[j, i] + R[i, j]) * s
        q[k] = (R[k, i] + R[i, k]) * s
    return q


def quat_mul(a, b):
    return np.array(
        [
            a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1],
            a[3] * b[1] + a[1] * b[3] + a[2] * b[0] - a[0] * b[2],
            a[3] * b[2] + a[2] * b[3] + a[0] * b[1] - a[1] * b[0],
            a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2],
        ]
    )


def robustify(rk, delta, x):
    if rk == 0:
        return x
    d2 = delta * delta
    if rk == 1:  # Tukey
        maxv = d2 / 3
        return maxv * (1 - (1 - x / d2) ** 3) if x <= d2 else maxv
    if rk == 2:  # Cauchy
        return d2 * np.log(x / d2 + 1)
    if rk == 3:  # Huber
        return x if x <= d2 else 2 * delta * np.sqrt(x) - d2
    raise ValueError(rk)


def robust_deriv(rk, delta, x):
    if rk == 0:
        return 1.0
    d2 = delta * delta
    if rk == 1:
        return (1 - x / d2) ** 2 if x <= d2 else 0.0
    if rk == 2:
        return 1.0 / (x / d2 + 1)
    if rk == 3:
        return 1.0 if x <= d2 else delta / np.sqrt(x)
    raise ValueError(rk)


class DenseLM:
    """Dense LM on a mono/stereo BA problem in packed-array form.

    Accepts a single-kind ``BAProblem`` or a ``MixedBAProblem`` (several edge
    specs over shared vertices, e.g. mono+stereo — the reference's real input
    shape, samples/sample_ba_from_file/main.cpp:121-165); mixed problems keep
    a per-edge ``kind`` so every edge runs its own residual/Jacobian."""

    def __init__(self, problem, rk=0, delta=1.0):
        self.q = problem.pose_q.copy()
        self.t = problem.pose_t.copy()
        self.Xw = problem.landmarks.copy()
        self.Pa = problem.num_active_poses
        self.La = problem.num_active_landmarks
        if hasattr(problem, "specs"):  # MixedBAProblem
            self.meas = [
                np.asarray(m, dtype=np.float64)
                for s in problem.specs
                for m in np.asarray(s["meas"])
            ]
            self.pose_idx = np.concatenate(
                [np.asarray(s["pose_idx"]) for s in problem.specs]
            )
            self.lm_idx = np.concatenate(
                [np.asarray(s["lm_idx"]) for s in problem.specs]
            )
            self.omega = np.concatenate(
                [np.asarray(s["omega"], dtype=np.float64) for s in problem.specs]
            )
            self.kinds = [
                s["kind"] for s in problem.specs for _ in range(len(s["meas"]))
            ]
        else:
            self.meas = problem.meas
            self.pose_idx = problem.pose_idx
            self.lm_idx = problem.lm_idx
            self.omega = problem.omega
            self.kinds = None
            self.kind = problem.kind
        self.cam = problem.cam
        self.rk, self.delta = rk, delta
        self.chi_trace = []

    def _kind_of(self, e):
        return self.kinds[e] if self.kinds is not None else self.kind

    def _residual_one(self, e):
        iP, iL = self.pose_idx[e], self.lm_idx[e]
        Xc = quat_rotate(self.q[iP], self.Xw[iL]) + self.t[iP]
        fx, fy, cx, cy, bf = self.cam
        iz = 1.0 / Xc[2]
        u = fx * Xc[0] * iz + cx
        v = fy * Xc[1] * iz + cy
        kind = self._kind_of(e)
        if kind == "mono":
            proj = np.array([u, v])
        elif kind == "stereo":
            proj = np.array([u, v, u - bf * iz])
        else:
            raise ValueError(kind)
        return proj - self.meas[e], Xc

    def compute_chi(self):
        total = 0.0
        for e in range(len(self.pose_idx)):
            r, _ = self._residual_one(e)
            total += robustify(self.rk, self.delta, self.omega[e] * (r @ r))
        return total

    def _jacobians_one(self, e, Xc):
        fx, fy, cx, cy, bf = self.cam
        X, Y, Z = Xc
        iz = 1.0 / Z
        izz = iz * iz
        R = quat_to_rotmat(self.q[self.pose_idx[e]])
        if self._kind_of(e) == "mono":
            x, y = X * iz, Y * iz
            JL = np.empty((2, 3))
            JL[0] = -fx * iz * (R[0] - x * R[2])
            JL[1] = -fy * iz * (R[1] - y * R[2])
            JP = np.array(
                [
                    [fx * x * y, -fx * (1 + x * x), fx * y, -fx * iz, 0, fx * iz * x],
                    [fy * (1 + y * y), -fy * x * y, -fy * x, 0, -fy * iz, fy * iz * y],
                ]
            )
        else:
            JL = np.empty((3, 3))
            JL[0] = -fx * R[0] * iz + fx * X * R[2] * izz
            JL[1] = -fy * R[1] * iz + fy * Y * R[2] * izz
            JL[2] = JL[0] - bf * R[2] * izz
            JP = np.empty((3, 6))
            JP[0] = [
                X * Y * izz * fx,
                -(1 + X * X * izz) * fx,
                Y * iz * fx,
                -iz * fx,
                0,
                X * izz * fx,
            ]
            JP[1] = [
                (1 + Y * Y * izz) * fy,
                -X * Y * izz * fy,
                -X * iz * fy,
                0,
                -iz * fy,
                Y * izz * fy,
            ]
            JP[2] = [
                JP[0, 0] - bf * Y * izz,
                JP[0, 1] + bf * X * izz,
                JP[0, 2],
                JP[0, 3],
                0,
                JP[0, 5] - bf * izz,
            ]
        return JP, JL

    def build_dense_system(self):
        n = 6 * self.Pa + 3 * self.La
        H = np.zeros((n, n))
        b = np.zeros(n)
        for e in range(len(self.pose_idx)):
            iP, iL = self.pose_idx[e], self.lm_idx[e]
            r, Xc = self._residual_one(e)
            x = self.omega[e] * (r @ r)
            w = self.omega[e] * robust_deriv(self.rk, self.delta, x)
            JP, JL = self._jacobians_one(e, Xc)
            if iP < self.Pa:
                sp = slice(6 * iP, 6 * iP + 6)
                H[sp, sp] += w * JP.T @ JP
                b[sp] += w * JP.T @ r
            if iL < self.La:
                sl = slice(6 * self.Pa + 3 * iL, 6 * self.Pa + 3 * iL + 3)
                H[sl, sl] += w * JL.T @ JL
                b[sl] += w * JL.T @ r
            if iP < self.Pa and iL < self.La:
                sp = slice(6 * iP, 6 * iP + 6)
                sl = slice(6 * self.Pa + 3 * iL, 6 * self.Pa + 3 * iL + 3)
                blk = w * JP.T @ JL
                H[sp, sl] += blk
                H[sl, sp] += blk.T
        return H, b

    def apply_update(self, x):
        for p in range(self.Pa):
            R, dt = se3_exp(x[6 * p : 6 * p + 6])
            dq = rotmat_to_quat(R)
            self.t[p] = dt + quat_rotate(dq, self.t[p])
            qn = quat_mul(dq, self.q[p])
            n = np.linalg.norm(qn)
            if qn[3] < 0:
                n = -n
            self.q[p] = qn / n
        for l in range(self.La):
            self.Xw[l] += x[6 * self.Pa + 3 * l : 6 * self.Pa + 3 * l + 3]

    def optimize(self, niterations, maxq=10, tau=1e-5):
        nu = 2.0
        lam = 0.0
        for it in range(niterations):
            F = self.compute_chi()
            H, b = self.build_dense_system()
            if it == 0:
                lam = tau * np.max(np.diag(H))
            q_cnt = 0
            rho = -1.0
            while q_cnt < maxq and rho < 0:
                q_bak, t_bak, X_bak = self.q.copy(), self.t.copy(), self.Xw.copy()
                Hd = H + lam * np.eye(H.shape[0])
                try:
                    x = np.linalg.solve(Hd, b)
                    success = np.all(np.isfinite(x))
                except np.linalg.LinAlgError:
                    x, success = np.zeros_like(b), False
                if success:
                    self.apply_update(x)
                Fhat = self.compute_chi()
                scale = float(x @ (lam * x + b)) + 1e-3
                Fdiff = Fhat - F
                rho = (F - Fhat) / scale if success else -1.0
                if rho > 0:
                    att = 1 - (2 * rho - 1) ** 3
                    lam *= min(max(att, 1 / 3), 2 / 3)
                    nu = 2.0
                    F = Fhat
                    break
                else:
                    self.q, self.t, self.Xw = q_bak, t_bak, X_bak
                    lam *= nu
                    nu *= 2
                    if not np.isfinite(lam) or Fdiff < 1e-4:
                        break
                    q_cnt += 1
            self.chi_trace.append(F)
            if q_cnt == maxq or rho < 1e-6 or not np.isfinite(lam):
                break
        return self.chi_trace
