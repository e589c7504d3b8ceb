"""The simulated EuRoC-family world: trajectories, scene and sensor rig.

Frozen from uav_airvision_tpu_torch/simulation/world.py at commit efd1109
(``Trajectory6DoF``, ``EUROC_MOTION_PRESETS``, ``make_texture`` without
OpenCV, ``StereoWorld``'s layered scene, ``_pixel_rays``), vectorised over
time and changed where the benchmark needs it:

- ``OffsetTrajectory`` flies a preset's motion from ``offset`` seconds in:
  at rest for the ``t0`` lead-in (the IMU's gravity and bias
  initialisation), then onto the motion through a C2 time ramp, so velocity
  and acceleration stay continuous.  Its rotation is the preset's relative
  to the rotation at the offset, so every instance starts level at the
  origin with the preset's body rates.
- the texture is always the OpenCV-free one (nearest-neighbour octaves),
  drawn from a ``torch.Generator`` seeded by the caller.

Everything here is host numpy except ``make_texture``; the renderer is
``gen/render.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: Difficulty presets approximating the EuRoC families (easy ~ MH_01,
#: difficult ~ V2_03): translation and rotation amplitude scales.
EUROC_MOTION_PRESETS = {
    "easy": dict(scale=0.7, rot_scale=0.5),
    "medium": dict(scale=1.0, rot_scale=1.0),
    "difficult": dict(scale=1.5, rot_scale=2.3),
}

GRAVITY = 9.81
GYRO_BIAS = np.array([2e-3, -1e-3, 5e-4])
IMU_NOISE = 1e-3
DIFF_H = 1e-4  # central-difference step (s), as the source's


def _rot(r, p, y):
    """R = Rz(y) Ry(p) Rx(r) for arrays of angles: (..., 3, 3)."""
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    R = np.empty(np.shape(r) + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


@dataclass
class OffsetTrajectory:
    """A preset's 6-DoF motion (``Trajectory6DoF``'s harmonics) flown from
    ``offset`` s in, after ``t0`` s at rest and a ``ramp`` s C2 time ramp."""

    preset: str
    offset: float
    t0: float = 1.5
    ramp: float = 1.0

    def __post_init__(self):
        p = EUROC_MOTION_PRESETS[self.preset]
        self.amp = np.array([1.2, 0.8, 0.45]) * p["scale"]
        self.om = np.array([0.9, 1.3, 1.7])
        self.ang_amp = np.array([0.25, 0.2, 0.5]) * p["rot_scale"]
        self.ang_om = np.array([2.1, 2.7, 1.6])
        self.R0T = np.swapaxes(self._R_base(np.array(self.offset)), -1, -2)
        self.p0 = self._pos_base(np.array(self.offset))

    def _u(self, t):
        """The preset's time at trajectory time t (arrays)."""
        tau = np.maximum(np.asarray(t, np.float64) - self.t0, 0.0)
        x = tau / self.ramp
        ramped = self.ramp * (x ** 3 - 0.5 * x ** 4)
        return self.offset + np.where(x <= 1.0, ramped, 0.5 * self.ramp + (tau - self.ramp))

    def _pos_base(self, u):
        u = np.asarray(u)[..., None]
        return self.amp * (1.0 - np.cos(self.om * u)) + 0.25 * self.amp * (
            1.0 - np.cos(2.3 * self.om * u))

    def _R_base(self, u):
        a = self.ang_amp * (1.0 - np.cos(self.ang_om * np.asarray(u)[..., None]))
        return _rot(a[..., 0], a[..., 1], a[..., 2])

    def pos(self, t):
        """(..., 3) world position."""
        return self._pos_base(self._u(t)) - self.p0

    def R_i_w(self, t):
        """(..., 3, 3) IMU -> world rotation."""
        return self.R0T @ self._R_base(self._u(t))

    def acc(self, t):
        """(..., 3) world acceleration, central differences of ``pos``."""
        t = np.asarray(t, np.float64)
        h = DIFF_H
        a = (self.pos(t + h) - 2.0 * self.pos(t) + self.pos(t - h)) / (h * h)
        return np.where((t < self.t0)[..., None], 0.0, a)

    def omega_body(self, t):
        """(..., 3) body angular rate, from the skew part of R^T dR/dt."""
        t = np.asarray(t, np.float64)
        h = DIFF_H
        R = self.R_i_w(t)
        dR = (self.R_i_w(t + h) - self.R_i_w(t - h)) / (2 * h)
        W = np.swapaxes(R, -1, -2) @ dR
        W = 0.5 * (W - np.swapaxes(W, -1, -2))
        w = np.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
        return np.where((t < self.t0)[..., None], 0.0, w)


def imu_stream(traj: OffsetTrajectory, duration: float, rng: np.random.Generator, rate=200):
    """(t, gyro, accel) of a 200 Hz IMU with the source's bias and noise:
    ``w = omega + bg + n``, ``a = R^T (acc - g_w) + n``."""
    n = int(round(duration * rate))
    ts = np.arange(n) / rate
    R = traj.R_i_w(ts)
    g_w = np.array([0.0, 0.0, -GRAVITY])
    w = traj.omega_body(ts) + GYRO_BIAS + rng.normal(0, IMU_NOISE, (n, 3))
    a = np.einsum("nji,nj->ni", R, traj.acc(ts) - g_w) + rng.normal(0, IMU_NOISE, (n, 3))
    return ts, w, a


def make_texture(gen: torch.Generator, device, size=1536, octaves=4):
    """Multi-octave random texture (the source's OpenCV-free path), float32
    holding uint8 values, (size, size) on ``device``."""
    tex = torch.zeros((size, size), dtype=torch.float64, device=device)
    for o in range(octaves):
        n = max(size >> (octaves + 1 - o), 4)
        layer = torch.rand((n, n), generator=gen, dtype=torch.float64, device=device) * 2 - 1
        reps = -(-size // n)
        layer = layer.repeat_interleave(reps, 0).repeat_interleave(reps, 1)[:size, :size]
        tex += layer / (o + 1)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    return (tex * 255).to(torch.uint8).to(torch.float32)


#: The layered scene (``StereoWorld(scene="layered")``, plane_z = 6): per plane
#: (z, (xmin, xmax, ymin, ymax) or None for the backdrop, texture offset).
PLANE_Z = 6.0
PLANES = [(PLANE_Z, None, 0.0),
          (PLANE_Z * 0.7, (0.4, 4.8, -0.8, 3.6), 0.63),
          (PLANE_Z * 0.42, (-1.5, 1.8, -2.2, 1.2), 0.31)]
TEX_SCALE = 12.0  # metres the whole texture covers


def pixel_rays(W, H, intr, coeffs):
    """Undistorted normalised ray (x, y, 1) of each pixel under the radtan
    model, (H, W, 3) float64 (8 fixed-point iterations)."""
    fx, fy, cx, cy = intr
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = (u - cx) / fx
    y = (v - cy) / fy
    k1, k2, p1, p2 = coeffs
    x0, y0 = x.copy(), y.copy()
    for _ in range(8):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return np.stack([x, y, np.ones_like(x)], axis=-1)


class Rig:
    """The stereo rig of a configuration's calibration block: each camera's
    rays and its camera -> IMU extrinsics."""

    def __init__(self, calib: dict):
        self.W, self.H = calib["cam0_resolution"]
        self.rays, self.R_c_i, self.t_c_i = {}, {}, {}
        for cam in ("cam0", "cam1"):
            if calib[f"{cam}_distortion_model"] != "radtan":
                raise ValueError("the benchmark's world renders the radtan model only")
            self.rays[cam] = pixel_rays(self.W, self.H, calib[f"{cam}_intrinsics"],
                                        calib[f"{cam}_distortion_coeffs"])
            T = np.linalg.inv(np.asarray(calib[f"T_imu_{cam}"], np.float64))  # cam -> imu
            self.R_c_i[cam], self.t_c_i[cam] = T[:3, :3], T[:3, 3]

    def camera_poses(self, traj: OffsetTrajectory, ts):
        """{cam: (R_c_w (T, 3, 3), t_c_w (T, 3))} at times ``ts``."""
        R_i_w, p = traj.R_i_w(ts), traj.pos(ts)
        return {cam: (R_i_w @ self.R_c_i[cam], R_i_w @ self.t_c_i[cam] + p)
                for cam in ("cam0", "cam1")}
