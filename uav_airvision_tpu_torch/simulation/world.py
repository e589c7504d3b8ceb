"""The PyTorch port's own copy of uav_airvision_tpu/simulation/world.py: same names, same
behaviour (tests/test_torch_standalone.py holds the two equal).

Synthetic stereo-VIO world: analytic trajectory + textured-plane renderer.

Generates a fully consistent sensor stream (stereo images with the real EuRoC
calibration incl. radtan distortion, 200 Hz IMU with biases and noise, ground
truth) so the complete pipeline can be exercised, benchmarked, and
fault-injected without the EuRoC dataset on disk.  The reference has no
equivalent; its only data path is dataset playback.

Conventions match the estimator: JPL world->IMU quaternion, gravity -z,
camera extrinsics from the config.  The scene is a textured plane placed
along the cameras' boresight (EuRoC's cam0 z-axis ~ IMU +z, which this world
keeps pointed at world +z).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclass
class Trajectory:
    """Smooth 1-cos trajectory, static for t < t0 (IMU init window)."""

    t0: float = 1.5
    amp: np.ndarray = None
    om: np.ndarray = None
    yaw_amp: float = 0.4
    yaw_om: float = 0.25

    def __post_init__(self):
        if self.amp is None:
            self.amp = np.array([1.0, 0.6, 0.3])
        if self.om is None:
            self.om = np.array([0.5, 0.4, 0.3])

    def _tau(self, t):
        return max(t - self.t0, 0.0)

    def pos(self, t):
        tau = self._tau(t)
        return self.amp * (1.0 - np.cos(self.om * tau))

    def vel(self, t):
        tau = self._tau(t)
        return self.amp * self.om * np.sin(self.om * tau)

    def acc(self, t):
        if t < self.t0:
            return np.zeros(3)
        tau = self._tau(t)
        return self.amp * self.om**2 * np.cos(self.om * tau)

    def yaw(self, t):
        return self.yaw_amp * (1.0 - np.cos(self.yaw_om * self._tau(t)))

    def yaw_rate(self, t):
        return self.yaw_amp * self.yaw_om * np.sin(self.yaw_om * self._tau(t))

    def R_i_w(self, t):
        """IMU -> world rotation."""
        return _rz(self.yaw(t))

    def omega_body(self, t):
        return self.R_i_w(t).T @ np.array([0.0, 0.0, self.yaw_rate(t)])


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclass
class Trajectory6DoF:
    """Aggressive 6-DoF trajectory: multi-harmonic translation + full
    roll/pitch/yaw excitation, static for t < t0 (IMU init window).

    Angular velocity and acceleration come from high-order central
    differences of the analytic pose (h=1e-4 s, error far below the IMU
    noise floor), so any R(t) stays consistent with its gyro stream.

    ``scale``/``rot_scale`` tune difficulty; the presets in
    EUROC_MOTION_PRESETS approximate published EuRoC peak body rates /
    accelerations (MH_01-easy ~0.5 rad/s peak, V2_03-difficult ~2.5 rad/s,
    accels 1..4 m/s^2).
    """

    t0: float = 1.5
    scale: float = 1.0
    rot_scale: float = 1.0
    amp: np.ndarray = None
    om: np.ndarray = None
    ang_amp: np.ndarray = None  # roll, pitch, yaw amplitudes (rad)
    ang_om: np.ndarray = None

    def __post_init__(self):
        if self.amp is None:
            self.amp = np.array([1.2, 0.8, 0.45]) * self.scale
        if self.om is None:
            self.om = np.array([0.9, 1.3, 1.7])
        if self.ang_amp is None:
            self.ang_amp = np.array([0.25, 0.2, 0.5]) * self.rot_scale
        if self.ang_om is None:
            self.ang_om = np.array([2.1, 2.7, 1.6])

    def _tau(self, t):
        return max(t - self.t0, 0.0)

    def pos(self, t):
        tau = self._tau(t)
        # two harmonics per axis for jerkier, EuRoC-like translation
        return self.amp * (1.0 - np.cos(self.om * tau)) + 0.25 * self.amp * (
            1.0 - np.cos(2.3 * self.om * tau)
        )

    def vel(self, t, h=1e-4):
        return (self.pos(t + h) - self.pos(t - h)) / (2 * h) if t > self.t0 else np.zeros(3)

    def acc(self, t, h=1e-4):
        if t < self.t0:
            return np.zeros(3)
        return (self.pos(t + h) - 2.0 * self.pos(t) + self.pos(t - h)) / (h * h)

    def R_i_w(self, t):
        tau = self._tau(t)
        r, p, y = self.ang_amp * (1.0 - np.cos(self.ang_om * tau))
        return _rz(y) @ _ry(p) @ _rx(r)

    def omega_body(self, t, h=1e-4):
        if t < self.t0:
            return np.zeros(3)
        R = self.R_i_w(t)
        dR = (self.R_i_w(t + h) - self.R_i_w(t - h)) / (2 * h)
        W = R.T @ dR  # body-frame [omega]_x
        W = 0.5 * (W - W.T)
        return np.array([W[2, 1], W[0, 2], W[1, 0]])


#: Difficulty presets approximating the EuRoC families (BASELINE.md rows).
EUROC_MOTION_PRESETS = {
    "easy": dict(scale=0.7, rot_scale=0.5),
    "medium": dict(scale=1.0, rot_scale=1.0),
    "difficult": dict(scale=1.5, rot_scale=2.3),
}


def make_texture(size=1536, seed=7, octaves=4):
    """Multi-octave smooth random texture, uint8."""
    try:
        import cv2
    except Exception:
        cv2 = None
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size))
    for o in range(octaves):
        n = size >> (octaves + 1 - o)
        layer = rng.uniform(-1, 1, (max(n, 4), max(n, 4)))
        if cv2 is not None:
            layer = cv2.resize(layer, (size, size), interpolation=cv2.INTER_CUBIC)
        else:
            reps = int(np.ceil(size / layer.shape[0]))
            layer = np.kron(layer, np.ones((reps, reps)))[:size, :size]
        tex += layer / (o + 1)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    return (tex * 255).astype(np.uint8)


class StereoWorld:
    """Textured plane at z=plane_z rendered through the calibrated stereo rig."""

    def __init__(self, config, plane_z=6.0, tex_scale=12.0, seed=7,
                 trajectory: Trajectory = None, scene="plane",
                 photometric=False):
        """scene="plane": single textured plane (round-1 behavior, default).
        scene="layered": three textured planes at different depths with
        depth discontinuities at their world-rectangle borders — exercises
        disparity spread and LK across occlusion boundaries.
        photometric=True adds exposure drift, vignetting, motion-scale blur
        and stronger sensor noise (EuRoC-like image degradation)."""
        self.config = config
        self.plane_z = plane_z
        self.tex = make_texture(seed=seed).astype(np.float32)
        self.tex_scale = tex_scale  # meters covered by the full texture
        self.traj = trajectory or Trajectory()
        self.photometric = photometric
        # far-to-near: the first (backdrop) plane samples unconditionally
        # (exactly the single-plane renderer), nearer finite planes overlay
        # where their intersection is valid and closer
        if scene == "layered":
            # (z, (xmin, xmax, ymin, ymax) or None for the backdrop, tex offset)
            self.planes = [
                (plane_z, None, 0.0),
                (plane_z * 0.7, (0.4, 4.8, -0.8, 3.6), 0.63),
                (plane_z * 0.42, (-1.5, 1.8, -2.2, 1.2), 0.31),
            ]
        else:
            self.planes = [(plane_z, None, 0.0)]

        w, h = config.calib.cam0_resolution
        self.W, self.H = w, h
        self._rays = {}
        for name, intr, coeffs, model in (
            ("cam0", config.calib.cam0_intrinsics,
             config.calib.cam0_distortion_coeffs,
             config.calib.cam0_distortion_model),
            ("cam1", config.calib.cam1_intrinsics,
             config.calib.cam1_distortion_coeffs,
             config.calib.cam1_distortion_model),
        ):
            self._rays[name] = self._pixel_rays(intr, coeffs, model)

        T0 = np.linalg.inv(config.np_T_imu_cam0())  # cam0 -> imu
        T1 = np.linalg.inv(config.np_T_imu_cam1())
        self.R_c0_i, self.t_c0_i = T0[:3, :3], T0[:3, 3]
        self.R_c1_i, self.t_c1_i = T1[:3, :3], T1[:3, 3]

    def _pixel_rays(self, intr, coeffs, model="radtan"):
        """Undistorted normalized ray (x, y, 1) per pixel — computed once."""
        fx, fy, cx, cy = intr
        u, v = np.meshgrid(np.arange(self.W), np.arange(self.H))
        x = (u - cx) / fx
        y = (v - cy) / fy
        if model == "equidistant":
            # invert theta_d = theta (1 + k1 th^2 + ... + k4 th^8), r = tan(th)
            k1, k2, k3, k4 = coeffs
            theta_d = np.sqrt(x * x + y * y)
            theta = theta_d.copy()
            for _ in range(8):
                t2 = theta * theta
                theta = theta_d / (1 + k1 * t2 + k2 * t2**2
                                   + k3 * t2**3 + k4 * t2**4)
            scale = np.where(theta_d > 1e-12,
                             np.tan(theta) / np.maximum(theta_d, 1e-12), 1.0)
            x, y = x * scale, y * scale
        else:
            k1, k2, p1, p2 = coeffs
            x0, y0 = x.copy(), y.copy()
            for _ in range(8):
                r2 = x * x + y * y
                icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
                dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                x = (x0 - dx) * icdist
                y = (y0 - dy) * icdist
        return np.stack([x, y, np.ones_like(x)], axis=-1).astype(np.float32)

    def _sample_tex(self, wx, wy, tex_off):
        n = self.tex.shape[0]
        fx = (wx / self.tex_scale + tex_off) * n
        fy = (wy / self.tex_scale + tex_off) * n
        ix = np.floor(fx).astype(np.int64)
        iy = np.floor(fy).astype(np.int64)
        ax = (fx - ix).astype(np.float32)
        ay = (fy - iy).astype(np.float32)
        ix %= n
        iy %= n
        ix1 = (ix + 1) % n
        iy1 = (iy + 1) % n
        tex = self.tex
        return (
            tex[iy, ix] * (1 - ax) * (1 - ay)
            + tex[iy, ix1] * ax * (1 - ay)
            + tex[iy1, ix] * (1 - ax) * ay
            + tex[iy1, ix1] * ax * ay
        )

    def _render_cam(self, rays, R_c_w, t_c_w, rng, t=0.0):
        ray_w = rays @ R_c_w.T  # (H,W,3)
        rz = ray_w[..., 2]
        rz_safe = np.where(np.abs(rz) > 1e-6, rz, 1e-6)
        # far-to-near compositing: backdrop samples unconditionally (the
        # round-1 single-plane renderer), nearer finite planes overlay where
        # their intersection is valid and closer (depth discontinuities at
        # the planes' world-rectangle borders)
        val = None
        best_s = None
        for z_k, rect, tex_off in self.planes:
            s = (z_k - t_c_w[2]) / rz_safe
            wx = t_c_w[0] + s * ray_w[..., 0]
            wy = t_c_w[1] + s * ray_w[..., 1]
            v = self._sample_tex(wx, wy, tex_off)
            if val is None:  # backdrop
                val = v
                best_s = np.where(s > 0.05, s, np.inf).astype(np.float32)
                continue
            x0, x1, y0, y1 = rect
            ok = (
                (s > 0.05) & (s < best_s)
                & (wx >= x0) & (wx <= x1) & (wy >= y0) & (wy <= y1)
            )
            val = np.where(ok, v, val)
            best_s = np.where(ok, s, best_s)
        if self.photometric:
            try:
                import cv2
            except Exception:
                cv2 = None
            gain = 1.0 + 0.22 * np.sin(0.7 * t) + 0.06 * np.sin(3.1 * t)
            val = val * gain + 8.0 * np.sin(1.3 * t)
            if not hasattr(self, "_vignette"):
                yy, xx = np.mgrid[0:self.H, 0:self.W].astype(np.float32)
                r2 = (((xx - self.W / 2) / (self.W / 2)) ** 2
                      + ((yy - self.H / 2) / (self.H / 2)) ** 2)
                self._vignette = 1.0 - 0.25 * r2
            val = val * self._vignette
            if cv2 is not None:
                val = cv2.GaussianBlur(val.astype(np.float32), (0, 0), 0.8)
            val = val + rng.normal(0, 2.5, val.shape)
        else:
            val = val + rng.normal(0, 1.0, val.shape)
        return np.clip(val, 0, 255).astype(np.uint8)

    def render_frame(self, t, rng=None, starve_window=None):
        """Render the stereo pair at trajectory time t.

        starve_window: optional (t0, t1) fault-injection interval during
        which the scene is textureless (uniform gray + sensor noise) —
        starves FAST of corners to exercise feature-loss recovery paths
        (gap called out in SURVEY.md section 5: the reference has no fault
        injection)."""
        rng = rng or np.random.default_rng(int(t * 1e6) & 0xFFFFFF)
        if starve_window is not None and starve_window[0] <= t < starve_window[1]:
            flat0 = np.clip(128.0 + rng.normal(0, 1.0, (self.H, self.W)), 0, 255)
            flat1 = np.clip(128.0 + rng.normal(0, 1.0, (self.H, self.W)), 0, 255)
            return flat0.astype(np.uint8), flat1.astype(np.uint8)
        R_i_w = self.traj.R_i_w(t)
        p = self.traj.pos(t)
        # cam -> world pose
        R0 = R_i_w @ self.R_c0_i
        t0 = R_i_w @ self.t_c0_i + p
        R1 = R_i_w @ self.R_c1_i
        t1 = R_i_w @ self.t_c1_i + p
        img0 = self._render_cam(self._rays["cam0"], R0, t0, rng, t)
        img1 = self._render_cam(self._rays["cam1"], R1, t1, rng, t)
        return img0, img1

    def imu_stream(self, duration, rate=200, gyro_bias=(2e-3, -1e-3, 5e-4),
                   noise=1e-3, seed=0, g=9.81, dropout_window=None):
        """IMU samples; dropout_window=(t0, t1) optionally removes every
        sample in that interval (sensor-outage fault injection)."""
        rng = np.random.default_rng(seed)
        g_w = np.array([0.0, 0.0, -g])
        bg = np.asarray(gyro_bias)
        n = int(duration * rate)
        ts = np.arange(n) / rate
        w = np.zeros((n, 3))
        a = np.zeros((n, 3))
        for i, t in enumerate(ts):
            R_wi = self.traj.R_i_w(t).T
            w[i] = self.traj.omega_body(t) + bg + rng.normal(0, noise, 3)
            a[i] = R_wi @ (self.traj.acc(t) - g_w) + rng.normal(0, noise, 3)
        if dropout_window is not None:
            keep = (ts < dropout_window[0]) | (ts >= dropout_window[1])
            ts, w, a = ts[keep], w[keep], a[keep]
        return ts, w, a

    def frame_times(self, duration, fps=20):
        n = int(duration * fps)
        return np.arange(n) / fps

    def groundtruth(self, ts):
        return np.stack([self.traj.pos(t) for t in ts])
