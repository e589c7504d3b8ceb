"""Reference-shaped facade classes (drop-in public API) over the port's steps.

Port of uav_airvision_tpu/compat.py.  The reference exposes
``ImageProcessor`` (with the ``stareo_callback`` typo alias) and ``MSCKF``
as callback-style classes; these run the port's ``frontend_step`` and
``backend_step`` on the card (or on the CPU when asked):

    ip = ImageProcessor(config)
    ip.imu_callback(imu_msg)
    feature_msg = ip.stereo_callback(stereo_msg)

    filt = MSCKF(config)
    filt.imu_callback(imu_msg)
    result = filt.feature_callback(feature_msg)

Host-side buffering is the JAX facade's: gravity and bias initialise after
``imu_init_msgs`` IMU messages (reference msckf.py:162-174), the front-end
rotation prediction averages the window [prev - 0.01, curr - 0.004) with
the reference's buffer truncation (imu_processor.py:28-67), and the
estimator consumes the IMU messages up to each frame's time.  Each callback
reads its result back to the host once (the messages are host objects).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .config import Config
from .device import get_device, to_host
from .models.frontend.params import make_frontend_params
from .models.frontend.pipeline import frontend_step, init_frontend_state
from .models.msckf.state import init_state, make_params, reset_cov
from .models.msckf.step import FrameInput, backend_step

# message structs (reference feature_measurment.py / feature_publisher.py)
FeatureMeasurement = namedtuple("FeatureMeasurement", ["id", "u0", "v0", "u1", "v1"])
feature_msg = namedtuple("feature_msg", ["timestamp", "features"])
vio_result = namedtuple("vio_result", ["timestamp", "position", "orientation",
                                       "velocity"])


class ImageProcessor:
    """Front-end facade (reference ImageProcessingPipeline/ImageProcessor)."""

    def __init__(self, config: Config, device="cuda"):
        self.config = config
        self.device = get_device(device)
        self.params = make_frontend_params(config, self.device)
        self.state = init_frontend_state(config, self.device)
        self.imu_buffer = []
        self._ptr_t = -np.inf
        self.prev_t = None
        self.num_features = {}
        self._last_stereo = None  # (cam0_img, cam1_img) for draw_features_stereo

    def imu_callback(self, msg):
        self.imu_buffer.append((msg.timestamp, np.asarray(msg.angular_velocity)))

    def _mean_angular_velocity(self, curr_t):
        """Reference integrate_imu_data window [prev-0.01, curr-0.004)
        (imu_processor.py:28-67) with its buffer truncation."""
        if self.prev_t is None:
            return np.zeros(3), 0.0
        lo, hi = self.prev_t - 0.01, curr_t - 0.004
        window = [m for m in self.imu_buffer if self._ptr_t <= m[0] and lo <= m[0] < hi]
        if not any(m[0] >= hi for m in self.imu_buffer if m[0] >= self._ptr_t):
            return np.zeros(3), curr_t - self.prev_t
        mean = np.mean(np.stack([m[1] for m in window]), axis=0) if window else np.zeros(3)
        self._ptr_t = hi
        # the reference truncates its buffer at the consumed pointer
        # (imu_processor.py:66); prefix deletion, so that an IMU thread
        # appending concurrently only touches the end of the list
        k = 0
        for m in self.imu_buffer:
            if m[0] >= hi:
                break
            k += 1
        if k:
            del self.imu_buffer[:k]
        return mean, curr_t - self.prev_t

    def stereo_callback(self, stereo_msg):
        t = stereo_msg.timestamp
        c0, c1 = np.asarray(stereo_msg.cam0_image), np.asarray(stereo_msg.cam1_image)
        self._last_stereo = (c0, c1)
        mean_w, dt = self._mean_angular_velocity(t)
        dev = self.device
        self.state, out = frontend_step(
            self.state, torch.as_tensor(c0, device=dev), torch.as_tensor(c1, device=dev),
            torch.as_tensor(mean_w, dtype=torch.float32, device=dev),
            torch.as_tensor(dt, dtype=torch.float32, device=dev), self.params, self.config)
        self.prev_t = t
        F = out.ids.shape[0]
        host = to_host(torch.cat([
            torch.stack([out.before_tracking, out.after_tracking, out.after_matching,
                         out.after_ransac]).to(torch.float64),
            out.ids.to(torch.float64), out.mask.to(torch.float64),
            out.uv.to(torch.float64).reshape(-1)]))
        counts, ids, mask = host[:4], host[4:4 + F], host[4 + F:4 + 2 * F]
        uv = np.asarray(host[4 + 2 * F:]).reshape(F, 4)
        self.num_features = dict(zip(("before_tracking", "after_tracking", "after_matching",
                                      "after_ransac"), (int(c) for c in counts)))
        feats = [FeatureMeasurement(int(ids[i]), float(uv[i, 0]), float(uv[i, 1]),
                                    float(uv[i, 2]), float(uv[i, 3]))
                 for i in range(F) if mask[i]]
        return feature_msg(t, feats)

    # the reference's legacy typo alias (reference __init__.py:27)
    stareo_callback = stereo_callback

    def draw_features_stereo(self, show=True):
        """Debug overlay: current features drawn as matches on the stereo
        pair (reference FeaturePublisher.draw_features_stereo,
        feature_publisher.py:123-137).  Returns the composed image; ``show``
        additionally pops the reference's cv2.imshow window (skipped on
        headless machines).  Needs OpenCV."""
        try:
            import cv2
        except ImportError:
            raise RuntimeError("draw_features_stereo needs OpenCV (cv2), which is not "
                               "installed") from None
        if self._last_stereo is None:
            return None
        img0, img1 = self._last_stereo
        cam0 = self.state.cam0.cpu().numpy()
        cam1 = self.state.cam1.cpu().numpy()
        vmask = self.state.valid.cpu().numpy()
        kps0, kps1, matches = [], [], []
        for i in np.nonzero(vmask)[0]:
            matches.append(cv2.DMatch(len(kps0), len(kps0), 0))
            kps0.append(cv2.KeyPoint(float(cam0[i, 0]), float(cam0[i, 1]), 1))
            kps1.append(cv2.KeyPoint(float(cam1[i, 0]), float(cam1[i, 1]), 1))
        img = cv2.drawMatches(img0, kps0, img1, kps1, matches, None, flags=2)
        if show:
            try:
                cv2.imshow("stereo features", img)
                cv2.waitKey(1)
            except cv2.error:
                pass  # headless build / no display
        return img


class MSCKF:
    """Estimator facade (reference MSCKF, src/msckf.py:96-228)."""

    def __init__(self, config: Config, device="cuda"):
        self.config = config
        self.device = get_device(device)
        self.params = make_params(config, self.device)
        self.state = None
        self.imu_buffer = []
        self.is_gravity_set = False
        self.time_base = None  # float32-device time rebase (see prebatch.py)
        self._started = False  # a frame was processed since the initialisation
        self._kept_extrinsics = None  # (R_imu_cam0, t_cam0_imu, sid) after reset()

    def imu_callback(self, msg):
        """Buffer; initialize gravity/bias after imu_init_msgs messages
        (reference msckf.py:162-174, initialize_gravity_and_bias :230-249)."""
        self.imu_buffer.append((msg.timestamp, np.asarray(msg.angular_velocity),
                                np.asarray(msg.linear_acceleration)))
        n = self.config.capacity.imu_init_msgs
        if not self.is_gravity_set and len(self.imu_buffer) >= n:
            gyro_bias = np.mean(np.stack([m[1] for m in self.imu_buffer[:n]]), axis=0)
            acc_mean = np.mean(np.stack([m[2] for m in self.imu_buffer[:n]]), axis=0)
            self.state = init_state(self.config, self.params, gyro_bias, acc_mean)
            if self._kept_extrinsics is not None:
                # reference reset() preserves the learned extrinsics and the
                # state id across the re-initialization (msckf.py:803-807)
                R, t, sid = self._kept_extrinsics
                imu = self.state.imu._replace(R_imu_cam0=R, t_cam0_imu=t, sid=sid)
                self.state = self.state._replace(imu=imu)
            self.is_gravity_set = True
            self._started = False

    def _imu_slice(self, frame_t, first):
        I = self.config.capacity.max_imu_per_frame
        if first:
            self.imu_buffer = [m for m in self.imu_buffer if m[0] >= frame_t]
        out = (np.zeros(I), np.zeros((I, 3)), np.zeros((I, 3)), np.zeros(I, bool))
        consumed = j = 0
        for (t, w, a) in self.imu_buffer:
            if t > frame_t:
                break
            consumed += 1
            if j < I:
                out[0][j], out[1][j], out[2][j], out[3][j] = t, w, a, True
                j += 1
        self.imu_buffer = self.imu_buffer[consumed:]
        return out

    def feature_callback(self, msg):
        """One frame of features -> state update -> vio_result (reference
        feature_callback, msckf.py:177-228)."""
        if not self.is_gravity_set:
            return None
        t = msg.timestamp
        if self.time_base is None:
            self.time_base = t
        imu_t, imu_w, imu_a, imu_m = self._imu_slice(t, not self._started)
        imu_t = np.where(imu_m, imu_t - self.time_base, 0.0)
        K = self.config.capacity.max_features
        ids = np.full(K, -1, np.int32)
        uv = np.zeros((K, 4))
        fm = np.zeros(K, bool)
        for j, f in enumerate(msg.features[:K]):
            ids[j] = f.id
            uv[j] = (f.u0, f.v0, f.u1, f.v1)
            fm[j] = True
        dtype, dev = self.state.cov.dtype, self.device

        def put(x, dt=dtype):
            return torch.as_tensor(x, dtype=dt, device=dev)

        frame = FrameInput(
            timestamp=put(t - self.time_base), imu_t=put(imu_t), imu_w=put(imu_w),
            imu_a=put(imu_a), imu_mask=put(imu_m, torch.bool), feat_ids=put(ids, torch.int32),
            feat_uv=put(uv), feat_mask=put(fm, torch.bool), active=True)
        self.state, out = backend_step(self.state, frame, self.params, self.config)
        self._started = True
        v = to_host(torch.cat([out.timestamp.reshape(1), out.p, out.q, out.v]).to(torch.float64))
        return vio_result(self.time_base + v[0], np.asarray(v[1:4]), np.asarray(v[4:8]),
                          np.asarray(v[8:11]))

    def reset(self):
        """Full reset (reference reset, msckf.py:800-819, present in the
        reference API, uncalled): keeps the LEARNED IMU-cam0 extrinsics and
        the state id, clears camera window / map / IMU buffer, re-arms
        gravity initialization."""
        if self.state is not None:
            imu = self.state.imu
            self._kept_extrinsics = (imu.R_imu_cam0.clone(), imu.t_cam0_imu.clone(),
                                     imu.sid.clone())
        self.state = None
        self.imu_buffer = []
        self.is_gravity_set = False
        self.time_base = None

    def reset_state_cov(self):
        """Re-initialize only the covariance (reference reset_state_cov,
        msckf.py:788-798)."""
        if self.state is not None:
            self.state = self.state._replace(
                cov=reset_cov(self.config, self.params, self.state.cov.dtype))
