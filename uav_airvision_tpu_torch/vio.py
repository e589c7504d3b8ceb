"""Streaming VIO orchestrator: the online entry point.

Port of uav_airvision_tpu/vio.py, API-compatible with the reference
orchestrator (``VIO(config, img_queue, imu_queue, viewer).start()``).  Three
threads: the IMU thread only buffers messages on the host; the image thread
assembles one frame per stereo message (the front-end's rotation window and
the back-end's propagation window of IMU samples), uploads it and runs the
same ``vio_step`` the batch runner runs, eagerly; the publish thread reads
each frame's ``StepOutput`` back on the host (one read per frame) and
publishes it (trajectory file, ``results``, viewer), so frame k's read
overlaps the launches of frame k+1.  Gravity and gyro bias initialise from
the first ``imu_init_msgs`` IMU messages, as in the reference.

The JAX package packs each frame into two transfers and donates its state
buffers, both answers to its remote device; here tensors are uploaded field
by field and the state is a tree of immutable tensors.
"""

from __future__ import annotations

from collections import namedtuple
from queue import Queue
from threading import Thread

import numpy as np
import torch

from .config import Config
from .device import get_device
from .models.frontend.params import make_frontend_params
from .models.frontend.pipeline import init_frontend_state
from .models.msckf.state import init_state, make_params
from .models.vio import VioFrame, VioState, vio_step
from .utils.trajectory import TrajectoryWriter
from .utils.transforms import Isometry

vio_result = namedtuple("vio_result", ["timestamp", "pose", "velocity", "cam0_pose"])

# StepOutput fields the publish path reads, flattened in this order into one
# vector: [timestamp, active, q(4), p(3), v(3), R_imu_cam0(9), t_cam0_imu(3)]
PUBLISH_FIELDS = ("timestamp", "active", "q", "p", "v", "R_imu_cam0", "t_cam0_imu")


class VIO:
    def __init__(self, config: Config, img_queue: Queue, imu_queue: Queue, viewer=None,
                 trajectory_writer: TrajectoryWriter = None, device="cuda"):
        self.config = config
        self.viewer = viewer
        self.img_queue = img_queue
        self.imu_queue = imu_queue
        self.writer = trajectory_writer or TrajectoryWriter()
        self.device = get_device(device)

        self.fparams = make_frontend_params(config, self.device)
        self.mparams = make_params(config, self.device)
        self.vio_state = VioState(
            frontend=init_frontend_state(config, self.device),
            filter=init_state(config, self.mparams, np.zeros(3), np.asarray([0.0, 0.0, 9.81])))
        self.time_base = None  # float32-device time rebase (see streaming/prebatch.py)
        self.imu_buffer = []  # (t, w, a)
        self.fe_ptr_t = -np.inf  # front-end window truncation point
        self._be_ptr_t = -np.inf  # back-end consumption pointer
        self._started = False  # first active frame processed
        self.prev_img_t = None
        self.is_gravity_set = False
        self.gyro_bias = None
        self.acc_mean = None
        self.results = []
        self.publish_reads = 0  # device-to-host reads of the publish thread
        self._errors = []  # exceptions that ended a thread; join() raises the first

        self.img_thread = Thread(target=self._process_img, daemon=True)
        self.imu_thread = Thread(target=self._process_imu, daemon=True)
        self._publish_queue = Queue(maxsize=64)
        self.publish_thread = Thread(target=self._publish_loop, daemon=True)

    def start(self):
        self.imu_thread.start()
        self.img_thread.start()
        self.publish_thread.start()

    def join(self):
        """Wait for the image and publish threads (they end at the image
        queue's ``None``); raise what ended any thread early."""
        self.img_thread.join()
        self.publish_thread.join()
        if self._errors:
            raise RuntimeError("the VIO stopped on an error in one of its threads") \
                from self._errors[0]

    def warmup(self):
        """One dummy inactive frame through the step on a throwaway state, so
        the kernels are built and loaded before the clock starts."""
        cap = self.config.capacity
        w, h = self.config.calib.cam0_resolution
        frame = self._frame(0.0, np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8),
                            np.zeros(cap.max_imu_per_frame), np.zeros((cap.max_imu_per_frame, 3)),
                            np.zeros((cap.max_imu_per_frame, 3)),
                            np.zeros(cap.max_imu_per_frame, bool), np.zeros(3), 0.0, False)
        _, out = vio_step(self.vio_state, frame, self.fparams, self.mparams, self.config, False)
        self._read(out)

    # ------------------------------------------------------------------
    def process_imu_msg(self, msg):
        """Buffer one IMU message (thread-agnostic; the imu thread calls
        this, and tests may call it synchronously)."""
        self.imu_buffer.append((msg.timestamp, np.asarray(msg.angular_velocity),
                                np.asarray(msg.linear_acceleration)))
        n = self.config.capacity.imu_init_msgs
        if not self.is_gravity_set and len(self.imu_buffer) >= n:
            self.gyro_bias = np.stack([m[1] for m in self.imu_buffer[:n]]).mean(axis=0)
            self.acc_mean = np.stack([m[2] for m in self.imu_buffer[:n]]).mean(axis=0)
            # the img thread owns vio_state; it swaps the filter in before
            # the first active frame
            self.is_gravity_set = True

    def _process_imu(self):
        try:
            while True:
                msg = self.imu_queue.get()
                if msg is None:
                    break
                self.process_imu_msg(msg)
        except Exception as e:  # thread boundary: join() reports it
            self._errors.append(e)

    def _frontend_window(self, curr_t):
        """Mean angular velocity over [prev_t - 0.01, curr_t - 0.004) with the
        reference's buffer-truncation semantics."""
        if self.prev_img_t is None:
            return np.zeros(3), 0.0
        lo = self.prev_img_t - 0.01
        hi = curr_t - 0.004
        window = [m for m in self.imu_buffer if self.fe_ptr_t <= m[0] and lo <= m[0] < hi]
        if not any(m[0] >= hi for m in self.imu_buffer if m[0] >= self.fe_ptr_t):
            return np.zeros(3), curr_t - self.prev_img_t
        mean = np.mean(np.stack([m[1] for m in window]), axis=0) if window else np.zeros(3)
        self.fe_ptr_t = hi
        # the buffer is truncated by _backend_imu_slice once the filter
        # starts; trimming here would race the gravity-init read
        return mean, curr_t - self.prev_img_t

    def _backend_imu_slice(self, frame_t):
        """Messages in (last consumed, frame_t] for the propagation window.

        Consumption is tracked by pointer (``_be_ptr_t``) and the buffer
        keeps an 11 ms tail past the consumed point: the NEXT frame's
        front-end rotation window starts at frame_t - 0.01 and must still
        see those messages."""
        I = self.config.capacity.max_imu_per_frame
        out_t = np.zeros(I)
        out_w = np.zeros((I, 3))
        out_a = np.zeros((I, 3))
        out_m = np.zeros(I, bool)
        j = 0
        for (t, w, a) in self.imu_buffer:
            if t > frame_t:
                break
            if t > self._be_ptr_t and j < I:
                out_t[j], out_w[j], out_a[j], out_m[j] = t, w, a, True
                j += 1
        self._be_ptr_t = frame_t
        self._drop_imu_prefix(lambda t: t <= frame_t - 0.011)
        return out_t, out_w, out_a, out_m

    def _drop_imu_prefix(self, old):
        """Delete the leading messages whose timestamp satisfies ``old``.
        Prefix deletion, not a rebuild: the imu thread appends to the END of
        the list concurrently, and ``del buf[:k]`` only touches the prefix."""
        k = 0
        for (t, _, _) in self.imu_buffer:
            if not old(t):
                break
            k += 1
        if k:
            del self.imu_buffer[:k]

    def _process_img(self):
        try:
            while True:
                msg = self.img_queue.get()
                if msg is None:
                    break
                self.process_stereo_msg(msg)
        except Exception as e:  # thread boundary: join() reports it
            self._errors.append(e)
        finally:
            # unblock join() and the publish thread even if the step raised
            self._publish_queue.put(None)

    def _frame(self, t, cam0, cam1, imu_t, imu_w, imu_a, imu_m, mean_w, dt, active) -> VioFrame:
        dev = self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

        return VioFrame(
            timestamp=f32(t), cam0=torch.as_tensor(np.ascontiguousarray(cam0)).to(dev),
            cam1=torch.as_tensor(np.ascontiguousarray(cam1)).to(dev), imu_t=f32(imu_t),
            imu_w=f32(imu_w), imu_a=f32(imu_a), imu_mask=torch.as_tensor(imu_m).to(dev),
            fe_mean_w=f32(mean_w), fe_dt=f32(dt), active=torch.as_tensor(bool(active)).to(dev))

    def process_stereo_msg(self, msg):
        """One stereo frame through the device step (thread-agnostic; the img
        thread calls this, tests may call it synchronously)."""
        if self.viewer is not None:
            self.viewer.update_image(msg.cam0_image)
        t = msg.timestamp
        mean_w, dt = self._frontend_window(t)

        active = self.is_gravity_set
        if active and not self._started:
            # gravity just initialized: swap in the measured-bias filter
            # state and discard IMU messages before the first frame (the
            # reference's clock anchoring)
            self.vio_state = VioState(
                frontend=self.vio_state.frontend,
                filter=init_state(self.config, self.mparams, self.gyro_bias, self.acc_mean))
            self._drop_imu_prefix(lambda mt: mt < t)
            self._started = True
        I = self.config.capacity.max_imu_per_frame
        if active:
            imu_t, imu_w, imu_a, imu_m = self._backend_imu_slice(t)
        else:
            imu_t, imu_w, imu_a, imu_m = (np.zeros(I), np.zeros((I, 3)), np.zeros((I, 3)),
                                          np.zeros(I, bool))
        if self.time_base is None:
            self.time_base = t
        base = self.time_base
        frame = self._frame(t - base, msg.cam0_image, msg.cam1_image,
                            np.where(imu_m, imu_t - base, 0.0), imu_w, imu_a, imu_m, mean_w, dt,
                            active)
        # launches only (the step's own branch reads aside); the publish
        # thread reads the output while the next frame is assembled
        self.vio_state, out = vio_step(self.vio_state, frame, self.fparams, self.mparams,
                                       self.config, active)
        self.prev_img_t = t
        if active:
            self._publish_queue.put(out)

    def _publish_loop(self):
        """Drain device outputs: one host read per frame, then trajectory
        write, ``results`` and the viewer."""
        try:
            while True:
                out = self._publish_queue.get()
                if out is None:
                    break
                result = self._publish(self._read(out))
                if result is not None and self.viewer is not None:
                    self.viewer.update_pose(result.cam0_pose)
        except Exception as e:  # thread boundary: join() reports it
            self._errors.append(e)
            while self._publish_queue.get() is not None:  # keep the img thread unblocked
                pass

    def _read(self, out) -> np.ndarray:
        """The publish fields of a StepOutput as one float64 host vector: one
        device-to-host read."""
        flat = torch.cat([getattr(out, f).reshape(-1).to(torch.float64)
                          for f in PUBLISH_FIELDS])
        self.publish_reads += 1
        return flat.cpu().numpy()

    def _publish(self, o):
        # o: the host vector of _read; pure NumPy from here, no device work
        # on the publish path
        if o[1] < 0.5:  # active flag
            return None
        q = o[2:6]
        p = o[6:9]
        v = o[9:12]
        t_abs = (self.time_base or 0.0) + float(o[0])
        self.writer.append(t_abs, p, q)

        R_w_i = _np_quat_to_rotation(q)
        Tib = self.config.np_T_imu_body()
        T_i_w = (R_w_i.T, p)
        # body pose: T_imu_body * T_i_w * T_imu_body^-1 (reference publish)
        Rb, tb = Tib[:3, :3], Tib[:3, 3]
        R_b_w = Rb @ T_i_w[0] @ Rb.T
        t_b_w = Rb @ (T_i_w[1] - T_i_w[0] @ Rb.T @ tb) + tb
        body_pose = Isometry(R_b_w, t_b_w)
        body_velocity = Rb @ v

        R_w_c = o[12:21].reshape(3, 3) @ R_w_i
        t_c_w = p + R_w_i.T @ o[21:24]
        cam0_pose = Isometry(R_w_c.T, t_c_w)
        result = vio_result(t_abs, body_pose, body_velocity, cam0_pose)
        self.results.append(result)
        return result


def _np_quat_to_rotation(q):
    """JPL quaternion [x y z w] -> rotation matrix, NumPy (mirrors
    utils.quaternion.to_rotation, including its normalization: a filter
    quaternion can drift off unit norm)."""
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
    ])
