"""Host-side IMU prebatching: sensor streams -> fixed-shape per-frame arrays.

Frozen copy of ``prebatch_imu`` and ``PrebatchedSequence`` from
uav_airvision_tpu_torch/streaming/prebatch.py at commit efd1109, unchanged:
the estimator's IMU windows (prev frame, frame] with the first-processed-frame
discard, the front-end's rotation-prediction window with the buffer
truncation, and gravity/bias initialisation from the first 200 IMU messages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PrebatchedSequence:
    # All times are REBASED to time_base (the first frame's absolute stamp):
    # the device computes with float32, whose resolution at EuRoC's absolute
    # epoch stamps (~1.4e9 s) is about two minutes — rebasing keeps per-frame
    # dt exact.  Absolute time = time_base + t.
    time_base: float
    timestamps: np.ndarray  # (T,) rebased
    imu_t: np.ndarray  # (T, I)
    imu_w: np.ndarray  # (T, I, 3)
    imu_a: np.ndarray  # (T, I, 3)
    imu_mask: np.ndarray  # (T, I)
    fe_mean_w: np.ndarray  # (T, 3)
    fe_dt: np.ndarray  # (T,)
    active: np.ndarray  # (T,) bool
    gyro_bias: np.ndarray  # (3,)
    acc_mean: np.ndarray  # (3,)
    n_dropped_imu: int  # overflow diagnostics


def prebatch_imu(frame_ts, imu_t, imu_w, imu_a, max_imu_per_frame,
                 init_msgs=200) -> PrebatchedSequence:
    """Align an IMU stream to camera frames.  frame_ts: (T,), imu_*: (N, ...).
    Image data is carried separately (it is large); this handles timing only.
    """
    frame_ts = np.asarray(frame_ts, np.float64)
    imu_t = np.asarray(imu_t, np.float64)
    time_base = float(frame_ts[0]) if len(frame_ts) else 0.0
    frame_ts = frame_ts - time_base
    imu_t = imu_t - time_base
    T = len(frame_ts)
    I = max_imu_per_frame

    # gravity init: first init_msgs messages; a frame is active once the
    # init_msgs-th message has arrived before it
    n_init = min(init_msgs, len(imu_t))
    gyro_bias = np.mean(imu_w[:n_init], axis=0)
    acc_mean = np.mean(imu_a[:n_init], axis=0)
    t_ready = imu_t[init_msgs - 1] if len(imu_t) >= init_msgs else np.inf
    active = frame_ts >= t_ready

    out_t = np.zeros((T, I))
    out_w = np.zeros((T, I, 3))
    out_a = np.zeros((T, I, 3))
    out_m = np.zeros((T, I), bool)
    dropped = 0

    # estimator windows: pointer over the stream; first active frame discards
    # everything strictly before its timestamp
    ptr = 0
    first_done = False
    for k in range(T):
        if not active[k]:
            continue
        ft = frame_ts[k]
        if not first_done:
            while ptr < len(imu_t) and imu_t[ptr] < ft:
                ptr += 1
            first_done = True
        j = 0
        while ptr < len(imu_t) and imu_t[ptr] <= ft:
            if j < I:
                out_t[k, j] = imu_t[ptr]
                out_w[k, j] = imu_w[ptr]
                out_a[k, j] = imu_a[ptr]
                out_m[k, j] = True
                j += 1
            else:
                dropped += 1
            ptr += 1

    # front-end rotation-prediction windows with truncation semantics
    fe_mean = np.zeros((T, 3))
    fe_dt = np.zeros(T)
    fptr = 0
    for k in range(1, T):
        prev_t, curr_t = frame_ts[k - 1], frame_ts[k]
        fe_dt[k] = curr_t - prev_t
        begin = fptr
        while begin < len(imu_t) and imu_t[begin] < prev_t - 0.01:
            begin += 1
        end = begin
        while end < len(imu_t) and imu_t[end] < curr_t - 0.004:
            end += 1
        if end >= len(imu_t):
            # reference returns identity when the window end is missing
            continue
        if end > begin:
            fe_mean[k] = np.mean(imu_w[begin:end], axis=0)
        fptr = end  # buffer truncation (imu_processor.py:66)

    return PrebatchedSequence(
        time_base=time_base,
        timestamps=frame_ts,
        imu_t=out_t, imu_w=out_w, imu_a=out_a, imu_mask=out_m,
        fe_mean_w=fe_mean, fe_dt=fe_dt, active=active,
        gyro_bias=gyro_bias, acc_mean=acc_mean, n_dropped_imu=dropped,
    )
