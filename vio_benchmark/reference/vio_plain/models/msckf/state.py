# Frozen copy of uav_airvision_tpu_torch/models/msckf/state.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Filter-state containers of the MSCKF back-end (port of
uav_airvision_tpu/models/msckf/state.py): fixed-capacity tensors with
validity masks -- the camera window as an ordered slot buffer, the map
server as a feature table with insertion sequence numbers, and one
(21 + 6N)^2 covariance whose inactive camera rows/columns stay zero."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.stats import chi2 as _chi2

from ...config import Config
from ...utils import quaternion as quat

IMU_DIM = 21  # error state: dtheta, bg, v, ba, p, ext_theta, ext_t
INT32_MAX = 2**31 - 1


class ImuState(NamedTuple):
    q: torch.Tensor  # (4,) world->IMU JPL quaternion
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    q_null: torch.Tensor  # (4,) OC-EKF anchors
    p_null: torch.Tensor  # (3,)
    v_null: torch.Tensor  # (3,)
    R_imu_cam0: torch.Tensor  # (3,3)
    t_cam0_imu: torch.Tensor  # (3,)
    timestamp: torch.Tensor  # ()
    sid: torch.Tensor  # () int32


class CamWindow(NamedTuple):
    sid: torch.Tensor  # (N,) int32
    q: torch.Tensor  # (N,4) world->cam0
    p: torch.Tensor  # (N,3)
    q_null: torch.Tensor  # (N,4)
    p_null: torch.Tensor  # (N,3)
    timestamp: torch.Tensor  # (N,)
    count: torch.Tensor  # () int32


class FeatureTable(NamedTuple):
    fid: torch.Tensor  # (M,) int32, -1 = free
    seq: torch.Tensor  # (M,) int32 insertion order
    obs: torch.Tensor  # (M,N,4)
    obs_mask: torch.Tensor  # (M,N) bool
    position: torch.Tensor  # (M,3)
    initialized: torch.Tensor  # (M,) bool
    valid: torch.Tensor  # (M,) bool


class FilterState(NamedTuple):
    imu: ImuState
    cams: CamWindow
    cov: torch.Tensor  # (D,D)
    features: FeatureTable
    gravity: torch.Tensor  # (3,)
    tracking_rate: torch.Tensor  # ()
    next_seq: torch.Tensor  # () int32
    started: torch.Tensor  # () bool


class MsckfParams(NamedTuple):
    R_cam0_cam1: torch.Tensor  # (3,3)
    t_cam0_cam1: torch.Tensor  # (3,)
    R_imu_cam0_init: torch.Tensor  # (3,3)
    t_cam0_imu_init: torch.Tensor  # (3,)
    T_imu_body_R: torch.Tensor  # (3,3)
    T_imu_body_t: torch.Tensor  # (3,)
    noise_qc_diag: torch.Tensor  # (12,)
    chi2_table: torch.Tensor  # (100,) chi2.ppf(0.05, dof)
    obs_noise: torch.Tensor  # ()
    init_cov_diag: torch.Tensor  # (21,)
    position_std_threshold: torch.Tensor  # ()


def torch_dtype(config: Config) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[config.dtype]


def make_params(config: Config, device, dtype=None) -> MsckfParams:
    dtype = dtype or torch_dtype(config)
    fc = config.filter
    T_c0c1 = config.np_T_cn_cnm1()
    T_cam0_imu = np.linalg.inv(config.np_T_imu_cam0())
    qc = np.concatenate([np.full(3, fc.gyro_noise), np.full(3, fc.gyro_bias_noise),
                         np.full(3, fc.acc_noise), np.full(3, fc.acc_bias_noise)])
    table = np.zeros(100)
    table[1:] = _chi2.ppf(0.05, np.arange(1, 100))
    init_diag = np.zeros(IMU_DIM)
    init_diag[3:6] = fc.gyro_bias_cov
    init_diag[6:9] = fc.velocity_cov
    init_diag[9:12] = fc.acc_bias_cov
    init_diag[15:18] = fc.extrinsic_rotation_cov
    init_diag[18:21] = fc.extrinsic_translation_cov
    Tib = config.np_T_imu_body()

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return MsckfParams(
        R_cam0_cam1=t(T_c0c1[:3, :3]), t_cam0_cam1=t(T_c0c1[:3, 3]),
        R_imu_cam0_init=t(T_cam0_imu[:3, :3].T), t_cam0_imu_init=t(T_cam0_imu[:3, 3]),
        T_imu_body_R=t(Tib[:3, :3]), T_imu_body_t=t(Tib[:3, 3]),
        noise_qc_diag=t(qc), chi2_table=t(table), obs_noise=t(fc.observation_noise),
        init_cov_diag=t(init_diag), position_std_threshold=t(fc.position_std_threshold),
    )


def reset_cov(config: Config, params: MsckfParams, dtype) -> torch.Tensor:
    D = config.capacity.state_dim
    cov = torch.zeros((D, D), dtype=dtype, device=params.init_cov_diag.device)
    idx = torch.arange(IMU_DIM, device=cov.device)
    cov[idx, idx] = params.init_cov_diag.to(dtype)
    return cov


def init_state(config: Config, params: MsckfParams, gyro_bias=None, acc_mean=None,
               dtype=None) -> FilterState:
    """Initial state; ``gyro_bias``/``acc_mean`` are the means of the first
    ``imu_init_msgs`` IMU messages (gravity magnitude and the orientation
    that aligns the measured gravity with world -z).  The device is the
    params' device."""
    dtype = dtype or torch_dtype(config)
    dev = params.obs_noise.device
    cap = config.capacity
    N, M = cap.max_cam_states, cap.max_map_features

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if acc_mean is None:
        gravity = torch.tensor([0.0, 0.0, -config.filter.gravity_acc], dtype=dtype, device=dev)
        q0 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    else:
        acc = torch.as_tensor(np.asarray(acc_mean), dtype=dtype, device=dev)
        g_norm = torch.linalg.norm(acc)
        gravity = torch.stack([z(), z(), -g_norm])
        q0 = quat.from_two_vectors(-gravity, acc)
    bg0 = z(3) if gyro_bias is None else torch.as_tensor(
        np.asarray(gyro_bias), dtype=dtype, device=dev)
    unit_q = z(N, 4)
    unit_q[:, 3] = 1.0
    imu = ImuState(
        q=q0, p=z(3), v=z(3), bg=bg0, ba=z(3), q_null=q0.clone(), p_null=z(3),
        v_null=z(3), R_imu_cam0=params.R_imu_cam0_init.to(dtype),
        t_cam0_imu=params.t_cam0_imu_init.to(dtype), timestamp=z(),
        sid=torch.zeros((), dtype=torch.int32, device=dev))
    cams = CamWindow(
        sid=torch.full((N,), -1, dtype=torch.int32, device=dev), q=unit_q,
        p=z(N, 3), q_null=unit_q.clone(), p_null=z(N, 3), timestamp=z(N),
        count=torch.zeros((), dtype=torch.int32, device=dev))
    feats = FeatureTable(
        fid=torch.full((M,), -1, dtype=torch.int32, device=dev),
        seq=torch.full((M,), INT32_MAX, dtype=torch.int32, device=dev),
        obs=z(M, N, 4), obs_mask=torch.zeros((M, N), dtype=torch.bool, device=dev),
        position=z(M, 3), initialized=torch.zeros((M,), dtype=torch.bool, device=dev),
        valid=torch.zeros((M,), dtype=torch.bool, device=dev))
    return FilterState(
        imu=imu, cams=cams, cov=reset_cov(config, params, dtype), features=feats,
        gravity=gravity, tracking_rate=z(), next_seq=torch.zeros((), dtype=torch.int32, device=dev),
        started=torch.zeros((), dtype=torch.bool, device=dev))
