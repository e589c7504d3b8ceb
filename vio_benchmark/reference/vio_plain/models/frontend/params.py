# Frozen copy of uav_airvision_tpu_torch/models/frontend/params.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Constant parameters of the image-processing front-end (port of
uav_airvision_tpu/models/frontend/params.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import Config
from ...utils.quaternion import skew


class FrontendParams(NamedTuple):
    cam0_intrinsics: torch.Tensor  # (4,) fx fy cx cy
    cam0_coeffs: torch.Tensor  # (4,)
    cam1_intrinsics: torch.Tensor  # (4,)
    cam1_coeffs: torch.Tensor  # (4,)
    R_cam0_imu: torch.Tensor  # (3,3) cam0 -> imu
    R_cam1_imu: torch.Tensor
    t_cam0_imu: torch.Tensor  # (3,)
    t_cam1_imu: torch.Tensor
    # the stereo matcher's rectification (cam0 -> cam1) and essential
    # matrix, (3,3) each, formed once here as the matcher formed them
    R0to1: torch.Tensor
    E: torch.Tensor


def make_frontend_params(config: Config, device, dtype=torch.float32) -> FrontendParams:
    T0 = np.linalg.inv(config.np_T_imu_cam0())
    T1 = np.linalg.inv(config.np_T_imu_cam1())

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    R_cam0_imu, R_cam1_imu = t(T0[:3, :3]), t(T1[:3, :3])
    t_cam0_imu, t_cam1_imu = t(T0[:3, 3]), t(T1[:3, 3])
    R0to1, E = stereo_geometry(R_cam0_imu, R_cam1_imu, t_cam0_imu, t_cam1_imu)
    return FrontendParams(
        cam0_intrinsics=t(config.calib.cam0_intrinsics),
        cam0_coeffs=t(config.calib.cam0_distortion_coeffs),
        cam1_intrinsics=t(config.calib.cam1_intrinsics),
        cam1_coeffs=t(config.calib.cam1_distortion_coeffs),
        R_cam0_imu=R_cam0_imu,
        R_cam1_imu=R_cam1_imu,
        t_cam0_imu=t_cam0_imu,
        t_cam1_imu=t_cam1_imu,
        R0to1=R0to1,
        E=E,
    )


def stereo_geometry(R_cam0_imu, R_cam1_imu, t_cam0_imu, t_cam1_imu):
    """(R0to1, E): the stereo matcher's rectification cam0 -> cam1 and its
    essential matrix, as the JAX package's matcher forms them."""
    R0to1 = R_cam1_imu.T @ R_cam0_imu
    t01 = R_cam1_imu.T @ (t_cam0_imu - t_cam1_imu)
    return R0to1, skew(t01) @ R0to1
