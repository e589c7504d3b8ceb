"""Stereo matching cam0 -> cam1 by seeded LK plus the reference's geometric
cuts.  Port of uav_airvision_tpu/models/frontend/stereo.py::stereo_match,
quirks included: the cam1 seed is re-distorted with the cam0 model, the
backward LK's status is ignored (only the 3 px fwd/bwd error is used), the
vertical-disparity gate measures against the rotation projection, and the
epipolar residual is the reference's elementwise expression with both sides
undistorted by the cam0 model."""

from __future__ import annotations

import torch

from ...config import Config
from ...ops import camera, lk
from ...ops.pyramid import Pyramid
from ...utils import quaternion as quat
from .params import FrontendParams


def stereo_match(pyr0: Pyramid, pyr1: Pyramid, cam0_pts, valid,
                 params: FrontendParams, config: Config,
                 init_cam1=None, init_ok=None, n_fwd_levels=None):
    """Returns (cam1_pts (B, 2), inlier (B,))."""
    fe = config.frontend
    h, w = pyr0.H0, pyr0.W0
    R0to1 = params.R_cam1_imu.T @ params.R_cam0_imu
    model = config.calib.cam0_distortion_model

    # undistort + rectify into cam1's frame, then re-distort: one K7 launch
    _, proj1 = camera.undistort_distort_points(cam0_pts, params.cam0_intrinsics, model,
                                               params.cam0_coeffs, R0to1)

    if n_fwd_levels is not None:
        n_fwd = n_fwd_levels
    else:
        n_fwd = None if fe.stereo_fwd_levels < 0 else fe.stereo_fwd_levels
    seed = proj1
    if init_cam1 is not None:
        seed = torch.where(init_ok[:, None], init_cam1, proj1)
    p1, st_fwd = lk.pyramidal_lk(
        pyr0, pyr1, cam0_pts, seed, valid, win=fe.patch_size,
        max_iter=fe.lk_max_iteration, eps=fe.lk_track_precision,
        min_eig_threshold=fe.lk_min_eig_threshold, n_levels=n_fwd,
        max_iter_upper=fe.lk_max_iteration_upper or None,
        compact_windows=fe.lk_compact_windows)
    # backward pass for the fwd/bwd gate: level 0 only, or the full pyramid
    # under stereo_full_backward (the reference's)
    p0r, _ = lk.pyramidal_lk(
        pyr1, pyr0, p1, cam0_pts, valid, win=fe.patch_size,
        max_iter=fe.stereo_bwd_max_iter or fe.lk_max_iteration,
        eps=fe.lk_track_precision, min_eig_threshold=fe.lk_min_eig_threshold,
        n_levels=None if fe.stereo_full_backward else 1,
        compact_windows=fe.lk_compact_windows)

    err = torch.linalg.norm(cam0_pts - p0r, dim=-1)
    disp = torch.abs(proj1[:, 1] - p1[:, 1])
    inlier = (valid & st_fwd & (err < fe.fwd_bwd_error_px)
              & (disp < fe.max_vertical_disparity_px))
    inlier = inlier & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)

    t01 = params.R_cam1_imu.T @ (params.t_cam0_imu - params.t_cam1_imu)
    E = quat.skew(t01) @ R0to1
    B = cam0_pts.shape[0]
    und_both = camera.undistort_points(torch.cat([cam0_pts, p1]), params.cam0_intrinsics,
                                       model, params.cam0_coeffs)
    und0, und1 = und_both[:B], und_both[B:]
    fx, fy = params.cam0_intrinsics[0], params.cam0_intrinsics[1]
    norm_unit = 4.0 / (2.0 * fx + 2.0 * fy)
    ones = torch.ones_like(und0[:, :1])
    pt0_h = torch.cat([und0, ones], dim=-1)
    pt1_h = torch.cat([und1, ones], dim=-1)
    line = pt0_h @ E.T
    err_epi = torch.abs(pt1_h[:, 0] * line[:, 0]) / torch.linalg.norm(line[:, :2], dim=-1)
    return p1, inlier & (err_epi <= fe.stereo_threshold * norm_unit)
