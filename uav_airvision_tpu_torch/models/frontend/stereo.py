"""Stereo matching cam0 -> cam1 by seeded LK plus the reference's geometric
cuts.  Port of uav_airvision_tpu/models/frontend/stereo.py::stereo_match,
quirks included: the cam1 seed is re-distorted with the cam0 model, the
backward LK's status is ignored (only the 3 px fwd/bwd error is used), the
vertical-disparity gate measures against the rotation projection, and the
epipolar residual is the reference's elementwise expression with both sides
undistorted by the cam0 model.  The prologue (rectify and re-distort) and
the cuts after the backward LK are one K7 launch each
(``camera.undistort_distort_points``, ``camera.stereo_gate``).  A fleet's
points (B, N, 2) match in the same launches: K7 on the flattened points,
the LK calls on the batched pyramids."""

from __future__ import annotations

import torch

from ...config import Config
from ...ops import camera, lk
from ...ops.pyramid import Pyramid
from .params import FrontendParams


def stereo_match(pyr0: Pyramid, pyr1: Pyramid, cam0_pts, valid,
                 params: FrontendParams, config: Config,
                 init_cam1=None, init_ok=None, n_fwd_levels=None):
    """Points (N, 2), or (B, N, 2) with batched pyramids; returns (cam1_pts
    of the points' shape, inlier of their leading shape)."""
    fe = config.frontend
    model = config.calib.cam0_distortion_model
    lead = cam0_pts.shape[:-1]

    # undistort + rectify into cam1's frame, then re-distort: one K7 launch
    _, proj1 = camera.undistort_distort_points(cam0_pts.reshape(-1, 2), params.cam0_intrinsics,
                                               model, params.cam0_coeffs, params.R0to1)
    proj1 = proj1.reshape(cam0_pts.shape)

    if n_fwd_levels is not None:
        n_fwd = n_fwd_levels
    else:
        n_fwd = None if fe.stereo_fwd_levels < 0 else fe.stereo_fwd_levels
    seed = proj1
    if init_cam1 is not None:
        seed = torch.where(init_ok[..., None], init_cam1, proj1)
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

    def flat(t):
        return t.reshape(-1, *t.shape[len(lead):])

    inlier = camera.stereo_gate(flat(cam0_pts), flat(p1), flat(p0r), flat(proj1), flat(valid),
                                flat(st_fwd), params.cam0_intrinsics, model, params.cam0_coeffs,
                                params.E, fe.fwd_bwd_error_px, fe.max_vertical_disparity_px,
                                fe.stereo_threshold, pyr0.H0, pyr0.W0)
    return p1, inlier.reshape(lead)
