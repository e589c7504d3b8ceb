"""The image-processing front-end step.

Port of uav_airvision_tpu/models/frontend/pipeline.py::frontend_step: pyramid
build for both cameras, first-frame initialization or temporal tracking
(IMU-homography seed, temporal LK, the pre-stereo 7x7 detection mask,
disparity-seeded stereo with the starvation fallback), per-cell pruning and
compaction in publish order, and the undistorted publish.

The JAX state carries banded template rows of the previous frame
(``prev_rows``); this port carries the previous frame's padded cam0 pyramid
instead (``FrontendState.prev_pyr``), which the temporal LK reads its
templates from.  The two ``lax.cond`` decisions become Python branches: the
first frame is the state without a pyramid, and the seed fallback reads the
number of seeds back from the device (only where the fallback can fire:
seeded stereo with ``stereo_seed_fallback``).  Every front-end option of the
JAX package's config runs: ``exact_adder_mask`` (the reference's order of
stereo, mask and candidate stereo), ``stereo_seeded``,
``stereo_seed_fallback``, ``stereo_fwd_levels``, ``stereo_full_backward``
and ``lk_compact_windows`` (ops/lk.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...config import Config
from ...device import to_host
from ...ops import camera, fast, gridops, lk, pyramid
from ...ops.pyramid import Pyramid
from ...utils.quaternion import skew
from .params import FrontendParams
from .stereo import stereo_match

CAND_INIT = 8  # per-cell candidates on the first frame


class FrontendState(NamedTuple):
    ids: torch.Tensor  # (F,) int32
    lifetime: torch.Tensor  # (F,) int32
    cam0: torch.Tensor  # (F,2) float32
    cam1: torch.Tensor  # (F,2)
    valid: torch.Tensor  # (F,) bool
    next_id: torch.Tensor  # () int32
    # previous frame's cam0 pyramid; None exactly while not initialized, so
    # the first-frame branch needs no device read
    prev_pyr: Optional[Pyramid]
    initialized: torch.Tensor  # () bool


class FrontendOutput(NamedTuple):
    ids: torch.Tensor  # (F,) int32
    uv: torch.Tensor  # (F,4) normalized [u0 v0 u1 v1]
    mask: torch.Tensor  # (F,)
    before_tracking: torch.Tensor
    after_tracking: torch.Tensor
    after_matching: torch.Tensor
    after_ransac: torch.Tensor
    n_seed: torch.Tensor


def temporal_lk_levels(config: Config) -> int:
    return config.frontend.lk_temporal_levels or (config.frontend.pyramid_levels + 1)


def init_frontend_state(config: Config, device) -> FrontendState:
    F = config.capacity.max_features
    return FrontendState(
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        lifetime=torch.zeros((F,), dtype=torch.int32, device=device),
        cam0=torch.zeros((F, 2), dtype=torch.float32, device=device),
        cam1=torch.zeros((F, 2), dtype=torch.float32, device=device),
        valid=torch.zeros((F,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        prev_pyr=None,
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def rodrigues(rvec):
    theta = torch.linalg.norm(rvec)
    safe = torch.where(theta > 1e-12, theta, torch.ones_like(theta))
    K = skew(rvec / safe)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > 1e-12, R, eye)


def predicted_rotations(mean_ang_vel, dt, params: FrontendParams):
    cam0_mean = params.R_cam0_imu.T @ mean_ang_vel
    cam1_mean = params.R_cam1_imu.T @ mean_ang_vel
    return rodrigues(cam0_mean * dt).T, rodrigues(cam1_mean * dt).T


def _detection_candidates(img, mask_pts, mask_valid, config: Config, per_cell: int):
    """FAST + mask + NMS + per-cell top-k: flat (pts, score, arrival, valid)."""
    fe = config.frontend
    keep, score = fast.detect_fast(img, fe.fast_threshold, mask_pts, mask_valid)
    ys, xs, vals = gridops.dense_grid_topk(score, fe.grid_row, fe.grid_col, per_cell)
    C = fe.grid_num * per_cell
    ys, xs, vals = ys.reshape(C), xs.reshape(C), vals.reshape(C)
    pts = torch.stack([xs, ys], dim=-1).to(torch.float32)
    arrival = ys * img.shape[1] + xs
    return pts, vals, arrival, vals > 0


def _normalize_publish(ids, cam0, cam1, valid, params: FrontendParams, config: Config):
    F = cam0.shape[0]
    calib = config.calib
    if calib.cam0_distortion_model == calib.cam1_distortion_model:
        def pair(a, b):  # (4, 2F): cam0's values for the first F points, then cam1's
            return torch.cat([a[:, None].expand(4, F), b[:, None].expand(4, F)], dim=1)

        intr = pair(params.cam0_intrinsics, params.cam1_intrinsics)
        coeffs = pair(params.cam0_coeffs, params.cam1_coeffs)
        und = camera.undistort_points(torch.cat([cam0, cam1]), intr,
                                      calib.cam0_distortion_model, coeffs)
        und0, und1 = und[:F], und[F:]
    else:
        und0 = camera.undistort_points(cam0, params.cam0_intrinsics,
                                       calib.cam0_distortion_model, params.cam0_coeffs)
        und1 = camera.undistort_points(cam1, params.cam1_intrinsics,
                                       calib.cam1_distortion_model, params.cam1_coeffs)
    uv = torch.cat([und0, und1], dim=-1)
    return (torch.where(valid, ids, -1), torch.where(valid[:, None], uv, 0.0), valid)


def frontend_step(state: FrontendState, cam0_img, cam1_img, mean_ang_vel, dt,
                  params: FrontendParams, config: Config):
    """One stereo frame through the front-end; returns (state, FrontendOutput).
    ``cam0_img``/``cam1_img`` are (H, W) uint8 tensors."""
    fe = config.frontend
    pyr0, pyr1 = pyramid.build_pyramid_pair(cam0_img, cam1_img, fe.pyramid_levels)
    if state.prev_pyr is None:
        state2, counters = _first_frame(state, cam0_img, pyr0, pyr1, params, config)
    else:
        state2, counters = _track_frame(state, cam0_img, pyr0, pyr1, mean_ang_vel, dt,
                                        params, config)
    state2 = state2._replace(prev_pyr=pyr0)
    ids, uv, mask = _normalize_publish(state2.ids, state2.cam0, state2.cam1,
                                       state2.valid, params, config)
    out = FrontendOutput(ids=ids, uv=uv, mask=mask, before_tracking=counters[0],
                         after_tracking=counters[1], after_matching=counters[2],
                         after_ransac=counters[3], n_seed=counters[4])
    return state2, out


def _first_frame(state: FrontendState, cam0_img, pyr0, pyr1, params: FrontendParams,
                 config: Config):
    """8 candidates per cell, full-pyramid stereo, the best 3 per cell kept."""
    fe = config.frontend
    F = config.capacity.max_features
    H, W = cam0_img.shape
    dev = cam0_img.device
    pts, score, arrival, vald = _detection_candidates(cam0_img, None, None, config,
                                                      CAND_INIT)
    cam1_pts, inlier = stereo_match(pyr0, pyr1, pts, vald, params, config)
    cell = gridops.cell_of_points(pts, fe.grid_row, fe.grid_col, H, W)
    rank, perm = gridops.rank_in_cell(cell, score.to(torch.float32), arrival, inlier,
                                      fe.grid_num)
    keep = inlier & (rank < fe.grid_min_feature_num)
    grank, _, n_kept = gridops.kept_order_stats(perm, keep, cell, inlier, fe.grid_num)
    ids = torch.where(keep, state.next_id + grank, -1)
    sel, selm = gridops.compact_kept(perm, keep, F)
    sel = sel.long()
    state2 = state._replace(
        ids=torch.where(selm, ids[sel], -1).to(torch.int32),
        lifetime=selm.to(torch.int32),
        cam0=torch.where(selm[:, None], pts[sel], 0.0),
        cam1=torch.where(selm[:, None], cam1_pts[sel], 0.0),
        valid=selm,
        next_id=(state.next_id + n_kept).to(torch.int32),
        initialized=torch.ones((), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return state2, (zero, zero, zero, zero, zero)


def _track_frame(state: FrontendState, cam0_img, pyr0, pyr1, mean_ang_vel, dt,
                 params: FrontendParams, config: Config):
    fe = config.frontend
    F = config.capacity.max_features
    n_cells = fe.grid_num
    H, W = cam0_img.shape
    i32 = torch.int32
    cam0_R_p_c, _ = predicted_rotations(mean_ang_vel, dt, params)

    prev_pts, prev_valid = state.cam0, state.valid
    before_tracking = prev_valid.to(i32).sum().to(i32)
    pred = camera.homography_warp_points(prev_pts, cam0_R_p_c, params.cam0_intrinsics)
    curr, st = lk.pyramidal_lk(
        state.prev_pyr, pyr0, prev_pts, pred, prev_valid,
        n_levels=temporal_lk_levels(config), win=fe.patch_size,
        max_iter=fe.lk_max_iteration, eps=fe.lk_track_precision,
        min_eig_threshold=fe.lk_min_eig_threshold,
        max_iter_upper=fe.lk_max_iteration_upper or None,
        compact_windows=fe.lk_compact_windows)
    st = st & (curr[:, 0] >= 0) & (curr[:, 0] <= W - 1) & (curr[:, 1] >= 0) \
        & (curr[:, 1] <= H - 1)
    after_tracking = st.to(i32).sum().to(i32)
    n_seed = None  # the seeds' count where the stereo is seeded (JAX: 0 elsewhere)

    if fe.exact_adder_mask:
        # the reference's order: stereo-match the temporal tracks, mask around
        # the survivors, then stereo-match the new candidates separately
        cam1_curr, match = stereo_match(pyr0, pyr1, curr, st, params, config)
        apts, ascore, aarrival, avalid = _detection_candidates(
            cam0_img, curr, st & match, config, fe.grid_max_feature_num)
        acam1, ainlier = stereo_match(pyr0, pyr1, apts, avalid, params, config)
    else:
        # The detection mask is built from the temporally tracked points, so
        # the tracked-feature and new-candidate stereo matches run as one LK
        # batch.
        apts, ascore, aarrival, avalid = _detection_candidates(
            cam0_img, curr, st, config, fe.grid_max_feature_num)
        both_pts = torch.cat([curr, apts])
        both_valid = torch.cat([st, avalid])
        if fe.stereo_seeded:
            # disparity seeds: tracked features at their previous disparity,
            # new candidates at their nearest tracked neighbour's
            d_prev = state.cam1 - state.cam0
            trk_ok = st & state.valid
            n_seed = trk_ok.to(i32).sum()
            dist2 = ((apts[:, None, :] - curr[None, :, :]) ** 2).sum(-1)
            dist2 = torch.where(trk_ok[None, :], dist2, torch.inf)
            nn = torch.argmin(dist2, dim=1)
            seed = torch.cat([curr + d_prev, apts + d_prev[nn]])
            seed_ok = torch.cat([trk_ok, (n_seed > 0).expand(apts.shape[0])])
            # starvation recovery, where enabled: too few tracks to trust the
            # seeds (the one host read of the front-end)
            if fe.stereo_seed_fallback and to_host(n_seed) < fe.stereo_seed_min_tracked:
                both_cam1, both_inlier = stereo_match(pyr0, pyr1, both_pts, both_valid,
                                                      params, config)
            else:
                both_cam1, both_inlier = stereo_match(
                    pyr0, pyr1, both_pts, both_valid, params, config, init_cam1=seed,
                    init_ok=seed_ok, n_fwd_levels=fe.stereo_seeded_levels)
        else:  # the reference's rotation-projected seeds and full pyramid
            both_cam1, both_inlier = stereo_match(pyr0, pyr1, both_pts, both_valid,
                                                  params, config)
        cam1_curr, match = both_cam1[:F], both_inlier[:F]
        acam1, ainlier = both_cam1[F:], both_inlier[F:]

    tracked = st & match
    after_matching = tracked.to(i32).sum().to(i32)

    tr_cell = gridops.cell_of_points(curr, fe.grid_row, fe.grid_col, H, W)
    tr_life = state.lifetime + 1
    acell = gridops.cell_of_points(apts, fe.grid_row, fe.grid_col, H, W)
    arank, aperm = gridops.rank_in_cell(acell, ascore.to(torch.float32), aarrival,
                                        ainlier, n_cells)
    akeep = ainlier & (arank < fe.grid_min_feature_num)
    a_grank, a_crank, a_kept = gridops.kept_order_stats(aperm, akeep, acell, ainlier,
                                                        n_cells)
    aids = torch.where(akeep, state.next_id + a_grank, -1).to(i32)

    # combine tracked + new, prune per cell
    C = apts.shape[0]
    dev = curr.device
    all_cell = torch.cat([tr_cell, acell])
    all_life = torch.cat([tr_life, torch.ones((C,), dtype=i32, device=dev)])
    all_valid = torch.cat([tracked, akeep])
    all_ids = torch.cat([state.ids, aids])
    all_cam0 = torch.cat([curr, apts])
    all_cam1 = torch.cat([cam1_curr, acam1])
    arrival = torch.cat([torch.arange(F, dtype=i32, device=dev), F + a_crank.to(i32)])

    cells = torch.arange(n_cells, device=dev)
    onehot = (all_cell[:, None] == cells[None, :]) & all_valid[:, None]
    overflow = onehot.to(i32).sum(0) > fe.grid_max_feature_num
    of_this = torch.where(all_valid, overflow[all_cell.clamp(0, n_cells - 1).long()],
                          False)
    sort_life = torch.where(of_this, all_life, 0)
    prank, pperm = gridops.rank_in_cell(all_cell, sort_life.to(torch.float32), arrival,
                                        all_valid, n_cells)
    keep = all_valid & (prank < fe.grid_max_feature_num)
    sel, selm = gridops.compact_kept(pperm, keep, F)
    sel = sel.long()
    new_state = state._replace(
        ids=torch.where(selm, all_ids[sel], -1).to(i32),
        lifetime=torch.where(selm, all_life[sel], 0).to(i32),
        cam0=torch.where(selm[:, None], all_cam0[sel], 0.0),
        cam1=torch.where(selm[:, None], all_cam1[sel], 0.0),
        valid=selm,
        next_id=(state.next_id + a_kept).to(i32),
    )
    if n_seed is None:
        n_seed = torch.zeros((), dtype=i32, device=dev)
    counters = (before_tracking, after_tracking, after_matching, after_matching,
                n_seed.to(i32))
    return new_state, counters
