"""The image-processing front-end step, for one stereo frame or a fleet's.

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

``frontend_step_fleet`` runs B instances (the JAX package's
``vmap(frontend_step)`` in ``models/vio.py::vio_step_fleet``): every state
leaf and input has a leading instance axis, ``prev_pyr`` is one batched
pyramid, and K2, K4+K6, K5, K1, K7's prediction and K8 (the first frame's
ranking, kept-order statistics and compaction, and a tracked frame's
selection) launch once for the whole batch.  K7's publish and stereo gate
run once on the flattened points.  The decisions read once for the batch: an
instance without a pyramid takes the first-frame branch on its own
(``Pyramid.held``, a host flag, no device read), and under the seed
fallback the (B,) seed counts are read once and the starved instances take
the unseeded stereo match on their subset, the others the seeded one:
each instance's result is its single-instance result.  ``frontend_step``
is the fleet step of one instance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...config import Config
from ...device import to_host
from ...ops import camera, gridops, lk, pyramid
from ...ops.camera import predict_warp_points, predicted_rotation
from ...ops.fast import detect_fast
from ...ops.gridops import select_track
from ...ops.pyramid import Pyramid
from ...utils.profiling import count, span
from ...utils.tree import split_run, take
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
    # the first-frame branch needs no device read (a fleet's: one batch,
    # None while no instance is initialized, ``held`` flags the others)
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


def predicted_rotations(mean_ang_vel, dt, params: FrontendParams):
    return (predicted_rotation(mean_ang_vel, dt, params.R_cam0_imu),
            predicted_rotation(mean_ang_vel, dt, params.R_cam1_imu))


def _detection_candidates(img, mask_pts, mask_valid, config: Config, per_cell: int):
    """FAST + mask + NMS + per-cell top-k: flat (pts, score, arrival, valid)
    per instance, from (B, H, W) images (one K4+K6 and one K5 launch)."""
    fe = config.frontend
    with span("fe.detect"):
        keep, score = detect_fast(img, fe.fast_threshold, mask_pts, mask_valid)
        ys, xs, vals = gridops.dense_grid_topk(score, fe.grid_row, fe.grid_col, per_cell)
        B, C = img.shape[0], fe.grid_num * per_cell
        ys, xs, vals = ys.reshape(B, C), xs.reshape(B, C), vals.reshape(B, C)
        pts = torch.stack([xs, ys], dim=-1).to(torch.float32)
        arrival = ys * img.shape[-1] + xs
        return pts, vals, arrival, vals > 0


def _normalize_publish(ids, cam0, cam1, valid, params: FrontendParams, config: Config):
    """The publish: every instance's points undistorted in one K7 launch."""
    B, F = cam0.shape[:2]
    cam0, cam1 = cam0.reshape(B * F, 2), cam1.reshape(B * F, 2)
    N = B * F
    calib = config.calib
    if calib.cam0_distortion_model == calib.cam1_distortion_model:
        def pair(a, b):  # (4, 2N): cam0's values for the first N points, then cam1's
            return torch.cat([a[:, None].expand(4, N), b[:, None].expand(4, N)], dim=1)

        intr = pair(params.cam0_intrinsics, params.cam1_intrinsics)
        coeffs = pair(params.cam0_coeffs, params.cam1_coeffs)
        und = camera.undistort_points(torch.cat([cam0, cam1]), intr,
                                      calib.cam0_distortion_model, coeffs)
        und0, und1 = und[:N], und[N:]
    else:
        und0 = camera.undistort_points(cam0, params.cam0_intrinsics,
                                       calib.cam0_distortion_model, params.cam0_coeffs)
        und1 = camera.undistort_points(cam1, params.cam1_intrinsics,
                                       calib.cam1_distortion_model, params.cam1_coeffs)
    uv = torch.cat([und0, und1], dim=-1).reshape(B, F, 4)
    return (torch.where(valid, ids, -1), torch.where(valid[..., None], uv, 0.0), valid)


def frontend_step(state: FrontendState, cam0_img, cam1_img, mean_ang_vel, dt,
                  params: FrontendParams, config: Config):
    """One stereo frame through the front-end; returns (state, FrontendOutput).
    ``cam0_img``/``cam1_img`` are (H, W) uint8 tensors."""
    one = type(state)(*(x if x is None or isinstance(x, Pyramid) else x[None] for x in state))
    one, out = frontend_step_fleet(one, cam0_img[None], cam1_img[None], mean_ang_vel[None],
                                   dt.reshape(1), params, config)
    return (type(state)(*(x if isinstance(x, Pyramid) else x[0] for x in one)),
            FrontendOutput(*(x[0] for x in out)))


def frontend_step_fleet(state: FrontendState, cam0_img, cam1_img, mean_ang_vel, dt,
                        params: FrontendParams, config: Config):
    """B instances' stereo frames through the front-end: every leaf of
    ``state`` and of the output has a leading instance axis; the images are
    (B, H, W) uint8, ``mean_ang_vel`` (B, 3), ``dt`` (B,).  Returns (state,
    FrontendOutput); each instance's slice is its ``frontend_step``."""
    with span("frontend"):
        fe = config.frontend
        B = cam0_img.shape[0]
        with span("fe.pyramid"):
            pyr0, pyr1 = pyramid.build_pyramid_pair(cam0_img, cam1_img, fe.pyramid_levels)
        prev = state.prev_pyr
        first = [True] * B if prev is None else [not h for h in (prev.held or (True,) * B)]

        def first_frame(idx):
            with span("fe.first_frame"):
                return _first_frame(take(state, idx), take(cam0_img, idx), pyr0.select(idx),
                                    pyr1.select(idx), params, config)

        def track_frame(idx):
            return _track_frame(take(state, idx), take(cam0_img, idx), pyr0.select(idx),
                                pyr1.select(idx), take(mean_ang_vel, idx), take(dt, idx),
                                params, config)

        state2, counters = split_run(first, first_frame, track_frame)
        state2 = state2._replace(prev_pyr=pyr0)
        with span("fe.publish"):
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
    B, H, W = cam0_img.shape
    dev = cam0_img.device
    pts, score, arrival, vald = _detection_candidates(cam0_img, None, None, config, CAND_INIT)
    with span("fe.stereo"):
        cam1_pts, inlier = stereo_match(pyr0, pyr1, pts, vald, params, config)

    # K8 once for the batch each: the best of each cell, their ids, compacted
    with span("fe.select"):
        cell = gridops.cell_of_points(pts, fe.grid_row, fe.grid_col, H, W)
        rank, perm = gridops.rank_in_cell(cell, score.to(torch.float32), arrival, inlier,
                                          fe.grid_num)
        keep = inlier & (rank < fe.grid_min_feature_num)
        grank, _, n_kept = gridops.kept_order_stats(perm, keep, cell, inlier, fe.grid_num)
        ids = torch.where(keep, state.next_id[:, None] + grank, -1)
        sel, selm = gridops.compact_kept(perm, keep, F)
        sel = sel.long()
        cam0 = torch.where(selm[..., None], gridops.gather_rows(pts, sel), 0.0)
        cam1 = torch.where(selm[..., None], gridops.gather_rows(cam1_pts, sel), 0.0)
        state2 = state._replace(ids=torch.where(selm, ids.gather(1, sel), -1).to(torch.int32),
                                lifetime=selm.to(torch.int32), cam0=cam0, cam1=cam1,
                                valid=selm, next_id=(state.next_id + n_kept).to(torch.int32),
                                initialized=torch.ones((B,), dtype=torch.bool, device=dev))
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    return state2, (zero, zero, zero, zero, zero)


def _track_frame(state: FrontendState, cam0_img, pyr0, pyr1, mean_ang_vel, dt,
                 params: FrontendParams, config: Config):
    fe = config.frontend
    F = config.capacity.max_features
    B, H, W = cam0_img.shape
    i32 = torch.int32

    prev_pts, prev_valid = state.cam0, state.valid
    before_tracking = prev_valid.to(i32).sum(-1).to(i32)
    # the IMU-rotation prediction (cam0's: the JAX package computes cam1's
    # too and drops it) and the K R K^-1 warp, one K7 launch for the batch
    with span("fe.predict"):
        pred, _ = predict_warp_points(prev_pts, mean_ang_vel, dt, params.R_cam0_imu,
                                      params.cam0_intrinsics)
    with span("fe.track"):
        curr, st = lk.pyramidal_lk(
            state.prev_pyr, pyr0, prev_pts, pred, prev_valid,
            n_levels=temporal_lk_levels(config), win=fe.patch_size,
            max_iter=fe.lk_max_iteration, eps=fe.lk_track_precision,
            min_eig_threshold=fe.lk_min_eig_threshold,
            max_iter_upper=fe.lk_max_iteration_upper or None,
            compact_windows=fe.lk_compact_windows)
        st = st & (curr[..., 0] >= 0) & (curr[..., 0] <= W - 1) & (curr[..., 1] >= 0) \
            & (curr[..., 1] <= H - 1)
        after_tracking = st.to(i32).sum(-1).to(i32)
    n_seed = None  # the seeds' count where the stereo is seeded (JAX: 0 elsewhere)

    if fe.exact_adder_mask:
        # the reference's order: stereo-match the temporal tracks, mask around
        # the survivors, then stereo-match the new candidates separately
        with span("fe.stereo"):
            cam1_curr, match = stereo_match(pyr0, pyr1, curr, st, params, config)
        apts, ascore, aarrival, avalid = _detection_candidates(
            cam0_img, curr, st & match, config, fe.grid_max_feature_num)
        with span("fe.stereo"):
            acam1, ainlier = stereo_match(pyr0, pyr1, apts, avalid, params, config)
    else:
        # The detection mask is built from the temporally tracked points, so
        # the tracked-feature and new-candidate stereo matches run as one LK
        # batch.
        apts, ascore, aarrival, avalid = _detection_candidates(
            cam0_img, curr, st, config, fe.grid_max_feature_num)
        with span("fe.stereo"):
            both_pts = torch.cat([curr, apts], dim=1)
            both_valid = torch.cat([st, avalid], dim=1)

            def unseeded(idx):  # the reference's rotation-projected seeds, full pyramid
                return stereo_match(pyr0.select(idx), pyr1.select(idx), take(both_pts, idx),
                                    take(both_valid, idx), params, config)

            if fe.stereo_seeded:
                # disparity seeds: tracked features at their previous disparity,
                # new candidates at their nearest tracked neighbour's
                d_prev = state.cam1 - state.cam0
                trk_ok = st & state.valid
                n_seed = trk_ok.to(i32).sum(-1)
                dist2 = ((apts[:, :, None, :] - curr[:, None, :, :]) ** 2).sum(-1)
                dist2 = torch.where(trk_ok[:, None, :], dist2, torch.inf)
                nn = torch.argmin(dist2, dim=-1)
                seed = torch.cat([curr + d_prev,
                                  apts + d_prev.gather(1, nn[..., None].expand(-1, -1, 2))], dim=1)
                seed_ok = torch.cat([trk_ok, (n_seed > 0)[:, None].expand(apts.shape[:2])], dim=1)

                def seeded(idx):
                    return stereo_match(pyr0.select(idx), pyr1.select(idx), take(both_pts, idx),
                                        take(both_valid, idx), params, config,
                                        init_cam1=take(seed, idx), init_ok=take(seed_ok, idx),
                                        n_fwd_levels=fe.stereo_seeded_levels)

                # starvation recovery, where enabled: too few tracks to trust the
                # seeds (the one host read of the front-end, for the batch)
                trust = [True] * B
                if fe.stereo_seed_fallback:
                    trust = [n >= fe.stereo_seed_min_tracked
                             for n in to_host(n_seed, "fe.seed_trust")]
                    count("fe.stereo_unseeded", trust.count(False))
                both_cam1, both_inlier = split_run(trust, seeded, unseeded)
            else:
                both_cam1, both_inlier = unseeded(list(range(B)))
            cam1_curr, match = both_cam1[:, :F], both_inlier[:, :F]
            acam1, ainlier = both_cam1[:, F:], both_inlier[:, F:]

    tracked = st & match
    after_matching = tracked.to(i32).sum(-1).to(i32)

    # the per-cell selection (new ids, prune, compaction), one K8 launch for
    # the batch
    with span("fe.select"):
        ids, lifetime, cam0, cam1, valid, next_id = select_track(
            curr, cam1_curr, tracked, state.ids, state.lifetime, apts, ascore, aarrival,
            ainlier, acam1, state.next_id, fe.grid_row, fe.grid_col, H, W,
            fe.grid_min_feature_num, fe.grid_max_feature_num)
    new_state = state._replace(ids=ids, lifetime=lifetime, cam0=cam0, cam1=cam1, valid=valid,
                               next_id=next_id)
    if n_seed is None:
        n_seed = torch.zeros((B,), dtype=i32, device=curr.device)
    counters = (before_tracking, after_tracking, after_matching, after_matching,
                n_seed.to(i32))
    return new_state, counters
