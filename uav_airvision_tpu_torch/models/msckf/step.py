"""The per-frame MSCKF step: propagation, state augmentation, observation
upsert, lost-feature marginalization, camera-pair pruning and online reset.

Port of uav_airvision_tpu/models/msckf/step.py (``backend_step`` and the
functions it calls, under every filter and triangulation option; the fleet
variants are not ported).  Each ``lax.cond``
becomes a Python branch on values read back from the device with
``device.to_host`` (one read per decision group), and each
``.at[].set(mode="drop")`` scatter becomes a scatter into a dump row
(``gridops.set_drop``), so the step needs no boolean indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import Config
from ...device import to_host
from ...ops.gridops import set_drop, smallest_k_indices, stable_compact_indices
from ...utils import quaternion as quat
from . import triangulation as tri
from .propagation import propagate
from .state import (IMU_DIM, INT32_MAX, CamWindow, FeatureTable, FilterState, MsckfParams,
                    reset_cov)
from .update import (apply_update, apply_update_rank12_rows, feature_block_rows,
                     gating_test_batch)

LOST_SMALL = 16  # lost-feature batch of the common case (JAX small tier)
MAX_BUDGET_ROWS = 1500  # the reference's Jacobian-stack row cap


class FrameInput(NamedTuple):
    timestamp: torch.Tensor  # ()
    imu_t: torch.Tensor  # (I,)
    imu_w: torch.Tensor  # (I,3)
    imu_a: torch.Tensor  # (I,3)
    imu_mask: torch.Tensor  # (I,)
    feat_ids: torch.Tensor  # (K,) int32
    feat_uv: torch.Tensor  # (K,4)
    feat_mask: torch.Tensor  # (K,)
    active: bool  # gravity initialized: process this frame (host value)


class StepOutput(NamedTuple):
    timestamp: torch.Tensor
    q: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    active: torch.Tensor
    warn_large_update: torch.Tensor
    did_reset: torch.Tensor
    n_cams: torch.Tensor
    n_features: torch.Tensor
    n_lost_overflow: torch.Tensor
    n_update_rows: torch.Tensor
    n_prune_feats: torch.Tensor
    R_imu_cam0: torch.Tensor
    t_cam0_imu: torch.Tensor


def augment_state(state: FilterState, t) -> FilterState:
    imu, cams = state.imu, state.cams
    dtype = state.cov.dtype
    dev = state.cov.device
    N = cams.q.shape[0]
    R_w_i = quat.to_rotation(imu.q)
    R_w_c = imu.R_imu_cam0 @ R_w_i
    t_c_w = imu.p + R_w_i.T @ imu.t_cam0_imu
    q_c = quat.to_quaternion(R_w_c)
    c = cams.count
    at_c = torch.arange(N, device=dev) == c
    cams = cams._replace(
        sid=torch.where(at_c, imu.sid, cams.sid),
        q=torch.where(at_c[:, None], q_c, cams.q),
        p=torch.where(at_c[:, None], t_c_w, cams.p),
        q_null=torch.where(at_c[:, None], q_c, cams.q_null),
        p_null=torch.where(at_c[:, None], t_c_w, cams.p_null),
        timestamp=torch.where(at_c, t, cams.timestamp),
        count=(c + 1).to(torch.int32))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((6, IMU_DIM), dtype=dtype, device=dev)
    J[:3, :3] = imu.R_imu_cam0
    J[:3, 15:18] = eye3
    J[3:6, :3] = quat.skew(R_w_i.T @ imu.t_cam0_imu)
    J[3:6, 12:15] = eye3
    J[3:6, 18:21] = eye3
    P = state.cov
    rows = IMU_DIM + 6 * c + torch.arange(6, device=dev)
    new_rows = J @ P[:IMU_DIM, :]  # (6, D)
    corner = J @ P[:IMU_DIM, :IMU_DIM] @ J.T
    P = P.index_copy(0, rows, new_rows)
    P = P.index_copy(1, rows, new_rows.T)
    P[rows[:, None], rows[None, :]] = corner
    return state._replace(cams=cams, cov=(P + P.T) / 2.0)


def add_observations(state: FilterState, feat_ids, feat_uv, feat_mask) -> FilterState:
    table = state.features
    M = table.fid.shape[0]
    K = feat_ids.shape[0]
    cslot = (state.cams.count - 1).long().expand(K)
    curr_num = table.valid.to(torch.int32).sum()
    match = feat_mask[:, None] & table.valid[None, :] & (feat_ids[:, None] == table.fid[None, :])
    matched = match.any(1)
    m_idx = torch.argmax(match.to(torch.int32), dim=1)
    tracked = matched.to(torch.int32).sum()
    safe_idx = torch.where(matched, m_idx, M)
    obs = set_drop(table.obs, (safe_idx, cslot), feat_uv)
    obs_mask = set_drop(table.obs_mask, (safe_idx, cslot), True)

    new = feat_mask & ~matched
    new_rank = torch.cumsum(new.to(torch.int32), 0) - 1
    n_new = new.to(torch.int32).sum()
    free_sorted = stable_compact_indices(~table.valid, M)
    tgt = torch.where(new, free_sorted[torch.clamp(new_rank, 0, M - 1).long()], M).long()
    table = table._replace(
        fid=set_drop(table.fid, tgt, feat_ids),
        seq=set_drop(table.seq, tgt, (state.next_seq + new_rank).to(torch.int32)),
        obs=set_drop(obs, (tgt, cslot), feat_uv),
        obs_mask=set_drop(obs_mask, (tgt, cslot), True),
        valid=set_drop(table.valid, tgt, True),
        initialized=set_drop(table.initialized, tgt, False),
        position=set_drop(table.position, tgt, 0.0))
    dtype = state.cov.dtype
    rate = tracked.to(dtype) / (curr_num.to(dtype) + 1e-5)
    return state._replace(features=table, next_seq=(state.next_seq + n_new).to(torch.int32),
                          tracking_rate=rate)


def _seen_now(table: FeatureTable, count):
    return table.obs_mask.index_select(1, (count - 1).long().reshape(1))[:, 0]


def _count_lost_candidates(state: FilterState):
    table = state.features
    obs_count = table.obs_mask.to(torch.int32).sum(1)
    cand = table.valid & ~_seen_now(table, state.cams.count) & (obs_count >= 3)
    return cand.to(torch.int32).sum()


def _remove(table: FeatureTable, remove) -> FeatureTable:
    return table._replace(
        valid=table.valid & ~remove, fid=torch.where(remove, -1, table.fid),
        seq=torch.where(remove, INT32_MAX, table.seq),
        obs_mask=table.obs_mask & ~remove[:, None],
        initialized=table.initialized & ~remove)


def _drop_lost_short(state: FilterState) -> FilterState:
    """Delete lost features with < 3 observations (the no-candidate case)."""
    table = state.features
    obs_count = table.obs_mask.to(torch.int32).sum(1)
    remove = table.valid & ~_seen_now(table, state.cams.count) & (obs_count < 3)
    return state._replace(features=_remove(table, remove))


def _triangulate_selected(state: FilterState, params: MsckfParams, config: Config, sel,
                          sel_ok):
    """Triangulate the not-yet-initialized features among ``sel`` over all
    their observations, behind the motion check where it is on; returns
    (state with positions, init_fail).  One K13 launch on the card."""
    table, cams = state.features, state.cams
    position, initialized, init_fail = tri.triangulate_rows(
        cams.q, cams.p, table.obs, table.obs_mask, table.position, table.initialized, sel,
        sel_ok, params.R_cam0_cam1, params.t_cam0_cam1, config.triangulation)
    return state._replace(features=table._replace(position=position,
                                                  initialized=initialized)), init_fail


def _stack_blocks(include, prefix, H_blk, r_blk, R_BUF: int):
    """The included (B, BLK, D) blocks and (B, BLK) residuals placed at their
    row prefixes in an R_BUF-row buffer, with one scatter-add: rows past a
    block's true height are exact zeros, so overlapping blocks only add
    zeros.  Returns (H_buf (R_BUF, D), r_buf (R_BUF,))."""
    B, BLK, D = H_blk.shape
    dev = H_blk.device
    row_idx = torch.where(include[:, None], prefix[:, None] + torch.arange(BLK, device=dev),
                          R_BUF).reshape(-1)
    H_buf = torch.zeros((R_BUF + 1, D), dtype=H_blk.dtype, device=dev).index_add(
        0, row_idx, H_blk.reshape(B * BLK, D))[:R_BUF]
    r_buf = torch.zeros((R_BUF + 1,), dtype=r_blk.dtype, device=dev).index_add(
        0, row_idx, r_blk.reshape(B * BLK))[:R_BUF]
    return H_buf, r_buf


def _remove_lost_once(state: FilterState, params: MsckfParams, config: Config,
                      row_cap: int, L: int):
    """One marginalization pass over up to L lost candidates (map order).
    Returns (state, warn, n_overflow, rows_total) with Python ints."""
    cap = config.capacity
    table, cams = state.features, state.cams
    dev = state.cov.device
    D = cap.state_dim
    obs_count = table.obs_mask.to(torch.int32).sum(1)
    lost = table.valid & ~_seen_now(table, cams.count)
    drop_short = lost & (obs_count < 3)
    cand = lost & (obs_count >= 3)
    sel = smallest_k_indices(torch.where(cand, table.seq, INT32_MAX), L).long()
    sel_mask = cand[sel]
    n_overflow = torch.clamp(cand.to(torch.int32).sum() - L, min=0)

    state, init_fail = _triangulate_selected(state, params, config, sel, sel_mask)
    table = state.features
    proc = sel_mask & ~init_fail
    H_blk, r_blk, rows_f = feature_block_rows(
        cams.q, cams.p, cams.q_null, cams.p_null, table.obs, table.obs_mask, table.position,
        sel, proc, state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, D)
    dof = table.obs_mask[sel].to(torch.int32).sum(1) - 1
    gate_ok = gating_test_batch(H_blk, r_blk, rows_f, state.cov, params.obs_noise,
                                params.chi2_table, dof)
    include = proc & gate_ok
    rows_inc = torch.where(include, rows_f, 0)
    prefix = torch.cumsum(rows_inc, 0) - rows_inc
    include = include & (prefix <= row_cap)  # order-dependent cap (ref :667)
    rows_inc = torch.where(include, rows_f, 0)
    rows_total = rows_inc.sum()

    H_buf, r_buf = _stack_blocks(include, prefix, H_blk, r_blk, cap.max_update_rows)

    any_update, n_rows, n_over = to_host(torch.stack(
        [include.any().to(torch.int64), rows_total.to(torch.int64), n_overflow.to(torch.int64)]))
    warn = torch.zeros((), dtype=torch.bool, device=dev)
    if any_update:
        state, warn = apply_update(state, params, H_buf, r_buf, n_rows)

    selected = torch.zeros_like(cand).index_put((sel,), sel_mask)
    remove = drop_short | selected | (cand if n_over == 0 else torch.zeros_like(cand))
    return state._replace(features=_remove(state.features, remove)), warn, n_over, n_rows


def remove_lost_features(state: FilterState, params: MsckfParams, config: Config,
                         n_cand: int):
    """Lost-feature marginalization with the overflow second pass.  Returns
    (state, warn, n_overflow, rows) with Python ints."""
    if n_cand == 0:
        warn = torch.zeros((), dtype=torch.bool, device=state.cov.device)
        return _drop_lost_short(state), warn, 0, 0
    L = LOST_SMALL if n_cand <= LOST_SMALL else config.capacity.max_lost_per_frame
    state, warn1, n_over1, rows1 = _remove_lost_once(state, params, config,
                                                     MAX_BUDGET_ROWS, L)
    if n_over1 == 0:
        return state, warn1, 0, rows1
    state, warn2, n_over2, _ = _remove_lost_once(
        state, params, config, MAX_BUDGET_ROWS - rows1, config.capacity.max_lost_per_frame)
    return state, warn1 | warn2, n_over2, rows1


def _find_redundant(state: FilterState, count: int):
    """Two camera positions to remove (reference find_redundant_cam_states):
    near-keyframe recent states or the oldest, sorted."""
    cams = state.cams
    key_idx = count - 4
    key_p = cams.p[key_idx]
    key_R = quat.to_rotation(cams.q[key_idx])
    first = torch.zeros((), dtype=torch.int64, device=cams.p.device)
    rms = []
    for i in range(2):
        cam_idx = key_idx + 1 + i
        distance = torch.linalg.norm(cams.p[cam_idx] - key_p)
        rel_q = quat.to_quaternion(quat.to_rotation(cams.q[cam_idx]) @ key_R.T)
        angle = 2.0 * torch.arccos(torch.clamp(rel_q[3], -1.0, 1.0))
        near = (angle < 0.2618) & (distance < 0.4) & (state.tracking_rate > 0.5)
        rms.append(torch.where(near, cam_idx, first))
        first = torch.where(near, first, first + 1)
    return torch.sort(torch.stack(rms)).values


def _two_view_features(state: FilterState, rm):
    table = state.features
    k_inv = table.obs_mask[:, rm].to(torch.int32).sum(1) * table.valid.to(torch.int32)
    return table.valid & (k_inv == 2)


def prune_cam_states(state: FilterState, params: MsckfParams, config: Config, count: int):
    """Camera-pair prune when the window is full.  ``count`` is the window
    size after augmentation (a Python int).  Returns (state, warn, n_two)."""
    dev = state.cov.device
    if count < config.filter.max_cam_state_size:
        return state, torch.zeros((), dtype=torch.bool, device=dev), 0
    M = state.features.obs_mask.shape[0]
    rm = _find_redundant(state, count)
    two = _two_view_features(state, rm)
    n_two = to_host(two.to(torch.int32).sum())
    Kp = 32 if n_two <= 32 else (min(64, M) if n_two <= 64
                                 else min(config.capacity.max_prune_feats, M))
    state, warn = _prune_sized(state, params, config, rm, two, n_two, Kp, count)
    return state, warn, n_two


def _prune_sized(state: FilterState, params: MsckfParams, config: Config, rm, two,
                 n_two: int, Kp: int, count: int):
    table = state.features
    dtype = state.cov.dtype
    dev = state.cov.device
    M, N = table.obs_mask.shape
    D = config.capacity.state_dim
    r0, r1 = rm[0], rm[1]
    sel = smallest_k_indices(torch.where(two, table.seq, INT32_MAX), Kp).long()
    sel_two = two[sel]
    state, init_fail = _triangulate_selected(state, params, config, sel, sel_two)
    table, cams = state.features, state.cams
    proc = sel_two & ~init_fail

    # Jacobian blocks over the two involved cameras only
    H, r_blk, rows_f = feature_block_rows(
        cams.q, cams.p, cams.q_null, cams.p_null, table.obs, table.obs_mask, table.position,
        sel, proc, state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, D, rm=rm)
    H12 = H[:, :, IMU_DIM:IMU_DIM + 12]
    cols = torch.cat([IMU_DIM + 6 * r0 + torch.arange(6, device=dev),
                      IMU_DIM + 6 * r1 + torch.arange(6, device=dev)])
    H_blk = torch.zeros((Kp, 5, D), dtype=dtype, device=dev).index_copy(2, cols, H12)
    gate_ok = gating_test_batch(H_blk, r_blk, rows_f, state.cov, params.obs_noise,
                                params.chi2_table,
                                torch.full((Kp,), 2, dtype=torch.int32, device=dev))
    include = proc & gate_ok
    warn = torch.zeros((), dtype=torch.bool, device=dev)
    if config.filter.prune_rank12:
        if to_host(include.any()):  # JAX's lax.cond on any_update
            state, warn = apply_update_rank12_rows(state, params, H12, r_blk, include, cols)
    else:
        # the stacked update (JAX :560-583): the gated blocks scattered in map
        # order into the max_prune_rows buffer, then K11 on its row tier
        rows_inc = torch.where(include, rows_f, 0)
        H_buf, r_buf = _stack_blocks(include, torch.cumsum(rows_inc, 0) - rows_inc, H_blk,
                                     r_blk, config.capacity.max_prune_rows)
        any_update, n_rows = to_host(torch.stack([include.any().to(torch.int64),
                                                  rows_inc.sum().to(torch.int64)]))
        if any_update:
            state, warn = apply_update(state, params, H_buf, r_buf, n_rows)
    warn = warn | (n_two > Kp)
    return _compact_window(state, rm, count), warn


def _compact_window(state: FilterState, rm, count: int) -> FilterState:
    """Delete the two pruned cameras ``rm``: their observations, their window
    slots and their covariance rows and columns, the rest moved up."""
    table, cams = state.features, state.cams
    dtype = state.cov.dtype
    dev = state.cov.device
    N = table.obs_mask.shape[1]
    slots = torch.arange(N, device=dev)
    doomed = (slots == rm[0]) | (slots == rm[1])
    obs_mask = table.obs_mask & ~doomed[None, :]
    keep = stable_compact_indices(~doomed, N).clamp(0, N - 1).long()
    live = slots < (count - 2)
    unit_q = torch.zeros((4,), dtype=dtype, device=dev)
    unit_q[3] = 1.0
    cams = CamWindow(
        sid=torch.where(live, cams.sid[keep], -1),
        q=torch.where(live[:, None], cams.q[keep], unit_q),
        p=torch.where(live[:, None], cams.p[keep], 0.0),
        q_null=torch.where(live[:, None], cams.q_null[keep], unit_q),
        p_null=torch.where(live[:, None], cams.p_null[keep], 0.0),
        timestamp=torch.where(live, cams.timestamp[keep], 0.0),
        count=(cams.count - 2).to(torch.int32))
    table = table._replace(obs=torch.where(live[None, :, None], table.obs[:, keep], 0.0),
                           obs_mask=torch.where(live[None, :], obs_mask[:, keep], False))
    idx = torch.cat([torch.arange(IMU_DIM, device=dev),
                     (IMU_DIM + 6 * keep[:, None] + torch.arange(6, device=dev)).reshape(-1)])
    row_live = torch.cat([torch.ones(IMU_DIM, dtype=torch.bool, device=dev),
                          live.repeat_interleave(6)])
    P = state.cov[idx][:, idx]
    P = torch.where(row_live[:, None] & row_live[None, :], P, 0.0)
    return state._replace(cams=cams, features=table, cov=P)


def online_reset(state: FilterState, params: MsckfParams, config: Config):
    """Reset window, map and covariance when the position std exceeds the
    threshold.  Returns (state, did_reset) with did_reset a Python bool."""
    thr = config.filter.position_std_threshold
    if thr <= 0:
        return state, False
    pos_std_max = torch.sqrt(torch.diagonal(state.cov)[12:15].max())
    if not to_host(pos_std_max >= thr):
        return state, False
    dtype = state.cov.dtype
    dev = state.cov.device
    N = state.cams.q.shape[0]
    M = state.features.fid.shape[0]
    unit_q = torch.zeros((N, 4), dtype=dtype, device=dev)
    unit_q[:, 3] = 1.0
    cams = CamWindow(
        sid=torch.full((N,), -1, dtype=torch.int32, device=dev), q=unit_q,
        p=torch.zeros((N, 3), dtype=dtype, device=dev), q_null=unit_q.clone(),
        p_null=torch.zeros((N, 3), dtype=dtype, device=dev),
        timestamp=torch.zeros((N,), dtype=dtype, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev))
    f = state.features
    feats = FeatureTable(
        fid=torch.full((M,), -1, dtype=torch.int32, device=dev),
        seq=torch.full((M,), INT32_MAX, dtype=torch.int32, device=dev),
        obs=torch.zeros_like(f.obs), obs_mask=torch.zeros_like(f.obs_mask),
        position=torch.zeros_like(f.position), initialized=torch.zeros_like(f.initialized),
        valid=torch.zeros_like(f.valid))
    return state._replace(cams=cams, features=feats, cov=reset_cov(config, params, dtype)), True


def backend_step(state: FilterState, frame: FrameInput, params: MsckfParams, config: Config):
    """One stereo frame through the estimator; returns (state, StepOutput)."""
    dev = state.cov.device
    dtype = state.cov.dtype

    def flag(v):
        return torch.tensor(bool(v), device=dev)

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    if not frame.active:
        q = torch.zeros(4, dtype=dtype, device=dev)
        q[3] = 1.0
        z3 = torch.zeros(3, dtype=dtype, device=dev)
        return state, StepOutput(
            timestamp=frame.timestamp, q=q, p=z3, v=z3.clone(), active=flag(False),
            warn_large_update=flag(False), did_reset=flag(False), n_cams=state.cams.count,
            n_features=i32(0), n_lost_overflow=i32(0), n_update_rows=i32(0),
            n_prune_feats=i32(0), R_imu_cam0=state.imu.R_imu_cam0,
            t_cam0_imu=state.imu.t_cam0_imu)

    # the first processed frame anchors the clock
    imu = state.imu._replace(timestamp=torch.where(state.started, state.imu.timestamp,
                                                   frame.timestamp))
    state = state._replace(imu=imu, started=flag(True))
    state = propagate(state, params, frame.imu_t, frame.imu_w, frame.imu_a, frame.imu_mask)
    state = augment_state(state, frame.timestamp)
    state = add_observations(state, frame.feat_ids, frame.feat_uv, frame.feat_mask)
    n_cand, count = to_host(torch.stack([_count_lost_candidates(state).to(torch.int32),
                                         state.cams.count]))
    state, warn1, n_overflow, urows = remove_lost_features(state, params, config, n_cand)
    state, warn2, n_two = prune_cam_states(state, params, config, count)
    out = StepOutput(
        timestamp=frame.timestamp, q=state.imu.q, p=state.imu.p, v=state.imu.v,
        active=flag(True), warn_large_update=warn1 | warn2, did_reset=flag(False),
        n_cams=state.cams.count, n_features=state.features.valid.to(torch.int32).sum(),
        n_lost_overflow=i32(n_overflow), n_update_rows=i32(urows), n_prune_feats=i32(n_two),
        R_imu_cam0=state.imu.R_imu_cam0, t_cam0_imu=state.imu.t_cam0_imu)
    # publish happens before the online reset
    state, did_reset = online_reset(state, params, config)
    return state, out._replace(did_reset=flag(did_reset))
