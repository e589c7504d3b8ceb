"""The per-frame MSCKF step: propagation, state augmentation, observation
upsert, lost-feature marginalization, camera-pair pruning and online reset.

Port of uav_airvision_tpu/models/msckf/step.py (``backend_step`` and the
functions it calls, under every filter and triangulation option, and the
fleet's batched ``backend_step_fleet`` :741-1083).  Each ``lax.cond``
becomes a Python branch on values read back from the device with
``device.to_host`` (one read per decision group; in the fleet's step one
read per group for all its instances), and each ``.at[].set(mode="drop")``
scatter becomes a scatter into a dump row (``gridops.set_drop``), so the
step needs no boolean indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import Config
from ...device import to_host
from ...ops.gridops import set_drop, smallest_k_indices, stable_compact_indices
from ...utils import quaternion as quat
from ...utils import tree
from ...utils.profiling import count, span
from . import triangulation as tri
from .propagation import propagate
from .state import (IMU_DIM, INT32_MAX, CamWindow, FeatureTable, FilterState, MsckfParams,
                    reset_cov)
from .update import (apply_update, apply_update_fleet, apply_update_rank12_rows,
                     apply_update_rank12_rows_fleet, feature_block_rows, gating_test_batch)

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


# The feature-table helpers below take one state or a fleet's (a leading
# instance axis on every leaf): their operations are exact.

def _seen_now(table: FeatureTable, count):
    idx = (count - 1).long()[..., None, None].expand(table.obs_mask.shape[:-1] + (1,))
    return table.obs_mask.gather(-1, idx)[..., 0]


def _count_lost_candidates(state: FilterState):
    table = state.features
    obs_count = table.obs_mask.to(torch.int32).sum(-1)
    cand = table.valid & ~_seen_now(table, state.cams.count) & (obs_count >= 3)
    return cand.to(torch.int32).sum(-1)


def _remove(table: FeatureTable, remove) -> FeatureTable:
    return table._replace(
        valid=table.valid & ~remove, fid=torch.where(remove, -1, table.fid),
        seq=torch.where(remove, INT32_MAX, table.seq),
        obs_mask=table.obs_mask & ~remove[..., None],
        initialized=table.initialized & ~remove)


def _drop_lost_short(state: FilterState) -> FilterState:
    """Delete lost features with < 3 observations (the no-candidate case)."""
    table = state.features
    obs_count = table.obs_mask.to(torch.int32).sum(-1)
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
    zeros.  The scatter's buffer holds every row a block can reach (a
    prefix is at most the rows of the blocks before it) and a sentinel row
    for the excluded blocks; rows past R_BUF are cut off with it (JAX's
    ``mode="drop"``).  Returns (H_buf (R_BUF, D), r_buf (R_BUF,))."""
    B, BLK, D = H_blk.shape
    dev = H_blk.device
    n = max(R_BUF, B * BLK)
    row_idx = torch.where(include[:, None], prefix[:, None] + torch.arange(BLK, device=dev),
                          n).reshape(-1)
    H_buf = torch.zeros((n + 1, D), dtype=H_blk.dtype, device=dev).index_add(
        0, row_idx, H_blk.reshape(B * BLK, D))[:R_BUF]
    r_buf = torch.zeros((n + 1,), dtype=r_blk.dtype, device=dev).index_add(
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
        [include.any().to(torch.int64), rows_total.to(torch.int64), n_overflow.to(torch.int64)]),
        "be.lost_update")
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
    n_two = to_host(two.to(torch.int32).sum(), "be.prune_two_view")
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
        if to_host(include.any(), "be.prune_update"):  # JAX's lax.cond on any_update
            state, warn = apply_update_rank12_rows(state, params, H12, r_blk, include, cols)
    else:
        # the stacked update (JAX :560-583): the gated blocks scattered in map
        # order into the max_prune_rows buffer, then K11 on its row tier
        rows_inc = torch.where(include, rows_f, 0)
        H_buf, r_buf = _stack_blocks(include, torch.cumsum(rows_inc, 0) - rows_inc, H_blk,
                                     r_blk, config.capacity.max_prune_rows)
        any_update, n_rows = to_host(torch.stack([include.any().to(torch.int64),
                                                  rows_inc.sum().to(torch.int64)]),
                                     "be.prune_update")
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
    if not to_host(pos_std_max >= thr, "be.reset"):
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
    with span("backend"):
        dev = state.cov.device
        dtype = state.cov.dtype

        def flag(v):
            return torch.tensor(bool(v), device=dev)

        def i32(v):
            return torch.as_tensor(v, dtype=torch.int32, device=dev)

        if not frame.active:
            with span("be.subset"):  # the inactive step's skip row
                q = torch.zeros(4, dtype=dtype, device=dev)
                q[3] = 1.0
                z3 = torch.zeros(3, dtype=dtype, device=dev)
                return state, StepOutput(
                    timestamp=frame.timestamp, q=q, p=z3, v=z3.clone(), active=flag(False),
                    warn_large_update=flag(False), did_reset=flag(False),
                    n_cams=state.cams.count, n_features=i32(0), n_lost_overflow=i32(0),
                    n_update_rows=i32(0), n_prune_feats=i32(0),
                    R_imu_cam0=state.imu.R_imu_cam0, t_cam0_imu=state.imu.t_cam0_imu)

        # the first processed frame anchors the clock
        imu = state.imu._replace(timestamp=torch.where(state.started, state.imu.timestamp,
                                                       frame.timestamp))
        state = state._replace(imu=imu, started=flag(True))
        with span("be.propagate"):
            state = propagate(state, params, frame.imu_t, frame.imu_w, frame.imu_a,
                              frame.imu_mask)
        with span("be.augment"):
            state = augment_state(state, frame.timestamp)
        with span("be.observe"):
            state = add_observations(state, frame.feat_ids, frame.feat_uv, frame.feat_mask)
            n_cand, n_cams = to_host(torch.stack([_count_lost_candidates(state).to(torch.int32),
                                                  state.cams.count]), "be.candidates")
        with span("be.lost"):
            state, warn1, n_overflow, urows = remove_lost_features(state, params, config, n_cand)
        with span("be.prune"):
            state, warn2, n_two = prune_cam_states(state, params, config, n_cams)
        out = StepOutput(
            timestamp=frame.timestamp, q=state.imu.q, p=state.imu.p, v=state.imu.v,
            active=flag(True), warn_large_update=warn1 | warn2, did_reset=flag(False),
            n_cams=state.cams.count, n_features=state.features.valid.to(torch.int32).sum(),
            n_lost_overflow=i32(n_overflow), n_update_rows=i32(urows), n_prune_feats=i32(n_two),
            R_imu_cam0=state.imu.R_imu_cam0, t_cam0_imu=state.imu.t_cam0_imu)
        # publish happens before the online reset
        with span("be.reset"):
            state, did_reset = online_reset(state, params, config)
        return state, out._replace(did_reset=flag(did_reset))


# ---------------------------------------------------------------------------
# The fleet's step (JAX step.py:741-1083): every leaf with a leading instance
# axis.  Each decision group is ONE host read for the whole fleet, and each
# stage runs once, on the instances that need it (gathered by index where
# not all do, put back after; the JAX package's power-of-two prefix ladder
# only keeps XLA's shapes static), with the widest tier any of them needs
# (a wider tier pads with masked rows: the result is each instance's own).
# K14, K13, K9 and K10 take the instance axis (one launch a stage); K11 and
# K12 launch once per updating instance into one allocation.
# ---------------------------------------------------------------------------

def _index(idx: list, dev) -> torch.Tensor:
    """Host indices as a device tensor, copied without a host sync."""
    t = torch.tensor(idx, dtype=torch.int64)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _on_subset(flags: list, st, stage):
    """``stage(sub)`` (-> (state, outputs (S',...))) on the instances whose
    host flag is set, gathered by index where not all are; the others keep
    their state and get zero outputs.  Returns (state, outputs (S, ...))."""
    on = [b for b, f in enumerate(flags) if f]
    if len(on) == len(flags):
        return stage(st)
    count("be.subset.gathers")
    with span("be.subset"):
        idx = _index(on, st.cov.device)
        sub = tree.map_leaves(lambda x: x.index_select(0, idx), st)
    sub, outs = stage(sub)
    with span("be.subset"):
        st = tree.map_leaves(lambda x, y: x.index_copy(0, idx, y), st, sub)
        return st, tuple(o.new_zeros((len(flags),) + o.shape[1:]).index_copy(0, idx, o)
                         for o in outs)


def _rows(x, idx):
    """x (S, n, ...) at each instance's indices idx (S, k): (S, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _small_mm(a, b):
    """a @ b of a fleet's 3 x 3 blocks (S, 3, k) @ (S, k, n) on the CPU,
    where PyTorch takes a batched product of fewer than 400 multiply-adds in
    its own loop, which rounds otherwise than the BLAS kernel that a single
    step's 2D product takes; padded to 8 x 8 the batched product goes to
    BLAS too, and an instance's bits are its single step's."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    ap = a.new_zeros(a.shape[:-2] + (8, 8))
    bp = b.new_zeros(b.shape[:-2] + (8, 8))
    ap[..., :m, :k] = a
    bp[..., :k, :n] = b
    return (ap @ bp)[..., :m, :n]


def _each(fn, *xs):
    """fn of each instance's slices, stacked: one 2D product an instance."""
    return torch.stack([fn(*(x[b] for x in xs)) for b in range(xs[0].shape[0])])


# On the card cuBLAS rounds a batched product of augment_state's shapes
# otherwise than the single step's 2D product, unless that 2D product's left
# operand is a transposed view (measured on the H100: a batched 3x3 product
# equal to the 2D product of a transposed-view operand on every sample, of a
# contiguous one on 14%; J P[:21] on 36%; R^T t differed in the fleet's
# step): those products are one 2D product an instance there, so that each
# instance keeps its single step's bits.


def _pose_products(imu, params: MsckfParams, R_w_i):
    """(R_imu_cam0 R_w_i, R_w_i^T t_cam0_imu) of every instance, with its
    single step's bits.  A single step's R_imu_cam0 is the transposed view
    ``make_params`` builds until its first update's injection leaves a
    contiguous one: on the card an instance whose R_imu_cam0 is still its
    initial value takes the batched product, the others a 2D product each."""
    R, t = imu.R_imu_cam0, imu.t_cam0_imu
    if R.device.type == "cpu":
        return _small_mm(R, R_w_i), _small_mm(R_w_i.transpose(-1, -2), t[..., None])[..., 0]
    fresh = (R == params.R_imu_cam0_init.to(R.dtype)).flatten(1).all(1)
    return (torch.where(fresh[:, None, None], R @ R_w_i, _each(torch.mm, R, R_w_i)),
            _each(lambda r, x: r.T @ x, R_w_i, t))


def _cov_products(J, P):
    """(J P[:21], J P[:21, :21] J^T) of every instance, with its single
    step's bits: batched on the CPU, a 2D product an instance on the card."""
    if P.device.type == "cpu":
        return J @ P[:, :IMU_DIM, :], J @ P[:, :IMU_DIM, :IMU_DIM] @ J.transpose(-1, -2)
    return (_each(lambda j, p: j @ p[:IMU_DIM, :], J, P),
            _each(lambda j, p: j @ p[:IMU_DIM, :IMU_DIM] @ j.T, J, P))


def _augment_fleet(state: FilterState, params: MsckfParams, t) -> FilterState:
    """``augment_state`` of every instance; t (S,)."""
    imu, cams = state.imu, state.cams
    dtype, dev = state.cov.dtype, state.cov.device
    S, N = cams.q.shape[:2]
    R_w_i = quat.to_rotation(imu.q)
    R_w_c, t_i = _pose_products(imu, params, R_w_i)
    t_c_w = imu.p + t_i
    q_c = quat.to_quaternion(R_w_c)
    c = cams.count
    at_c = torch.arange(N, device=dev) == c[:, None]
    cams = cams._replace(
        sid=torch.where(at_c, imu.sid[:, None], cams.sid),
        q=torch.where(at_c[..., None], q_c[:, None], cams.q),
        p=torch.where(at_c[..., None], t_c_w[:, None], cams.p),
        q_null=torch.where(at_c[..., None], q_c[:, None], cams.q_null),
        p_null=torch.where(at_c[..., None], t_c_w[:, None], cams.p_null),
        timestamp=torch.where(at_c, t[:, None], cams.timestamp),
        count=(c + 1).to(torch.int32))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((S, 6, IMU_DIM), dtype=dtype, device=dev)
    J[:, :3, :3] = imu.R_imu_cam0
    J[:, :3, 15:18] = eye3
    J[:, 3:6, :3] = quat.skew(t_i)
    J[:, 3:6, 12:15] = eye3
    J[:, 3:6, 18:21] = eye3
    new_rows, corner = _cov_products(J, state.cov)  # (S, 6, D), (S, 6, 6)
    rows = IMU_DIM + 6 * c[:, None].long() + torch.arange(6, device=dev)  # (S, 6)
    inst = torch.arange(S, device=dev)[:, None]
    P = state.cov.clone()
    P[inst, rows] = new_rows
    P[inst, :, rows] = new_rows
    P[inst[..., None], rows[:, :, None], rows[:, None, :]] = corner
    return state._replace(cams=cams, cov=(P + P.transpose(-1, -2)) / 2.0)


def _set_drop_fleet(x, idx, val):
    """``set_drop`` of each instance: idx indexes the axes after the
    instance axis, index len(x[b]) of the first drops."""
    S, n = x.shape[:2]
    ext = torch.cat([x, x[:, :1]], 1)
    idx = idx if isinstance(idx, tuple) else (idx,)
    inst = torch.arange(S, device=x.device).view((S,) + (1,) * (idx[0].dim() - 1))
    ext[(inst,) + idx] = val
    return ext[:, :n]


def _add_observations_fleet(state: FilterState, feat_ids, feat_uv, feat_mask) -> FilterState:
    """``add_observations`` of every instance: feat_* (S, K, ...)."""
    table = state.features
    S, M = table.fid.shape
    K = feat_ids.shape[1]
    cslot = (state.cams.count - 1).long()[:, None].expand(S, K)
    curr_num = table.valid.to(torch.int32).sum(1)
    match = (feat_mask[:, :, None] & table.valid[:, None, :]
             & (feat_ids[:, :, None] == table.fid[:, None, :]))
    matched = match.any(2)
    m_idx = torch.argmax(match.to(torch.int32), dim=2)
    tracked = matched.to(torch.int32).sum(1)
    safe_idx = torch.where(matched, m_idx, M)
    obs = _set_drop_fleet(table.obs, (safe_idx, cslot), feat_uv)
    obs_mask = _set_drop_fleet(table.obs_mask, (safe_idx, cslot), True)

    new = feat_mask & ~matched
    new_rank = torch.cumsum(new.to(torch.int32), 1) - 1
    n_new = new.to(torch.int32).sum(1)
    free_sorted = stable_compact_indices(~table.valid, M)
    tgt = torch.where(new, free_sorted.gather(1, torch.clamp(new_rank, 0, M - 1).long()),
                      M).long()
    table = table._replace(
        fid=_set_drop_fleet(table.fid, tgt, feat_ids),
        seq=_set_drop_fleet(table.seq, tgt, (state.next_seq[:, None] + new_rank).to(torch.int32)),
        obs=_set_drop_fleet(obs, (tgt, cslot), feat_uv),
        obs_mask=_set_drop_fleet(obs_mask, (tgt, cslot), True),
        valid=_set_drop_fleet(table.valid, tgt, True),
        initialized=_set_drop_fleet(table.initialized, tgt, False),
        position=_set_drop_fleet(table.position, tgt, 0.0))
    dtype = state.cov.dtype
    rate = tracked.to(dtype) / (curr_num.to(dtype) + 1e-5)
    return state._replace(features=table, next_seq=(state.next_seq + n_new).to(torch.int32),
                          tracking_rate=rate)


def _stack_blocks_fleet(include, prefix, H_blk, r_blk, R_BUF: int):
    """``_stack_blocks`` of every instance: (S, K, BLK, D) blocks into
    (S, R_BUF, D) buffers, one scatter-add for the fleet."""
    S, K, BLK, D = H_blk.shape
    dev = H_blk.device
    base = (R_BUF + 1) * torch.arange(S, device=dev)[:, None, None]
    row = torch.where(include[..., None], prefix[..., None] + torch.arange(BLK, device=dev),
                      R_BUF).clamp(max=R_BUF) + base
    H_buf = H_blk.new_zeros((S * (R_BUF + 1), D)).index_add(
        0, row.reshape(-1), H_blk.reshape(-1, D)).view(S, R_BUF + 1, D)[:, :R_BUF]
    r_buf = r_blk.new_zeros((S * (R_BUF + 1),)).index_add(
        0, row.reshape(-1), r_blk.reshape(-1)).view(S, R_BUF + 1)[:, :R_BUF]
    return H_buf, r_buf


def _remove_lost_once_fleet(state: FilterState, params: MsckfParams, config: Config,
                            row_cap, L: int):
    """``_remove_lost_once`` of every instance (row_cap (S,)), the stage's
    kernels launched once for all.  Returns (state, warn, n_overflow,
    rows_total, each (S,), and n_overflow as host ints)."""
    cap = config.capacity
    table, cams = state.features, state.cams
    D = cap.state_dim
    obs_count = table.obs_mask.to(torch.int32).sum(2)
    lost = table.valid & ~_seen_now(table, cams.count)
    drop_short = lost & (obs_count < 3)
    cand = lost & (obs_count >= 3)
    sel = smallest_k_indices(torch.where(cand, table.seq, INT32_MAX), L).long()
    sel_mask = cand.gather(1, sel)
    n_overflow = torch.clamp(cand.to(torch.int32).sum(1) - L, min=0)

    with span("be.lost.triangulate"):
        state, init_fail = _triangulate_selected(state, params, config, sel, sel_mask)
    table = state.features
    proc = sel_mask & ~init_fail
    with span("be.lost.jacobian"):
        H_blk, r_blk, rows_f = feature_block_rows(
            cams.q, cams.p, cams.q_null, cams.p_null, table.obs, table.obs_mask, table.position,
            sel, proc, state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, D)
        dof = _rows(table.obs_mask, sel).to(torch.int32).sum(2) - 1
    with span("be.lost.gate"):
        gate_ok = gating_test_batch(H_blk, r_blk, rows_f, state.cov, params.obs_noise,
                                    params.chi2_table, dof)
    with span("be.lost.stack"):
        include = proc & gate_ok
        rows_inc = torch.where(include, rows_f, 0)
        prefix = torch.cumsum(rows_inc, 1) - rows_inc
        include = include & (prefix <= row_cap[:, None])  # order-dependent cap (ref :667)
        rows_inc = torch.where(include, rows_f, 0)
        rows_total = rows_inc.sum(1)

        H_buf, r_buf = _stack_blocks_fleet(include, prefix, H_blk, r_blk, cap.max_update_rows)
        upd_t = include.any(1)
        any_update, n_rows, n_over = to_host(torch.stack(
            [upd_t.to(torch.int64), rows_total.to(torch.int64), n_overflow.to(torch.int64)]),
            "be.lost_update")
    warn = torch.zeros_like(upd_t)
    if any(any_update):
        with span("be.lost.update"):
            state, warn = apply_update_fleet(state, params, H_buf, r_buf, n_rows, any_update,
                                             upd_t)

    selected = torch.zeros_like(cand).scatter(1, sel, sel_mask)
    remove = drop_short | selected | (cand & (n_overflow == 0)[:, None])
    return (state._replace(features=_remove(state.features, remove)), warn,
            n_overflow.to(torch.int32), rows_total.to(torch.int32), n_over)


def _remove_lost_fleet(state: FilterState, params: MsckfParams, config: Config,
                       n_cand: list):
    """``remove_lost_features`` of instances that all have lost candidates
    (``n_cand`` their host counts), the overflow pass on those that
    overflow.  Returns (state, (warn, n_overflow, rows))."""
    S, dev = len(n_cand), state.cov.device
    count("be.lost.instances", S)
    L = LOST_SMALL if max(n_cand) <= LOST_SMALL else config.capacity.max_lost_per_frame
    budget = torch.full((S,), MAX_BUDGET_ROWS, dtype=torch.int32, device=dev)
    state, warn1, _, rows1, n_over1 = _remove_lost_once_fleet(state, params, config, budget, L)
    if not any(n_over1):
        return state, (warn1, torch.zeros_like(rows1), rows1)

    def second(st):
        idx = [b for b, n in enumerate(n_over1) if n]
        count("be.lost.second_pass", len(idx))
        left = budget - rows1 if len(idx) == S else (budget - rows1).index_select(
            0, _index(idx, dev))
        st, warn2, n_over2, _, _ = _remove_lost_once_fleet(
            st, params, config, left, config.capacity.max_lost_per_frame)
        return st, (warn2, n_over2)

    state, (warn2, n_over2) = _on_subset([n > 0 for n in n_over1], state, second)
    return state, (warn1 | warn2, n_over2, rows1)


def _find_redundant_fleet(state: FilterState):
    """``_find_redundant`` of every instance, at its own window count."""
    cams = state.cams
    S = cams.q.shape[0]
    inst = torch.arange(S, device=cams.q.device)
    key_idx = cams.count.long() - 4
    key_p = cams.p[inst, key_idx]
    key_R = quat.to_rotation(cams.q[inst, key_idx])
    first = torch.zeros_like(key_idx)
    rms = []
    for i in range(2):
        cam_idx = key_idx + 1 + i
        distance = torch.linalg.norm(cams.p[inst, cam_idx] - key_p, dim=-1)
        rel_q = quat.to_quaternion(quat.to_rotation(cams.q[inst, cam_idx])
                                   @ key_R.transpose(-1, -2))
        angle = 2.0 * torch.arccos(torch.clamp(rel_q[:, 3], -1.0, 1.0))
        near = (angle < 0.2618) & (distance < 0.4) & (state.tracking_rate > 0.5)
        rms.append(torch.where(near, cam_idx, first))
        first = torch.where(near, first, first + 1)
    return torch.sort(torch.stack(rms, 1), dim=1).values


def _prune_tier(n_two, M: int, config: Config):
    """The prune's feature tier of ``n_two`` two-view features (host ints
    or a tensor): 32, 64 or max_prune_feats, at most M past 32."""
    if isinstance(n_two, torch.Tensor):
        return torch.where(n_two <= 32, 32, torch.where(n_two <= 64, min(64, M),
                                                        min(config.capacity.max_prune_feats, M)))
    return 32 if n_two <= 32 else (min(64, M) if n_two <= 64
                                   else min(config.capacity.max_prune_feats, M))


def _prune_fleet(state: FilterState, params: MsckfParams, config: Config):
    """``prune_cam_states`` of instances whose windows are all full: one
    host read for the two-view counts, the widest tier among them, one for
    the updates.  Returns (state, (warn, n_two))."""
    table = state.features
    dtype, dev = state.cov.dtype, state.cov.device
    S, M, N = table.obs_mask.shape
    D = config.capacity.state_dim
    count("be.prune.instances", S)
    with span("be.prune.redundant"):
        rm = _find_redundant_fleet(state)
        two = table.valid & ((table.obs_mask.gather(2, rm[:, None, :].expand(S, M, 2))
                              .to(torch.int32).sum(2) * table.valid.to(torch.int32)) == 2)
        n_two_t = two.to(torch.int32).sum(1)
        tiers = [_prune_tier(n, M, config) for n in to_host(n_two_t, "be.prune_two_view")]
    Kp = max(tiers)
    sel = smallest_k_indices(torch.where(two, table.seq, INT32_MAX), Kp).long()
    sel_two = two.gather(1, sel)
    with span("be.prune.triangulate"):
        state, init_fail = _triangulate_selected(state, params, config, sel, sel_two)
    table, cams = state.features, state.cams
    proc = sel_two & ~init_fail

    # Jacobian blocks over the two involved cameras only
    with span("be.prune.jacobian"):
        H, r_blk, rows_f = feature_block_rows(
            cams.q, cams.p, cams.q_null, cams.p_null, table.obs, table.obs_mask, table.position,
            sel, proc, state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, D, rm=rm)
        H12 = H[..., IMU_DIM:IMU_DIM + 12]
        cols = IMU_DIM + 6 * rm.repeat_interleave(6, 1) + torch.arange(6, device=dev).repeat(2)
        H_blk = torch.zeros((S, Kp, 5, D), dtype=dtype, device=dev).scatter(
            3, cols[:, None, None, :].expand(S, Kp, 5, 12), H12)
    with span("be.prune.gate"):
        gate_ok = gating_test_batch(H_blk, r_blk, rows_f, state.cov, params.obs_noise,
                                    params.chi2_table,
                                    torch.full((S, Kp), 2, dtype=torch.int32, device=dev))
    include = proc & gate_ok
    upd_t = include.any(1)
    with span("be.prune.update"):
        if config.filter.prune_rank12:
            upd = to_host(upd_t, "be.prune_update")  # JAX's lax.cond on any_update
            warn = torch.zeros_like(upd_t)
            if any(upd):
                state, warn = apply_update_rank12_rows_fleet(state, params, H12, r_blk, include,
                                                             cols, upd, upd_t, tiers)
        else:
            rows_inc = torch.where(include, rows_f, 0)
            H_buf, r_buf = _stack_blocks_fleet(include, torch.cumsum(rows_inc, 1) - rows_inc,
                                               H_blk, r_blk, config.capacity.max_prune_rows)
            upd, n_rows = to_host(torch.stack([upd_t.to(torch.int64),
                                               rows_inc.sum(1).to(torch.int64)]),
                                  "be.prune_update")
            warn = torch.zeros_like(upd_t)
            if any(upd):
                state, warn = apply_update_fleet(state, params, H_buf, r_buf, n_rows, upd, upd_t)
    warn = warn | (n_two_t > _prune_tier(n_two_t, M, config))
    with span("be.prune.compact"):
        return _compact_window_fleet(state, rm), (warn, n_two_t)


def _compact_window_fleet(state: FilterState, rm) -> FilterState:
    """``_compact_window`` of every instance: its cameras ``rm`` (S, 2)
    deleted at its own window count."""
    table, cams = state.features, state.cams
    dtype, dev = state.cov.dtype, state.cov.device
    S, M, N = table.obs_mask.shape
    slots = torch.arange(N, device=dev)
    doomed = (slots == rm[:, :1]) | (slots == rm[:, 1:])
    obs_mask = table.obs_mask & ~doomed[:, None, :]
    keep = stable_compact_indices(~doomed, N).clamp(0, N - 1).long()
    live = slots < (cams.count[:, None] - 2)
    unit_q = torch.zeros((4,), dtype=dtype, device=dev)
    unit_q[3] = 1.0
    lv = live[..., None]
    cams = CamWindow(
        sid=torch.where(live, cams.sid.gather(1, keep), -1),
        q=torch.where(lv, _rows(cams.q, keep), unit_q),
        p=torch.where(lv, _rows(cams.p, keep), 0.0),
        q_null=torch.where(lv, _rows(cams.q_null, keep), unit_q),
        p_null=torch.where(lv, _rows(cams.p_null, keep), 0.0),
        timestamp=torch.where(live, cams.timestamp.gather(1, keep), 0.0),
        count=(cams.count - 2).to(torch.int32))
    kk = keep[:, None, :].expand(S, M, N)
    table = table._replace(
        obs=torch.where(live[:, None, :, None],
                        table.obs.gather(2, kk[..., None].expand(S, M, N, 4)), 0.0),
        obs_mask=torch.where(live[:, None, :], obs_mask.gather(2, kk), False))
    idx = torch.cat([torch.arange(IMU_DIM, device=dev).expand(S, IMU_DIM),
                     (IMU_DIM + 6 * keep[:, :, None] + torch.arange(6, device=dev)).reshape(S, -1)],
                    1)
    row_live = torch.cat([torch.ones((S, IMU_DIM), dtype=torch.bool, device=dev),
                          live.repeat_interleave(6, 1)], 1)
    D = idx.shape[1]
    P = state.cov.gather(1, idx[:, :, None].expand(S, D, D)).gather(
        2, idx[:, None, :].expand(S, D, D))
    P = torch.where(row_live[:, :, None] & row_live[:, None, :], P, 0.0)
    return state._replace(cams=cams, features=table, cov=P)


def _online_reset_fleet(state: FilterState, params: MsckfParams, config: Config):
    """``online_reset`` of every instance, decided on the card (a select,
    no host read).  Returns (state, did_reset (S,))."""
    S = state.cov.shape[0]
    dev = state.cov.device
    thr = config.filter.position_std_threshold
    if thr <= 0:
        return state, torch.zeros((S,), dtype=torch.bool, device=dev)
    pos_std_max = torch.sqrt(torch.diagonal(state.cov, dim1=1, dim2=2)[:, 12:15].max(1).values)
    do = pos_std_max >= thr
    N, M = state.cams.q.shape[1], state.features.fid.shape[1]
    unit_q = torch.zeros((4,), dtype=state.cov.dtype, device=dev)
    unit_q[3] = 1.0
    cams = CamWindow(sid=-1, q=unit_q, p=0.0, q_null=unit_q, p_null=0.0, timestamp=0.0, count=0)
    feats = FeatureTable(fid=-1, seq=INT32_MAX, obs=0.0, obs_mask=False, position=0.0,
                         initialized=False, valid=False)

    def reset(x, fresh):
        return torch.where(do.view((S,) + (1,) * (x.dim() - 1)), fresh, x)

    return state._replace(
        cams=CamWindow(*(reset(x, f) for x, f in zip(state.cams, cams))),
        features=FeatureTable(*(reset(x, f) for x, f in zip(state.features, feats))),
        cov=reset(state.cov, reset_cov(config, params, state.cov.dtype))), do


def _skip_rows(bstate: FilterState, bframe: FrameInput) -> StepOutput:
    """The skip row (JAX inactive_out :1056-1083) of every instance."""
    S = bstate.cov.shape[0]
    dtype, dev = bstate.cov.dtype, bstate.cov.device
    q = torch.zeros((S, 4), dtype=dtype, device=dev)
    q[:, 3] = 1.0
    no = torch.zeros((S,), dtype=torch.bool, device=dev)
    z = torch.zeros((S,), dtype=torch.int32, device=dev)
    return StepOutput(
        timestamp=bframe.timestamp, q=q, p=q.new_zeros((S, 3)), v=q.new_zeros((S, 3)),
        active=no, warn_large_update=no, did_reset=no, n_cams=bstate.cams.count,
        n_features=z.to(torch.int64), n_lost_overflow=z, n_update_rows=z, n_prune_feats=z,
        R_imu_cam0=bstate.imu.R_imu_cam0, t_cam0_imu=bstate.imu.t_cam0_imu)


def _active_fleet(state: FilterState, frame: FrameInput, params: MsckfParams, config: Config):
    """``backend_step``'s active branch of every instance."""
    S = state.cov.shape[0]
    dev = state.cov.device
    imu = state.imu._replace(timestamp=torch.where(state.started, state.imu.timestamp,
                                                   frame.timestamp))
    state = state._replace(imu=imu, started=torch.ones((S,), dtype=torch.bool, device=dev))
    with span("be.propagate"):
        state = propagate(state, params, frame.imu_t, frame.imu_w, frame.imu_a, frame.imu_mask)
    with span("be.augment"):
        state = _augment_fleet(state, params, frame.timestamp)
    with span("be.observe"):
        state = _add_observations_fleet(state, frame.feat_ids, frame.feat_uv, frame.feat_mask)
        n_cand, n_cams = to_host(torch.stack([_count_lost_candidates(state).to(torch.int32),
                                              state.cams.count]), "be.candidates")
    with span("be.lost"):
        # the lost features too short to marginalize go on every instance; an
        # instance with candidates removes them again in its pass (no change)
        state = _drop_lost_short(state)
        zero = torch.zeros((S,), dtype=torch.int32, device=dev)
        no = torch.zeros((S,), dtype=torch.bool, device=dev)
        warn1, n_over, urows, warn2, n_two = no, zero, zero, no, zero
        has_cand = [n > 0 for n in n_cand]
        if any(has_cand):
            state, (warn1, n_over, urows) = _on_subset(
                has_cand, state,
                lambda st: _remove_lost_fleet(st, params, config, [n for n in n_cand if n > 0]))
    full = [c >= config.filter.max_cam_state_size for c in n_cams]
    if any(full):
        with span("be.prune"):
            state, (warn2, n_two) = _on_subset(full, state,
                                               lambda st: _prune_fleet(st, params, config))
    out = StepOutput(
        timestamp=frame.timestamp, q=state.imu.q, p=state.imu.p, v=state.imu.v,
        active=~no, warn_large_update=warn1 | warn2, did_reset=no, n_cams=state.cams.count,
        n_features=state.features.valid.to(torch.int32).sum(1), n_lost_overflow=n_over,
        n_update_rows=urows, n_prune_feats=n_two.to(torch.int32),
        R_imu_cam0=state.imu.R_imu_cam0, t_cam0_imu=state.imu.t_cam0_imu)
    # publish happens before the online reset
    with span("be.reset"):
        state, did_reset = _online_reset_fleet(state, params, config)
    return state, out._replace(did_reset=did_reset)


def backend_step_fleet(bstate: FilterState, bframe: FrameInput, params: MsckfParams,
                       config: Config):
    """``backend_step`` over a leading instance axis (JAX
    ``backend_step_fleet``, defined equal to ``vmap(backend_step)``): every
    leaf of ``bstate`` and ``bframe`` has one, and ``bframe.active`` is the
    B host flags.  The active instances run the step together: at most six
    host reads for the fleet (the lost candidates and window counts; each
    lost pass's updates, the second only where an instance overflows; the
    prune's two-view counts and its updates; the online reset is a select
    on the card), each stage only on the instances that need it.  Inactive
    instances keep their state and publish the skip row.  Returns (state,
    StepOutput), each with the leading axis; instance b's slice is its
    ``backend_step``'s."""
    with span("backend"):
        act = list(bframe.active)
        on = [b for b, a in enumerate(act) if a]
        with span("be.subset"):
            skip = _skip_rows(bstate, bframe)
        if not on:
            return bstate, skip
        if len(on) == len(act):
            return _active_fleet(bstate, bframe, params, config)
        count("be.subset.gathers")
        with span("be.subset"):
            idx = _index(on, bstate.cov.device)
            frame = FrameInput(*(x.index_select(0, idx) for x in bframe[:-1]),
                               active=[True] * len(on))
            sub = tree.map_leaves(lambda x: x.index_select(0, idx), bstate)
        st, out = _active_fleet(sub, frame, params, config)
        with span("be.subset"):
            return (tree.map_leaves(lambda x, y: x.index_copy(0, idx, y), bstate, st),
                    tree.map_leaves(lambda x, y: x.index_copy(0, idx, y.to(x.dtype)), skip, out))
