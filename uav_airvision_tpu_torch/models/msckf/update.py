"""Measurement model: stereo reprojection Jacobians, the Householder
left-nullspace projection, the chi-square gate and the EKF updates.

Port of uav_airvision_tpu/models/msckf/update.py, batched over features.
The JAX ``lax.cond`` tiers of the update (row tiers T1/T2/QR) are kept as
Python branches on values read back from the device, so each branch
computes what the JAX branch computes; the gate's (bounds / 32-row tier /
all rows) is decided on the device, in its kernel or, in the plain
version, by a branch-free selection.

Four kernels carry the marginalization path on CUDA tensors, each beside
its plain PyTorch version (``<name>_plain``, which CPU tensors run):
K9 ``feature_block`` (``csrc/feature_block.cu``), K10 ``gating_test_batch``
(``csrc/gate.cu``, the whole gate in one launch),
K11 ``apply_update`` (``csrc/ekf_update.cu``: the update and the error-state
injection in one launch; ``ekf_update`` is its entry without the injection)
and K12 ``apply_update_rank12`` (``csrc/rank12.cu``, likewise, and
``rank12_update``).
"""

from __future__ import annotations

import ctypes

import torch

from ... import kernels
from ...utils import quaternion as quat
from .state import IMU_DIM, FilterState, MsckfParams

GATE_TIER = 32


def stereo_jacobian(cam_q, cam_p, cam_q_null, cam_p_null, p_w, z, gravity, R_c0c1, t_c0c1):
    """Jacobian/residual of stereo observations wrt their camera states
    (OC-EKF projected, with the reference's H_f = -H_x[:, 3:6] quirk).
    cam_* (N, .) broadcast against p_w (B, 1, 3) and z (B, N, 4).
    Returns H_x (B,N,4,6), H_f (B,N,4,3), r (B,N,4)."""
    R_w_c0 = quat.to_rotation(cam_q)  # (N,3,3)
    R_w_c1 = R_c0c1 @ R_w_c0
    t_c1_w = cam_p - torch.einsum("nji,j->ni", R_w_c1, t_c0c1)
    p_c0 = torch.einsum("nij,bnj->bni", R_w_c0, p_w - cam_p)  # (B,N,3)
    p_c1 = torch.einsum("nij,bnj->bni", R_w_c1, p_w - t_c1_w)
    inv_z0 = 1.0 / p_c0[..., 2]
    inv_z1 = 1.0 / p_c1[..., 2]
    zero = torch.zeros_like(inv_z0)
    zrow = torch.stack([zero, zero, zero], dim=-1)
    dz_dpc0 = torch.stack([
        torch.stack([inv_z0, zero, -p_c0[..., 0] * inv_z0 * inv_z0], dim=-1),
        torch.stack([zero, inv_z0, -p_c0[..., 1] * inv_z0 * inv_z0], dim=-1),
        zrow, zrow], dim=-2)  # (B,N,4,3)
    dz_dpc1 = torch.stack([
        zrow, zrow,
        torch.stack([inv_z1, zero, -p_c1[..., 0] * inv_z1 * inv_z1], dim=-1),
        torch.stack([zero, inv_z1, -p_c1[..., 1] * inv_z1 * inv_z1], dim=-1)], dim=-2)
    B = p_c0.shape[0]
    sk0 = quat.skew(p_c0)  # (B,N,3,3)
    dpc0_dxc = torch.cat([sk0, -R_w_c0.expand(B, -1, -1, -1)], dim=-1)  # (B,N,3,6)
    dpc1_dxc = torch.cat([R_c0c1 @ sk0, -R_w_c1.expand(B, -1, -1, -1)], dim=-1)
    A = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc  # (B,N,4,6)
    u = torch.cat([
        torch.einsum("nij,j->ni", quat.to_rotation(cam_q_null), gravity).expand(B, -1, -1),
        torch.einsum("bnij,j->bni", quat.skew(p_w - cam_p_null), gravity)], dim=-1)  # (B,N,6)
    Au = torch.einsum("bnij,bnj->bni", A, u)
    H_x = A - Au[..., :, None] * u[..., None, :] / (u * u).sum(-1)[..., None, None]
    H_f = -H_x[..., 3:6]
    pred = torch.cat([p_c0[..., :2] * inv_z0[..., None], p_c1[..., :2] * inv_z1[..., None]], -1)
    return H_x, H_f, z - pred


def stacked_tile(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity, R_c0c1,
                 t_c0c1):
    """[H_f | r | H_x] (B, 4N, 4 + 21 + 6N) of B features, the observing
    slots' rows first, and n_obs (B,): the tile that ``feature_block``
    projects onto the left nullspace of H_f."""
    B, N = obs_mask.shape
    dtype = p_w.dtype
    Hx, Hf, r = stereo_jacobian(cams_q, cams_p, cams_qn, cams_pn, p_w[:, None, :], obs,
                                gravity, R_c0c1, t_c0c1)
    m = obs_mask.to(dtype)
    Hx = Hx * m[..., None, None]
    Hf = Hf * m[..., None, None]
    r = r * m[..., None]
    Hx = torch.where(torch.isfinite(Hx), Hx, 0.0)
    Hf = torch.where(torch.isfinite(Hf), Hf, 0.0)
    r = torch.where(torch.isfinite(r), r, 0.0)

    rank = torch.cumsum(obs_mask.to(torch.int32), dim=1) - 1  # (B,N)
    n_obs = obs_mask.to(torch.int32).sum(1)
    slots = torch.arange(N, device=obs.device)
    # P[b, r, s] = 1 iff valid slot s has rank r (row compaction)
    P = ((rank[:, None, :] == slots[None, :, None]) & obs_mask[:, None, :]).to(dtype)
    H_fj = torch.einsum("brs,bsij->brij", P, Hf).reshape(B, 4 * N, 3)
    r_j = torch.einsum("brs,bsi->bri", P, r).reshape(B, 4 * N)
    H_cam = torch.einsum("brs,bsij->brisj", P, Hx).reshape(B, 4 * N, 6 * N)
    H_xj = torch.cat([torch.zeros((B, 4 * N, IMU_DIM), dtype=dtype, device=obs.device),
                      H_cam], dim=-1)
    return torch.cat([H_fj, r_j[..., None], H_xj], dim=-1), n_obs


def feature_block_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                        R_c0c1, t_c0c1, state_dim):
    # three Householder reflections applied to [H_f | r | H_x]
    T, n_obs = stacked_tile(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                            R_c0c1, t_c0c1)  # (B, 4N, 4+D)
    dtype = T.dtype
    rows = torch.arange(T.shape[1], device=obs.device)
    for j in range(3):
        x = torch.where(rows >= j, T[..., j], 0.0)
        normx = torch.sqrt((x * x).sum(-1))
        sign = torch.where(x[:, j] >= 0, 1.0, -1.0).to(dtype)
        v = x.clone()
        v[:, j] = v[:, j] + sign * normx
        vnorm2 = (v * v).sum(-1)
        scale = torch.where(vnorm2 > 1e-30, 2.0 / vnorm2, torch.zeros_like(vnorm2))
        vT = torch.einsum("br,brc->bc", v, T)
        T = T - scale[:, None, None] * (v[:, :, None] * vT[:, None, :])
    return T[:, 3:, 4:], T[:, 3:, 3], (4 * n_obs - 3).to(torch.int32)


def feature_block(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                  R_c0c1, t_c0c1, state_dim):
    """Stacked, nullspace-projected blocks of B features over their masked
    observations.  cams_* (N, .) window slots, obs (B,N,4), obs_mask (B,N),
    p_w (B,3).  Returns (H_proj (B, 4N-3, 21+6N), r_proj (B, 4N-3),
    rows_true (B,)) where only the first 4 n_obs - 3 rows of a block are
    nonzero.  ``state_dim`` is unused (the columns follow from N)."""
    dev = obs.device
    if dev.type == "cpu":
        return feature_block_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w,
                                   gravity, R_c0c1, t_c0c1, state_dim)
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {dev}")
    args = (cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity, R_c0c1, t_c0c1)
    kernels.observe("feature_block", args + (state_dim,))
    out = _feature_block_kernel(*args)
    feature_block.launches += 1
    return out


feature_block.launches = 0


def _feature_block_kernel(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                          R_c0c1, t_c0c1):
    dtype, dev = p_w.dtype, p_w.device
    entry = {torch.float32: "feature_block_f32", torch.float64: "feature_block_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K9 takes float32 or float64, got {dtype}")
    B, N = obs_mask.shape
    cams_q, cams_p, cams_qn, cams_pn, obs, p_w, gravity, R_c0c1, t_c0c1 = (
        x.to(dtype).contiguous()
        for x in (cams_q, cams_p, cams_qn, cams_pn, obs, p_w, gravity, R_c0c1, t_c0c1))
    obs_mask = obs_mask.to(torch.bool).contiguous()
    kernels.check_cuda(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                       R_c0c1, t_c0c1)
    if (cams_q.shape != (N, 4) or cams_qn.shape != (N, 4) or cams_p.shape != (N, 3)
            or cams_pn.shape != (N, 3) or obs.shape != (B, N, 4) or p_w.shape != (B, 3)
            or gravity.shape != (3,) or R_c0c1.shape != (3, 3) or t_c0c1.shape != (3,)):
        raise ValueError("feature_block: inconsistent window / observation shapes")
    R, D = 4 * N - 3, IMU_DIM + 6 * N
    H = torch.empty((B, R, D), dtype=dtype, device=dev)
    r = torch.empty((B, R), dtype=dtype, device=dev)
    rows = torch.empty((B,), dtype=torch.int32, device=dev)
    # the block's 4N x (4 + 6N) tile and its scratch; past the shared memory
    # a block holds, each block's tile lives in a device workspace
    tile = 4 * N * (4 + 6 * N)
    smem = (tile + 4 * N + 4 + 6 * N + 32) * p_w.element_size() + 4 * N
    work = (torch.empty((B * tile,), dtype=dtype, device=dev)
            if smem > kernels.SMEM_PER_BLOCK else None)
    kernels.launch(entry, *(kernels.ptr(x) for x in (cams_q, cams_p, cams_qn, cams_pn)), N,
                   kernels.ptr(obs), kernels.ptr(obs_mask), kernels.ptr(p_w),
                   kernels.ptr(gravity), kernels.ptr(R_c0c1), kernels.ptr(t_c0c1), B,
                   kernels.ptr(H), kernels.ptr(r), kernels.ptr(rows),
                   kernels.ptr(work) if work is not None else None)
    return H, r, rows


def _cholesky(S):
    """Lower Cholesky factor; a factor that fails is NaN, as in JAX."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, L)


def gate_gamma_plain(H, r, cov, obs_noise):
    """gamma = r' S^-1 r per block, S = H P H' + s2 I: H (B,m,D), r (B,m).
    A factorisation that fails gives NaN."""
    m = H.shape[1]
    S = H @ cov @ H.transpose(1, 2) + obs_noise * torch.eye(m, dtype=H.dtype, device=H.device)
    y = torch.linalg.solve_triangular(_cholesky(S), r[..., None], upper=False)[..., 0]
    return (y * y).sum(-1)


def gate_bounds_plain(H, r, cov, obs_noise, thresh):
    """The gate's eigenvalue bounds per block: (pass_sure, fail_sure) with
    pass_sure = r'r < thresh s2 and fail_sure = r'r > thresh (s2 + tr HPH')."""
    rtr = (r * r).sum(-1)
    tr = ((H @ cov) * H).sum((1, 2))
    return rtr < thresh * obs_noise, rtr > thresh * (obs_noise + tr)


def gating_test_batch_plain(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    """Plain version of kernel K10: the JAX function's lax.cond tree as a
    branch-free selection, so it reads nothing back to the host either (both
    gamma tiers are computed and one is selected)."""
    thresh = chi2_table[torch.clamp(dof, 0, chi2_table.shape[0] - 1).long()]
    if H.shape[1] <= GATE_TIER:
        return gate_gamma_plain(H, r, cov, obs_noise) < thresh
    pass_sure, fail_sure = gate_bounds_plain(H, r, cov, obs_noise, thresh)
    any_undecided = (~(pass_sure | fail_sure)).any()
    small = gate_gamma_plain(H[:, :GATE_TIER], r[:, :GATE_TIER], cov, obs_noise) < thresh
    full = gate_gamma_plain(H, r, cov, obs_noise) < thresh
    solve = torch.where(rows_true.max() <= GATE_TIER, small, full)
    return torch.where(any_undecided, solve, pass_sure)


def gating_test_batch(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    """Chi-square gate per feature block: H (B,R,D), r (B,R) (row prefixes
    of larger blocks are taken as they are, no copy), rows_true and dof
    (B,).  Blocks taller than GATE_TIER first try the eigenvalue bounds
    r'r / (s2 + tr HPH') <= gamma <= r'r / s2; the exact Cholesky runs only
    when a block is undecided, on the 32-row prefix when every block fits
    in it.  On CUDA tensors one launch of kernel K10 decides the whole gate
    on the card, with no host read."""
    if H.device.type == "cpu":
        return gating_test_batch_plain(H, r, rows_true, cov, obs_noise, chi2_table, dof)
    if H.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got {H.device}")
    kernels.observe("gating_test_batch", (H, r, rows_true, cov, obs_noise, chi2_table, dof))
    out = _gate_kernel(H, r, rows_true, cov, obs_noise, chi2_table, dof)
    gating_test_batch.launches += 1
    return out


gating_test_batch.launches = 0


def _gate_kernel(H, r, rows_true, cov, obs_noise, chi2_table, dof, with_gamma=False):
    """K10's launch.  Its operands: H and r with contiguous rows (a row
    prefix of a larger block is kept as the view it is), cov, s2 and the
    table in H's type, rows_true int32, dof int32 or int64; at the main
    path's types nothing is cast or copied, and the one allocation holds the
    decisions, the bound flags, gamma and, for blocks too large for a
    block's shared memory, the kernel's workspace.  Returns the decisions,
    and with ``with_gamma`` also gamma (B,), defined where the kernel computed it
    (R <= 32, or some block undecided by the bounds)."""
    dtype = H.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K10 takes float32 or float64, got {dtype}")
    B, R, D = H.shape
    if H.stride(2) != 1 or H.stride(1) != D:
        H = H.contiguous()
    if r.stride(1) != 1:
        r = r.contiguous()
    if cov.dtype != dtype or not cov.is_contiguous():
        cov = cov.to(dtype).contiguous()
    if obs_noise.dtype != dtype:
        obs_noise = obs_noise.to(dtype)
    if chi2_table.dtype != dtype or not chi2_table.is_contiguous():
        chi2_table = chi2_table.to(dtype).contiguous()
    if rows_true.dtype != torch.int32 or not rows_true.is_contiguous():
        rows_true = rows_true.to(torch.int32).contiguous()
    if dof.dtype not in (torch.int32, torch.int64) or not dof.is_contiguous():
        dof = dof.to(torch.int64).contiguous()
    if (r.shape != (B, R) or cov.shape != (D, D) or obs_noise.numel() != 1
            or rows_true.shape != (B,) or dof.shape != (B,) or chi2_table.dim() != 1):
        raise ValueError(f"K10: H {tuple(H.shape)}, r {tuple(r.shape)}, cov {tuple(cov.shape)}, "
                         f"rows_true {tuple(rows_true.shape)}, dof {tuple(dof.shape)}")
    for x in (r, cov, obs_noise, chi2_table, rows_true, dof):
        if x.device != H.device:
            raise ValueError(f"K10: tensors on {H.device} and {x.device}")
    size = H.element_size()
    off = (2 * B + size - 1) // size * size  # gamma's offset, after decisions and flags
    # where even the kernel's smallest layout (H, 16 rows of H P, S) does not
    # fit a block's shared memory, each block's goes to a workspace after gamma
    block = R * D + 16 * D + (R + 1) * (R | 1)
    work = B * block if (block * size + 512 > kernels.SMEM_PER_BLOCK) else 0
    buf = torch.empty(off + (B + work) * size, dtype=torch.uint8, device=H.device)
    base = buf.data_ptr()
    kernels.launch("gate_f32" if dtype == torch.float32 else "gate_f64",
                   kernels.ptr(H), kernels.ptr(r), B, R, D, H.stride(0), r.stride(0),
                   kernels.ptr(rows_true), kernels.ptr(dof), int(dof.dtype == torch.int64),
                   kernels.ptr(cov), kernels.ptr(obs_noise), kernels.ptr(chi2_table),
                   chi2_table.shape[0], ctypes.c_void_p(base), ctypes.c_void_p(base + B),
                   ctypes.c_void_p(base + off),
                   ctypes.c_void_p(base + off + B * size) if work else None)
    out = buf[:B].view(torch.bool)
    return (out, buf[off:].view(dtype)) if with_gamma else out


def update_tiers(D: int):
    T1 = D + 7 - (D + 7) % 8
    return T1, 2 * D


def rank12_update_plain(P, B, r, cols, obs_noise):
    Pc = P[:, cols]
    P12 = Pc[cols, :]
    BtB = B.T @ B
    Btr = B.T @ r
    W = obs_noise * torch.eye(12, dtype=P.dtype, device=P.device) + BtB @ P12
    bsr = torch.linalg.solve(W, Btr)
    G = torch.linalg.solve(W, BtB)
    G = (G + G.T) / 2.0
    delta = Pc @ bsr
    P_new = P - Pc @ G @ Pc.T
    return delta, (P_new + P_new.T) / 2.0


def rank12_update(P, B, r, cols, obs_noise):
    """The camera-prune update for a stack nonzero only in the 12 columns
    ``cols``, in the push-through form that never inverts P12:
    W = s2 I + B'B P12, B' S^-1 r = W^-1 B'r, B' S^-1 B = W^-1 B'B.
    P (D,D), B (n,12), r (n,), cols (12,).  Returns (delta (D,), the
    symmetrised P_new (D,D)).  On CUDA tensors one launch of kernel K12
    (``csrc/rank12.cu``) without the injection; the main path calls
    ``apply_update_rank12``."""
    if P.device.type == "cpu":
        return rank12_update_plain(P, B, r, cols, obs_noise)
    if P.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {P.device}")
    kernels.observe("rank12_update", (P, B, r, cols, obs_noise))
    P_new, delta, _, _ = _rank12_kernel(P, B, r, cols, obs_noise)
    rank12_update.launches += 1
    return delta, P_new


rank12_update.launches = 0


def _operand(x, dtype):
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def _update_launch(P, state, work: int):
    """What the EKF update kernels (K11, K12) take beside their operands:
    ONE allocation holding P_new (D, D), delta (D,), with a ``state`` the
    injected fields (msckf_common.cuh::inject_size) and the too_large flag,
    and ``work`` values of workspace; and the injection's arguments (the
    state's fields, nullptr without a state).  The main path's state fields
    are contiguous and of P's type, so nothing is cast or copied and only
    the pointers are taken (as ints: ctypes passes them as void*).  Returns
    (vals, flag, work pointer, injection arguments, the operands to keep
    alive)."""
    dtype, D = P.dtype, P.shape[0]
    N = state.cams.q.shape[0] if state is not None else 0
    n_out = D * D + D + (28 + 7 * N if state is not None else 0)
    size = P.element_size()
    n_out = (n_out * size + 15) // 16 * 16 // size  # the workspace starts 16-byte aligned
    buf = torch.empty((n_out + work) * size + 1, dtype=torch.uint8, device=P.device)
    vals = buf[:(n_out + work) * size].view(dtype)
    flag = buf[(n_out + work) * size:].view(torch.bool).reshape(())
    base = vals.data_ptr()
    if state is None:
        return vals, flag, base + n_out * size, [None] * 9 + [0, None, None], ()
    imu, cams = state.imu, state.cams
    ops = [imu.q, imu.bg, imu.v, imu.ba, imu.p, imu.R_imu_cam0, imu.t_cam0_imu, cams.q, cams.p,
           cams.count]
    dev = P.get_device()
    for k, x in enumerate(ops):
        want = torch.int32 if k == 9 else dtype
        if x.dtype != want or not x.is_contiguous():
            ops[k] = x = x.to(want).contiguous()
        if x.get_device() != dev:
            raise ValueError(f"EKF update: state tensors on {x.device} and P on {P.device}")
    if (ops[0].numel() != 4 or ops[5].numel() != 9 or ops[7].numel() != 4 * N
            or ops[8].numel() != 3 * N or D != IMU_DIM + 6 * N):
        raise ValueError(f"EKF update: a window of {N} slots and a covariance of {D} rows")
    inject = [x.data_ptr() for x in ops[:9]] + [N, ops[9].data_ptr(), flag.data_ptr()]
    return vals, flag, base + n_out * size, inject, ops


def _injected(state: FilterState, vals, flag, D: int):
    """The state with the fields an update kernel wrote into ``vals``:
    views of the one allocation, no copy."""
    N = state.cams.q.shape[0]
    o = D * D + D
    q, bg, v, ba, p, R, t, cq, cp = vals[o:o + 28 + 7 * N].split_with_sizes(
        (4, 3, 3, 3, 3, 9, 3, 4 * N, 3 * N))
    imu = state.imu._replace(q=q, bg=bg, v=v, ba=ba, p=p, R_imu_cam0=R.view(3, 3), t_cam0_imu=t)
    cams = state.cams._replace(q=cq.view(N, 4), p=cp.view(N, 3))
    return state._replace(imu=imu, cams=cams, cov=vals[:D * D].view(D, D)), flag


def _rank12_kernel(P, B, r, cols, obs_noise, state=None):
    """K12's launch; with a ``state`` it ends in the injection.  Returns
    (P_new, delta, the injected state or None, too_large or None)."""
    dtype = P.dtype
    entry = {torch.float32: "rank12_f32", torch.float64: "rank12_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K12 takes float32 or float64, got {dtype}")
    P = P.contiguous()
    B, r = _operand(B, dtype), _operand(r, dtype)
    cols = cols if cols.dtype == torch.int64 and cols.is_contiguous() else (
        cols.to(torch.int64).contiguous())
    noise = _operand(obs_noise, dtype).reshape(1)
    kernels.check_cuda(P, B, r, cols, noise)
    D, n = P.shape[0], B.shape[0]
    if P.shape != (D, D) or B.shape != (n, 12) or r.shape != (n,) or cols.shape != (12,):
        raise ValueError(f"rank12_update: P {tuple(P.shape)}, B {tuple(B.shape)}, "
                         f"r {tuple(r.shape)}, cols {tuple(cols.shape)}")
    vals, flag, _, inject, _keep = _update_launch(P, state, 0)
    kernels.launch(entry, P.data_ptr(), D, B.data_ptr(), r.data_ptr(), n, cols.data_ptr(),
                   noise.data_ptr(), vals.data_ptr(), *inject)
    P_new, delta = vals[:D * D].view(D, D), vals[D * D:D * D + D]
    if state is None:
        return P_new, delta, None, None
    return (P_new, delta, *_injected(state, vals, flag, D))


def apply_update_rank12(state: FilterState, params: MsckfParams, B, r, cols):
    """EKF update of the camera prune (``rank12_update``), injected into the
    state.  Returns (state, too_large).  On CUDA tensors ONE launch of
    kernel K12 computes the update and the injection; the new state's
    changed fields are views of its one allocation."""
    if state.cov.device.type == "cpu":
        return apply_update_rank12_plain(state, params, B, r, cols)
    if state.cov.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {state.cov.device}")
    kernels.observe("apply_update_rank12", (state, params, B, r, cols))
    _, _, new_state, too_large = _rank12_kernel(state.cov, B, r, cols, params.obs_noise, state)
    apply_update_rank12.launches += 1
    return new_state, too_large


apply_update_rank12.launches = 0


def apply_update_rank12_plain(state: FilterState, params: MsckfParams, B, r, cols):
    return _inject_delta(state, *rank12_update_plain(state.cov, B, r, cols, params.obs_noise))


def ekf_update_plain(P, H_buf, r_buf, obs_noise, rows_true=None):
    dtype = H_buf.dtype
    D = H_buf.shape[1]

    def gain(H, r):
        S = H @ P @ H.T + obs_noise * torch.eye(H.shape[0], dtype=dtype, device=P.device)
        HP = H @ P
        K = torch.cholesky_solve(HP, _cholesky(S), upper=False).T
        return K @ r, K @ H

    T1, T2 = update_tiers(D)
    if rows_true is None or H_buf.shape[0] <= T2:
        delta, KH = gain(H_buf, r_buf)
    elif rows_true <= T1:
        delta, KH = gain(H_buf[:T1], r_buf[:T1])
    elif rows_true <= T2:
        delta, KH = gain(H_buf[:T2], r_buf[:T2])
    else:
        Q, R = torch.linalg.qr(H_buf, mode="reduced")
        delta, KH = gain(R, Q.T @ r_buf)
    P_new = P - KH @ P
    return delta, (P_new + P_new.T) / 2.0


def ekf_update(P, H_buf, r_buf, obs_noise, rows_true=None):
    """The EKF update from the stacked zero-padded buffer: H_buf (R, D),
    r_buf (R,), P (D, D).  ``rows_true`` (a Python int) picks the row tier:
    zero padding rows give zero gain columns, so a prefix covering every true
    row is the same update; past T2 a thin QR compresses the stack first.
    Non-Joseph P <- P - K H P, kept.  Returns (delta (D,), the symmetrised
    P_new (D, D)); a factorisation that fails gives NaN.  On CUDA tensors
    one launch of kernel K11 (``csrc/ekf_update.cu``) without the
    injection; the main path calls ``apply_update``."""
    if P.device.type == "cpu":
        return ekf_update_plain(P, H_buf, r_buf, obs_noise, rows_true)
    if P.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA tensors, got {P.device}")
    kernels.observe("ekf_update", (P, H_buf, r_buf, obs_noise, rows_true))
    P_new, delta, _, _ = _ekf_update_kernel(P, H_buf, r_buf, obs_noise, rows_true)
    ekf_update.launches += 1
    return delta, P_new


ekf_update.launches = 0


def update_tier(n_rows: int, D: int, rows_true) -> str:
    """The row tier ``ekf_update`` takes: "all" (every row of a buffer no
    taller than T2), "T1", "T2" or "QR"."""
    T1, T2 = update_tiers(D)
    if rows_true is None or n_rows <= T2:
        return "all"
    return "T1" if rows_true <= T1 else ("T2" if rows_true <= T2 else "QR")


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _update_layout(m: int, D: int) -> int:
    """Values of K11's working arrays for m rows (ekf_update.cu::layout):
    P, H', [HP | r], S, delta and 1 / U_jj, some rows padded to fours."""
    mp, Cs = _round4(m), _round4(D + 1)
    return _round4(D * D) + D * mp + m * Cs + m * mp + _round4(D) + mp


def _ekf_update_kernel(P, H_buf, r_buf, obs_noise, rows_true, state=None, clocks=None):
    """K11's launch: the whole update of the row tier ``rows_true`` selects,
    and with a ``state`` the injection, in one launch of one block.  On the
    T1 and T2 tiers the kernel factors the true rows only (the rows past
    ``rows_true`` are zero padding and change nothing), on the QR tier it
    first compresses the stack's first max(rows_true, D) rows.  The one
    allocation holds the outputs and the workspace.  ``clocks``, an int64
    CUDA tensor of 7, receives the SM clock at the kernel's phase
    boundaries (tools/kernel_probe.py).  Returns (P_new, delta, the injected
    state or None, too_large or None)."""
    dtype = P.dtype
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise ValueError(f"K11 takes float32 or float64, got {dtype}")
    P, H_buf, r_buf, noise = (_operand(x, dtype) for x in (P, H_buf, r_buf, obs_noise))
    kernels.check_cuda(P, H_buf, r_buf, noise)
    n_rows, D = H_buf.shape
    if P.shape != (D, D) or r_buf.shape != (n_rows,):
        raise ValueError(f"ekf_update: P {tuple(P.shape)}, H {tuple(H_buf.shape)}, "
                         f"r {tuple(r_buf.shape)}")
    tier = update_tier(n_rows, D, rows_true)
    C = D + 1
    if tier == "QR":
        # only the first rows_true rows hold data; the rest reflect to zeros
        m = min(max(int(rows_true), D), n_rows)
        work = _round4(m * C) + max(m + 33 * C + 32, _update_layout(D, D))
    else:
        m = n_rows if tier == "all" else max(int(rows_true), 1)
        work = _update_layout(m, D)
    vals, flag, work_ptr, inject, _keep = _update_launch(P, state, work)
    kernels.launch(f"ekf_update_{suffix}", P.data_ptr(), D, H_buf.data_ptr(), r_buf.data_ptr(),
                   m, int(tier == "QR"), noise.data_ptr(), work_ptr, vals.data_ptr(), *inject,
                   clocks.data_ptr() if clocks is not None else None)
    P_new, delta = vals[:D * D].view(D, D), vals[D * D:D * D + D]
    if state is None:
        return P_new, delta, None, None
    return (P_new, delta, *_injected(state, vals, flag, D))


def apply_update(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true=None):
    """EKF update from the stacked zero-padded buffer (``ekf_update``),
    injected into the state.  Returns (state, too_large).  On CUDA tensors
    ONE launch of kernel K11 computes the update on its row tier and the
    injection; the new state's changed fields are views of its one
    allocation."""
    if state.cov.device.type == "cpu":
        return apply_update_plain(state, params, H_buf, r_buf, rows_true)
    if state.cov.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA tensors, got {state.cov.device}")
    kernels.observe("apply_update", (state, params, H_buf, r_buf, rows_true))
    _, _, new_state, too_large = _ekf_update_kernel(state.cov, H_buf, r_buf, params.obs_noise,
                                                    rows_true, state)
    apply_update.launches += 1
    apply_update.tiers[update_tier(H_buf.shape[0], H_buf.shape[1], rows_true)] += 1
    return new_state, too_large


apply_update.launches = 0
apply_update.tiers = {"T1": 0, "T2": 0, "QR": 0, "all": 0}  # calls per row tier


def apply_update_plain(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true=None):
    return _inject_delta(state, *ekf_update_plain(state.cov, H_buf, r_buf, params.obs_noise,
                                                  rows_true))


def _inject_delta(state: FilterState, delta, P_new):
    """Error-state correction: quaternion boxplus for IMU, extrinsic and
    camera states, the new covariance, and the update-magnitude warning
    (the plain version of the injection that ends kernels K11 and K12)."""
    d_imu = delta[:IMU_DIM]
    imu = state.imu
    dq = quat.small_angle_quaternion(d_imu[:3])
    imu = imu._replace(q=quat.multiply(dq, imu.q), bg=imu.bg + d_imu[3:6],
                       v=imu.v + d_imu[6:9], ba=imu.ba + d_imu[9:12], p=imu.p + d_imu[12:15])
    dq_ext = quat.small_angle_quaternion(d_imu[15:18])
    imu = imu._replace(R_imu_cam0=quat.to_rotation(dq_ext) @ imu.R_imu_cam0,
                       t_cam0_imu=imu.t_cam0_imu + d_imu[18:21])
    cams = state.cams
    N = cams.q.shape[0]
    d_cam = delta[IMU_DIM:].reshape(N, 6)
    live = torch.arange(N, device=delta.device) < cams.count
    q_new = quat.multiply(quat.small_angle_quaternion(d_cam[:, :3]), cams.q)
    cams = cams._replace(q=torch.where(live[:, None], q_new, cams.q),
                         p=torch.where(live[:, None], cams.p + d_cam[:, 3:], cams.p))
    too_large = (torch.linalg.norm(d_imu[6:9]) > 0.5) | (torch.linalg.norm(d_imu[12:15]) > 1.0)
    return state._replace(imu=imu, cams=cams, cov=P_new), too_large
