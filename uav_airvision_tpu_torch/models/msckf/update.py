"""Measurement model: stereo reprojection Jacobians, the Householder
left-nullspace projection, the chi-square gate and the EKF updates.

Port of uav_airvision_tpu/models/msckf/update.py, batched over features.
The JAX ``lax.cond`` tiers (gate bounds / 32-row gate tier, update row
tiers T1/T2/QR) are kept as Python branches on values read back from the
device, so each branch computes what the JAX branch computes.

Four kernels carry the marginalization path on CUDA tensors, each beside
its plain PyTorch version (``<name>_plain``, which CPU tensors run):
K9 ``feature_block`` (``csrc/feature_block.cu``), K10 ``gate_bounds`` and
``gate_gamma`` (``csrc/gate.cu``, the two pieces of ``gating_test_batch``),
K11 ``ekf_update`` (``csrc/ekf_update.cu``, the update of ``apply_update``)
and K12 ``rank12_update`` (``csrc/rank12.cu``, the update of
``apply_update_rank12``).
"""

from __future__ import annotations

import torch

from ... import kernels
from ...device import to_host
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


def feature_block_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                        R_c0c1, t_c0c1, state_dim):
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

    # three Householder reflections applied to [H_f | r | H_x]
    T = torch.cat([H_fj, r_j[..., None], H_xj], dim=-1)  # (B, 4N, 4+D)
    rows = torch.arange(4 * N, device=obs.device)
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
    kernels.launch(entry, *(kernels.ptr(x) for x in (cams_q, cams_p, cams_qn, cams_pn)), N,
                   kernels.ptr(obs), kernels.ptr(obs_mask), kernels.ptr(p_w),
                   kernels.ptr(gravity), kernels.ptr(R_c0c1), kernels.ptr(t_c0c1), B,
                   kernels.ptr(H), kernels.ptr(r), kernels.ptr(rows))
    return H, r, rows


def _cholesky(S):
    """Lower Cholesky factor; a factor that fails is NaN, as in JAX."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, L)


def gate_gamma_plain(H, r, cov, obs_noise):
    m = H.shape[1]
    S = H @ cov @ H.transpose(1, 2) + obs_noise * torch.eye(m, dtype=H.dtype, device=H.device)
    y = torch.linalg.solve_triangular(_cholesky(S), r[..., None], upper=False)[..., 0]
    return (y * y).sum(-1)


def gate_bounds_plain(H, r, cov, obs_noise, thresh):
    rtr = (r * r).sum(-1)
    tr = ((H @ cov) * H).sum((1, 2))
    return rtr < thresh * obs_noise, rtr > thresh * (obs_noise + tr)


def _gate_args(H, r, cov, obs_noise):
    """The kernels' operands: H and r with contiguous rows (a row prefix of a
    larger block is kept as the view it is), cov and s2 in H's type."""
    if H.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K10 takes float32 or float64, got {H.dtype}")
    B, m, D = H.shape
    if H.stride(2) != 1 or H.stride(1) != D:
        H = H.contiguous()
    if r.stride(1) != 1:
        r = r.contiguous()
    cov = cov.to(H.dtype).contiguous()
    noise = obs_noise.to(H.dtype).reshape(1).contiguous()
    if r.shape != (B, m) or cov.shape != (D, D):
        raise ValueError(f"K10: H {tuple(H.shape)}, r {tuple(r.shape)}, cov {tuple(cov.shape)}")
    if H.device != cov.device or r.device != cov.device or noise.device != cov.device:
        raise ValueError(f"K10: tensors on {H.device}, {r.device}, {cov.device}")
    return H, r, cov, noise


def gate_gamma(H, r, cov, obs_noise):
    """gamma = r' S^-1 r per block, S = H P H' + s2 I: H (B,m,D), r (B,m)
    (row prefixes of larger blocks are taken as they are, no copy).  A
    factorisation that fails gives NaN."""
    if H.device.type == "cpu":
        return gate_gamma_plain(H, r, cov, obs_noise)
    if H.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got {H.device}")
    kernels.observe("gate_gamma", (H, r, cov, obs_noise))
    gamma = _gate_gamma_kernel(H, r, cov, obs_noise)
    gate_gamma.launches += 1
    return gamma


def gate_bounds(H, r, cov, obs_noise, thresh):
    """The gate's eigenvalue bounds per block: (pass_sure, fail_sure) with
    pass_sure = r'r < thresh s2 and fail_sure = r'r > thresh (s2 + tr HPH')."""
    if H.device.type == "cpu":
        return gate_bounds_plain(H, r, cov, obs_noise, thresh)
    if H.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got {H.device}")
    kernels.observe("gate_bounds", (H, r, cov, obs_noise, thresh))
    out = _gate_bounds_kernel(H, r, cov, obs_noise, thresh)
    gate_bounds.launches += 1
    return out


gate_gamma.launches = 0
gate_bounds.launches = 0


def _gate_gamma_kernel(H, r, cov, obs_noise):
    dtype = H.dtype
    H, r, cov, noise = _gate_args(H, r, cov, obs_noise)
    B, m, D = H.shape
    gamma = torch.empty((B,), dtype=dtype, device=H.device)
    kernels.launch("gate_gamma_f32" if dtype == torch.float32 else "gate_gamma_f64",
                   kernels.ptr(H), kernels.ptr(r), B, m, D, H.stride(0), r.stride(0),
                   kernels.ptr(cov), kernels.ptr(noise), kernels.ptr(gamma))
    return gamma


def _gate_bounds_kernel(H, r, cov, obs_noise, thresh):
    dtype = H.dtype
    H, r, cov, noise = _gate_args(H, r, cov, obs_noise)
    thresh = thresh.to(dtype).contiguous()
    B, R, D = H.shape
    if thresh.shape != (B,):
        raise ValueError(f"gate_bounds: thresh {tuple(thresh.shape)}")
    pass_sure = torch.empty((B,), dtype=torch.bool, device=H.device)
    fail_sure = torch.empty((B,), dtype=torch.bool, device=H.device)
    kernels.launch("gate_bounds_f32" if dtype == torch.float32 else "gate_bounds_f64",
                   kernels.ptr(H), kernels.ptr(r), B, R, D, H.stride(0), r.stride(0),
                   kernels.ptr(cov), kernels.ptr(noise), kernels.ptr(thresh),
                   kernels.ptr(pass_sure), kernels.ptr(fail_sure))
    return pass_sure, fail_sure


def _gate(bounds, gamma, H, r, rows_true, cov, obs_noise, chi2_table, dof):
    R = H.shape[1]
    thresh = chi2_table[torch.clamp(dof, 0, chi2_table.shape[0] - 1).long()]
    if R <= GATE_TIER:
        return gamma(H, r, cov, obs_noise) < thresh
    pass_sure, fail_sure = bounds(H, r, cov, obs_noise, thresh)
    undecided = ~(pass_sure | fail_sure)
    any_undecided, fits = to_host(torch.stack([undecided.any(),
                                               rows_true.max() <= GATE_TIER]))
    if not any_undecided:
        return pass_sure
    if fits:
        return gamma(H[:, :GATE_TIER], r[:, :GATE_TIER], cov, obs_noise) < thresh
    return gamma(H, r, cov, obs_noise) < thresh


def gating_test_batch(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    """Chi-square gate per feature block: H (B,R,D), r (B,R).  Blocks taller
    than GATE_TIER first try the eigenvalue bounds r'r / (s2 + tr HPH') <=
    gamma <= r'r / s2; the exact Cholesky runs only when a block is
    undecided, on the 32-row prefix when every block fits in it.  Runs the
    K10 kernels on CUDA tensors."""
    if H.device.type == "cuda":
        kernels.observe("gating_test_batch", (H, r, rows_true, cov, obs_noise, chi2_table, dof))
    return _gate(gate_bounds, gate_gamma, H, r, rows_true, cov, obs_noise, chi2_table, dof)


def gating_test_batch_plain(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    return _gate(gate_bounds_plain, gate_gamma_plain, H, r, rows_true, cov, obs_noise,
                 chi2_table, dof)


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
    symmetrised P_new (D,D))."""
    if P.device.type == "cpu":
        return rank12_update_plain(P, B, r, cols, obs_noise)
    if P.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {P.device}")
    kernels.observe("rank12_update", (P, B, r, cols, obs_noise))
    out = _rank12_kernel(P, B, r, cols, obs_noise)
    rank12_update.launches += 1
    return out


rank12_update.launches = 0


def _rank12_kernel(P, B, r, cols, obs_noise):
    dtype = P.dtype
    entry = {torch.float32: "rank12_f32", torch.float64: "rank12_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K12 takes float32 or float64, got {dtype}")
    P = P.contiguous()
    B, r = B.to(dtype).contiguous(), r.to(dtype).contiguous()
    cols = cols.to(torch.int64).contiguous()
    noise = obs_noise.to(dtype).reshape(1).contiguous()
    kernels.check_cuda(P, B, r, cols, noise)
    D, n = P.shape[0], B.shape[0]
    if P.shape != (D, D) or B.shape != (n, 12) or r.shape != (n,) or cols.shape != (12,):
        raise ValueError(f"rank12_update: P {tuple(P.shape)}, B {tuple(B.shape)}, "
                         f"r {tuple(r.shape)}, cols {tuple(cols.shape)}")
    delta = torch.empty((D,), dtype=dtype, device=P.device)
    P_new = torch.empty_like(P)
    kernels.launch(entry, kernels.ptr(P), D, kernels.ptr(B), kernels.ptr(r), n,
                   kernels.ptr(cols), kernels.ptr(noise), kernels.ptr(delta),
                   kernels.ptr(P_new))
    return delta, P_new


def apply_update_rank12(state: FilterState, params: MsckfParams, B, r, cols):
    """EKF update of the camera prune (``rank12_update``, kernel K12 on CUDA
    tensors), injected into the state.  Returns (state, too_large)."""
    return _inject_delta(state, *rank12_update(state.cov, B, r, cols, params.obs_noise))


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
    P_new (D, D)); a factorisation that fails gives NaN.  Kernel K11
    (``csrc/ekf_update.cu``) on CUDA tensors; shapes are dynamic there, so
    on the T1 and T2 tiers it takes the ``rows_true`` prefix itself."""
    if P.device.type == "cpu":
        return ekf_update_plain(P, H_buf, r_buf, obs_noise, rows_true)
    if P.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA tensors, got {P.device}")
    kernels.observe("ekf_update", (P, H_buf, r_buf, obs_noise, rows_true))
    out = _ekf_update_kernel(P, H_buf, r_buf, obs_noise, rows_true)
    ekf_update.launches += 1
    ekf_update.tiers[update_tier(H_buf.shape[0], H_buf.shape[1], rows_true)] += 1
    return out


ekf_update.launches = 0
ekf_update.tiers = {"T1": 0, "T2": 0, "QR": 0, "all": 0}  # calls per row tier


def update_tier(n_rows: int, D: int, rows_true) -> str:
    """The row tier ``ekf_update`` takes: "all" (every row of a buffer no
    taller than T2), "T1", "T2" or "QR"."""
    T1, T2 = update_tiers(D)
    if rows_true is None or n_rows <= T2:
        return "all"
    return "T1" if rows_true <= T1 else ("T2" if rows_true <= T2 else "QR")


def _ekf_update_kernel(P, H_buf, r_buf, obs_noise, rows_true):
    dtype, dev = P.dtype, P.device
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise ValueError(f"K11 takes float32 or float64, got {dtype}")
    P = P.contiguous()
    H_buf, r_buf = H_buf.to(dtype).contiguous(), r_buf.to(dtype).contiguous()
    noise = obs_noise.to(dtype).reshape(1).contiguous()
    kernels.check_cuda(P, H_buf, r_buf, noise)
    n_rows, D = H_buf.shape
    if P.shape != (D, D) or r_buf.shape != (n_rows,):
        raise ValueError(f"ekf_update: P {tuple(P.shape)}, H {tuple(H_buf.shape)}, "
                         f"r {tuple(r_buf.shape)}")
    if update_tiers(D)[1] > 1024:
        raise ValueError(f"K11 factors at most 1024 rows in one block, T2 = {2 * D}")
    tier = update_tier(n_rows, D, rows_true)
    if tier == "QR":
        # only the first rows_true rows hold data; the rest reflect to zeros
        n = min(max(int(rows_true), D), n_rows)
        work = torch.empty((n * (D + 1),), dtype=dtype, device=dev)
        H = torch.empty((D, D), dtype=dtype, device=dev)
        r = torch.empty((D,), dtype=dtype, device=dev)
        kernels.launch(f"ekf_qr_{suffix}", kernels.ptr(H_buf), kernels.ptr(r_buf), n, D,
                       kernels.ptr(work), kernels.ptr(H), kernels.ptr(r))
    elif tier == "all":
        H, r = H_buf, r_buf
    else:
        # rows past rows_true are zero padding and change nothing (the tier
        # argument): the kernel factors the true rows only, not the tier's
        m = max(int(rows_true), 1)
        H, r = H_buf[:m], r_buf[:m]
    m = H.shape[0]
    work = torch.empty((2 * D * m + m * m + D * D,), dtype=dtype, device=dev)
    delta = torch.empty((D,), dtype=dtype, device=dev)
    P_new = torch.empty_like(P)
    kernels.launch(f"ekf_update_{suffix}", kernels.ptr(P), D, kernels.ptr(H), kernels.ptr(r), m,
                   kernels.ptr(noise), kernels.ptr(work), kernels.ptr(delta), kernels.ptr(P_new))
    return delta, P_new


def apply_update(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true=None):
    """EKF update from the stacked zero-padded buffer (``ekf_update``, kernel
    K11 on CUDA tensors), injected into the state.  Returns (state,
    too_large)."""
    return _inject_delta(state, *ekf_update(state.cov, H_buf, r_buf, params.obs_noise,
                                            rows_true))


def apply_update_plain(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true=None):
    return _inject_delta(state, *ekf_update_plain(state.cov, H_buf, r_buf, params.obs_noise,
                                                  rows_true))


def _inject_delta(state: FilterState, delta, P_new):
    """Error-state correction: quaternion boxplus for IMU, extrinsic and
    camera states, the new covariance, and the update-magnitude warning."""
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
