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
K9 ``feature_block`` and ``feature_block_rows`` (``csrc/feature_block.cu``;
the second with the back-end's gathers and masks in its launch), K10
``gating_test_batch`` (``csrc/gate.cu``, the whole gate in one launch),
K11 ``apply_update`` (``csrc/ekf_update.cu``: the update and the error-state
injection in one launch; ``ekf_update`` is its entry without the injection)
and K12 ``apply_update_rank12`` (``csrc/rank12.cu``, likewise, and
``rank12_update``; ``apply_update_rank12_rows`` with its call site's masks
in its launch).  ``feature_block_rows`` and ``gating_test_batch`` (and their
plain versions) take a fleet's instance axis too, one launch for the fleet;
so do K11 and K12 (``apply_update_fleet``, ``apply_update_rank12_rows_fleet``:
one launch for a fleet's updating instances, a block (K12: a row of
clusters) an instance, each on its own tier, into one allocation), and
``apply_update`` and ``apply_update_rank12_rows`` are their fleets of one.
"""

from __future__ import annotations

import ctypes

import torch

from ... import kernels
from ...utils import quaternion as quat
from ...utils import profiling, tree
from .state import IMU_DIM, FilterState, MsckfParams

GATE_TIER = 32


def stereo_jacobian(cam_q, cam_p, cam_q_null, cam_p_null, p_w, z, gravity, R_c0c1, t_c0c1):
    """Jacobian/residual of stereo observations wrt their camera states
    (OC-EKF projected, with the reference's H_f = -H_x[:, 3:6] quirk), for S
    instances: cam_* (S, N, .) broadcast against p_w (S, B, 1, 3) and z
    (S, B, N, 4), gravity (S, 3).  Returns H_x (S,B,N,4,6), H_f (S,B,N,4,3),
    r (S,B,N,4)."""
    R_w_c0 = quat.to_rotation(cam_q)  # (S,N,3,3)
    R_w_c1 = R_c0c1 @ R_w_c0
    t_c1_w = cam_p - quat.matvec(R_w_c1.transpose(-1, -2), t_c0c1)
    # a feature's bits whatever B: matvec's sums, not a library product
    p_c0 = quat.matvec(R_w_c0[:, None], p_w - cam_p[:, None])  # (S,B,N,3)
    p_c1 = quat.matvec(R_w_c1[:, None], p_w - t_c1_w[:, None])
    inv_z0 = 1.0 / p_c0[..., 2]
    inv_z1 = 1.0 / p_c1[..., 2]
    zero = torch.zeros_like(inv_z0)
    zrow = torch.stack([zero, zero, zero], dim=-1)
    dz_dpc0 = torch.stack([
        torch.stack([inv_z0, zero, -p_c0[..., 0] * inv_z0 * inv_z0], dim=-1),
        torch.stack([zero, inv_z0, -p_c0[..., 1] * inv_z0 * inv_z0], dim=-1),
        zrow, zrow], dim=-2)  # (S,B,N,4,3)
    dz_dpc1 = torch.stack([
        zrow, zrow,
        torch.stack([inv_z1, zero, -p_c1[..., 0] * inv_z1 * inv_z1], dim=-1),
        torch.stack([zero, inv_z1, -p_c1[..., 1] * inv_z1 * inv_z1], dim=-1)], dim=-2)
    S, B = p_c0.shape[:2]
    sk0 = quat.skew(p_c0)  # (S,B,N,3,3)
    dpc0_dxc = torch.cat([sk0, -R_w_c0[:, None].expand(S, B, -1, -1, -1)], dim=-1)
    dpc1_dxc = torch.cat([R_c0c1 @ sk0, -R_w_c1[:, None].expand(S, B, -1, -1, -1)], dim=-1)
    A = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc  # (S,B,N,4,6)
    u = torch.cat([
        quat.matvec(quat.to_rotation(cam_q_null), gravity[:, None])[:, None].expand(
            S, B, -1, -1),
        quat.matvec(quat.skew(p_w - cam_p_null[:, None]), gravity[:, None, None])],
        dim=-1)  # (S,B,N,6)
    Au = torch.einsum("sbnij,sbnj->sbni", A, u)
    H_x = A - Au[..., :, None] * u[..., None, :] / (u * u).sum(-1)[..., None, None]
    H_f = -H_x[..., 3:6]
    pred = torch.cat([p_c0[..., :2] * inv_z0[..., None], p_c1[..., :2] * inv_z1[..., None]], -1)
    return H_x, H_f, z - pred


def stacked_tile(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity, R_c0c1,
                 t_c0c1):
    """[H_f | r | H_x] (B, 4N, 4 + 21 + 6N) of B features (cams_* (N, .),
    obs (B, N, 4), obs_mask (B, N), p_w (B, 3), gravity (3,)), or (S, B, ...)
    of S instances' (each argument but the extrinsic with a leading axis),
    the observing slots' rows first, and n_obs (B,) or (S, B): the tile
    that ``feature_block`` projects onto the left nullspace of H_f."""
    if cams_q.dim() == 2:
        out = stacked_tile(*tree.one(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity),
                           R_c0c1, t_c0c1)
        return tuple(x[0] for x in out)
    S, B, N = obs_mask.shape
    dtype = p_w.dtype
    Hx, Hf, r = stereo_jacobian(cams_q, cams_p, cams_qn, cams_pn, p_w[..., None, :], obs,
                                gravity, R_c0c1, t_c0c1)
    m = obs_mask.to(dtype)
    Hx = Hx * m[..., None, None]
    Hf = Hf * m[..., None, None]
    r = r * m[..., None]
    Hx = torch.where(torch.isfinite(Hx), Hx, 0.0)
    Hf = torch.where(torch.isfinite(Hf), Hf, 0.0)
    r = torch.where(torch.isfinite(r), r, 0.0)

    rank = torch.cumsum(obs_mask.to(torch.int32), dim=-1) - 1  # (S,B,N)
    n_obs = obs_mask.to(torch.int32).sum(-1)
    slots = torch.arange(N, device=obs.device)
    # P[., r, s] = 1 iff valid slot s has rank r (row compaction)
    P = ((rank[..., None, :] == slots[:, None]) & obs_mask[..., None, :]).to(dtype)
    H_fj = torch.einsum("xbrs,xbsij->xbrij", P, Hf).reshape(S, B, 4 * N, 3)
    r_j = torch.einsum("xbrs,xbsi->xbri", P, r).reshape(S, B, 4 * N)
    H_cam = torch.einsum("xbrs,xbsij->xbrisj", P, Hx).reshape(S, B, 4 * N, 6 * N)
    H_xj = torch.cat([torch.zeros((S, B, 4 * N, IMU_DIM), dtype=dtype, device=obs.device),
                      H_cam], dim=-1)
    return torch.cat([H_fj, r_j[..., None], H_xj], dim=-1), n_obs


def _feature_block_fleet_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                               R_c0c1, t_c0c1):
    # three Householder reflections applied to [H_f | r | H_x]
    T, n_obs = stacked_tile(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                            R_c0c1, t_c0c1)  # (S, B, 4N, 4+D)
    dtype = T.dtype
    rows = torch.arange(T.shape[-2], device=obs.device)
    for j in range(3):
        x = torch.where(rows >= j, T[..., j], 0.0)
        normx = torch.sqrt((x * x).sum(-1))
        sign = torch.where(x[..., j] >= 0, 1.0, -1.0).to(dtype)
        v = x.clone()
        v[..., j] = v[..., j] + sign * normx
        vnorm2 = (v * v).sum(-1)
        scale = torch.where(vnorm2 > 1e-30, 2.0 / vnorm2, torch.zeros_like(vnorm2))
        vT = torch.einsum("sbr,sbrc->sbc", v, T)
        T = T - scale[..., None, None] * (v[..., :, None] * vT[..., None, :])
    return T[..., 3:, 4:], T[..., 3:, 3], (4 * n_obs - 3).to(torch.int32)


def feature_block_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                        R_c0c1, t_c0c1, state_dim):
    out = _feature_block_fleet_plain(*tree.one(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask,
                                           p_w, gravity), R_c0c1, t_c0c1)
    return tuple(x[0] for x in out)


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


def feature_block_rows_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, position, sel,
                             proc, gravity, R_c0c1, t_c0c1, state_dim, rm=None):
    """The back-end's call sites of ``feature_block`` as they stood: the
    gathers of the map rows ``sel`` (and of the window slots ``rm``), the
    blocks, and the blocks whose ``proc`` is false set to zeros, rows 0.
    Of one table, or of a fleet's (every argument but the extrinsic with a
    leading instance axis); one table runs as a fleet of one."""
    if cams_q.dim() == 2:
        out = feature_block_rows_plain(*tree.one(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask,
                                             position, sel, proc, gravity), R_c0c1, t_c0c1,
                                       state_dim, *tree.one(rm))
        return tuple(x[0] for x in out)
    rows = torch.arange(sel.shape[0], device=sel.device)[:, None]
    o, m, pw = obs[rows, sel], obs_mask[rows, sel], position[rows, sel]
    cams = (cams_q, cams_p, cams_qn, cams_pn)
    if rm is not None:
        cams = tuple(c[rows, rm] for c in cams)
        k = rm[:, None, :].expand(-1, sel.shape[1], -1)
        o = o.gather(2, k[..., None].expand(-1, -1, -1, 4))
        m = m.gather(2, k)
    H, r, n_rows = _feature_block_fleet_plain(*cams, o, m, pw, gravity, R_c0c1, t_c0c1)
    H = torch.where(proc[..., None, None], H, 0.0)
    r = torch.where(proc[..., None], r, 0.0)
    n_rows = torch.where(proc, n_rows, 0)
    return H, r, n_rows


def feature_block_rows(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, position, sel, proc,
                       gravity, R_c0c1, t_c0c1, state_dim, rm=None):
    """``feature_block`` of the map rows ``sel`` (B,) of the feature table
    (obs (M, Nw, 4), obs_mask (M, Nw), position (M, 3)) over the window's
    Nw slots, or over its slots ``rm`` (2,) only (the camera prune: N = 2).
    A block whose ``proc`` (B,) is false is zeros with rows_true 0.  A
    fleet's call gives every argument but the extrinsic R_c0c1, t_c0c1 (and
    ``state_dim``) a leading instance axis.  On CUDA tensors one launch of
    K9 gathers, computes and masks, for every instance of a fleet."""
    dev = obs.device
    if dev.type == "cpu":
        return feature_block_rows_plain(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask,
                                        position, sel, proc, gravity, R_c0c1, t_c0c1,
                                        state_dim, rm)
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {dev}")
    args = (cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, position, gravity, R_c0c1, t_c0c1)
    kernels.observe("feature_block_rows", (cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask,
                                           position, sel, proc, gravity, R_c0c1, t_c0c1,
                                           state_dim, rm))
    out = _feature_block_kernel(*args, sel=sel, proc=proc, rm=rm)
    feature_block_rows.launches += 1
    return out


feature_block_rows.launches = 0


def _feature_block_kernel(cams_q, cams_p, cams_qn, cams_pn, obs, obs_mask, p_w, gravity,
                          R_c0c1, t_c0c1, sel=None, proc=None, rm=None, clocks=None):
    """K9's launch, of one instance or (``cams_q`` (S, Nw, 4)) of a fleet's
    S.  Without ``sel`` block b is row b of obs / p_w; without ``rm`` the
    blocks run over every window slot; without ``proc`` every block is
    computed.  ``clocks``: an int64 (6,) tensor for the SM clock at the
    start of (the first instance's) block 0 and at the end of each of its
    five phases."""
    dtype, dev = p_w.dtype, p_w.device
    entry = {torch.float32: "feature_block_f32", torch.float64: "feature_block_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K9 takes float32 or float64, got {dtype}")
    fleet = cams_q.dim() == 3
    S = cams_q.shape[0] if fleet else 1
    lead = cams_q.shape[:1] if fleet else ()
    ins, strides = [], []
    for x, t in ((cams_q, dtype), (cams_p, dtype), (cams_qn, dtype), (cams_pn, dtype),
                 (rm, torch.int64), (obs, dtype), (obs_mask, torch.bool), (p_w, dtype),
                 (sel, torch.int64), (proc, torch.bool), (gravity, dtype)):
        x, st = kernels.per_instance(x, t, fleet) if x is not None else (None, 0)
        ins.append(x)
        strides.append(st)
    cams_q, cams_p, cams_qn, cams_pn, rm, obs, obs_mask, p_w, sel, proc, gravity = ins
    R_c0c1, t_c0c1 = (x.to(dtype).contiguous() for x in (R_c0c1, t_c0c1))
    kernels.check_cuda(R_c0c1, t_c0c1, *(x[0] if fleet else x for x in ins if x is not None))
    M, Nw = obs_mask.shape[-2:]
    N = Nw if rm is None else rm.shape[-1]
    B = M if sel is None else sel.shape[-1]
    if (cams_q.shape != lead + (Nw, 4) or cams_qn.shape != lead + (Nw, 4)
            or cams_p.shape != lead + (Nw, 3) or cams_pn.shape != lead + (Nw, 3)
            or obs.shape != lead + (M, Nw, 4) or p_w.shape != lead + (M, 3)
            or gravity.shape != lead + (3,) or R_c0c1.shape != (3, 3) or t_c0c1.shape != (3,)
            or (sel is not None and sel.shape != lead + (B,))
            or (rm is not None and rm.shape != lead + (N,))
            or (proc is not None and proc.shape != lead + (B,))):
        raise ValueError("feature_block: inconsistent window / observation shapes")
    R, D = 4 * N - 3, IMU_DIM + 6 * N
    H = torch.empty(lead + (B, R, D), dtype=dtype, device=dev)
    r = torch.empty(lead + (B, R), dtype=dtype, device=dev)
    rows = torch.empty(lead + (B,), dtype=torch.int32, device=dev)
    strides += [B * R * D, B * R, B]

    def opt(x):
        return kernels.ptr(x) if x is not None else None

    kernels.launch(entry, *(kernels.ptr(x) for x in (cams_q, cams_p, cams_qn, cams_pn)),
                   opt(rm), N, Nw, kernels.ptr(obs), kernels.ptr(obs_mask), kernels.ptr(p_w),
                   opt(sel), opt(proc), kernels.ptr(gravity), kernels.ptr(R_c0c1),
                   kernels.ptr(t_c0c1), B, kernels.ptr(H), kernels.ptr(r), kernels.ptr(rows), S,
                   kernels.int64s(strides), opt(clocks))
    return H, r, rows


def _cholesky(S):
    """Lower Cholesky factor; a factor that fails is NaN, as in JAX."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, L)


def gate_gamma_plain(H, r, cov, obs_noise):
    """gamma = r' S^-1 r per block, S = H P H' + s2 I: H (..., B, m, D), r
    (..., B, m), cov (..., D, D).  A factorisation that fails gives NaN."""
    m = H.shape[-2]
    S = H @ cov[..., None, :, :] @ H.transpose(-1, -2) + obs_noise * torch.eye(
        m, dtype=H.dtype, device=H.device)
    y = torch.linalg.solve_triangular(_cholesky(S), r[..., None], upper=False)[..., 0]
    return (y * y).sum(-1)


def gate_bounds_plain(H, r, cov, obs_noise, thresh):
    """The gate's eigenvalue bounds per block: (pass_sure, fail_sure) with
    pass_sure = r'r < thresh s2 and fail_sure = r'r > thresh (s2 + tr HPH')."""
    rtr = (r * r).sum(-1)
    tr = ((H @ cov[..., None, :, :]) * H).sum((-2, -1))
    return rtr < thresh * obs_noise, rtr > thresh * (obs_noise + tr)


def gating_test_batch_plain(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    """Plain version of kernel K10: the JAX function's lax.cond tree as a
    branch-free selection, so it reads nothing back to the host either (both
    gamma tiers are computed and one is selected).  Of one instance's
    blocks, or of a fleet's (H (S, B, R, D), r, rows_true and dof with the
    same leading axis, cov (S, D, D)), each instance deciding its own tier;
    one instance runs as a fleet of one."""
    if cov.dim() == 2:
        return gating_test_batch_plain(*tree.one(H, r, rows_true, cov), obs_noise, chi2_table,
                                       dof[None])[0]
    thresh = chi2_table[torch.clamp(dof, 0, chi2_table.shape[0] - 1).long()]
    if H.shape[-2] <= GATE_TIER:
        return gate_gamma_plain(H, r, cov, obs_noise) < thresh
    pass_sure, fail_sure = gate_bounds_plain(H, r, cov, obs_noise, thresh)
    any_undecided = (~(pass_sure | fail_sure)).any(-1, keepdim=True)
    small = gate_gamma_plain(H[..., :GATE_TIER, :], r[..., :GATE_TIER], cov, obs_noise) < thresh
    full = gate_gamma_plain(H, r, cov, obs_noise) < thresh
    solve = torch.where(rows_true.max(-1, keepdim=True).values <= GATE_TIER, small, full)
    return torch.where(any_undecided, solve, pass_sure)


def gating_test_batch(H, r, rows_true, cov, obs_noise, chi2_table, dof):
    """Chi-square gate per feature block: H (B,R,D), r (B,R) (row prefixes
    of larger blocks are taken as they are, no copy), rows_true and dof
    (B,).  Blocks taller than GATE_TIER first try the eigenvalue bounds
    r'r / (s2 + tr HPH') <= gamma <= r'r / s2; the exact Cholesky runs only
    when a block is undecided, on the 32-row prefix when every block fits
    in it.  A fleet's call gives H, r, rows_true, dof and cov a leading
    instance axis; each instance decides on its own blocks and covariance.
    On CUDA tensors one launch of kernel K10 decides the whole gate on the
    card, for every instance of a fleet, with no host read."""
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
    """K10's launch, of one instance's blocks or (cov (S, D, D)) of a
    fleet's.  Its operands: H and r with contiguous rows (a row prefix of a
    larger block is kept as the view it is), cov (each instance's
    contiguous), s2 and the table in H's type, rows_true int32, dof int32 or
    int64; at the main path's types nothing is cast or copied, and the one
    allocation holds the decisions, the bound flags, gamma and, for blocks
    too large for a block's shared memory, the kernel's workspace.  Returns
    the decisions, and with ``with_gamma`` also gamma, defined where the
    kernel computed it (R <= 32, or some block of the instance undecided by
    the bounds)."""
    dtype = H.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K10 takes float32 or float64, got {dtype}")
    fleet = cov.dim() == 3
    S = cov.shape[0] if fleet else 1
    lead = cov.shape[:1] if fleet else ()
    B, R, D = H.shape[-3:]
    if H.stride(-1) != 1 or H.stride(-2) != D:
        H = H.contiguous()
    if r.stride(-1) != 1:
        r = r.contiguous()
    cov, s_p = kernels.per_instance(cov, dtype, fleet)
    if obs_noise.dtype != dtype:
        obs_noise = obs_noise.to(dtype)
    if chi2_table.dtype != dtype or not chi2_table.is_contiguous():
        chi2_table = chi2_table.to(dtype).contiguous()
    rows_true, s_rows = kernels.per_instance(rows_true, torch.int32, fleet)
    if dof.dtype not in (torch.int32, torch.int64):
        dof = dof.to(torch.int64)
    dof, s_dof = kernels.per_instance(dof, dof.dtype, fleet)
    if (H.shape != lead + (B, R, D) or r.shape != lead + (B, R) or cov.shape != lead + (D, D)
            or obs_noise.numel() != 1 or rows_true.shape != lead + (B,)
            or dof.shape != lead + (B,) or chi2_table.dim() != 1):
        raise ValueError(f"K10: H {tuple(H.shape)}, r {tuple(r.shape)}, cov {tuple(cov.shape)}, "
                         f"rows_true {tuple(rows_true.shape)}, dof {tuple(dof.shape)}")
    for x in (r, cov, obs_noise, chi2_table, rows_true, dof):
        if x.device != H.device:
            raise ValueError(f"K10: tensors on {H.device} and {x.device}")
    size = H.element_size()
    n = S * B
    off = (2 * n + size - 1) // size * size  # gamma's offset, after decisions and flags
    # where even the kernel's smallest layout (H, 16 rows of H P, S) does not
    # fit a block's shared memory, each block's goes to a workspace after gamma
    block = R * D + 16 * D + (R + 1) * (R | 1)
    work = n * block if (block * size + 512 > kernels.SMEM_PER_BLOCK) else 0
    buf = torch.empty(off + (n + work) * size, dtype=torch.uint8, device=H.device)
    base = buf.data_ptr()
    strides = [H.stride(0), r.stride(0), s_rows, s_dof, s_p] if fleet else [0] * 5
    kernels.launch("gate_f32" if dtype == torch.float32 else "gate_f64",
                   kernels.ptr(H), kernels.ptr(r), B, R, D, H.stride(-3), r.stride(-2),
                   kernels.ptr(rows_true), kernels.ptr(dof), int(dof.dtype == torch.int64),
                   kernels.ptr(cov), kernels.ptr(obs_noise), kernels.ptr(chi2_table),
                   chi2_table.shape[0], ctypes.c_void_p(base), ctypes.c_void_p(base + n),
                   ctypes.c_void_p(base + off),
                   ctypes.c_void_p(base + off + n * size) if work else None, S,
                   kernels.int64s(strides))
    out = buf[:n].view(torch.bool).view(lead + (B,))
    gamma = buf[off:off + n * size].view(dtype).view(lead + (B,))
    return (out, gamma) if with_gamma else out


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
    ``apply_update_rank12_rows``."""
    if not _on_card(P, "K12"):
        return rank12_update_plain(P, B, r, cols, obs_noise)
    kernels.observe("rank12_update", (P, B, r, cols, obs_noise))
    P_new, delta, _, _ = _rank12_kernel(P, B, r, cols, obs_noise)
    rank12_update.launches += 1
    return delta, P_new


rank12_update.launches = 0

# Instances of one K11 or K12 launch (kMaxInst in ekf_update.cu and
# rank12.cu): a call over more takes one launch per MAX_INST.
MAX_INST = 64


def _launches(n_inst: int) -> int:
    """Launches of one K11 or K12 call over ``n_inst`` instances."""
    return -(-n_inst // MAX_INST)


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (plain version)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {t.device}")
    return True


def _one(state: FilterState) -> FilterState:
    """A single state as a fleet of one (views)."""
    return tree.map_leaves(lambda x: x[None], state)


def _operand(x, dtype):
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def _update_values(D: int, N: int, size: int) -> int:
    """Values an EKF update kernel (K11, K12) writes for an instance: P_new
    (D, D), delta (D,) and, with a window of N slots (N > 0), the injected
    fields (msckf_common.cuh::inject_size), rounded up so that what follows
    starts 16-byte aligned."""
    n_out = D * D + D + (28 + 7 * N if N else 0)
    return (n_out * size + 15) // 16 * 16 // size


def _update_rows(P, N: int, work: int):
    """ONE allocation for the EKF updates (K11, K12) of S instances (P (S,
    D, D), windows of N slots, 0 without the injection): a row per instance
    of ``_update_values`` and ``work`` values of workspace (each row
    16-byte aligned), then the S too_large flags.  Returns (vals (S, row),
    flags (S,))."""
    S, D = P.shape[0], P.shape[-1]
    size = P.element_size()
    row = _update_values(D, N, size) + (work * size + 15) // 16 * 16 // size
    buf = torch.empty(S * row * size + S, dtype=torch.uint8, device=P.device)
    return buf[:S * row * size].view(P.dtype).view(S, row), buf[S * row * size:].view(
        torch.bool)


def _fleet_rows(state: FilterState, work: int):
    """``_update_rows`` of a fleet's state."""
    return _update_rows(state.cov, state.cams.q.shape[1], work)


def _inject_operands(P, state):
    """The injection's arguments of the EKF update kernels (K11, K12) for a
    fleet's ``state`` (None: no injection): the fields' pointers, N and
    count's pointer (ints: ctypes passes them as void*), the fields'
    instance strides, and the operands to keep alive.  The main path's
    fields are of P's type and contiguous per instance, so nothing is cast
    or copied."""
    if state is None:
        return [None] * 9 + [0, None], [0] * 10, ()
    S, D = P.shape[0], P.shape[-1]
    imu, cams = state.imu, state.cams
    N = cams.q.shape[1]
    ops, strides = [], []
    for k, x in enumerate((imu.q, imu.bg, imu.v, imu.ba, imu.p, imu.R_imu_cam0, imu.t_cam0_imu,
                           cams.q, cams.p, cams.count)):
        x, st = kernels.per_instance(x, torch.int32 if k == 9 else P.dtype, True)
        if x.device != P.device:
            raise ValueError(f"EKF update: state tensors on {x.device} and P on {P.device}")
        ops.append(x)
        strides.append(st)
    sizes = (4, 3, 3, 3, 3, 9, 3, 4 * N, 3 * N, 1)
    if (any(x.shape[0] != S or x[0].numel() != n for x, n in zip(ops, sizes))
            or D != IMU_DIM + 6 * N):
        raise ValueError(f"EKF update: a window of {N} slots and a covariance of {D} rows")
    return [x.data_ptr() for x in ops[:9]] + [N, ops[9].data_ptr()], strides, ops


def _single(P, vals, flags, state):
    """(P_new, delta, the injected state or None, too_large or None) of a
    fleet-of-one launch's row."""
    D = P.shape[-1]
    P_new, delta = vals[0, :D * D].view(D, D), vals[0, D * D:D * D + D]
    if state is None:
        return P_new, delta, None, None
    new, too_large = _fleet_injected(_one(state), vals, flags, [True], None)
    return P_new, delta, tree.index(new, 0), too_large[0]


def _rank12_fleet_kernel(P, B, r, cols, obs_noise, idx: list, n_feats: list, state=None,
                         include=None, clocks=None):
    """K12's launch for the instances ``idx`` (host ints) of S: P (S, D, D);
    B (S, n, 12) with r (S, n), or (S, K, R, 12) with r (S, K, R): features
    of R rows each, read in place through their strides (B's columns
    contiguous), instance b taking its first ``n_feats[b]`` and skipping
    those whose ``include`` (S, K) is false; cols (S, 12); with a fleet's
    ``state`` each update ends in its injection.  ONE launch (one per
    MAX_INST instances past that), each instance on its own features as its
    launch alone.  ``clocks``: an int64 (7,) tensor for the SM clock of the
    first instance's block 1 (the first off-diagonal tile pair) at its start
    and at the end of each of its six phases.  Returns (vals (S, row),
    flags (S,)) of ``_update_rows`` (rows of the instances not in ``idx``
    are not written)."""
    dtype = P.dtype
    entry = {torch.float32: "rank12_f32", torch.float64: "rank12_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K12 takes float32 or float64, got {dtype}")
    S, D = P.shape[0], P.shape[-1]
    P, s_P = kernels.per_instance(P, dtype, True)
    if B.dtype != dtype or B.stride(-1) != 1:
        B = B.to(dtype).contiguous()
    if r.dtype != dtype:
        r = r.to(dtype)
    cols, s_c = kernels.per_instance(cols, torch.int64, True)
    noise = _operand(obs_noise, dtype).reshape(1)
    K = B.shape[1]
    if (not idx or P.shape != (S, D, D) or B.ndim not in (3, 4) or B.shape[0] != S
            or B.shape[-1] != 12 or r.shape != B.shape[:-1] or cols.shape != (S, 12)
            or (include is not None and include.shape != (S, K))
            or any(not 1 <= n_feats[b] <= K for b in idx)):
        raise ValueError(f"rank12_update: P {tuple(P.shape)}, B {tuple(B.shape)}, "
                         f"r {tuple(r.shape)}, cols {tuple(cols.shape)}, instances {idx}")
    R = B.shape[2] if B.ndim == 4 else 1
    strides = ((B.stride(1), B.stride(2), r.stride(1), r.stride(2)) if B.ndim == 4
               else (B.stride(1), 0, r.stride(1), 0))
    s_i = 0
    if include is not None:
        include, s_i = kernels.per_instance(include, torch.bool, True)
    kernels.check_cuda(P[0], cols[0], noise, *(x[0] for x in (include,) if x is not None))
    for x in (B, r):
        if x.device != P.device:
            raise ValueError(f"tensor on {x.device}, expected {P.device}")
    N = state.cams.q.shape[1] if state is not None else 0
    vals, flags = _update_rows(P, N, 0)
    inject, s_inj, _keep = _inject_operands(P, state)
    kernels.launch(entry, P.data_ptr(), D, B.data_ptr(), R, *strides[:2], r.data_ptr(),
                   *strides[2:], include.data_ptr() if include is not None else None,
                   cols.data_ptr(), noise.data_ptr(), vals.data_ptr(), *inject, flags.data_ptr(),
                   clocks.data_ptr() if clocks is not None else None, len(idx),
                   kernels.int32s([v for b in idx for v in (b, n_feats[b])]),
                   kernels.int64s([s_P, B.stride(0), r.stride(0), s_i, s_c, vals.shape[1],
                                   *s_inj, 1]))
    return vals, flags


def _rank12_kernel(P, B, r, cols, obs_noise, state=None, clocks=None, include=None):
    """K12's launch of one instance (the fleet launch of one): P (D, D), B
    (n, 12) with r (n,) or (K, R, 12) with r (K, R), cols (12,), include
    (K,) or None, a single ``state`` or None; ``clocks`` as in
    ``_rank12_fleet_kernel``.  Returns (P_new, delta, the injected state or
    None, too_large or None)."""
    vals, flags = _rank12_fleet_kernel(
        P[None], B[None], r[None], cols[None], obs_noise, [0], [B.shape[0]],
        None if state is None else _one(state), None if include is None else include[None],
        clocks)
    return _single(P, vals, flags, state)


def apply_update_rank12(state: FilterState, params: MsckfParams, B, r, cols):
    """EKF update of the camera prune (``rank12_update``), injected into the
    state.  Returns (state, too_large).  On CUDA tensors ONE launch of
    kernel K12 computes the update and the injection; the new state's
    changed fields are views of its one allocation."""
    if not _on_card(state.cov, "K12"):
        return apply_update_rank12_plain(state, params, B, r, cols)
    kernels.observe("apply_update_rank12", (state, params, B, r, cols))
    _, _, new_state, too_large = _rank12_kernel(state.cov, B, r, cols, params.obs_noise, state)
    apply_update_rank12.launches += 1
    return new_state, too_large


apply_update_rank12.launches = 0


def apply_update_rank12_plain(state: FilterState, params: MsckfParams, B, r, cols):
    return _inject_delta(state, *rank12_update_plain(state.cov, B, r, cols, params.obs_noise))


def apply_update_rank12_rows_plain(state: FilterState, params: MsckfParams, H12, r_blk,
                                   include, cols):
    """The prune's call site as it stood: the features whose ``include`` is
    false masked to zeros, the blocks stacked, then ``apply_update_rank12``."""
    K, R = r_blk.shape
    B = torch.where(include[:, None, None], H12, 0.0).reshape(K * R, 12)
    r_s = torch.where(include[:, None], r_blk, 0.0).reshape(K * R)
    return apply_update_rank12_plain(state, params, B, r_s, cols)


def apply_update_rank12_rows(state: FilterState, params: MsckfParams, H12, r_blk, include,
                             cols):
    """``apply_update_rank12`` of the prune's blocks as K9 leaves them: H12
    (K, R, 12) (the 12 columns of the two pruned cameras, a strided slice of
    the (K, R, 21 + 12) blocks is read in place), r_blk (K, R) and include
    (K,): a feature whose ``include`` is false adds nothing.  Returns
    (state, too_large).  The fleet's prune of one instance
    (``apply_update_rank12_rows_fleet``): on CUDA tensors ONE launch of K12
    masks, updates and injects."""
    if _on_card(state.cov, "K12"):
        kernels.observe("apply_update_rank12_rows", (state, params, H12, r_blk, include, cols))
    new, too_large = _prune_update_fleet(_one(state), params, H12[None], r_blk[None],
                                         include[None], cols[None], [True], None,
                                         [H12.shape[0]])
    return tree.index(new, 0), too_large[0]


apply_update_rank12_rows.launches = 0


def _write_row(vals, flag, state: FilterState, too_large):
    """A plain update's state into its row of ``_fleet_rows`` (the CPU's
    stand-in for a kernel's writes; delta is not kept)."""
    D = state.cov.shape[-1]
    imu, cams = state.imu, state.cams
    vals[:D * D] = state.cov.reshape(-1)
    fields = torch.cat([imu.q, imu.bg, imu.v, imu.ba, imu.p, imu.R_imu_cam0.reshape(-1),
                        imu.t_cam0_imu, cams.q.reshape(-1), cams.p.reshape(-1)])
    vals[D * D + D:D * D + D + fields.shape[0]] = fields
    flag.copy_(too_large)


def _fleet_injected(state: FilterState, vals, flags, upd: list, upd_mask):
    """The fleet's state after its instances ``upd`` (host flags; the same
    as ``upd_mask`` (S,) on the device) wrote their updates into ``vals``:
    views of the one allocation when every instance updated, else each
    field taken from the allocation where ``upd_mask`` holds.  Returns
    (state, too_large (S,))."""
    S, D, N = state.cov.shape[0], state.cov.shape[-1], state.cams.q.shape[1]
    o = D * D + D
    q, bg, v, ba, p, R, t, cq, cp = vals[:, o:o + 28 + 7 * N].split(
        (4, 3, 3, 3, 3, 9, 3, 4 * N, 3 * N), 1)
    imu, cams = state.imu, state.cams
    new = (vals[:, :D * D].view(S, D, D), q, bg, v, ba, p, R.view(S, 3, 3), t, cq.view(S, N, 4),
           cp.view(S, N, 3), flags)
    if not all(upd):
        old = (state.cov, imu.q, imu.bg, imu.v, imu.ba, imu.p, imu.R_imu_cam0, imu.t_cam0_imu,
               cams.q, cams.p, torch.zeros_like(flags))
        new = tuple(torch.where(upd_mask.view((S,) + (1,) * (x.dim() - 1)), x, y)
                    for x, y in zip(new, old))
    cov, q, bg, v, ba, p, R, t, cq, cp, too_large = new
    imu = imu._replace(q=q, bg=bg, v=v, ba=ba, p=p, R_imu_cam0=R, t_cam0_imu=t)
    return state._replace(imu=imu, cams=cams._replace(q=cq, p=cp), cov=cov), too_large


def apply_update_fleet_plain(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true,
                             upd: list, upd_mask):
    """Plain version of ``apply_update_fleet``: ``apply_update_plain``
    instance by instance (each on its own row tier, which decides the
    shapes of its products), written into one allocation as the kernel
    writes it."""
    vals, flags = _fleet_rows(state, 0)
    for b, u in enumerate(upd):
        if u:
            _write_row(vals[b], flags[b], *apply_update_plain(
                tree.index(state, b), params, H_buf[b], r_buf[b], rows_true[b]))
    return _fleet_injected(state, vals, flags, upd, upd_mask)


def _update_fleet(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true, upd: list,
                  upd_mask):
    """``apply_update_fleet`` (the single ``apply_update`` is its fleet of
    one): the plain version on the CPU, ONE launch of K11 on the card.  The
    recorder counts each instance's update by its row tier, and its rows."""
    if profiling.enabled():
        for b, u in enumerate(upd):
            if u:
                tier = update_tier(H_buf.shape[1], H_buf.shape[2], rows_true[b])
                profiling.count(f"k11.updates.{tier}")
                profiling.count("k11.rows", rows_true[b] or 0)
    if not _on_card(state.cov, "K11"):
        return apply_update_fleet_plain(state, params, H_buf, r_buf, rows_true, upd, upd_mask)
    idx = [b for b, u in enumerate(upd) if u]
    vals, flags = _ekf_update_fleet_kernel(state.cov, H_buf, r_buf, params.obs_noise, rows_true,
                                           idx, state)
    apply_update.launches += _launches(len(idx))
    return _fleet_injected(state, vals, flags, upd, upd_mask)


def apply_update_fleet(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true,
                       upd: list, upd_mask):
    """``apply_update`` of a fleet's instances whose host flag in ``upd``
    is set (``upd_mask`` the same flags on the device), each on its buffer
    H_buf[b] (R, D), r_buf[b] and its row tier ``rows_true[b]`` (host
    ints).  On the card ONE launch of K11 for all of them, a block an
    instance on its own row tier, each writing into its row of one
    allocation for the fleet (no copy of an instance's state); on the CPU
    the plain version, instance by instance.  Returns (state, too_large
    (S,))."""
    if _on_card(state.cov, "K11"):
        kernels.observe("apply_update_fleet", (state, params, H_buf, r_buf, rows_true, upd,
                                               upd_mask))
    return _update_fleet(state, params, H_buf, r_buf, rows_true, upd, upd_mask)


def apply_update_rank12_rows_fleet_plain(state: FilterState, params: MsckfParams, H12, r_blk,
                                         include, cols, upd: list, upd_mask, n_feats: list):
    """Plain version of ``apply_update_rank12_rows_fleet``:
    ``apply_update_rank12_rows_plain`` instance by instance, each over its
    own first ``n_feats[b]`` features (the sums' length), written into one
    allocation as the kernel writes it."""
    vals, flags = _fleet_rows(state, 0)
    for b, u in enumerate(upd):
        if u:
            k = n_feats[b]
            _write_row(vals[b], flags[b], *apply_update_rank12_rows_plain(
                tree.index(state, b), params, H12[b, :k], r_blk[b, :k], include[b, :k], cols[b]))
    return _fleet_injected(state, vals, flags, upd, upd_mask)


def _prune_update_fleet(state: FilterState, params: MsckfParams, H12, r_blk, include, cols,
                        upd: list, upd_mask, n_feats: list):
    """``apply_update_rank12_rows_fleet`` (the single
    ``apply_update_rank12_rows`` is its fleet of one): the plain version on
    the CPU, ONE launch of K12 on the card."""
    profiling.count("k12.updates", sum(map(bool, upd)))
    if not _on_card(state.cov, "K12"):
        return apply_update_rank12_rows_fleet_plain(state, params, H12, r_blk, include, cols, upd,
                                                    upd_mask, n_feats)
    idx = [b for b, u in enumerate(upd) if u]
    vals, flags = _rank12_fleet_kernel(state.cov, H12, r_blk, cols, params.obs_noise, idx,
                                       n_feats, state, include)
    apply_update_rank12_rows.launches += _launches(len(idx))
    return _fleet_injected(state, vals, flags, upd, upd_mask)


def apply_update_rank12_rows_fleet(state: FilterState, params: MsckfParams, H12, r_blk,
                                   include, cols, upd: list, upd_mask, n_feats: list):
    """``apply_update_rank12_rows`` of a fleet's instances whose host flag
    in ``upd`` is set, each on its first ``n_feats[b]`` blocks H12[b]
    (K, R, 12), r_blk[b], include[b] (its own feature tier: the blocks
    past it are excluded, and the plain version's sums run over the blocks
    it is given) and columns cols[b] (12,).  On the card ONE launch of K12
    for all of them (instance by instance in its launch: each keeps its own
    feature count, so its own sums), into one allocation for the fleet; on
    the CPU the plain version.  Returns (state, too_large (S,))."""
    if _on_card(state.cov, "K12"):
        kernels.observe("apply_update_rank12_rows_fleet", (state, params, H12, r_blk, include,
                                                           cols, upd, upd_mask, n_feats))
    return _prune_update_fleet(state, params, H12, r_blk, include, cols, upd, upd_mask, n_feats)


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


def _update_work(n_rows: int, D: int, rows_true):
    """(the rows K11 factors, its QR tier, the values of its workspace) for
    a buffer of n_rows rows whose first ``rows_true`` hold data."""
    tier = update_tier(n_rows, D, rows_true)
    if tier == "QR":
        # only the first rows_true rows hold data; the rest reflect to zeros
        m = min(max(int(rows_true), D), n_rows)
        C = D + 1
        return m, True, _round4(m * C) + max(m + 33 * C + 32, _update_layout(D, D))
    m = n_rows if tier == "all" else max(int(rows_true), 1)
    return m, False, _update_layout(m, D)


def _ekf_update_fleet_kernel(P, H_buf, r_buf, obs_noise, rows_true, idx: list, state=None,
                             clocks=None):
    """K11's launch for the instances ``idx`` (host ints) of S: P (S, D, D),
    H_buf (S, R, D), r_buf (S, R) (each instance contiguous, read at its
    instance stride), ``rows_true`` each instance's true rows (host ints or
    None), with a fleet's ``state`` each update ending in its injection.
    ONE launch (one per MAX_INST instances past that), a block an instance,
    each on the row tier its ``rows_true`` selects, with its own layout and
    shared memory, as its launch alone: on the T1 and T2 tiers the kernel
    factors the true rows only (the rows past ``rows_true`` are zero
    padding and change nothing), on the QR tier it first compresses the
    stack's first max(rows_true, D) rows.  One allocation holds every
    instance's outputs and its workspace (sized for the largest tier among
    them).  ``clocks``, an int64 CUDA tensor of 7, receives the SM clock of
    the first instance's block at the kernel's phase boundaries
    (tools/kernel_probe.py).  Returns (vals (S, row), flags (S,)) of
    ``_update_rows`` (rows of the instances not in ``idx`` are not
    written)."""
    dtype = P.dtype
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise ValueError(f"K11 takes float32 or float64, got {dtype}")
    S, n_rows, D = H_buf.shape
    P, s_P = kernels.per_instance(P, dtype, True)
    H_buf, s_H = kernels.per_instance(H_buf, dtype, True)
    r_buf, s_r = kernels.per_instance(r_buf, dtype, True)
    noise = _operand(obs_noise, dtype)
    kernels.check_cuda(P[0], H_buf[0], r_buf[0], noise)
    if not idx or P.shape != (S, D, D) or r_buf.shape != (S, n_rows):
        raise ValueError(f"ekf_update: P {tuple(P.shape)}, H {tuple(H_buf.shape)}, "
                         f"r {tuple(r_buf.shape)}, instances {idx}")
    tiers = [_update_work(n_rows, D, rows_true[b]) for b in idx]
    N = state.cams.q.shape[1] if state is not None else 0
    vals, flags = _update_rows(P, N, max(w for _, _, w in tiers))
    inject, s_inj, _keep = _inject_operands(P, state)
    row, n_out = vals.shape[1], _update_values(D, N, P.element_size())
    kernels.launch(f"ekf_update_{suffix}", P.data_ptr(), D, H_buf.data_ptr(), r_buf.data_ptr(),
                   noise.data_ptr(), vals.data_ptr() + n_out * P.element_size(),
                   vals.data_ptr(), *inject, flags.data_ptr(),
                   clocks.data_ptr() if clocks is not None else None, len(idx),
                   kernels.int32s([v for b, (m, qr, _) in zip(idx, tiers)
                                   for v in (b, m, int(qr))]),
                   kernels.int64s([s_P, s_H, s_r, row, row, *s_inj, 1]))
    return vals, flags


def _ekf_update_kernel(P, H_buf, r_buf, obs_noise, rows_true, state=None, clocks=None):
    """K11's launch of one instance (the fleet launch of one): P (D, D),
    H_buf (R, D), r_buf (R,), a single ``state`` or None; ``clocks`` as in
    ``_ekf_update_fleet_kernel``.  Returns (P_new, delta, the injected state
    or None, too_large or None)."""
    vals, flags = _ekf_update_fleet_kernel(P[None], H_buf[None], r_buf[None], obs_noise,
                                           [rows_true], [0],
                                           None if state is None else _one(state), clocks)
    return _single(P, vals, flags, state)


def apply_update(state: FilterState, params: MsckfParams, H_buf, r_buf, rows_true=None):
    """EKF update from the stacked zero-padded buffer (``ekf_update``),
    injected into the state.  Returns (state, too_large).  The fleet update
    (``apply_update_fleet``) of one instance: on CUDA tensors ONE launch of
    kernel K11 computes the update on its row tier and the injection; the
    new state's changed fields are views of its one allocation."""
    if _on_card(state.cov, "K11"):
        kernels.observe("apply_update", (state, params, H_buf, r_buf, rows_true))
    new, too_large = _update_fleet(_one(state), params, H_buf[None], r_buf[None], [rows_true],
                                   [True], None)
    return tree.index(new, 0), too_large[0]


apply_update.launches = 0


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
