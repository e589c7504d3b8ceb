# Frozen copy of uav_airvision_tpu_torch/models/msckf/propagation.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""IMU propagation: error-state transition and covariance, OC-EKF
constrained.  Port of uav_airvision_tpu/models/msckf/propagation.py.

``propagate`` launches kernel K14 (``csrc/propagate.cu``: one launch of one
block, in the same four phases, folding with the same association) on a
CUDA state and runs the plain PyTorch version ``propagate_plain`` on a CPU
state.  The plain version keeps the JAX package's batched phases: prefix
products of the per-sample quaternion integrators, RK4 velocity/position as
cumulative sums, batched 21x21 transitions and noises, and a pairwise fold
of the (Phi, Q) composition.  Both take one state or a fleet's (a leading
instance axis on every leaf): one launch for the fleet, and one plain code
path, a single state running as a fleet of one.  The JAX
``propagate_tiered`` slices the padded IMU slice to 16 samples when they
fit; masked samples are identity, so the result is the same and the port
has no tier.
"""

from __future__ import annotations

import torch

from ... import kernels
from ...utils import quaternion as quat
from ...utils import tree
from .state import IMU_DIM, FilterState, MsckfParams


def _omega_mat(gyro, half_dt):
    norm = torch.linalg.norm(gyro, dim=-1)
    Omega = torch.zeros(gyro.shape[:-1] + (4, 4), dtype=gyro.dtype, device=gyro.device)
    Omega[..., :3, :3] = -quat.skew(gyro)
    Omega[..., :3, 3] = gyro
    Omega[..., 3, :3] = -gyro
    big = norm > 1e-5
    safe = torch.where(big, norm, torch.ones_like(norm))
    eye4 = torch.eye(4, dtype=gyro.dtype, device=gyro.device)
    c = torch.cos(norm * half_dt)[..., None, None]
    s = (torch.sin(norm * half_dt) / safe)[..., None, None]
    exact = c * eye4 + s * Omega
    approx = c * (eye4 + Omega * half_dt[..., None, None])
    return torch.where(big[..., None, None], exact, approx)


def fold_pairs(Phi, Q):
    """The composition of the per-sample (Phi_i, Q_i) (..., n, d, d):
    adjacent pairs fold as (Phi_b Phi_a, (Phi_b Q_a) Phi_b^T + Q_b), level by
    level, the stack padded with identity pairs to a power of two (the JAX
    package's association).  Returns (Phi_tot, Q_tot), (..., d, d)."""
    n, d, lead = Phi.shape[-3], Phi.shape[-1], Phi.shape[:-3]
    if n & (n - 1):
        n2 = 1 << (n - 1).bit_length()
        eye = torch.eye(d, dtype=Phi.dtype, device=Phi.device)
        Phi = torch.cat([Phi, eye.expand(*lead, n2 - n, d, d)], -3)
        Q = torch.cat([Q, Q.new_zeros(lead + (n2 - n, d, d))], -3)
        n = n2
    while n > 1:
        Pa, Qa = Phi[..., 0::2, :, :], Q[..., 0::2, :, :]
        Pb, Qb = Phi[..., 1::2, :, :], Q[..., 1::2, :, :]
        Phi = Pb @ Pa
        Q = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
        n //= 2
    return Phi[..., 0, :, :], Q[..., 0, :, :]


def propagate_plain(state: FilterState, params: MsckfParams, imu_t, imu_w, imu_a,
                    imu_mask) -> FilterState:
    """Plain version of K14, of one state or of a fleet's (every leaf, and
    the IMU slice, with a leading instance axis).  One state runs as a
    fleet of one, so that an instance of a fleet gets its single run's
    bits."""
    if state.cov.dim() == 3:
        imu, cov = _propagate_fleet_plain(state.imu, state.cov, state.gravity, params, imu_t,
                                          imu_w, imu_a, imu_mask)
        return state._replace(imu=imu, cov=cov)
    imu, cov = _propagate_fleet_plain(tree.stack([state.imu]), state.cov[None],
                                      state.gravity[None], params, imu_t[None], imu_w[None],
                                      imu_a[None], imu_mask[None])
    return state._replace(imu=tree.index(imu, 0), cov=cov[0])


def _propagate_fleet_plain(imu, cov, gravity, params: MsckfParams, imu_t, imu_w, imu_a, m):
    """(imu, cov) of B instances after their (B, I) IMU slices."""
    dtype, dev = cov.dtype, cov.device
    qc = params.noise_qc_diag
    B, I = imu_t.shape
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eyeI = torch.eye(IMU_DIM, dtype=dtype, device=dev)

    t_prev = torch.cat([imu.timestamp[:, None], imu_t[:, :-1]], 1)
    dt = torch.where(m, imu_t - t_prev, 0.0).to(dtype)
    gyro = torch.where(m[..., None], imu_w - imu.bg[:, None, :], 0.0).to(dtype)
    acc = torch.where(m[..., None], imu_a - imu.ba[:, None, :], 0.0).to(dtype)

    # orientation chain: prefix products P_i = M_i ... M_0 (Hillis-Steele)
    M_full = _omega_mat(gyro, dt * 0.5)
    M_half = _omega_mat(gyro, dt * 0.25)
    M_full = torch.where(m[..., None, None], M_full, torch.eye(4, dtype=dtype, device=dev))
    P = M_full
    d = 1
    while d < I:
        P = torch.cat([P[:, :d], P[:, d:] @ P[:, :-d]], 1)
        d *= 2
    q_next = quat.normalize(quat.matvec(P, imu.q[:, None]))
    q_at = torch.cat([imu.q[:, None], q_next[:, :-1]], 1)

    # RK4 velocity / position
    dq_full = torch.einsum("bnij,bnj->bni", M_full, q_at)
    dq_half = torch.einsum("bnij,bnj->bni", M_half, q_at)
    R_all_T = quat.to_rotation(torch.cat([q_at, dq_half, dq_full], 1)).transpose(-1, -2)
    k_all = torch.einsum("bnij,bnj->bni", R_all_T, acc.repeat(1, 3, 1)) + gravity[:, None, :]
    k1vd, k2vd, k4vd = k_all[:, :I], k_all[:, I:2 * I], k_all[:, 2 * I:]
    dv = (k1vd + 4.0 * k2vd + k4vd) * (dt / 6.0)[..., None]
    dv = torch.where(m[..., None], dv, 0.0)
    v_next = imu.v[:, None, :] + torch.cumsum(dv, 1)
    v_at = torch.cat([imu.v[:, None], v_next[:, :-1]], 1)
    dp = v_at * dt[..., None] + (k1vd + 2.0 * k2vd) * (dt * dt / 6.0)[..., None]
    dp = torch.where(m[..., None], dp, 0.0)
    p_next = imu.p[:, None, :] + torch.cumsum(dp, 1)

    # batched transition / noise
    qn_at = torch.cat([imu.q_null[:, None], q_next[:, :-1]], 1)
    vn_at = torch.cat([imu.v_null[:, None], v_next[:, :-1]], 1)
    pn_at = torch.cat([imu.p_null[:, None], p_next[:, :-1]], 1)
    R_at = quat.to_rotation(q_at)
    F = torch.zeros((B, I, IMU_DIM, IMU_DIM), dtype=dtype, device=dev)
    F[..., :3, :3] = -quat.skew(gyro)
    F[..., :3, 3:6] = -eye3
    F[..., 6:9, :3] = -torch.einsum("bnji,bnjk->bnik", R_at, quat.skew(acc))
    F[..., 6:9, 9:12] = -R_at.transpose(-1, -2)
    F[..., 12:15, 6:9] = eye3
    G = torch.zeros((B, I, IMU_DIM, 12), dtype=dtype, device=dev)
    G[..., :3, :3] = -eye3
    G[..., 3:6, 3:6] = eye3
    G[..., 6:9, 6:9] = -R_at.transpose(-1, -2)
    G[..., 9:12, 9:12] = eye3

    Fdt = F * dt[..., None, None]
    Fdt2 = Fdt @ Fdt
    Phi = eyeI + Fdt + Fdt2 / 2.0 + (Fdt2 @ Fdt) / 6.0
    R_null = quat.to_rotation(qn_at)
    Phi[..., :3, :3] = quat.to_rotation(q_next) @ R_null.transpose(-1, -2)
    u = quat.matvec(R_null, gravity[:, None])
    s_vec = u / (u * u).sum(-1, keepdim=True)
    A1 = Phi[..., 6:9, :3].clone()
    w1 = quat.matvec(quat.skew(vn_at - v_next), gravity[:, None])
    corr1 = torch.einsum("bnij,bnj->bni", A1, u) - w1
    Phi[..., 6:9, :3] = A1 - corr1[..., :, None] * s_vec[..., None, :]
    A2 = Phi[..., 12:15, :3].clone()
    w2 = quat.matvec(quat.skew(dt[..., None] * vn_at + pn_at - p_next),
                     gravity[:, None])
    corr2 = torch.einsum("bnij,bnj->bni", A2, u) - w2
    Phi[..., 12:15, :3] = A2 - corr2[..., :, None] * s_vec[..., None, :]
    Phi = torch.where(m[..., None, None], Phi, eyeI)
    PhiG = Phi @ G
    Q = torch.einsum("bnik,k,bnjk->bnij", PhiG, qc, PhiG) * dt[..., None, None]
    Q = torch.where(m[..., None, None], Q, 0.0)

    Phi_tot, Q_tot = fold_pairs(Phi, Q)

    cov = cov.clone()
    P_ii = Phi_tot @ cov[:, :IMU_DIM, :IMU_DIM] @ Phi_tot.transpose(-1, -2) + Q_tot
    P_ic = Phi_tot @ cov[:, :IMU_DIM, IMU_DIM:]
    cov[:, :IMU_DIM, :IMU_DIM] = P_ii
    cov[:, :IMU_DIM, IMU_DIM:] = P_ic
    cov[:, IMU_DIM:, :IMU_DIM] = P_ic.transpose(-1, -2)
    cov = (cov + cov.transpose(-1, -2)) / 2.0

    n_valid = m.to(torch.int32).sum(1)
    any_valid = n_valid > 0
    last = torch.clamp(n_valid - 1, min=0).long()
    rows = torch.arange(B, device=dev)

    def pick(new_arr, old):
        return torch.where(any_valid[:, None], new_arr[rows, last], old)

    q_new, v_new, p_new = pick(q_next, imu.q), pick(v_next, imu.v), pick(p_next, imu.p)
    imu = imu._replace(
        q=q_new, v=v_new, p=p_new,
        q_null=torch.where(any_valid[:, None], q_new, imu.q_null),
        v_null=torch.where(any_valid[:, None], v_new, imu.v_null),
        p_null=torch.where(any_valid[:, None], p_new, imu.p_null),
        timestamp=torch.where(any_valid, imu_t[rows, last], imu.timestamp),
        sid=imu.sid + 1)
    return imu, cov


# The kernel's layout (csrc/propagate.cu): 24 (Phi, Q) nodes of 2 x 15 x 15
# values in shared memory, then the staged inputs (8 per IMU slot and 48),
# the slots (163 values each) and, past 16 slots, a chunk root (a node) per
# 16 slots of the next power of two: in shared memory where they fit, else
# in a device workspace.
_NODE_VALS, _SLOT_VALS, _FIXED_VALS = 450, 163, 24 * 450
_ENTRIES = {torch.float32: "propagate_f32", torch.float64: "propagate_f64"}
_FIELD_SIZES = (4, 3, 3, 3, 3, 4, 3, 3, 1, 3)


def _workspace_values(I: int, itemsize: int) -> int:
    """Values of the device workspace K14 needs for I IMU slots (0 when its
    inputs, slots and roots fit the block's shared memory)."""
    n2 = 1 << max(I - 1, 0).bit_length()
    rest = I * (8 + _SLOT_VALS) + 48 + (n2 // 16 if n2 > 16 else 0) * _NODE_VALS
    return rest if (_FIXED_VALS + rest) * itemsize > kernels.SMEM_PER_BLOCK else 0


def propagate(state: FilterState, params: MsckfParams, imu_t, imu_w, imu_a,
              imu_mask, clocks=None) -> FilterState:
    """Propagate the IMU state and covariance over one frame's padded IMU
    slice (valid samples packed first); of one state, or of a fleet's: every
    leaf with a leading instance axis, the slices (B, I, ...), one launch
    for all B.  ``clocks``, an int64 tensor of 10 on the card, receives the
    (first instance's) propagating block's SM clock at its start, when its
    inputs are staged, at the end of each of the state chain's five steps,
    of the first leaves, of the fold and of the first 21 rows and columns
    (tools/kernel_probe.py)."""
    cov = state.cov
    if cov.device.type == "cpu":
        return propagate_plain(state, params, imu_t, imu_w, imu_a, imu_mask)
    if cov.device.type != "cuda":
        raise ValueError(f"K14 runs on CUDA tensors, got {cov.device}")
    kernels.observe("propagate", (state, params, imu_t, imu_w, imu_a, imu_mask))
    out = _propagate_kernel(state, params, imu_t, imu_w, imu_a, imu_mask, clocks)
    propagate.launches += 1
    return out


propagate.launches = 0


def _propagate_kernel(state: FilterState, params: MsckfParams, imu_t, imu_w, imu_a, imu_mask,
                      clocks=None) -> FilterState:
    """K14's launch, of one state or of a fleet's."""
    cov = state.cov
    dtype = cov.dtype
    entry = _ENTRIES.get(dtype)
    if entry is None:
        raise ValueError(f"K14 takes float32 or float64, got {dtype}")
    imu = state.imu
    fleet = cov.dim() == 3
    B = cov.shape[0] if fleet else 1
    # the state's fields go to the kernel one pointer each (and, in a fleet,
    # an instance stride each): cast or copy only what is not already
    # contiguous in the covariance's type, instance by instance
    ins = [imu_t, imu_w, imu_a, imu_mask, imu.q, imu.p, imu.v, imu.bg, imu.ba, imu.q_null,
           imu.p_null, imu.v_null, imu.timestamp, state.gravity, imu.sid, cov]
    types = [dtype] * 3 + [torch.bool] + [dtype] * 10 + [torch.int32, dtype]
    strides = []
    for k, (x, t) in enumerate(zip(ins, types)):
        ins[k], st = kernels.per_instance(x, t, fleet)
        strides.append(st)
    qc = kernels.per_instance(params.noise_qc_diag, dtype, False)[0]
    kernels.check_cuda(qc, *(x if not fleet else x[0] for x in ins))
    I, D = imu_t.shape[-1], cov.shape[-1]
    lead = (B,) if fleet else ()
    if (cov.shape != lead + (D, D) or D < IMU_DIM or imu_t.shape != lead + (I,)
            or imu_w.shape != lead + (I, 3) or imu_a.shape != lead + (I, 3)
            or imu_mask.shape != lead + (I,) or qc.numel() != 12
            or tuple(x[0].numel() if fleet else x.numel() for x in ins[4:14]) != _FIELD_SIZES
            or (fleet and any(x.shape[0] != B for x in ins))):
        raise ValueError("propagate: inconsistent covariance / IMU slice / state shapes")
    # one allocation: the covariances, the 21 state values and the sequence
    # id of each instance, then the workspaces (16-byte aligned) if the
    # slots need them
    size = cov.element_size()
    ws = _workspace_values(I, size)
    n_out = B * (D * D + 22)
    if ws:
        n_out = -(-n_out * size // 16) * 16 // size
        ws = -(-ws * size // 16) * 16 // size
    buf = torch.empty((n_out + B * ws,), dtype=dtype, device=cov.device)
    cov_out = buf[:B * D * D].view(B, D, D)
    st = buf[B * D * D:B * (D * D + 22)].view(B, 22)
    strides += [22, 22 * size // 4, D * D, ws]
    ptr = kernels.ptr
    kernels.launch(entry, *(ptr(x) for x in ins[:4]), I, *(ptr(x) for x in ins[4:15]), ptr(qc),
                   ptr(ins[15]), D, ptr(st), ptr(st) + 21 * size, ptr(buf),
                   ptr(buf) + n_out * size if ws else None, B, kernels.int64s(strides),
                   ptr(clocks) if clocks is not None else None)
    new = dict(q=st[:, 0:4], v=st[:, 4:7], p=st[:, 7:10], timestamp=st[:, 10],
               q_null=st[:, 11:15], v_null=st[:, 15:18], p_null=st[:, 18:21],
               sid=st[:, 21:].view(torch.int32)[:, 0])
    if not fleet:
        new, cov_out = {k: x[0] for k, x in new.items()}, cov_out[0]
    return state._replace(imu=imu._replace(**new), cov=cov_out)
