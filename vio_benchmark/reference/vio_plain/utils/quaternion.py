# Frozen copy of uav_airvision_tpu_torch/utils/quaternion.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""JPL-convention quaternion toolkit ([qx, qy, qz, qw], world -> body),
branch-free and batched over leading axes.  Port of
uav_airvision_tpu/utils/quaternion.py (Trawny & Roumeliotis eq. 78)."""

from __future__ import annotations

import torch


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def matvec(M, x):
    """M (..., i, j) times x (..., j), x broadcast against M's leading axes,
    as elementwise products summed in j order: a row's bits do not depend
    on how many rows or instances the call holds (a library product's can)."""
    return sum(M[..., j] * x[..., None, j] for j in range(M.shape[-1]))


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def to_rotation(q):
    """R = (2 w^2 - 1) I - 2 w [v]_x + 2 v v^T, with q normalized first."""
    q = normalize(q)
    vec = q[..., :3]
    w_ = q[..., 3][..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return ((2.0 * w_ * w_ - 1.0) * eye - 2.0 * w_ * skew(vec)
            + 2.0 * vec[..., :, None] * vec[..., None, :])


def to_quaternion(R):
    """Rotation matrix -> JPL quaternion (branchless Shepperd selection)."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    c0 = torch.stack([1.0 + R00 - R11 - R22, R01 + R10, R20 + R02, R12 - R21], dim=-1)
    c1 = torch.stack([R01 + R10, 1.0 - R00 + R11 - R22, R21 + R12, R20 - R02], dim=-1)
    c2 = torch.stack([R02 + R20, R21 + R12, 1.0 - R00 - R11 + R22, R01 - R10], dim=-1)
    c3 = torch.stack([R12 - R21, R20 - R02, R01 - R10, 1.0 + R00 + R11 + R22], dim=-1)
    q = torch.where((R22 < 0)[..., None],
                    torch.where((R00 > R11)[..., None], c0, c1),
                    torch.where((R00 < -R11)[..., None], c2, c3))
    return normalize(q)


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def multiply(q1, q2):
    """JPL product q1 * q2, normalizing inputs and output."""
    q1 = normalize(q1)
    q2 = normalize(q2)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a, b, c, d = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    x = w1 * a + z1 * b - y1 * c + x1 * d
    y = -z1 * a + w1 * b + x1 * c + y1 * d
    z = y1 * a - x1 * b + w1 * c + z1 * d
    w = -x1 * a - y1 * b - z1 * c + w1 * d
    return normalize(torch.stack([x, y, z, w], dim=-1))


def small_angle_quaternion(dtheta):
    dq = dtheta / 2.0
    nsq = (dq * dq).sum(-1, keepdim=True)
    w_in = torch.sqrt(torch.clamp(1.0 - nsq, min=0.0))
    q_in = torch.cat([dq, w_in], dim=-1)
    q_out = torch.cat([dq, torch.ones_like(nsq)], dim=-1) * (1.0 / torch.sqrt(1.0 + nsq))
    return torch.where(nsq <= 1.0, q_in, q_out)


def from_two_vectors(v0, v1):
    """Quaternion rotating v0 into v1, Hamilton -> JPL conjugated."""
    v0 = v0 / torch.linalg.norm(v0, dim=-1, keepdim=True)
    v1 = v1 / torch.linalg.norm(v1, dim=-1, keepdim=True)
    d = (v0 * v1).sum(-1)
    s = torch.sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-24))
    q_gen = torch.cat([torch.linalg.cross(v0, v1) / s[..., None], 0.5 * s[..., None]], dim=-1)
    q_id = torch.zeros_like(q_gen)
    q_id[..., 3] = 1.0
    ex = torch.zeros_like(v0)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v0)
    ey[..., 1] = 1.0
    ax = torch.linalg.cross(ex, v0)
    ax_ok = torch.linalg.norm(ax, dim=-1) >= 1e-6
    ax = torch.where(ax_ok[..., None], ax, torch.linalg.cross(ey, v0))
    q_opp = torch.cat([ax, torch.zeros_like(d)[..., None]], dim=-1)
    q = torch.where((d < -0.999999)[..., None], q_opp,
                    torch.where((d > 0.999999)[..., None], q_id, q_gen))
    return conjugate(normalize(q))
