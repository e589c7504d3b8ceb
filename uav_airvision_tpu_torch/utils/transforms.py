"""SE(3) rigid transforms (the port's counterpart of
uav_airvision_tpu/utils/transforms.py; tests/test_torch_standalone.py holds
the two equal on the same inputs).

An isometry is a NamedTuple ``(R, t)``; operations are free functions over
leading batch axes.  The functions compute in PyTorch and take tensors or
anything ``torch.as_tensor`` takes; the streaming orchestrator's publish path
uses ``Isometry`` as a plain container of NumPy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Isometry(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def _tensors(T: Isometry):
    return torch.as_tensor(T.R), torch.as_tensor(T.t)


def identity(dtype=torch.float32, batch_shape=()):
    R = torch.eye(3, dtype=dtype).expand(*batch_shape, 3, 3)
    return Isometry(R, torch.zeros((*batch_shape, 3), dtype=dtype))


def inverse(T: Isometry) -> Isometry:
    R, t = _tensors(T)
    RT = R.transpose(-1, -2)
    return Isometry(RT, -torch.einsum("...ij,...j->...i", RT, t))


def compose(Ta: Isometry, Tb: Isometry) -> Isometry:
    """Ta * Tb (apply Tb first)."""
    Ra, ta = _tensors(Ta)
    Rb, tb = _tensors(Tb)
    return Isometry(Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta)


def apply(T: Isometry, p):
    """Transform point(s) p by T."""
    R, t = _tensors(T)
    return torch.einsum("...ij,...j->...i", R, torch.as_tensor(p)) + t


def matrix(T: Isometry):
    R, t = _tensors(T)
    bottom = torch.zeros((*t.shape[:-1], 1, 4), dtype=R.dtype)
    bottom[..., 0, 3] = 1.0
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m) -> Isometry:
    return Isometry(m[..., :3, :3], m[..., :3, 3])
