"""Image pyramid: cv2 ``pyrDown`` levels, each REFLECT_101-padded by LK_PAD.

Port of uav_airvision_tpu/ops/pyramid.py::build_pyramid_padded.  Levels are
integer-valued (cv2's uint8 rounding, (k + 128) >> 8) and stored as float32,
which holds them exactly.  All levels of one pyramid live in ONE flat buffer
(``Pyramid.flat``) so the LK kernel takes a single pointer per pyramid and
computes each level's offset from the level-0 size.

On a CUDA tensor ``build_pyramid_padded`` launches kernel K2
(``csrc/pyramid.cu``) once per level; on a CPU tensor it runs the plain
PyTorch version ``build_pyramid_padded_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .. import kernels

LK_PAD = 17  # window 15 + bilinear margin; matches cv2's per-level border


def level_shapes(H: int, W: int, n_levels: int):
    """Unpadded (h, w) of levels 0..n_levels-1: ceil(n/2) per level."""
    shapes = [(H, W)]
    for _ in range(n_levels - 1):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


@dataclass
class Pyramid:
    """Padded levels (level 0 first) as views into one flat float32 buffer."""

    flat: torch.Tensor
    H0: int
    W0: int
    levels: List[torch.Tensor]

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def empty_pyramid(H: int, W: int, n_levels: int, device, pad: int = LK_PAD) -> Pyramid:
    shapes = [(h + 2 * pad, w + 2 * pad) for h, w in level_shapes(H, W, n_levels)]
    flat = torch.empty(sum(h * w for h, w in shapes), dtype=torch.float32,
                       device=device)
    levels, off = [], 0
    for h, w in shapes:
        levels.append(flat[off:off + h * w].view(h, w))
        off += h * w
    return Pyramid(flat, H, W, levels)


def reflect101_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.pad(mode="reflect") source index for any offset (triangle wave)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def _fold(s: torch.Tensor, n: int) -> torch.Tensor:
    """The single REFLECT_101 fold of the JAX decimation matrix."""
    s = torch.where(s < 0, -s, s)
    return torch.where(s >= n, 2 * (n - 1) - s, s)


def pyr_down_plain(img: torch.Tensor) -> torch.Tensor:
    """cv2 uint8 pyrDown of an integer-valued (H, W) image, as int32."""
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    src = img.to(torch.int32)
    dev = img.device
    w = torch.tensor([1, 4, 6, 4, 1], dtype=torch.int32, device=dev)
    taps = torch.arange(5, device=dev) - 2
    ry = _fold(2 * torch.arange(Ho, device=dev)[:, None] + taps[None, :], H)  # (Ho,5)
    rx = _fold(2 * torch.arange(Wo, device=dev)[:, None] + taps[None, :], W)  # (Wo,5)
    v = (src[ry] * w[None, :, None]).sum(dim=1)  # (Ho, W)
    acc = (v[:, rx] * w[None, None, :]).sum(dim=2)  # (Ho, Wo)
    return (acc + 128) >> 8


def pad_reflect_plain(img: torch.Tensor, pad: int) -> torch.Tensor:
    H, W = img.shape
    dev = img.device
    ry = reflect101_index(torch.arange(-pad, H + pad, device=dev), H)
    rx = reflect101_index(torch.arange(-pad, W + pad, device=dev), W)
    return img[ry][:, rx]


def build_pyramid_padded_plain(img: torch.Tensor, levels: int,
                               pad: int = LK_PAD) -> Pyramid:
    """Plain PyTorch version of kernel K2 (integer math, exact)."""
    H, W = img.shape
    pyr = empty_pyramid(H, W, levels + 1, img.device, pad)
    cur = img.to(torch.int32)
    for L in range(levels + 1):
        if L > 0:
            cur = pyr_down_plain(cur)
        pyr.levels[L].copy_(pad_reflect_plain(cur, pad).to(torch.float32))
    return pyr


def build_pyramid_padded(img: torch.Tensor, levels: int, pad: int = LK_PAD) -> Pyramid:
    """``levels`` = LK maxLevel; returns levels+1 padded levels (level 0 = the
    input).  ``img`` is (H, W) uint8."""
    if img.device.type == "cpu":
        return build_pyramid_padded_plain(img, levels, pad)
    if img.device.type != "cuda" or img.dtype != torch.uint8:
        raise ValueError(f"K2 takes a uint8 CUDA image, got {img.dtype} on {img.device}")
    img = img.contiguous()
    kernels.check_cuda(img)
    H, W = img.shape
    pyr = empty_pyramid(H, W, levels + 1, img.device, pad)
    shapes = level_shapes(H, W, levels + 1)
    kernels.launch("pyr_level_u8", kernels.ptr(img), W, 0, H, W,
                   kernels.ptr(pyr.levels[0]), H, W, pad, 0)
    build_pyramid_padded.launches += 1
    for L in range(1, levels + 1):
        (hs, ws), (ho, wo) = shapes[L - 1], shapes[L]
        kernels.launch("pyr_level_f32", kernels.ptr(pyr.levels[L - 1]),
                       ws + 2 * pad, pad, hs, ws,
                       kernels.ptr(pyr.levels[L]), ho, wo, pad, 1)
        build_pyramid_padded.launches += 1
    return pyr


build_pyramid_padded.launches = 0
