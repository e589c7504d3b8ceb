"""Image pyramid: cv2 ``pyrDown`` levels, each REFLECT_101-padded by LK_PAD.

Port of uav_airvision_tpu/ops/pyramid.py::build_pyramid_padded.  Levels are
integer-valued (cv2's uint8 rounding, (k + 128) >> 8) and stored as float32,
which holds them exactly.  All levels of one pyramid live in ONE flat buffer
(``Pyramid.flat``) so the LK kernel takes a single pointer per pyramid and
computes each level's offset from the level-0 size.

On CUDA tensors ``build_pyramid_pair`` (both cameras of a frame) and
``build_pyramid_padded`` (one camera) launch kernel K2 (``csrc/pyramid.cu``)
once: every level of every camera in one launch, into one allocation (past
what a block's shared memory holds, as at 1440x1080 with four levels, the
same entry builds the levels in passes, one launch a level).  On
CPU tensors they run the plain PyTorch versions ``build_pyramid_pair_plain``
and ``build_pyramid_padded_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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
    """Padded levels (level 0 first) in one flat float32 buffer.  ``levels``
    are views into it, made at their first use: the LK kernels take the
    flat buffer and the level-0 size alone."""

    flat: torch.Tensor
    H0: int
    W0: int
    n_levels: int
    pad: int = LK_PAD
    _levels: Optional[List[torch.Tensor]] = field(default=None, repr=False, compare=False)

    @property
    def levels(self) -> List[torch.Tensor]:
        if self._levels is None:
            views, off = [], 0
            for h, w in level_shapes(self.H0, self.W0, self.n_levels):
                h, w = h + 2 * self.pad, w + 2 * self.pad
                views.append(self.flat[off:off + h * w].view(h, w))
                off += h * w
            self._levels = views
        return self._levels


def pyramid_size(H: int, W: int, n_levels: int, pad: int = LK_PAD) -> int:
    """Floats of one padded pyramid (every level)."""
    return sum((h + 2 * pad) * (w + 2 * pad) for h, w in level_shapes(H, W, n_levels))


def empty_pyramid(H: int, W: int, n_levels: int, device, pad: int = LK_PAD) -> Pyramid:
    flat = torch.empty(pyramid_size(H, W, n_levels, pad), dtype=torch.float32, device=device)
    return Pyramid(flat, H, W, n_levels, pad)


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


def build_pyramid_pair_plain(cam0_img: torch.Tensor, cam1_img: torch.Tensor, levels: int,
                             pad: int = LK_PAD):
    """Plain version of ``build_pyramid_pair``: each camera on its own."""
    return (build_pyramid_padded_plain(cam0_img, levels, pad),
            build_pyramid_padded_plain(cam1_img, levels, pad))


def _pyramid_kernel(imgs, levels: int, pad: int):
    """One launch of K2 over one or two (H, W) uint8 CUDA images of one
    shape; their pyramids' flats are views of one allocation."""
    for img in imgs:
        if img.device.type != "cuda" or img.dtype != torch.uint8:
            raise ValueError(f"K2 takes uint8 CUDA images, got {img.dtype} on {img.device}")
    imgs = [img if img.is_contiguous() else img.contiguous() for img in imgs]
    kernels.check_cuda(*imgs)
    H, W = imgs[0].shape
    if any(img.shape != (H, W) for img in imgs):
        raise ValueError(f"K2: images of shapes {[tuple(i.shape) for i in imgs]}")
    n_levels = levels + 1
    shapes = level_shapes(H, W, n_levels)
    if not 1 <= n_levels <= 8 or min(min(hw) for hw in shapes) < 3:
        raise ValueError(f"K2 takes 1 to 8 levels of at least 3 x 3 px, got {shapes}")
    size = pyramid_size(H, W, n_levels, pad)
    flat = torch.empty(len(imgs) * size, dtype=torch.float32, device=imgs[0].device)
    kernels.launch("pyramid_u8", kernels.ptr(imgs[0]), kernels.ptr(imgs[-1]), len(imgs), H, W,
                   n_levels, pad, kernels.ptr(flat))
    if len(imgs) == 1:
        return [Pyramid(flat, H, W, n_levels, pad)]
    return [Pyramid(part, H, W, n_levels, pad) for part in flat.split(size)]


def build_pyramid_pair(cam0_img: torch.Tensor, cam1_img: torch.Tensor, levels: int,
                       pad: int = LK_PAD):
    """Both cameras' pyramids, ``levels`` = LK maxLevel (levels+1 padded
    levels each, level 0 = the input): (Pyramid, Pyramid).  On CUDA images
    one launch of K2 builds both into one allocation."""
    if cam0_img.device.type == "cpu" and cam1_img.device.type == "cpu":
        return build_pyramid_pair_plain(cam0_img, cam1_img, levels, pad)
    pyr0, pyr1 = _pyramid_kernel([cam0_img, cam1_img], levels, pad)
    build_pyramid_pair.launches += 1
    return pyr0, pyr1


def build_pyramid_padded(img: torch.Tensor, levels: int, pad: int = LK_PAD) -> Pyramid:
    """One camera's pyramid: ``levels`` = LK maxLevel; returns levels+1
    padded levels (level 0 = the input).  ``img`` is (H, W) uint8; on a
    CUDA image one launch of K2."""
    if img.device.type == "cpu":
        return build_pyramid_padded_plain(img, levels, pad)
    (pyr,) = _pyramid_kernel([img], levels, pad)
    build_pyramid_padded.launches += 1
    return pyr


build_pyramid_pair.launches = 0
build_pyramid_padded.launches = 0
