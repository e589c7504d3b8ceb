"""Per-window extract: F windows of n x n, each at its own integer origin, out
of one padded image level.

Port of scripts/exp_gather.py::pallas_extract (TPU kernel P1, a DMA per
window into VMEM).  The JAX package computes the same function inside LK
under ``frontend.lk_compact_windows`` (ops/lk.py::_iterate_level cuts each
level's exact 32-px search span with ``_shift_extract``); the port's
compact-window LK (``ops/lk.py``) fetches its windows here.

Origins outside the image are clamped to [0, HP - n] x [0, WP - n], on the
device and with no host read, as the JAX code clamps ``des`` before it
extracts; the compact LK's origins are already in that range.

On a CUDA tensor ``extract_windows`` launches kernel P1
(``csrc/extract.cu``, one block per window); on a CPU tensor it runs the
plain PyTorch version ``extract_windows_plain``.
"""

from __future__ import annotations

import torch

from .. import kernels


def extract_windows_plain(level: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Plain PyTorch version of kernel P1 (index ops, exact)."""
    HP, WP = level.shape
    oy = oy.long().clamp(0, HP - n)
    ox = ox.long().clamp(0, WP - n)
    ar = torch.arange(n, device=level.device)
    return level[(oy[:, None] + ar)[:, :, None], (ox[:, None] + ar)[:, None, :]]


def extract_windows(level: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``out[f] = level[oy[f]:oy[f]+n, ox[f]:ox[f]+n]``: level (HP, WP)
    float32 (a level view of ``Pyramid.flat``), oy / ox (F,) int32 (strided
    views of one (F, 2) tensor are taken as they are).  Returns (F, n, n)
    float32."""
    if level.device.type == "cpu":
        return extract_windows_plain(level, oy, ox, n)
    if level.device.type != "cuda":
        raise ValueError(f"P1 runs on CUDA tensors, got {level.device}")
    F = oy.shape[0]
    HP, WP = level.shape
    if level.dtype != torch.float32 or not level.is_contiguous():
        raise ValueError(f"P1 takes a contiguous float32 level, got {level.dtype}")
    if (oy.dtype != torch.int32 or ox.dtype != torch.int32 or oy.shape != (F,)
            or ox.shape != (F,) or oy.stride() != ox.stride()):
        raise ValueError("P1 takes int32 origins oy, ox of one shape (F,) and one stride")
    if not (0 < n <= min(HP, WP)):
        raise ValueError(f"window {n} does not fit the {HP}x{WP} level")
    for t in (oy, ox):
        if t.device != level.device:
            raise ValueError(f"origins on {t.device}, level on {level.device}")
    kernels.observe("extract_windows", (level, oy, ox, n))
    out = torch.empty((F, n, n), dtype=torch.float32, device=level.device)
    kernels.launch("extract_windows", kernels.ptr(level), HP, WP, kernels.ptr(oy),
                   kernels.ptr(ox), oy.stride(0), F, n, kernels.ptr(out))
    extract_windows.launches += 1
    return out


extract_windows.launches = 0
