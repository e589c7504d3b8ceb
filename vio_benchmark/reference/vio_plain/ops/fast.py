# Frozen copy of uav_airvision_tpu_torch/ops/fast.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""FAST-9/16 corner detection with OpenCV scoring, the 7x7 detection mask
and strict 3x3 non-max suppression.

Port of uav_airvision_tpu/ops/fast.py::detect_fast together with
models/frontend/pipeline.py::_detection_mask.  The mask is given as the
point list it is built from (``mask_pts``, ``mask_valid``), so kernel K4+K6
(``csrc/fast.cu``) can build it in shared memory.  On a CPU tensor
``detect_fast`` runs the plain PyTorch version.  A fleet's (B, H, W) images,
each with its own (B, n, 2) mask points, run in one launch (and the plain
version's leading axis).
"""

from __future__ import annotations

import torch

from .. import kernels

# Bresenham circle of radius 3, contiguous ring order, (dy, dx)
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx], zero outside the image."""
    H, W = img.shape[-2:]
    out = torch.zeros_like(img)
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        img[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def detection_mask(shape, pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True = detection allowed: a 7x7 exclusion window around each valid
    point; points with int(x) < 3 or int(y) < 3 do not mask (the reference's
    numpy negative-slice quirk).  ``pts`` (..., F, 2) gives a (..., H, W)
    mask."""
    H, W = shape
    ix = torch.floor(pts[..., 0]).to(torch.int32)
    iy = torch.floor(pts[..., 1]).to(torch.int32)
    ok = valid & (ix >= 3) & (iy >= 3)
    ix = torch.where(ok, ix, -10)
    iy = torch.where(ok, iy, -10)
    ay = torch.arange(H, dtype=torch.int32, device=pts.device)
    ax = torch.arange(W, dtype=torch.int32, device=pts.device)
    Rm = ((ay - iy[..., None]).abs() <= 3).to(torch.float32)  # (..., F, H)
    Cm = ((ax - ix[..., None]).abs() <= 3).to(torch.float32)  # (..., F, W)
    return (Rm.transpose(-1, -2) @ Cm) == 0.0  # counts <= F are exact in float32


def fast_score_map(img: torch.Tensor, threshold: int):
    """(corner, score) maps of FAST-9/16 with the OpenCV score; 3-px border.
    The differences are int16 (|d| <= 255): exact, and half the bytes of
    int32 for the sixteen full-image planes.  ``img`` (..., H, W)."""
    f = img.to(torch.int16)
    H, W = f.shape[-2:]
    d = torch.stack([_shifted(f, dy, dx) - f for dy, dx in CIRCLE])  # (16,H,W)

    def best_arc(x):
        # max over the 16 arc starts of the min over 9 consecutive positions
        x = torch.cat([x, x[:ARC - 1]])
        m2 = torch.minimum(x[:-1], x[1:])
        m4 = torch.minimum(m2[:-2], m2[2:])
        m8 = torch.minimum(m4[:-4], m4[4:])
        return torch.minimum(m8[:16], x[8:24]).amax(dim=0)

    bright, dark = best_arc(d), best_arc(-d)
    score = (torch.maximum(bright, dark) - 1).to(torch.int32)
    corner = (bright > threshold) | (dark > threshold)
    ay = torch.arange(H, device=img.device)
    ax = torch.arange(W, device=img.device)
    border = ((ay >= 3) & (ay < H - 3))[:, None] & ((ax >= 3) & (ax < W - 3))[None, :]
    corner = corner & border
    return corner, torch.where(corner, score, 0)


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep = keep & (score > _shifted(score, dy, dx))
    return keep


def detect_fast_plain(img, threshold: int, mask_pts=None, mask_valid=None):
    """Plain version of K4+K6: ``img`` (H, W) or (B, H, W), the mask points
    (n, 2) or (B, n, 2) with their valid flags."""
    corner, score = fast_score_map(img, threshold)
    if mask_pts is not None:
        mask = detection_mask(img.shape[-2:], mask_pts, mask_valid)
        score = torch.where(mask, score, 0)
        corner = corner & mask
    keep = nonmax_3x3(score) & corner
    return keep, torch.where(keep, score, 0)


def detect_fast(img: torch.Tensor, threshold: int, mask_pts=None, mask_valid=None):
    """FAST + optional 7x7 exclusion mask + NMS on a (H, W) uint8 image, or
    on B images (B, H, W) each with its own mask points (B, n, 2), in one
    launch.  Returns (keep bool, score int32), each of the images' shape."""
    if img.device.type == "cpu":
        return detect_fast_plain(img, threshold, mask_pts, mask_valid)
    kernels.observe("detect_fast", (img, threshold, mask_pts, mask_valid))
    out = _fast_kernel(img, threshold, mask_pts, mask_valid)
    detect_fast.launches += 1
    return out


detect_fast.launches = 0


def _fast_kernel(img, threshold, mask_pts, mask_valid, clocks=None):
    """K4+K6's one launch: keep and score are its only allocations.
    ``clocks``: an int64 (6,) tensor for the SM clock at the start of the
    middle block and at the end of each of its five phases."""
    if img.device.type != "cuda" or img.dtype != torch.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"K4 takes a (H, W) or (B, H, W) uint8 CUDA image, got {img.dtype} "
                         f"{tuple(img.shape)} on {img.device}")
    img = img.contiguous()
    B = img.shape[0] if img.ndim == 3 else 1
    H, W = img.shape[-2:]
    if mask_pts is None:
        pts = pvalid = img  # never read: no points
        n = 0
    else:
        pts = mask_pts.to(torch.float32).contiguous()  # no copy when already so
        pvalid = mask_valid.to(torch.bool).contiguous()
        if (pts.shape[:-2] != img.shape[:-2] or pts.shape[-1] != 2
                or pvalid.shape != pts.shape[:-1]):
            raise ValueError(f"mask points {tuple(pts.shape)} / valid {tuple(pvalid.shape)} "
                             f"for images {tuple(img.shape)}")
        n = pts.shape[-2]
    kernels.check_cuda(img, pts, pvalid)
    keep = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    score = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    kernels.launch("fast_detect_masked", kernels.ptr(img), B, H, W, int(threshold),
                   kernels.ptr(pts), kernels.ptr(pvalid), n, kernels.ptr(keep),
                   kernels.ptr(score), kernels.ptr(clocks) if clocks is not None else None)
    return keep, score
