# Frozen copy of uav_airvision_tpu_torch/ops/lk.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Batched pyramidal Lucas-Kanade optical flow with OpenCV semantics.

Port of uav_airvision_tpu/ops/lk.py::pyramidal_lk_banded: window win x win (15 by default),
Scharr/32 template gradients zeroed outside the image, G computed once per
level at the previous point, bilinear re-sampling of J per iteration, eps
convergence plus OpenCV's flip-flop halving, the level-0 min-eigenvalue and
in-bounds status, OPTFLOW_USE_INITIAL_FLOW.

The JAX package's banded block layout is a TPU gather workaround and is not
ported, but the search-window freeze bounds it implies change results and are
reproduced exactly (``_search_window``).  Templates come from ``prev_pyr``
and search windows from ``curr_pyr``; the temporal tracker passes the
previous frame's cam0 pyramid as ``prev_pyr``.

On a CUDA tensor ``pyramidal_lk`` launches kernel K1 (``csrc/lk.cu``, one
block per point, any window side); on a CPU tensor it runs ``pyramidal_lk_plain``, batched
over points.  Under ``frontend.lk_compact_windows`` the JAX package cuts
each level's exact 32-px search span and iterates on it, which makes the
freeze bounds uniform (origin des, span 16): there the port runs
``pyramidal_lk_compact``, ONE launch of K1's compact entry, whose blocks
stage each level's window in shared memory themselves (P1's function).
The route it replaced, per level kernel P1 (``ops/extract.py``) for the
windows and K1's level entry ``pyramidal_lk_level`` on them, stays as
``pyramidal_lk_compact_levels``, its witness; its plain version is the
compact tracker's plain version.

A fleet's points (B, F, 2) with batched pyramids (``Pyramid.batch`` = B)
track in one launch of either entry, a block per point of each instance;
the plain versions take the same leading axis.
"""

from __future__ import annotations

import torch

from .. import kernels
from .extract import extract_windows, extract_windows_plain
from .pyramid import LK_PAD, Pyramid

LK_MARGIN = 8  # search margin; with the 48-px / 16-px block snap: 8..23 px
BAND_STRIDE = 16
BAND_BW = 48
_SM = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)


def _template(img: torch.Tensor, inst: torch.Tensor, pts: torch.Tensor, scale: float,
              win: int):
    """(I, Ix, Iy, corner) of each point's template at one level: ``img``
    (B, HP, WP) the level of each instance, ``inst`` (F,) the points'."""
    HP, WP = img.shape[-2:]
    F = pts.shape[0]
    n = win + 3
    half = (win - 1) * 0.5
    c = pts * scale - half + LK_PAD  # (F, 2) window corner, padded coords
    fc = torch.floor(c)
    ry0 = torch.clamp(fc[:, 1].to(torch.int64) - 1, 0, HP - n)
    rx0 = torch.clamp(fc[:, 0].to(torch.int64) - 1, 0, WP - n)
    ar = torch.arange(n, device=img.device)
    raw = img[inst[:, None, None], (ry0[:, None] + ar)[:, :, None],
              (rx0[:, None] + ar)[:, None, :]]
    ax = (c[:, 0] - fc[:, 0])[:, None, None]
    ay = (c[:, 1] - fc[:, 1])[:, None, None]
    T = ((1 - ax) * (1 - ay) * raw[:, :-1, :-1] + ax * (1 - ay) * raw[:, :-1, 1:]
         + (1 - ax) * ay * raw[:, 1:, :-1] + ax * ay * raw[:, 1:, 1:])  # (F,17,17)
    v = _SM[0] * T[:, :-2] + _SM[1] * T[:, 1:-1] + _SM[2] * T[:, 2:]
    ix = (-1.0 * v[:, :, :-2] + 0.0 * v[:, :, 1:-1]) + 1.0 * v[:, :, 2:]
    w = (-1.0 * T[:, :-2] + 0.0 * T[:, 1:-1]) + 1.0 * T[:, 2:]
    iy = _SM[0] * w[:, :, :-2] + _SM[1] * w[:, :, 1:-1] + _SM[2] * w[:, :, 2:]
    aw = torch.arange(win, device=img.device, dtype=c.dtype)
    ys = c[:, 1:2] + aw  # (F, win) patch pixel centres
    xs = c[:, 0:1] + aw
    inside = (((ys >= LK_PAD) & (ys <= HP - 1 - LK_PAD))[:, :, None]
              & ((xs >= LK_PAD) & (xs <= WP - 1 - LK_PAD))[:, None, :])
    ix = ix * inside
    iy = iy * inside
    return T[:, 1:-1, 1:-1], ix, iy, c.reshape(F, 2)


def _search_window(pts_l: torch.Tensor, HP: int, WP: int, win: int,
                   compact: bool = False):
    """Block origin o (F, 2) [y, x] and sample-corner bound ub (F, 2) of the
    search window (lk.py:188-219 with extract.py::block_of's clip and snap).
    ``compact``: the exact 32-px span at des, o = des and ub = need - (win+1)
    (lk.py:199-218)."""
    need = win + 1 + 2 * LK_MARGIN
    half = (win - 1) * 0.5
    corner0 = pts_l - half + LK_PAD
    out_o, out_ub = [], []
    for axis, n in ((1, HP), (0, WP)):
        des = torch.clamp(torch.floor(corner0[:, axis]).to(torch.int64) - LK_MARGIN,
                          0, n - need)
        if compact:
            o, bw = des, need
        else:
            nb = max(1, -((n - BAND_BW) // -BAND_STRIDE) + 1)
            o, bw = BAND_STRIDE * torch.clamp(des // BAND_STRIDE, max=nb - 1), BAND_BW
        out_o.append(o)
        out_ub.append(torch.clamp(n - (win + 1) - o, max=bw - (win + 1)))
    return torch.stack(out_o, 1), torch.stack(out_ub, 1)


def compact_origin(pts: torch.Tensor, level: torch.Tensor, L: int, win: int = 15):
    """des (F, 2) int32 [y, x]: the compact search window's origin at level L
    (shape of ``level``: (HP, WP), or (B, HP, WP)) of the full-resolution
    points ``pts``."""
    HP, WP = level.shape[-2:]
    return _search_window(pts * (1.0 / (1 << L)), HP, WP, win, compact=True)[0].to(torch.int32)


def _sample(img: torch.Tensor, inst: torch.Tensor, sy, sx, oy, ox, win: int):
    """Bilinear win x win patches with corners at (oy + sy, ox + sx) of
    image ``inst`` of ``img`` (n, h, w): each point's instance's level, or
    each point's own window."""
    by, bx = torch.floor(sy), torch.floor(sx)
    fy = (sy - by)[:, None, None]
    fx = (sx - bx)[:, None, None]
    aw = torch.arange(win, device=img.device)
    r = (oy + by.to(torch.int64))[:, None] + aw  # (F, win)
    c = (ox + bx.to(torch.int64))[:, None] + aw
    r0, r1 = r[:, :, None], r[:, :, None] + 1
    c0, c1 = c[:, None, :], c[:, None, :] + 1
    f = inst[:, None, None]

    def at(rr, cc):
        return img[f, rr, cc]

    t0 = (1 - fy) * at(r0, c0) + fy * at(r1, c0)
    t1 = (1 - fy) * at(r0, c1) + fy * at(r1, c1)
    return t0 * (1 - fx) + t1 * fx


def _track_level(pimg, src, inst, src_inst, prev_pts, next_pts, valid, L: int, o, ub, r_off,
                 win: int, it_max: int, eps2: float, min_eig_threshold: float):
    """One level, coarse to fine: the template of ``prev_pts`` in their
    instances' (``inst``) level of ``pimg`` (B, HP, WP), then the gated
    Gauss-Newton steps from ``next_pts`` (full resolution) with the sample
    corner clamped to [o, o + ub] and read from image ``src_inst`` of
    ``src`` at corner - o + r_off.  Returns (next_pts, the level-0 status
    gate)."""
    scale = 1.0 / (1 << L)
    half = (win - 1) * 0.5
    HP, WP = pimg.shape[-2:]
    H, W = HP - 2 * LK_PAD, WP - 2 * LK_PAD
    I, ix, iy, c = _template(pimg, inst, prev_pts, scale, win)
    a11 = (ix * ix).sum((1, 2))
    a12 = (ix * iy).sum((1, 2))
    a22 = (iy * iy).sum((1, 2))
    bt1 = (I * ix).sum((1, 2))
    bt2 = (I * iy).sum((1, 2))
    det = a11 * a22 - a12 * a12
    inv_det = torch.where(det > 1e-12, 1.0 / det, torch.zeros_like(det))
    ipx = torch.floor(c[:, 0]) - LK_PAD
    ipy = torch.floor(c[:, 1]) - LK_PAD
    in_prev = (ipx >= -win) & (ipx < W) & (ipy >= -win) & (ipy < H)
    good = valid & in_prev & (det > 1e-12)
    min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / (
        2.0 * win * win)
    status = valid & in_prev & (min_eig >= min_eig_threshold) & (det > 1e-12)

    pts = next_pts * scale
    oy, ox = o[:, 0], o[:, 1]
    uby, ubx = ub[:, 0].to(pts.dtype), ub[:, 1].to(pts.dtype)
    ry, rx = r_off[:, 0], r_off[:, 1]
    conv = ~good
    prev_delta = torch.zeros_like(pts)
    for it in range(it_max):
        corner = pts - half + LK_PAD
        sy = torch.minimum(torch.clamp(corner[:, 1] - oy.to(pts.dtype), min=0.0), uby)
        sx = torch.minimum(torch.clamp(corner[:, 0] - ox.to(pts.dtype), min=0.0), ubx)
        J = _sample(src, src_inst, sy, sx, ry, rx, win)
        b1 = (J * ix).sum((1, 2)) - bt1
        b2 = (J * iy).sum((1, 2)) - bt2
        dx = (a12 * b2 - a22 * b1) * inv_det
        dy = (a12 * b1 - a11 * b2) * inv_det
        delta = torch.stack([dx, dy], dim=-1)
        new = pts + delta
        fl = torch.floor(new - half)
        inb = (fl[:, 0] >= -win) & (fl[:, 0] < W) & (fl[:, 1] >= -win) & (fl[:, 1] < H)
        nc = new - half + LK_PAD
        in_win = ((nc[:, 0] - ox >= 0.0) & (nc[:, 0] - ox <= ubx)
                  & (nc[:, 1] - oy >= 0.0) & (nc[:, 1] - oy <= uby))
        step = ~conv & good & in_win
        pts = torch.where(step[:, None], new, pts)
        small = (delta * delta).sum(-1) <= eps2
        flip = ((it > 0) & (torch.abs(dx + prev_delta[:, 0]) < 0.01)
                & (torch.abs(dy + prev_delta[:, 1]) < 0.01))
        pts = torch.where((step & flip)[:, None], pts - delta * 0.5, pts)
        conv = conv | small | flip | ~good | ~inb | ~in_win
        prev_delta = delta
    return pts * (1 << L), status


def _final_status(next_pts, status, H0: int, W0: int, win: int):
    """OpenCV's status drop on the final level-0 point."""
    half = (win - 1) * 0.5
    fl = torch.floor(next_pts - half)
    inb = (fl[:, 0] >= -win) & (fl[:, 0] < W0) & (fl[:, 1] >= -win) & (fl[:, 1] < H0)
    return status & inb


def _iters(L: int, max_iter: int, max_iter_upper):
    return max_iter if (L == 0 or not max_iter_upper) else max_iter_upper


def _batch(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts) -> int:
    """The instance count B of (F, 2) points of one pyramid pair (1) or of
    (B, F, 2) points of pyramid batches of B."""
    B = prev_pts.shape[0] if prev_pts.dim() == 3 else 1
    if prev_pyr.batch != B or curr_pyr.batch != B:
        raise ValueError(f"points {tuple(prev_pts.shape)} for pyramid batches "
                         f"{prev_pyr.batch}, {curr_pyr.batch}")
    return B


def _instances(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts):
    """The instance of each point, (B*F,) int64, for the plain versions."""
    B = _batch(prev_pyr, curr_pyr, prev_pts)
    return torch.arange(B, device=prev_pts.device).repeat_interleave(prev_pts.shape[-2])


def pyramidal_lk_plain(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts,
                       valid, win: int = 15, max_iter: int = 30, eps: float = 0.01,
                       min_eig_threshold: float = 1e-4, n_levels: int | None = None,
                       max_iter_upper: int | None = None, compact_windows: bool = False):
    """Plain PyTorch version of kernel K1 (every point runs the capped number
    of gated steps; a converged point never moves again).  With
    ``compact_windows`` the level loop of ``pyramidal_lk_level_plain``.
    Points (F, 2), or (B, F, 2) of B instances' batched pyramids."""
    if n_levels is None:
        n_levels = min(prev_pyr.n_levels, curr_pyr.n_levels)
    inst = _instances(prev_pyr, curr_pyr, prev_pts)
    lead = prev_pts.shape[:-1]
    prev, init, ok = prev_pts.reshape(-1, 2), init_pts.reshape(-1, 2), valid.reshape(-1)
    if compact_windows:
        pts, status, _ = _compact_levels(extract_windows_plain, pyramidal_lk_level_plain,
                                         prev_pyr, curr_pyr, prev, init, ok, win, max_iter, eps,
                                         min_eig_threshold, n_levels, max_iter_upper, inst)
        return pts.reshape(*lead, 2), status.reshape(lead)
    next_pts = init.clone()
    status = None
    for L in reversed(range(n_levels)):
        cimg = curr_pyr.stacked_levels[L]
        HP, WP = cimg.shape[-2:]
        o, ub = _search_window(next_pts * (1.0 / (1 << L)), HP, WP, win)
        next_pts, st = _track_level(prev_pyr.stacked_levels[L], cimg, inst, inst, prev,
                                    next_pts, ok, L, o, ub, o, win,
                                    _iters(L, max_iter, max_iter_upper), eps * eps,
                                    min_eig_threshold)
        if L == 0:
            status = st
    status = _final_status(next_pts, status, prev_pyr.H0, prev_pyr.W0, win)
    return next_pts.reshape(*lead, 2), status.reshape(lead)


def pyramidal_lk_level_plain(prev_pyr: Pyramid, prev_pts, pts, valid, windows, des, L: int,
                             win: int = 15, it_max: int = 30, eps: float = 0.01,
                             min_eig_threshold: float = 1e-4, inst=None):
    """Plain PyTorch version of K1's level entry: level ``L`` of the
    compact-window tracker, sampling the (F, 32, 32) ``windows`` cut at
    ``des`` (F, 2) [y, x].  Returns (pts (F, 2) full resolution, the next
    finer level's des or None at L = 0, the status at L = 0 or None).
    ``inst`` (F,): each point's instance of a batched ``prev_pyr``."""
    need = win + 1 + 2 * LK_MARGIN
    o = des.to(torch.int64)
    pimg = prev_pyr.stacked_levels[L]
    HP, WP = pimg.shape[-2:]
    if inst is None:
        inst = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    ub = torch.clamp(torch.tensor([HP, WP], device=o.device) - (win + 1) - o,
                     max=need - (win + 1))
    out, status = _track_level(pimg, windows, inst, torch.arange(o.shape[0], device=o.device),
                               prev_pts, pts, valid, L, o, ub, torch.zeros_like(o), win, it_max,
                               eps * eps, min_eig_threshold)
    if L > 0:
        return out, compact_origin(out, prev_pyr.stacked_levels[L - 1], L - 1, win), None
    return out, None, _final_status(out, status, prev_pyr.H0, prev_pyr.W0, win)


def pyramidal_lk_level(prev_pyr: Pyramid, prev_pts, pts, valid, windows, des, L: int,
                       win: int = 15, it_max: int = 30, eps: float = 0.01,
                       min_eig_threshold: float = 1e-4):
    """Level ``L`` of the compact-window tracker (``pyramidal_lk_level_plain``'s
    contract): kernel K1's level entry on CUDA tensors, the plain version on
    CPU tensors."""
    if pts.device.type == "cpu":
        return pyramidal_lk_level_plain(prev_pyr, prev_pts, pts, valid, windows, des, L, win,
                                        it_max, eps, min_eig_threshold)
    if pts.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {pts.device}")
    if win < 1:
        raise ValueError(f"K1 takes a window side of at least 1, got {win}")
    need = win + 1 + 2 * LK_MARGIN
    F = pts.shape[0]
    prev_pts = prev_pts.to(torch.float32).contiguous()
    pts = pts.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    des = des.to(torch.int32).contiguous()
    kernels.check_cuda(prev_pyr.flat, prev_pts, pts, valid, windows, des)
    if (prev_pts.shape != (F, 2) or valid.shape != (F,) or des.shape != (F, 2)
            or windows.shape != (F, need, need) or windows.dtype != torch.float32
            or not 0 <= L < prev_pyr.n_levels or prev_pyr.batch != 1):
        raise ValueError(f"pyramidal_lk_level: points {tuple(pts.shape)}, windows "
                         f"{tuple(windows.shape)}, des {tuple(des.shape)}, level {L}")
    kernels.observe("pyramidal_lk_level", (prev_pyr, prev_pts, pts, valid, windows, des, L,
                                           win, it_max, eps, min_eig_threshold))
    out = torch.empty_like(pts)
    des_next = torch.empty_like(des) if L > 0 else None
    status = torch.empty((F,), dtype=torch.bool, device=pts.device) if L == 0 else None
    kernels.launch("pyramidal_lk_level", kernels.ptr(prev_pyr.flat), prev_pyr.H0,
                   prev_pyr.W0, kernels.ptr(prev_pts), kernels.ptr(pts), kernels.ptr(valid),
                   kernels.ptr(windows), kernels.ptr(des), F, L, int(it_max),
                   float(eps * eps), float(min_eig_threshold), kernels.ptr(out),
                   kernels.ptr(des_next) if des_next is not None else None,
                   kernels.ptr(status) if status is not None else None, int(win))
    pyramidal_lk_level.launches += 1
    return out, des_next, status


pyramidal_lk_level.launches = 0


def _compact_levels(extract, level, prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts,
                    valid, win, max_iter, eps, min_eig_threshold, n_levels, max_iter_upper,
                    inst=None):
    """The compact-window tracker level by level (lk.py:199-218): per level,
    coarse to fine, the points' 32-px search windows cut out of the current
    level at des (``extract``: P1), then the level's Gauss-Newton steps on
    them (``level``: K1's level entry), which also give the next level's
    des.  Returns (pts, status, des (F, n_levels, 2) int32: [:, L] the
    origin at level L).  ``inst`` (F,), for the plain versions: each point's
    instance of batched pyramids."""
    need = win + 1 + 2 * LK_MARGIN
    kw = {} if inst is None else {"inst": inst}
    levels = curr_pyr.levels if inst is None else curr_pyr.stacked_levels
    pts, status = init_pts, None
    des = compact_origin(init_pts, levels[n_levels - 1], n_levels - 1, win)
    origins = [None] * n_levels
    for L in reversed(range(n_levels)):
        origins[L] = des
        windows = extract(levels[L], des[:, 0], des[:, 1], need, **kw)
        pts, des, status = level(prev_pyr, prev_pts, pts, valid, windows, des, L, win,
                                 _iters(L, max_iter, max_iter_upper), eps,
                                 min_eig_threshold, **kw)
    return pts, status, torch.stack(origins, 1)


def pyramidal_lk_compact_levels(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts,
                                valid, win: int = 15, max_iter: int = 30, eps: float = 0.01,
                                min_eig_threshold: float = 1e-4, n_levels: int | None = None,
                                max_iter_upper: int | None = None):
    """The compact-window tracker as the port ran it before
    ``pyramidal_lk_compact``: per level kernel P1 and K1's level entry (two
    launches a level on CUDA tensors, their plain versions on CPU tensors),
    the coarsest level's des computed by the host.  The one-launch entry's
    witness: (pts, status, des) as ``_compact_levels`` returns them."""
    if n_levels is None:
        n_levels = min(prev_pyr.n_levels, curr_pyr.n_levels)
    return _compact_levels(extract_windows, pyramidal_lk_level, prev_pyr, curr_pyr, prev_pts,
                           init_pts, valid, win, max_iter, eps, min_eig_threshold, n_levels,
                           max_iter_upper)


def _check_points(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts, valid, win,
                  n_levels):
    """K1's launch operands: float32 (F, 2) or (B, F, 2) points, bool valid,
    contiguous on the card, and the instance count B."""
    if prev_pts.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {prev_pts.device}")
    if win < 1:
        raise ValueError(f"K1 takes a window side of at least 1, got {win}")
    if (prev_pyr.H0, prev_pyr.W0) != (curr_pyr.H0, curr_pyr.W0):
        raise ValueError("prev and curr pyramids differ in size")
    if not 1 <= n_levels <= min(prev_pyr.n_levels, curr_pyr.n_levels):
        raise ValueError("n_levels exceeds the pyramids' depth")
    prev_pts = prev_pts.to(torch.float32).contiguous()
    init_pts = init_pts.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if (prev_pts.dim() not in (2, 3) or prev_pts.shape[-1] != 2
            or init_pts.shape != prev_pts.shape or valid.shape != prev_pts.shape[:-1]):
        raise ValueError(f"points {tuple(prev_pts.shape)}, {tuple(init_pts.shape)}, "
                         f"valid {tuple(valid.shape)}")
    B = _batch(prev_pyr, curr_pyr, prev_pts)
    kernels.check_cuda(prev_pyr.flat, curr_pyr.flat, prev_pts, init_pts, valid)
    return prev_pts, init_pts, valid, B


def pyramidal_lk_compact(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts, valid,
                         win: int = 15, max_iter: int = 30, eps: float = 0.01,
                         min_eig_threshold: float = 1e-4, n_levels: int | None = None,
                         max_iter_upper: int | None = None, des=None, clocks=None):
    """The compact-window tracker (``pyramidal_lk(compact_windows=True)``):
    on CUDA tensors ONE launch of K1's compact entry, which computes each
    level's des, stages the level's window in shared memory (P1's function)
    and iterates on it; on CPU tensors the plain route.  Returns (next_pts,
    status).  Points (F, 2), or (B, F, 2) with batched pyramids.  ``des``:
    an int32 (..., F, n_levels, 2) tensor the launch fills with each level's
    window origin ([..., L, :] at level L); ``clocks``: an int64
    (1 + 3 n_levels,) tensor for block 0's SM clock at its start and, coarse
    to fine, after each level's template, its window's wait and its
    Gauss-Newton steps."""
    if n_levels is None:
        n_levels = min(prev_pyr.n_levels, curr_pyr.n_levels)
    if prev_pts.device.type == "cpu":
        inst = _instances(prev_pyr, curr_pyr, prev_pts)
        lead = prev_pts.shape[:-1]
        pts, status, origins = _compact_levels(
            extract_windows_plain, pyramidal_lk_level_plain, prev_pyr, curr_pyr,
            prev_pts.reshape(-1, 2), init_pts.reshape(-1, 2), valid.reshape(-1), win, max_iter,
            eps, min_eig_threshold, n_levels, max_iter_upper, inst)
        if des is not None:
            des.copy_(origins.reshape(*lead, n_levels, 2))
        return pts.reshape(*lead, 2), status.reshape(lead)
    prev_pts, init_pts, valid, B = _check_points(prev_pyr, curr_pyr, prev_pts, init_pts, valid,
                                                 win, n_levels)
    F = prev_pts.shape[-2]
    if des is not None and (des.shape != (*prev_pts.shape[:-1], n_levels, 2)
                            or des.dtype != torch.int32):
        raise ValueError(f"des {tuple(des.shape)} {des.dtype} for points "
                         f"{tuple(prev_pts.shape)}")
    kernels.check_cuda(prev_pts, *(x for x in (des, clocks) if x is not None))
    kernels.observe("pyramidal_lk_compact", (prev_pyr, curr_pyr, prev_pts, init_pts, valid,
                                             win, max_iter, eps, min_eig_threshold, n_levels,
                                             max_iter_upper))
    out_pts = torch.empty_like(prev_pts)
    out_status = torch.empty(prev_pts.shape[:-1], dtype=torch.bool, device=prev_pts.device)
    kernels.launch("pyramidal_lk_compact", kernels.ptr(prev_pyr.flat),
                   kernels.ptr(curr_pyr.flat), prev_pyr.size, curr_pyr.size, B, prev_pyr.H0,
                   prev_pyr.W0, kernels.ptr(prev_pts), kernels.ptr(init_pts), kernels.ptr(valid),
                   F, n_levels, int(max_iter), int(max_iter_upper or 0), float(eps * eps),
                   float(min_eig_threshold), kernels.ptr(out_pts), kernels.ptr(out_status),
                   kernels.ptr(des) if des is not None else None,
                   kernels.ptr(clocks) if clocks is not None else None, int(win))
    pyramidal_lk_compact.launches += 1
    return out_pts, out_status


pyramidal_lk_compact.launches = 0


def pyramidal_lk(prev_pyr: Pyramid, curr_pyr: Pyramid, prev_pts, init_pts, valid,
                 win: int = 15, max_iter: int = 30, eps: float = 0.01,
                 min_eig_threshold: float = 1e-4, n_levels: int | None = None,
                 max_iter_upper: int | None = None, compact_windows: bool = False,
                 clocks=None):
    """Track ``prev_pts`` (F, 2) from ``prev_pyr`` into ``curr_pyr``, starting
    at ``init_pts``.  Returns (next_pts (F, 2) float32, status (F,) bool).
    A fleet's points (B, F, 2) with batched pyramids give (B, F, 2) and
    (B, F), in one launch.  ``max_iter_upper`` caps the iterations of
    levels > 0.  ``compact_windows`` (frontend.lk_compact_windows) tracks
    level by level on each point's exact 32-px search window:
    ``pyramidal_lk_compact``.  ``clocks``: an int64 (1 + 3 n_levels,) CUDA
    tensor for block 0's SM clock at its start and, coarse to fine, each
    level's [when its template is ready, after its Gauss-Newton steps, the
    number of steps it took] (the compact entry's ``clocks`` where
    ``compact_windows``)."""
    if prev_pts.device.type == "cpu":
        return pyramidal_lk_plain(prev_pyr, curr_pyr, prev_pts, init_pts, valid,
                                  win, max_iter, eps, min_eig_threshold, n_levels,
                                  max_iter_upper, compact_windows)
    if n_levels is None:
        n_levels = min(prev_pyr.n_levels, curr_pyr.n_levels)
    if compact_windows:
        return pyramidal_lk_compact(prev_pyr, curr_pyr, prev_pts, init_pts, valid, win,
                                    max_iter, eps, min_eig_threshold, n_levels, max_iter_upper,
                                    clocks=clocks)
    prev_pts, init_pts, valid, B = _check_points(prev_pyr, curr_pyr, prev_pts, init_pts, valid,
                                                 win, n_levels)
    if clocks is not None:
        kernels.check_cuda(prev_pts, clocks)
        if clocks.shape != (1 + 3 * n_levels,) or clocks.dtype != torch.int64:
            raise ValueError(f"clocks {tuple(clocks.shape)} {clocks.dtype} for {n_levels} levels")
    kernels.observe("pyramidal_lk", (prev_pyr, curr_pyr, prev_pts, init_pts, valid, win,
                                     max_iter, eps, min_eig_threshold, n_levels, max_iter_upper))
    out_pts = torch.empty_like(prev_pts)
    out_status = torch.empty(prev_pts.shape[:-1], dtype=torch.bool, device=prev_pts.device)
    kernels.launch("pyramidal_lk", kernels.ptr(prev_pyr.flat), kernels.ptr(curr_pyr.flat),
                   prev_pyr.size, curr_pyr.size, B, prev_pyr.H0, prev_pyr.W0,
                   kernels.ptr(prev_pts), kernels.ptr(init_pts), kernels.ptr(valid),
                   prev_pts.shape[-2], n_levels, int(max_iter), int(max_iter_upper or 0),
                   float(eps * eps), float(min_eig_threshold), kernels.ptr(out_pts),
                   kernels.ptr(out_status), kernels.ptr(clocks) if clocks is not None else None,
                   int(win))
    pyramidal_lk.launches += 1
    return out_pts, out_status


pyramidal_lk.launches = 0
