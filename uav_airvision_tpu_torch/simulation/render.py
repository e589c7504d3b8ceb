"""The simulated world rendered on a device: the port's ``StereoWorld.render_frame``.

``render_pair(world, t, rng, device)`` returns the stereo pair at trajectory
time ``t`` as two (H, W) uint8 tensors on ``device``; ``render_frames(world,
ts, rng, device)`` a chunk of them as two (T, H, W) stacks.  On a CPU device
they call ``world.render_frame`` (the plain version); on any other device
they run ``render_pair_tensor``, which computes what ``_render_cam``
(simulation/world.py) computes in tensor operations on the device:

- each camera's rays (uploaded once per world and device, with the texture
  and the vignette) rotated into the world and each plane's intersection
  ``s``, ``wx``, ``wy``, in float64;
- the bilinear texture sample with wrap-around (``_sample_tex``), in
  float32 with numpy's operation order;
- the far-to-near compositing (``s > 0.05``, ``s < best_s``, the plane's
  rectangle), the photometric gain, offset and vignette, the noise, the clip
  and the uint8 cast, each in the dtype numpy promotes to (a float64 numpy
  scalar promotes a float32 array under NumPy 2, not under NumPy 1).

The noise is drawn from the caller's numpy generator in the same calls and
order as ``render_frame`` (``rng.normal(0, 2.5, (H, W))`` for cam0, then
cam1; ``rng.normal(0, 1.0, ...)`` when not photometric; the two flat draws
inside a ``starve_window``) and uploaded, so the generator's state after
each frame is exactly ``render_frame``'s.  A division by a constant divides
by a 0-dim tensor on the device (CUDA's division by a Python number
multiplies by its reciprocal).  The rotation's float64 sums may round in
another order than numpy's BLAS, so a pixel on a floor or a uint8 boundary
can differ by one grey level, or a pixel on a plane's rectangle border take
the other plane (``pixel_agreement`` states the bar).

``render_frame`` blurs a photometric world with OpenCV where ``cv2``
imports; that branch is not implemented here, and ``render_pair_tensor``
raises where ``cv2`` imports on a photometric world rather than draw
another world.  ``without_opencv()`` builds and renders a world as a
machine without OpenCV does, on every device (the long run and the sweep's
synthetic suite run inside it).
"""

from __future__ import annotations

import collections
import contextlib
import sys
import weakref

import numpy as np
import torch

from ..device import get_device

#: Frames rendered, by route: "tensor" (render_pair_tensor) and "host"
#: (world.render_frame, the plain version).
frames_rendered = collections.Counter()

# a float64 numpy scalar times a float32 array: float64 under NumPy 2's
# promotion rules, float32 under NumPy 1's value-based casting
_SCALAR_PROMOTES = (np.ones(1, np.float32) * np.float64(1.0)).dtype == np.float64

_DEVICE_WORLDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _DeviceWorld:
    """A world's constant arrays on one device."""

    def __init__(self, world, device):
        f64 = torch.float64
        self.device = device
        n = world.tex.shape[0]
        self.n = n
        self.tex = torch.as_tensor(world.tex, device=device).reshape(-1)
        self.tex_scale = torch.tensor(world.tex_scale, dtype=f64, device=device)
        self.rays = {}
        for cam in ("cam0", "cam1"):
            r = torch.as_tensor(world._rays[cam], device=device).to(f64)  # float32 -> exact
            self.rays[cam] = (r[..., 0], r[..., 1], r[..., 2])
        H, W = world.H, world.W
        # the vignette as _render_cam builds it, with numpy on the host
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        r2 = (((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2)
        self.vignette = torch.as_tensor(1.0 - 0.25 * r2, device=device)


def _device_world(world, device) -> _DeviceWorld:
    per = _DEVICE_WORLDS.setdefault(world, {})
    if device not in per:
        per[device] = _DeviceWorld(world, device)
    return per[device]


@contextlib.contextmanager
def without_opencv():
    """Inside, ``import cv2`` fails: a world built and rendered there is the
    world a machine without OpenCV draws (``make_texture`` without
    ``cv2.resize``, ``render_frame`` without the blur), the one
    ``render_pair_tensor`` draws."""
    saved = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def _check_no_blur(world):
    if not world.photometric:
        return
    try:
        import cv2  # noqa: F401
    except Exception:
        return
    raise RuntimeError(
        "cv2 imports, so world.render_frame blurs this photometric world with "
        "cv2.GaussianBlur, which the device renderer does not implement: block cv2 "
        "(sys.modules['cv2'] = None) before building the world, or render on the CPU")


def _sample_tex(dw: _DeviceWorld, wx, wy, tex_off):
    """``StereoWorld._sample_tex``: bilinear, wrapping, float32 weights."""
    n = dw.n
    fx = (torch.div(wx, dw.tex_scale) + tex_off) * n
    fy = (torch.div(wy, dw.tex_scale) + tex_off) * n
    flx, fly = torch.floor(fx), torch.floor(fy)
    ax = (fx - flx).to(torch.float32)
    ay = (fy - fly).to(torch.float32)
    ix = torch.remainder(flx.to(torch.int64), n)
    iy = torch.remainder(fly.to(torch.int64), n)
    ix1 = torch.remainder(ix + 1, n)
    iy1 = torch.remainder(iy + 1, n)
    tex = dw.tex
    row0, row1 = iy * n, iy1 * n
    return (tex[row0 + ix] * (1 - ax) * (1 - ay)
            + tex[row0 + ix1] * ax * (1 - ay)
            + tex[row1 + ix] * (1 - ax) * ay
            + tex[row1 + ix1] * ax * ay)


def _render_cam(world, dw: _DeviceWorld, cam, R_c_w, t_c_w, noise, t):
    """``StereoWorld._render_cam`` on the device; ``noise`` is the float64
    draw render_frame adds, already on the device."""
    x, y, z = dw.rays[cam]
    # ray_w = rays @ R_c_w.T, one component at a time
    ray = [x * float(R_c_w[i, 0]) + y * float(R_c_w[i, 1]) + z * float(R_c_w[i, 2])
           for i in range(3)]
    rz = ray[2]
    rz_safe = torch.where(rz.abs() > 1e-6, rz, 1e-6)
    val = best_s = None
    for z_k, rect, tex_off in world.planes:
        num = torch.tensor(z_k - t_c_w[2], dtype=torch.float64, device=dw.device)
        s = torch.div(num, rz_safe)
        wx = s * ray[0] + float(t_c_w[0])
        wy = s * ray[1] + float(t_c_w[1])
        v = _sample_tex(dw, wx, wy, tex_off)
        if val is None:  # backdrop
            val = v
            best_s = torch.where(s > 0.05, s, float("inf")).to(torch.float32)
            continue
        x0, x1, y0, y1 = rect
        ok = (s > 0.05) & (s < best_s) & (wx >= x0) & (wx <= x1) & (wy >= y0) & (wy <= y1)
        val = torch.where(ok, v, val)
        best_s = torch.where(ok, s, best_s)  # float64 from the first overlay on, as numpy's
    if world.photometric:
        gain = 1.0 + 0.22 * np.sin(0.7 * t) + 0.06 * np.sin(3.1 * t)
        offset = 8.0 * np.sin(1.3 * t)
        if _SCALAR_PROMOTES:
            val = val.to(torch.float64)
        val = val * float(gain) + float(offset)
        val = val * dw.vignette
    return torch.clamp(val + noise, 0, 255).to(torch.uint8)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def render_pair_tensor(world, t, rng, device, starve_window=None):
    """``world.render_frame(t, rng, starve_window)`` in tensor operations on
    ``device`` (any device, the CPU included): two (H, W) uint8 tensors, the
    generator advanced exactly as ``render_frame`` advances it."""
    _check_no_blur(world)
    device = torch.device(device)
    rng = rng or np.random.default_rng(int(t * 1e6) & 0xFFFFFF)
    H, W = world.H, world.W
    frames_rendered["tensor"] += 1
    if starve_window is not None and starve_window[0] <= t < starve_window[1]:
        flat = [torch.clamp(_upload(rng.normal(0, 1.0, (H, W)), device) + 128.0, 0, 255)
                .to(torch.uint8) for _ in range(2)]
        return flat[0], flat[1]
    dw = _device_world(world, device)
    R_i_w = world.traj.R_i_w(t)
    p = world.traj.pos(t)
    R0 = R_i_w @ world.R_c0_i
    t0 = R_i_w @ world.t_c0_i + p
    R1 = R_i_w @ world.R_c1_i
    t1 = R_i_w @ world.t_c1_i + p
    sigma = 2.5 if world.photometric else 1.0
    img0 = _render_cam(world, dw, "cam0", R0, t0, _upload(rng.normal(0, sigma, (H, W)), device), t)
    img1 = _render_cam(world, dw, "cam1", R1, t1, _upload(rng.normal(0, sigma, (H, W)), device), t)
    return img0, img1


def render_pair(world, t, rng=None, device="cuda", starve_window=None):
    """The stereo pair at time ``t`` on ``device`` (the card unless the
    caller asks for the CPU; raises without CUDA): ``world.render_frame`` on
    the CPU, ``render_pair_tensor`` on any other device."""
    device = get_device(device)
    if device.type == "cpu":
        frames_rendered["host"] += 1
        img0, img1 = world.render_frame(t, rng, starve_window)
        return torch.from_numpy(img0), torch.from_numpy(img1)
    return render_pair_tensor(world, t, rng, device, starve_window)


def render_frames(world, ts, rng=None, device="cuda", starve_window=None):
    """``render_pair`` over the times ``ts``, in order, with one generator:
    two (T, H, W) uint8 stacks on ``device``."""
    pairs = [render_pair(world, t, rng, device, starve_window) for t in ts]
    return torch.stack([a for a, _ in pairs]), torch.stack([b for _, b in pairs])


def rect_border(world, t, tol=1e-6):
    """(2, H, W) bool, with numpy on the host: the pixels whose ray meets an
    overlay plane (in front of the camera) within ``tol`` m of its
    rectangle's edge, where a last-bit difference in ``wx``/``wy`` can take
    the other plane."""
    R_i_w = world.traj.R_i_w(t)
    p = world.traj.pos(t)
    out = []
    for cam, R_c_i, t_c_i in (("cam0", world.R_c0_i, world.t_c0_i),
                              ("cam1", world.R_c1_i, world.t_c1_i)):
        R, tc = R_i_w @ R_c_i, R_i_w @ t_c_i + p
        ray = world._rays[cam] @ R.T
        rz = np.where(np.abs(ray[..., 2]) > 1e-6, ray[..., 2], 1e-6)
        near = np.zeros((world.H, world.W), bool)
        for z_k, rect, _ in world.planes:
            if rect is None:
                continue
            s = (z_k - tc[2]) / rz
            wx, wy = tc[0] + s * ray[..., 0], tc[1] + s * ray[..., 1]
            x0, x1, y0, y1 = rect
            in_x = (wx >= x0 - tol) & (wx <= x1 + tol)
            in_y = (wy >= y0 - tol) & (wy <= y1 + tol)
            edge = (((np.abs(wx - x0) <= tol) | (np.abs(wx - x1) <= tol)) & in_y
                    | ((np.abs(wy - y0) <= tol) | (np.abs(wy - y1) <= tol)) & in_x)
            near |= edge & (s > 0.05)
        out.append(near)
    return np.stack(out)


def pixel_agreement(got, want, border=None):
    """The renderer's bar against ``render_frame``: at most one pixel in
    10,000 of each camera's image differs, each by at most one grey level
    unless it lies on a plane's rectangle border (``border``, (2, H, W) or
    None).  ``got`` and ``want`` are the (cam0, cam1) pairs; returns (ok, the
    number of differing pixels of the pair, the largest difference, the
    number off by more than one grey level off the border)."""
    got = np.stack([np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g) for g in got])
    want = np.stack([np.asarray(w) for w in want])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    per_cam = (diff > 0).reshape(2, -1).sum(1)
    big = diff > 1
    if border is not None:
        big &= ~border
    n_big = int(big.sum())
    ok = n_big == 0 and int(per_cam.max()) <= diff[0].size // 10_000
    return ok, int(per_cam.sum()), int(diff.max()), n_big
