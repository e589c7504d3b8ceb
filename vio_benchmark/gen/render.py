"""Batched stereo rendering on a device: the layered, photometric world.

Frozen from uav_airvision_tpu_torch/simulation/render.py and world.py
(``_render_cam``, ``_sample_tex``) at commit efd1109, without numpy's bit
parity: every operation is a float32 tensor operation over a batch of
frames, and the sensor noise comes from a ``torch.Generator`` on the device.
Per pixel and camera: the ray rotated into the world, each plane's
intersection, a bilinear wrapping texture sample, far-to-near compositing
inside each overlay's rectangle, the photometric gain, offset and vignette,
Gaussian noise (sigma 2.5), the clip and the uint8 cast.  No blur (the
source's OpenCV-free path).
"""

from __future__ import annotations

import numpy as np
import torch

from .world import PLANES, TEX_SCALE

NOISE_SIGMA = 2.5


class DeviceScene:
    """One rig's rays and vignette on a device, shared by every world."""

    def __init__(self, rig, device):
        self.device = device
        self.H, self.W = rig.H, rig.W
        self.rays = {cam: torch.as_tensor(rig.rays[cam], dtype=torch.float32, device=device)
                     for cam in ("cam0", "cam1")}
        yy, xx = np.mgrid[0:self.H, 0:self.W].astype(np.float64)
        r2 = ((xx - self.W / 2) / (self.W / 2)) ** 2 + ((yy - self.H / 2) / (self.H / 2)) ** 2
        self.vignette = torch.as_tensor(1.0 - 0.25 * r2, dtype=torch.float32, device=device)


def _sample(tex, wx, wy, tex_off):
    n = tex.shape[0]
    fx = (wx / TEX_SCALE + tex_off) * n
    fy = (wy / TEX_SCALE + tex_off) * n
    flx, fly = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - flx, fy - fly
    ix = torch.remainder(flx.to(torch.int64), n)
    iy = torch.remainder(fly.to(torch.int64), n)
    ix1, iy1 = torch.remainder(ix + 1, n), torch.remainder(iy + 1, n)
    flat = tex.reshape(-1)
    r0, r1 = iy * n, iy1 * n
    return (flat[r0 + ix] * (1 - ax) * (1 - ay) + flat[r0 + ix1] * ax * (1 - ay)
            + flat[r1 + ix] * (1 - ax) * ay + flat[r1 + ix1] * ax * ay)


def render_batch(scene: DeviceScene, tex, cam, R_c_w, t_c_w, ts, gen, out):
    """Render ``len(ts)`` frames of one camera into ``out`` ((F, H, W)
    uint8): ``R_c_w`` (F, 3, 3) and ``t_c_w`` (F, 3) host float64 poses,
    ``ts`` (F,) the world times, ``tex`` the world's texture."""
    dev = scene.device
    R = torch.as_tensor(R_c_w, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t_c_w, dtype=torch.float32, device=dev)
    rays = scene.rays[cam]  # (H, W, 3)
    ray = torch.einsum("hwk,fjk->fjhw", rays, R)  # (F, 3, H, W)
    rz = ray[:, 2]
    rz = torch.where(rz.abs() > 1e-6, rz, torch.full_like(rz, 1e-6))
    val = best = None
    for z_k, rect, tex_off in PLANES:
        s = (z_k - t[:, 2, None, None]) / rz
        wx = t[:, 0, None, None] + s * ray[:, 0]
        wy = t[:, 1, None, None] + s * ray[:, 1]
        v = _sample(tex, wx, wy, tex_off)
        if val is None:  # backdrop
            val, best = v, torch.where(s > 0.05, s, torch.full_like(s, float("inf")))
            continue
        x0, x1, y0, y1 = rect
        ok = (s > 0.05) & (s < best) & (wx >= x0) & (wx <= x1) & (wy >= y0) & (wy <= y1)
        val = torch.where(ok, v, val)
        best = torch.where(ok, s, best)
    tt = np.asarray(ts, np.float64)
    gain = torch.as_tensor(1.0 + 0.22 * np.sin(0.7 * tt) + 0.06 * np.sin(3.1 * tt),
                           dtype=torch.float32, device=dev)[:, None, None]
    offset = torch.as_tensor(8.0 * np.sin(1.3 * tt), dtype=torch.float32,
                             device=dev)[:, None, None]
    val = (val * gain + offset) * scene.vignette
    noise = torch.randn(val.shape, generator=gen, dtype=torch.float32, device=dev)
    out.copy_(torch.clamp(val + NOISE_SIGMA * noise, 0, 255).to(torch.uint8))
