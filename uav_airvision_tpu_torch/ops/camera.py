"""Pinhole camera model with radtan / equidistant distortion, batched over
points.  Port of uav_airvision_tpu/ops/camera.py (cv2.undistortPoints'
5-iteration fixed point, the projectPoints-style distort, the K R K^-1
homography warp).  Intrinsics and coefficients are a (4,) tensor or four
scalars (shared by all points), or a (4, n) tensor or four (n,) tensors
(one set per point).

On CUDA tensors ``undistort_points``, ``distort_points``,
``homography_warp_points`` and the fused stereo prologue
``undistort_distort_points`` launch kernel K7 (``csrc/camera.cu``, float32);
CPU tensors run the plain versions (``<name>_plain``)."""

from __future__ import annotations

import torch

from .. import kernels

UNDISTORT_ITERS = 5


def pixel_to_normalized(pts, intrinsics):
    fx, fy, cx, cy = intrinsics
    return torch.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], dim=-1)


def normalized_to_pixel(pts, intrinsics):
    fx, fy, cx, cy = intrinsics
    return torch.stack([pts[..., 0] * fx + cx, pts[..., 1] * fy + cy], dim=-1)


def _radtan_delta(x, y, k1, k2, p1, p2):
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, dx, dy


def distort_normalized_radtan(pts, coeffs):
    k1, k2, p1, p2 = coeffs
    x, y = pts[..., 0], pts[..., 1]
    radial, dx, dy = _radtan_delta(x, y, k1, k2, p1, p2)
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_normalized_radtan(pts, coeffs, iters=UNDISTORT_ITERS):
    k1, k2, p1, p2 = coeffs
    x0, y0 = pts[..., 0], pts[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        radial, dx, dy = _radtan_delta(x, y, k1, k2, p1, p2)
        inv = 1.0 / radial
        x = (x0 - dx) * inv
        y = (y0 - dy) * inv
    return torch.stack([x, y], dim=-1)


def distort_normalized_equidistant(pts, coeffs):
    k1, k2, k3, k4 = coeffs
    x, y = pts[..., 0], pts[..., 1]
    r = torch.sqrt(x * x + y * y)
    r_safe = torch.where(r > 1e-12, r, torch.ones_like(r))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = torch.where(r > 1e-12, theta_d / r_safe, torch.ones_like(r))
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_normalized_equidistant(pts, coeffs, iters=UNDISTORT_ITERS):
    k1, k2, k3, k4 = coeffs
    x, y = pts[..., 0], pts[..., 1]
    theta_d = torch.sqrt(x * x + y * y)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        theta = theta_d / (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = torch.where(theta_d > 1e-12,
                        torch.tan(theta) / torch.clamp(theta_d, min=1e-12),
                        torch.ones_like(theta_d))
    return torch.stack([x * scale, y * scale], dim=-1)


def _dispatch(model):
    if model == "equidistant":
        return distort_normalized_equidistant, undistort_normalized_equidistant
    return distort_normalized_radtan, undistort_normalized_radtan


def undistort_points_plain(pts_px, intrinsics, model, coeffs, rectification=None,
                           new_intrinsics=(1.0, 1.0, 0.0, 0.0)):
    _, undo = _dispatch(model)
    u = undo(pixel_to_normalized(pts_px, intrinsics), coeffs)
    if rectification is not None:
        h = torch.cat([u, torch.ones_like(u[..., :1])], dim=-1)
        h = torch.einsum("ij,...j->...i", rectification, h)
        u = h[..., :2] / h[..., 2:3]
    return normalized_to_pixel(u, new_intrinsics)


def distort_points_plain(pts_norm_px, intrinsics, model, coeffs):
    do, _ = _dispatch(model)
    return normalized_to_pixel(do(pts_norm_px, coeffs), intrinsics)


def undistort_distort_points_plain(pts_px, intrinsics, model, coeffs, rectification):
    und = undistort_points_plain(pts_px, intrinsics, model, coeffs, rectification)
    return und, distort_points_plain(und, intrinsics, model, coeffs)


def homography_warp_points_plain(pts_px, R_p_c, intrinsics):
    fx, fy, cx, cy = intrinsics
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                     torch.stack([z, z, o])])
    Kinv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                        torch.stack([z, 1.0 / fy, -cy / fy]),
                        torch.stack([z, z, o])])
    H = K @ R_p_c @ Kinv
    h = torch.cat([pts_px, torch.ones_like(pts_px[..., :1])], dim=-1)
    w = torch.einsum("ij,...j->...i", H, h)
    return w[..., :2] / w[..., 2:3]


def _on_cuda(pts) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (plain version)."""
    if pts.device.type == "cpu":
        return False
    if pts.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA tensors, got {pts.device}")
    if pts.dtype != torch.float32:
        raise ValueError(f"K7 takes float32 points, got {pts.dtype}")
    return True


def _points(pts):
    flat = pts.reshape(-1, 2).contiguous()
    return flat, flat.shape[0]


def _four(values, n, dev):
    """The kernel's form of four per-camera values: (tensor, field stride,
    point stride) from a (4,) or (4, n) tensor or four scalars / (n,)
    tensors.  No host read."""
    if not isinstance(values, torch.Tensor):
        values = [v if isinstance(v, torch.Tensor)
                  else torch.tensor(float(v), dtype=torch.float32, device=dev) for v in values]
        values = torch.stack(torch.broadcast_tensors(*values))
    v = values.to(torch.float32).contiguous()
    if v.device != dev:
        raise ValueError(f"tensor on {v.device}, expected {dev}")
    if v.shape == (4,):
        return v, 1, 0
    if v.shape == (4, n):
        return v, n, 1
    raise ValueError(f"K7: camera values of shape {tuple(v.shape)} for {n} points")


def _model_flag(model) -> int:
    return 1 if model == "equidistant" else 0


def _mat3(R, dev):
    R = R.to(torch.float32).contiguous()
    if R.shape != (3, 3) or R.device != dev:
        raise ValueError(f"K7: rotation {tuple(R.shape)} on {R.device}")
    return R


def undistort_points(pts_px, intrinsics, model, coeffs, rectification=None,
                     new_intrinsics=(1.0, 1.0, 0.0, 0.0)):
    """Pixel points -> undistorted points under ``new_intrinsics`` after an
    optional rectification rotation (cv2.undistortPoints semantics)."""
    if not _on_cuda(pts_px):
        return undistort_points_plain(pts_px, intrinsics, model, coeffs, rectification,
                                      new_intrinsics)
    kernels.observe("undistort_points", (pts_px, intrinsics, model, coeffs, rectification,
                                         new_intrinsics))
    dev = pts_px.device
    pts, n = _points(pts_px)
    intr, coef = _four(intrinsics, n, dev), _four(coeffs, n, dev)
    R = None if rectification is None else _mat3(rectification, dev)
    identity = (not isinstance(new_intrinsics, torch.Tensor)
                and not any(isinstance(v, torch.Tensor) for v in new_intrinsics)
                and tuple(float(v) for v in new_intrinsics) == (1.0, 1.0, 0.0, 0.0))
    new = None
    if not identity:
        new, _, stride = _four(new_intrinsics, n, dev)
        if stride != 0:
            raise ValueError("K7: new_intrinsics are four values shared by all points")
    out = torch.empty_like(pts)
    kernels.launch("camera_undistort", kernels.ptr(pts), n, kernels.ptr(intr[0]), *intr[1:],
                   kernels.ptr(coef[0]), *coef[1:], _model_flag(model),
                   None if R is None else kernels.ptr(R),
                   None if new is None else kernels.ptr(new), kernels.ptr(out))
    undistort_points.launches += 1
    return out.reshape(pts_px.shape)


def distort_points(pts_norm_px, intrinsics, model, coeffs):
    """Normalized points -> distorted pixel points."""
    if not _on_cuda(pts_norm_px):
        return distort_points_plain(pts_norm_px, intrinsics, model, coeffs)
    kernels.observe("distort_points", (pts_norm_px, intrinsics, model, coeffs))
    dev = pts_norm_px.device
    pts, n = _points(pts_norm_px)
    intr, coef = _four(intrinsics, n, dev), _four(coeffs, n, dev)
    out = torch.empty_like(pts)
    kernels.launch("camera_distort", kernels.ptr(pts), n, kernels.ptr(intr[0]), *intr[1:],
                   kernels.ptr(coef[0]), *coef[1:], _model_flag(model), kernels.ptr(out))
    distort_points.launches += 1
    return out.reshape(pts_norm_px.shape)


def undistort_distort_points(pts_px, intrinsics, model, coeffs, rectification):
    """The stereo prologue in one launch: (``undistort_points(pts, ...,
    rectification)``, ``distort_points`` of that result with the same
    camera), identical to the two calls."""
    if not _on_cuda(pts_px):
        return undistort_distort_points_plain(pts_px, intrinsics, model, coeffs, rectification)
    kernels.observe("undistort_distort_points", (pts_px, intrinsics, model, coeffs,
                                                 rectification))
    dev = pts_px.device
    pts, n = _points(pts_px)
    intr, coef = _four(intrinsics, n, dev), _four(coeffs, n, dev)
    R = _mat3(rectification, dev)
    und, dis = torch.empty_like(pts), torch.empty_like(pts)
    kernels.launch("camera_undistort_distort", kernels.ptr(pts), n, kernels.ptr(intr[0]),
                   *intr[1:], kernels.ptr(coef[0]), *coef[1:], _model_flag(model),
                   kernels.ptr(R), kernels.ptr(und), kernels.ptr(dis))
    undistort_distort_points.launches += 1
    return und.reshape(pts_px.shape), dis.reshape(pts_px.shape)


def homography_warp_points(pts_px, R_p_c, intrinsics):
    """Rotation-compensated prediction: warp by K R K^-1."""
    if not _on_cuda(pts_px):
        return homography_warp_points_plain(pts_px, R_p_c, intrinsics)
    kernels.observe("homography_warp_points", (pts_px, R_p_c, intrinsics))
    dev = pts_px.device
    pts, n = _points(pts_px)
    intr = _four(intrinsics, n, dev)
    R = _mat3(R_p_c, dev)
    out = torch.empty_like(pts)
    kernels.launch("camera_warp", kernels.ptr(pts), n, kernels.ptr(intr[0]), *intr[1:],
                   kernels.ptr(R), kernels.ptr(out))
    homography_warp_points.launches += 1
    return out.reshape(pts_px.shape)


WRAPPERS = (undistort_points, distort_points, undistort_distort_points,
            homography_warp_points)
for _fn in WRAPPERS:
    _fn.launches = 0
