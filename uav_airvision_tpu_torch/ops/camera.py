"""Pinhole camera model with radtan / equidistant distortion, batched over
points.  Port of uav_airvision_tpu/ops/camera.py (cv2.undistortPoints'
5-iteration fixed point, the projectPoints-style distort, the K R K^-1
homography warp).  Intrinsics and coefficients are 4-tuples of scalars or
of per-point tensors."""

from __future__ import annotations

import torch

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


def undistort_points(pts_px, intrinsics, model, coeffs, rectification=None,
                     new_intrinsics=(1.0, 1.0, 0.0, 0.0)):
    """Pixel points -> undistorted points under ``new_intrinsics`` after an
    optional rectification rotation (cv2.undistortPoints semantics)."""
    _, undo = _dispatch(model)
    u = undo(pixel_to_normalized(pts_px, intrinsics), coeffs)
    if rectification is not None:
        h = torch.cat([u, torch.ones_like(u[..., :1])], dim=-1)
        h = torch.einsum("ij,...j->...i", rectification, h)
        u = h[..., :2] / h[..., 2:3]
    return normalized_to_pixel(u, new_intrinsics)


def distort_points(pts_norm_px, intrinsics, model, coeffs):
    do, _ = _dispatch(model)
    return normalized_to_pixel(do(pts_norm_px, coeffs), intrinsics)


def homography_warp_points(pts_px, R_p_c, intrinsics):
    """Rotation-compensated prediction: warp by K R K^-1."""
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
