# Frozen copy of uav_airvision_tpu_torch/ops/camera.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Pinhole camera model with radtan / equidistant distortion, batched over
points.  Port of uav_airvision_tpu/ops/camera.py (cv2.undistortPoints'
5-iteration fixed point, the projectPoints-style distort, the K R K^-1
homography warp).  Intrinsics and coefficients are a (4,) tensor or four
scalars (shared by all points), or a (4, n) tensor or four (n,) tensors
(one set per point).

On CUDA tensors ``undistort_points``, ``distort_points``,
``homography_warp_points`` and the fused stereo prologue
``undistort_distort_points`` launch kernel K7 (``csrc/camera.cu``, float32),
as do two entry points that fuse the camera model with the front-end's glue
around it: ``predict_warp_points`` (the IMU-rotation prediction and the
warp) and ``stereo_gate`` (the stereo matcher's cuts after the backward LK);
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
    if rectification is not None:  # each point's own sums (a matmul's depend on the count)
        x, y, R = u[..., 0], u[..., 1], rectification
        h = [R[i, 0] * x + R[i, 1] * y + R[i, 2] for i in range(3)]
        u = torch.stack([h[0] / h[2], h[1] / h[2]], dim=-1)
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


def _mat3_mul(A, B):
    """A @ B of (..., 3, 3) blocks, each entry's three products summed left
    to right (the kernel's mat3_mul): an instance's bits whatever the
    batch, where a library product's depend on it."""
    return torch.stack([torch.stack([(A[..., r, 0] * B[..., 0, c] + A[..., r, 1] * B[..., 1, c])
                                     + A[..., r, 2] * B[..., 2, c] for c in range(3)], -1)
                        for r in range(3)], -2)


def predicted_rotation(w, dt, R_cam_imu):
    """A camera's inter-frame rotation R_p_c = rodrigues(R_cam_imu' w dt)'
    from the mean gyro rate (cv2.Rodrigues' closed form), of one instance
    (w (3,), dt ()) or of each of a fleet's (w (..., 3), dt (...)), in the
    kernel's expressions: (R' w)_c = (R_0c w_0 + R_1c w_1) + R_2c w_2, the
    angle sqrt((x^2 + y^2) + z^2), R = (I + sin(t) K) + (1 - cos(t)) K K
    with K the skew matrix of the unit axis, the identity for an angle
    <= 1e-12."""
    R = R_cam_imu
    r = torch.stack([((R[0, c] * w[..., 0] + R[1, c] * w[..., 1]) + R[2, c] * w[..., 2]) * dt
                     for c in range(3)], -1)
    x, y, z = r.unbind(-1)
    theta = torch.sqrt((x * x + y * y) + z * z)
    big = theta > 1e-12
    safe = torch.where(big, theta, torch.ones_like(theta))
    kx, ky, kz = x / safe, y / safe, z / safe
    o = torch.zeros_like(kx)
    K = torch.stack([torch.stack([o, -kz, ky], -1), torch.stack([kz, o, -kx], -1),
                     torch.stack([-ky, kx, o], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Rot = (eye + torch.sin(theta)[..., None, None] * K) + (
        1.0 - torch.cos(theta))[..., None, None] * _mat3_mul(K, K)
    return torch.where(big[..., None, None], Rot, eye).transpose(-1, -2)


def predict_warp_points_plain(pts_px, mean_ang_vel, dt, R_cam_imu, intrinsics):
    """Plain version of K7's prediction, of one instance ((F, 2) points, a
    (3,) rate, a one-element dt) or of a fleet's ((B, F, 2), (B, 3), (B,)):
    the kernel's expressions elementwise (the homography K R K^-1 and the
    warp too), so that each instance's values are its single call's."""
    fleet = pts_px.dim() == 3
    w = mean_ang_vel if fleet else mean_ang_vel[None]
    R = predicted_rotation(w, dt.reshape(w.shape[0]), R_cam_imu)  # (B, 3, 3)
    fx, fy, cx, cy = intrinsics
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]), torch.stack([z, z, o])])
    Kinv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]), torch.stack([z, 1.0 / fy, -cy / fy]),
                        torch.stack([z, z, o])])
    Hm = _mat3_mul(_mat3_mul(K.expand_as(R), R), Kinv.expand_as(R))[:, None]  # (B, 1, 3, 3)
    pts = pts_px if fleet else pts_px[None]
    x, y = pts[..., 0], pts[..., 1]
    wx, wy, wz = ((Hm[..., i, 0] * x + Hm[..., i, 1] * y) + Hm[..., i, 2] for i in range(3))
    out = torch.stack([wx / wz, wy / wz], -1)
    return (out, R) if fleet else (out[0], R[0])


def epipolar_residual_plain(cam0_pts, p1, intrinsics, model, coeffs, E):
    """The reference's epipolar residual |u1_x l_0| / |l[:2]|, l = E [u0 1]',
    with both sides undistorted by the one (cam0's) model; normalized
    units."""
    B = cam0_pts.shape[0]
    und_both = undistort_points_plain(torch.cat([cam0_pts, p1]), intrinsics, model, coeffs)
    und0, und1 = und_both[:B], und_both[B:]
    x, y = und0[:, 0], und0[:, 1]
    l0, l1 = (E[i, 0] * x + E[i, 1] * y + E[i, 2] * 1.0 for i in range(2))
    return torch.abs(und1[:, 0] * l0) / torch.linalg.norm(torch.stack([l0, l1], dim=-1), dim=-1)


def stereo_gate_plain(cam0_pts, p1, p0r, proj1, valid, st_fwd, intrinsics, model, coeffs, E,
                      fwd_bwd_px, max_vdisp_px, threshold, h, w):
    err = torch.linalg.norm(cam0_pts - p0r, dim=-1)
    disp = torch.abs(proj1[:, 1] - p1[:, 1])
    inlier = valid & st_fwd & (err < fwd_bwd_px) & (disp < max_vdisp_px)
    inlier = inlier & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)
    err_epi = epipolar_residual_plain(cam0_pts, p1, intrinsics, model, coeffs, E)
    fx, fy = intrinsics[0], intrinsics[1]
    norm_unit = 4.0 / (2.0 * fx + 2.0 * fy)
    return inlier & (err_epi <= threshold * norm_unit)


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


def _check(t, dtype, shape, what):
    if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"K7 {what}: expected contiguous {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def predict_warp_points(pts_px, mean_ang_vel, dt, R_cam_imu, intrinsics):
    """The temporal tracker's prediction: (``pts_px`` warped by K R K^-1,
    R) with R the camera's inter-frame rotation from the mean gyro rate over
    ``dt`` (``predicted_rotation``).  One instance's (F, 2) points, (3,)
    rate and one-element dt, or a fleet's (B, F, 2), (B, 3) and (B,) (each
    instance contiguous along its rows; the kernel reads each at its
    instance stride), with a (3, 3) extrinsic rotation and (4,) intrinsics,
    all float32.  Returns (points, R) with the points' leading axis.  On
    CUDA tensors ONE launch of K7 for every instance (a block row an
    instance); a single call is the launch of one."""
    if not _on_cuda(pts_px):
        return predict_warp_points_plain(pts_px, mean_ang_vel, dt, R_cam_imu, intrinsics)
    kernels.observe("predict_warp_points", (pts_px, mean_ang_vel, dt, R_cam_imu, intrinsics))
    fleet = pts_px.dim() == 3
    B = pts_px.shape[0] if fleet else 1
    n = pts_px.shape[-2]
    lead = (B,) if fleet else ()
    f32 = torch.float32
    pts, s_pts = kernels.per_instance(pts_px, f32, fleet)
    w, s_w = kernels.per_instance(mean_ang_vel, f32, fleet)
    if dt.dtype != f32 or dt.numel() != B or (fleet and dt.shape != (B,)):
        raise ValueError(f"K7 dt: expected {B} float32 values, got {tuple(dt.shape)} {dt.dtype}")
    dt, s_dt = kernels.per_instance(dt, f32, fleet)
    if pts.shape != lead + (n, 2) or w.shape != lead + (3,):
        raise ValueError(f"K7 points {tuple(pts.shape)} and angular velocity {tuple(w.shape)} "
                         f"for {B} instances")
    _check(R_cam_imu, f32, (3, 3), "rotation")
    _check(intrinsics, f32, (4,), "intrinsics")
    kernels.check_cuda(*(x[0] if fleet else x for x in (pts, w, dt)), R_cam_imu, intrinsics)
    row = 2 * n + 9
    out = torch.empty(lead + (row,), dtype=f32, device=pts_px.device)
    kernels.launch("camera_predict_warp", pts.data_ptr(), n, w.data_ptr(), dt.data_ptr(),
                   R_cam_imu.data_ptr(), intrinsics.data_ptr(), out.data_ptr(), B,
                   kernels.int64s([s_pts, s_w, s_dt, row if fleet else 0]))
    predict_warp_points.launches += 1
    return out[..., :2 * n].unflatten(-1, (n, 2)), out[..., 2 * n:].unflatten(-1, (3, 3))


def stereo_gate(cam0_pts, p1, p0r, proj1, valid, st_fwd, intrinsics, model, coeffs, E,
                fwd_bwd_px, max_vdisp_px, threshold, h, w):
    """The stereo matcher's inlier decision after the backward LK: valid,
    forward-tracked, fwd/bwd error under ``fwd_bwd_px``, vertical disparity
    against the rotation projection ``proj1`` under ``max_vdisp_px``, ``p1``
    inside the (h, w) image, and the reference's epipolar residual with both
    sides undistorted by this (cam0's) model within ``threshold`` pixels.
    The kernel takes (B, 2) float32 points, (B,) bools, one camera's (4,)
    intrinsics and coefficients and the (3, 3) essential matrix ``E``."""
    if not _on_cuda(cam0_pts):
        return stereo_gate_plain(cam0_pts, p1, p0r, proj1, valid, st_fwd, intrinsics, model,
                                 coeffs, E, fwd_bwd_px, max_vdisp_px, threshold, h, w)
    kernels.observe("stereo_gate", (cam0_pts, p1, p0r, proj1, valid, st_fwd, intrinsics, model,
                                    coeffs, E, fwd_bwd_px, max_vdisp_px, threshold, h, w))
    B = cam0_pts.shape[0]
    f32 = torch.float32
    for t, what in ((cam0_pts, "cam0 points"), (p1, "cam1 points"), (p0r, "back-tracked points"),
                    (proj1, "projected points")):
        _check(t, f32, (B, 2), what)
    _check(valid, torch.bool, (B,), "valid")
    _check(st_fwd, torch.bool, (B,), "status")
    _check(intrinsics, f32, (4,), "intrinsics")
    _check(coeffs, f32, (4,), "coefficients")
    _check(E, f32, (3, 3), "essential matrix")
    out = torch.empty((B,), dtype=torch.bool, device=cam0_pts.device)
    kernels.launch("camera_stereo_gate", cam0_pts.data_ptr(), p1.data_ptr(), p0r.data_ptr(),
                   proj1.data_ptr(), valid.data_ptr(), st_fwd.data_ptr(), B,
                   intrinsics.data_ptr(), coeffs.data_ptr(), _model_flag(model), E.data_ptr(),
                   fwd_bwd_px, max_vdisp_px, threshold, int(h), int(w), out.data_ptr())
    stereo_gate.launches += 1
    return out


WRAPPERS = (undistort_points, distort_points, undistort_distort_points,
            homography_warp_points)
for _fn in WRAPPERS + (predict_warp_points, stereo_gate):
    _fn.launches = 0
