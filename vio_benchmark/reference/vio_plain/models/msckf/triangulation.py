# Frozen copy of uav_airvision_tpu_torch/models/msckf/triangulation.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Feature triangulation: inverse-depth Levenberg-Marquardt over all stereo
observations of a feature, batched over features.

Port of the ``static_solve`` path of
uav_airvision_tpu/models/msckf/triangulation.py::triangulate with
``build_views``: at most ``inner_loop_max_iteration`` damped 3x3 solves in
total (the reference's inner counter is shared across outer iterations),
Huber weights, a Cramer 3x3 solve, and the positive-depth validity check.
The JAX package's while-loop form (``static_solve=False``) gives the same
result, so the port runs this one form for both settings.

``triangulate`` launches kernel K13 (``csrc/triangulate.cu``, the views
built in the kernel, one warp per feature) on CUDA tensors and runs the
plain PyTorch version ``triangulate_plain`` on CPU tensors.
``triangulate_rows`` is the back-end's entry: the feature table's rows
``sel``, the motion check and the new position and initialized columns,
one launch of K13 on CUDA tensors (plain version ``triangulate_rows_plain``),
of one table or of a fleet's (a leading instance axis).  The plain helpers
work on (instances, features, ...) axes; a view's products are summed in
writing in K13's order (``quat.matvec``), so a feature's bits do not
depend on how many features or instances a call holds, and only the sums
over a feature's views round otherwise than the kernel's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from ...config import TriangulationConfig
from ...utils import quaternion as quat
from ...utils import tree


class TriangulationViews(NamedTuple):
    """2N masked views per feature, in the anchor (first observing cam0)
    frame: x_ci = R @ x_anchor + t.  Leading axes (S, B): instances, then
    their features."""

    R: torch.Tensor  # (S, B, 2N, 3, 3)
    t: torch.Tensor  # (S, B, 2N, 3)
    z: torch.Tensor  # (S, B, 2N, 2)
    mask: torch.Tensor  # (S, B, 2N)
    R_anchor: torch.Tensor  # (S, B, 3, 3)
    t_anchor: torch.Tensor  # (S, B, 3)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 if none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(x, idx):
    """x (S, B, n, ...) at idx (S, B) along its third axis."""
    return torch.gather(x, 2, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + (1,) + x.shape[3:]))[:, :, 0]


def build_views(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1) -> TriangulationViews:
    """cam_q (S,N,4), cam_p (S,N,3) the S instances' window poses; obs
    (S,B,N,4); obs_mask (S,B,N).  Views are ordered [cam0_0, cam1_0,
    cam0_1, cam1_1, ...]."""
    S, B, N = obs_mask.shape
    R_c0_w = quat.to_rotation(cam_q).transpose(-1, -2)  # (S,N,3,3) cam0 -> world
    t_c0_w = cam_p
    R_c1_c0 = R_c0c1.T
    t_c1_c0 = -R_c0c1.T @ t_c0c1
    R_c1_w = R_c0_w @ R_c1_c0
    t_c1_w = quat.matvec(R_c0_w, t_c1_c0) + t_c0_w
    first = _first_true(obs_mask)
    R_a = _take(R_c0_w[:, None].expand(S, B, N, 3, 3), first)  # (S,B,3,3)
    t_a = _take(t_c0_w[:, None].expand(S, B, N, 3), first)  # (S,B,3)

    def rel(Rp, tp):
        # sums over j written out, in the kernel's order: a feature's views
        # get the same bits whatever the number of features
        Rp = Rp[:, None]  # (S,1,N,3,3)
        Rr = sum(Rp[..., j, :, None] * R_a[:, :, None, j, None, :] for j in range(3))
        tr = quat.matvec(Rp.transpose(-1, -2), t_a[:, :, None, :] - tp[:, None])  # (S,B,N,3)
        return Rr, tr

    R0r, t0r = rel(R_c0_w, t_c0_w)
    R1r, t1r = rel(R_c1_w, t_c1_w)
    return TriangulationViews(
        R=torch.stack([R0r, R1r], dim=3).reshape(S, B, 2 * N, 3, 3),
        t=torch.stack([t0r, t1r], dim=3).reshape(S, B, 2 * N, 3),
        z=obs.reshape(S, B, 2 * N, 2),
        mask=torch.stack([obs_mask, obs_mask], dim=3).reshape(S, B, 2 * N),
        R_anchor=R_a, t_anchor=t_a)


def _initial_guess(v: TriangulationViews):
    first = _first_true(v.mask)
    z1, z2 = _take(v.z, first), _take(v.z, first + 1)
    R, t = _take(v.R, first + 1), _take(v.t, first + 1)
    z1h = torch.cat([z1, torch.ones_like(z1[..., :1])], dim=-1)
    m = quat.matvec(R, z1h)
    a = m[..., :2] - z2 * m[..., 2:3]
    b = z2 * t[..., 2:3] - t[..., :2]
    depth = (a * b).sum(-1) / (a * a).sum(-1)
    p = z1h * depth[..., None]
    return torch.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2], 1.0 / p[..., 2]], dim=-1)


def _project(v: TriangulationViews, x):
    g = torch.stack([x[..., 0], x[..., 1], torch.ones_like(x[..., 0])], dim=-1)
    return quat.matvec(v.R, g[..., None, :]) + x[..., 2, None, None] * v.t


def _total_cost(v: TriangulationViews, x):
    h = _project(v, x)
    e = ((h[..., :2] / h[..., 2:3] - v.z) ** 2).sum(-1)
    return torch.where(v.mask, e, 0.0).sum(-1)


def _normal_equations(v: TriangulationViews, x, huber_eps):
    h = _project(v, x)
    h1, h2 = h[..., 0], h[..., 1]
    h3 = torch.where(v.mask, h[..., 2], 1.0)
    W = torch.cat([v.R[..., :2], v.t[..., None]], dim=-1)  # (S,B,2N,3,3)
    J0 = W[..., 0, :] / h3[..., None] - W[..., 2, :] * (h1 / (h3 * h3))[..., None]
    J1 = W[..., 1, :] / h3[..., None] - W[..., 2, :] * (h2 / (h3 * h3))[..., None]
    J = torch.stack([J0, J1], dim=-2)  # (S,B,2N,2,3)
    r = torch.stack([h1 / h3, h2 / h3], dim=-1) - v.z
    e = torch.sqrt(r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1])
    w = torch.where(e <= huber_eps, torch.ones_like(e), huber_eps / (2.0 * e))
    w2 = torch.where(v.mask, w * w, 0.0)
    # a view's terms as K13 forms them, (w2 J0_a) J0_b + (w2 J1_a) J1_b,
    # then summed over the views
    w2J0, w2J1 = w2[..., None] * J[..., 0, :], w2[..., None] * J[..., 1, :]
    A = (w2J0[..., :, None] * J[..., 0, None, :] + w2J1[..., :, None] * J[..., 1, None, :]).sum(2)
    b = (w2J0 * r[..., 0, None] + w2J1 * r[..., 1, None]).sum(2)
    return A, b


def _solve3(A, b):
    """Batched closed-form 3x3 solve (adjugate over A's columns)."""
    c0 = torch.linalg.cross(A[..., :, 1], A[..., :, 2])
    c1 = torch.linalg.cross(A[..., :, 2], A[..., :, 0])
    c2 = torch.linalg.cross(A[..., :, 0], A[..., :, 1])
    det = (A[..., :, 0] * c0).sum(-1)
    ok = torch.abs(det) > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    x = torch.stack([(b * c0).sum(-1), (b * c1).sum(-1), (b * c2).sum(-1)], dim=-1) / safe[..., None]
    return torch.where(ok[..., None], x, torch.zeros_like(x))


def triangulate_views(v: TriangulationViews, tri: TriangulationConfig, active=None):
    """The LM solve over built views.  Returns (position_world (S,B,3),
    is_valid (S,B)).  ``active=False`` rows run no solve (their result is
    the closed-form initial guess)."""
    dtype, dev = v.z.dtype, v.z.device
    shape = v.z.shape[:2]
    x = _initial_guess(v)
    lam = torch.full(shape, tri.initial_damping, dtype=dtype, device=dev)
    cost = _total_cost(v, x)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev) if active is None else active
    dnorm = torch.where(alive, torch.full_like(lam, float("inf")), torch.zeros_like(lam))
    group_start = torch.ones(shape, dtype=torch.bool, device=dev)
    outer = torch.zeros(shape, dtype=torch.int32, device=dev)
    A = torch.zeros(shape + (3, 3), dtype=dtype, device=dev)
    b = torch.zeros(shape + (3,), dtype=dtype, device=dev)
    for _ in range(tri.inner_loop_max_iteration):
        # segment boundary: outer-loop termination test + normal equations
        cond_ok = (outer < tri.outer_loop_max_iteration) & (dnorm > tri.estimation_precision)
        alive = alive & torch.where(group_start, cond_ok, True)
        start_now = alive & group_start
        A_new, b_new = _normal_equations(v, x, tri.huber_epsilon)
        A = torch.where(start_now[..., None, None], A_new, A)
        b = torch.where(start_now[..., None], b_new, b)
        outer = outer + start_now.to(torch.int32)
        # one damped solve, masked by alive
        delta = _solve3(A + lam[..., None, None] * eye3, b)
        x_new = x - delta
        dnorm_new = torch.linalg.norm(delta, dim=-1)
        cost_new = _total_cost(v, x_new)
        better = cost_new < cost
        upd = alive & better
        x = torch.where(upd[..., None], x_new, x)
        cost = torch.where(upd, cost_new, cost)
        lam = torch.where(alive, torch.where(better, torch.clamp(lam / 10.0, min=1e-10),
                                             torch.clamp(lam * 10.0, max=1e12)), lam)
        dnorm = torch.where(alive, dnorm_new, dnorm)
        group_start = torch.where(alive, better, group_start)
    return _finish(v, x)


def _finish(v: TriangulationViews, x):
    final = torch.stack([x[..., 0], x[..., 1], torch.ones_like(x[..., 0])], dim=-1) / x[..., 2:3]
    depths = quat.matvec(v.R, final[..., None, :])[..., 2] + v.t[..., 2]
    ok = torch.where(v.mask, depths > 0, True).all(-1)
    pos = quat.matvec(v.R_anchor, final) + v.t_anchor
    return pos, ok


def check_motion(cam_q, cam_p, obs, obs_mask, tri: TriangulationConfig):
    """The baseline check before triangulation (JAX triangulation.py:294-314,
    reference feature_motion_checker.py:16-45), batched over B features: the
    camera translation from a feature's first to its last observation,
    orthogonal to the first observation's ray, must exceed
    ``translation_threshold``.  cam_q (N,4), cam_p (N,3), obs (B,N,4),
    obs_mask (B,N), or each with a leading axis of S instances.  Returns
    (B,) or (S, B) bool.  Plain PyTorch on the views' inputs (no kernel: the
    JAX package's is an XLA function)."""
    if cam_q.dim() == 2:
        return check_motion(*tree.one(cam_q, cam_p, obs, obs_mask), tri)[0]
    S, B, N = obs_mask.shape
    m = obs_mask.to(torch.int32)
    first = torch.argmax(m, dim=-1)
    last = (N - 1) - torch.argmax(m.flip(-1), dim=-1)
    rows = torch.arange(S, device=obs.device)[:, None]
    # every sum written out in K13's order (its motion check rounds so), a
    # decision at the threshold being the kernel's
    R_w = quat.to_rotation(cam_q[rows, first])  # world -> cam
    z = _take(obs, first)[..., :2]
    direction = torch.cat([z, torch.ones_like(z[..., :1])], dim=-1)
    direction = direction / torch.sqrt(_dot3(direction, direction))[..., None]
    direction = quat.matvec(R_w.transpose(-1, -2), direction)  # the ray in the world
    translation = cam_p[rows, last] - cam_p[rows, first]
    parallel = _dot3(translation, direction)
    ortho = translation - parallel[..., None] * direction
    return torch.sqrt(_dot3(ortho, ortho)) > tri.translation_threshold


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def triangulate_plain(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri: TriangulationConfig,
                      active=None):
    pos, ok = triangulate_views(build_views(*tree.one(cam_q, cam_p, obs, obs_mask), R_c0c1, t_c0c1),
                                tri, *tree.one(active))
    return pos[0], ok[0]


def triangulate(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri: TriangulationConfig,
                active=None):
    """Triangulate B features over their masked stereo observations of the
    window: cam_q (N,4), cam_p (N,3), obs (B,N,4), obs_mask (B,N), the
    stereo extrinsic R_c0c1 (3,3), t_c0c1 (3,), active (B,) or None.
    Returns (position_world (B,3), is_valid (B,))."""
    dev = obs.device
    if dev.type == "cpu":
        return triangulate_plain(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri, active)
    if dev.type != "cuda":
        raise ValueError(f"K13 runs on CUDA tensors, got {dev}")
    args = (cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri, active)
    kernels.observe("triangulate", args)
    out = _triangulate_kernel(*args)
    triangulate.launches += 1
    return out


triangulate.launches = 0


def _triangulate_kernel(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri, active,
                        clocks=None):
    """K13's launch.  ``clocks``: an int64 (9,) tensor for block 0's first
    warp: its SM clock at the start, after the views and after the initial
    guess and cost; its cycles in the normal equations, the solves and the
    trial costs; the clock after the loop and after the finish; its steps."""
    dtype, dev = obs.dtype, obs.device
    entry = {torch.float32: "triangulate_f32", torch.float64: "triangulate_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K13 takes float32 or float64, got {dtype}")
    B, N = obs_mask.shape
    cam_q, cam_p, obs, R_c0c1, t_c0c1 = (x.to(dtype).contiguous()
                                         for x in (cam_q, cam_p, obs, R_c0c1, t_c0c1))
    obs_mask = obs_mask.to(torch.bool).contiguous()
    args = [cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1]
    if active is not None:
        active = active.to(torch.bool).contiguous()
        args.append(active)
    kernels.check_cuda(*args)
    if (cam_q.shape != (N, 4) or cam_p.shape != (N, 3) or obs.shape != (B, N, 4)
            or R_c0c1.shape != (3, 3) or t_c0c1.shape != (3,)
            or (active is not None and active.shape != (B,))):
        raise ValueError("triangulate: inconsistent window / observation shapes")
    pos = torch.empty((B, 3), dtype=dtype, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    kernels.launch(entry, kernels.ptr(cam_q), kernels.ptr(cam_p), N, kernels.ptr(obs),
                   kernels.ptr(obs_mask), kernels.ptr(R_c0c1), kernels.ptr(t_c0c1),
                   kernels.ptr(active) if active is not None else None, B,
                   float(tri.huber_epsilon), float(tri.estimation_precision),
                   float(tri.initial_damping), int(tri.outer_loop_max_iteration),
                   int(tri.inner_loop_max_iteration), kernels.ptr(pos), kernels.ptr(ok),
                   kernels.ptr(clocks) if clocks is not None else None)
    return pos, ok


def triangulate_rows_plain(cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok,
                           R_c0c1, t_c0c1, tri: TriangulationConfig):
    """The back-end's triangulation of the map rows ``sel`` as its call site
    did it: ``need_init = sel_ok & ~initialized[sel]`` triangulated over all
    their observations, behind the motion check where it is on, the
    positions and the initialized flags written back where that succeeded.
    Of one table, or of a fleet's (every argument but the extrinsic with a
    leading instance axis); one table runs as a fleet of one.  Returns
    (position (M, 3), initialized (M,), init_fail (B,)), new tensors."""
    if cam_q.dim() == 2:
        out = triangulate_rows_plain(*tree.one(cam_q, cam_p, obs, obs_mask, position, initialized,
                                           sel, sel_ok), R_c0c1, t_c0c1, tri)
        return tuple(x[0] for x in out)
    rows = torch.arange(sel.shape[0], device=sel.device)[:, None]
    need_init = sel_ok & ~initialized[rows, sel]
    mask, o = obs_mask[rows, sel], obs[rows, sel]
    new_pos, tri_ok = triangulate_views(build_views(cam_q, cam_p, o, mask, R_c0c1, t_c0c1), tri,
                                        need_init)
    if tri.translation_threshold >= 0:  # the motion check (JAX step.py:191-196)
        tri_ok = tri_ok & check_motion(cam_q, cam_p, o, mask, tri)
    init_done = need_init & tri_ok
    position = position.index_put((rows, sel), torch.where(init_done[..., None], new_pos,
                                                           position[rows, sel]))
    initialized = initialized.index_put((rows, sel), initialized[rows, sel] | init_done)
    return position, initialized, need_init & ~tri_ok


def triangulate_rows(cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok, R_c0c1,
                     t_c0c1, tri: TriangulationConfig):
    """Triangulate the map rows ``sel`` (B,) int64 of the feature table
    (obs (M, N, 4), obs_mask (M, N), position (M, 3), initialized (M,))
    whose ``sel_ok`` (B,) holds and that are not initialized yet, over the
    window cam_q (N, 4), cam_p (N, 3), behind the motion check where
    ``tri.translation_threshold >= 0``.  ``sel`` holds distinct rows.  A
    fleet's call gives every argument but the extrinsic R_c0c1, t_c0c1 a
    leading instance axis.  Returns (position, initialized, init_fail
    (B,)): the new columns (the inputs are left as they are) and the rows
    that needed a position and got none.  On CUDA tensors ONE launch of K13
    gathers, checks, triangulates and writes the new columns, for every
    instance of a fleet."""
    dev = obs.device
    if dev.type == "cpu":
        return triangulate_rows_plain(cam_q, cam_p, obs, obs_mask, position, initialized, sel,
                                      sel_ok, R_c0c1, t_c0c1, tri)
    if dev.type != "cuda":
        raise ValueError(f"K13 runs on CUDA tensors, got {dev}")
    args = (cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok, R_c0c1, t_c0c1,
            tri)
    kernels.observe("triangulate_rows", args)
    out = _triangulate_rows_kernel(*args)
    triangulate_rows.launches += 1
    return out


triangulate_rows.launches = 0


def _triangulate_rows_kernel(cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok,
                             R_c0c1, t_c0c1, tri, clocks=None):
    """K13's row entry's launch (``clocks`` as in ``_triangulate_kernel``,
    the first instance's)."""
    dtype, dev = obs.dtype, obs.device
    entry = {torch.float32: "triangulate_rows_f32",
             torch.float64: "triangulate_rows_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K13 takes float32 or float64, got {dtype}")
    fleet = cam_q.dim() == 3
    S = cam_q.shape[0] if fleet else 1
    lead = cam_q.shape[:1] if fleet else ()
    M, N = obs_mask.shape[-2:]
    B = sel.shape[-1]
    ins, strides = [], []
    for x, t in zip((cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok),
                    (dtype,) * 3 + (torch.bool, dtype, torch.bool, torch.int64, torch.bool)):
        x, st = kernels.per_instance(x, t, fleet)
        ins.append(x)
        strides.append(st)
    cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok = ins
    R_c0c1, t_c0c1 = (x.to(dtype).contiguous() for x in (R_c0c1, t_c0c1))
    kernels.check_cuda(R_c0c1, t_c0c1, *(x[0] if fleet else x for x in ins))
    if (cam_q.shape != lead + (N, 4) or cam_p.shape != lead + (N, 3)
            or obs.shape != lead + (M, N, 4) or position.shape != lead + (M, 3)
            or initialized.shape != lead + (M,) or sel.shape != lead + (B,)
            or sel_ok.shape != lead + (B,) or R_c0c1.shape != (3, 3) or t_c0c1.shape != (3,)):
        raise ValueError("triangulate_rows: inconsistent window / table / row shapes")
    pos_out = torch.empty(lead + (M, 3), dtype=dtype, device=dev)
    init_out = torch.empty(lead + (M,), dtype=torch.bool, device=dev)
    fail = torch.empty(lead + (B,), dtype=torch.bool, device=dev)
    strides += [3 * M, M, B]
    ptr = kernels.ptr
    kernels.launch(entry, ptr(cam_q), ptr(cam_p), N, ptr(obs), ptr(obs_mask), M, ptr(position),
                   ptr(initialized), ptr(sel), ptr(sel_ok), B, ptr(R_c0c1), ptr(t_c0c1),
                   float(tri.huber_epsilon), float(tri.estimation_precision),
                   float(tri.initial_damping), int(tri.outer_loop_max_iteration),
                   int(tri.inner_loop_max_iteration), float(tri.translation_threshold),
                   ptr(pos_out), ptr(init_out), ptr(fail), S, kernels.int64s(strides),
                   ptr(clocks) if clocks is not None else None)
    return pos_out, init_out, fail
