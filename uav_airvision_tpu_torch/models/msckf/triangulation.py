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
one launch of K13 on CUDA tensors (plain version ``triangulate_rows_plain``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from ...config import TriangulationConfig
from ...utils import quaternion as quat


class TriangulationViews(NamedTuple):
    """2N masked views per feature, in the anchor (first observing cam0)
    frame: x_ci = R @ x_anchor + t.  Leading axis B = features."""

    R: torch.Tensor  # (B, 2N, 3, 3)
    t: torch.Tensor  # (B, 2N, 3)
    z: torch.Tensor  # (B, 2N, 2)
    mask: torch.Tensor  # (B, 2N)
    R_anchor: torch.Tensor  # (B, 3, 3)
    t_anchor: torch.Tensor  # (B, 3)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 if none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def build_views(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1) -> TriangulationViews:
    """cam_q (N,4), cam_p (N,3) window poses; obs (B,N,4); obs_mask (B,N).
    Views are ordered [cam0_0, cam1_0, cam0_1, cam1_1, ...]."""
    B, N = obs_mask.shape
    R_c0_w = quat.to_rotation(cam_q).transpose(-1, -2)  # (N,3,3) cam0 -> world
    t_c0_w = cam_p
    R_c1_c0 = R_c0c1.T
    t_c1_c0 = -R_c0c1.T @ t_c0c1
    R_c1_w = R_c0_w @ R_c1_c0
    t_c1_w = torch.einsum("nij,j->ni", R_c0_w, t_c1_c0) + t_c0_w
    first = _first_true(obs_mask)
    R_a, t_a = R_c0_w[first], t_c0_w[first]  # (B,3,3), (B,3)

    def rel(Rp, tp):
        Rr = torch.einsum("nji,bjk->bnik", Rp, R_a)
        tr = torch.einsum("nji,bnj->bni", Rp, t_a[:, None, :] - tp[None])
        return Rr, tr

    R0r, t0r = rel(R_c0_w, t_c0_w)
    R1r, t1r = rel(R_c1_w, t_c1_w)
    return TriangulationViews(
        R=torch.stack([R0r, R1r], dim=2).reshape(B, 2 * N, 3, 3),
        t=torch.stack([t0r, t1r], dim=2).reshape(B, 2 * N, 3),
        z=obs.reshape(B, 2 * N, 2),
        mask=torch.stack([obs_mask, obs_mask], dim=2).reshape(B, 2 * N),
        R_anchor=R_a, t_anchor=t_a)


def _take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _initial_guess(v: TriangulationViews):
    first = _first_true(v.mask)
    z1, z2 = _take(v.z, first), _take(v.z, first + 1)
    R, t = _take(v.R, first + 1), _take(v.t, first + 1)
    z1h = torch.cat([z1, torch.ones_like(z1[:, :1])], dim=-1)
    m = torch.einsum("bij,bj->bi", R, z1h)
    a = m[:, :2] - z2 * m[:, 2:3]
    b = z2 * t[:, 2:3] - t[:, :2]
    depth = (a * b).sum(-1) / (a * a).sum(-1)
    p = z1h * depth[:, None]
    return torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], 1.0 / p[:, 2]], dim=-1)


def _project(v: TriangulationViews, x):
    g = torch.stack([x[:, 0], x[:, 1], torch.ones_like(x[:, 0])], dim=-1)
    return torch.einsum("bnij,bj->bni", v.R, g) + x[:, 2, None, None] * v.t


def _total_cost(v: TriangulationViews, x):
    h = _project(v, x)
    e = ((h[..., :2] / h[..., 2:3] - v.z) ** 2).sum(-1)
    return torch.where(v.mask, e, 0.0).sum(-1)


def _normal_equations(v: TriangulationViews, x, huber_eps):
    h = _project(v, x)
    h1, h2 = h[..., 0], h[..., 1]
    h3 = torch.where(v.mask, h[..., 2], 1.0)
    W = torch.cat([v.R[..., :2], v.t[..., None]], dim=-1)  # (B,2N,3,3)
    J0 = W[..., 0, :] / h3[..., None] - W[..., 2, :] * (h1 / (h3 * h3))[..., None]
    J1 = W[..., 1, :] / h3[..., None] - W[..., 2, :] * (h2 / (h3 * h3))[..., None]
    J = torch.stack([J0, J1], dim=-2)  # (B,2N,2,3)
    r = torch.stack([h1 / h3, h2 / h3], dim=-1) - v.z
    e = torch.linalg.norm(r, dim=-1)
    w = torch.where(e <= huber_eps, torch.ones_like(e), huber_eps / (2.0 * e))
    w2 = torch.where(v.mask, w * w, 0.0)
    A = torch.einsum("bn,bnki,bnkj->bij", w2, J, J)
    b = torch.einsum("bn,bnki,bnk->bi", w2, J, r)
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
    """The LM solve over built views.  Returns (position_world (B,3),
    is_valid (B,)).  ``active=False`` rows run no solve (their result is
    the closed-form initial guess)."""
    dtype = v.z.dtype
    B = v.z.shape[0]
    dev = v.z.device
    x = _initial_guess(v)
    lam = torch.full((B,), tri.initial_damping, dtype=dtype, device=dev)
    cost = _total_cost(v, x)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev) if active is None else active
    dnorm = torch.where(alive, torch.full_like(lam, float("inf")), torch.zeros_like(lam))
    group_start = torch.ones((B,), dtype=torch.bool, device=dev)
    outer = torch.zeros((B,), dtype=torch.int32, device=dev)
    A = torch.zeros((B, 3, 3), dtype=dtype, device=dev)
    b = torch.zeros((B, 3), dtype=dtype, device=dev)
    for _ in range(tri.inner_loop_max_iteration):
        # segment boundary: outer-loop termination test + normal equations
        cond_ok = (outer < tri.outer_loop_max_iteration) & (dnorm > tri.estimation_precision)
        alive = alive & torch.where(group_start, cond_ok, True)
        start_now = alive & group_start
        A_new, b_new = _normal_equations(v, x, tri.huber_epsilon)
        A = torch.where(start_now[:, None, None], A_new, A)
        b = torch.where(start_now[:, None], b_new, b)
        outer = outer + start_now.to(torch.int32)
        # one damped solve, masked by alive
        delta = _solve3(A + lam[:, None, None] * eye3, b)
        x_new = x - delta
        dnorm_new = torch.linalg.norm(delta, dim=-1)
        cost_new = _total_cost(v, x_new)
        better = cost_new < cost
        upd = alive & better
        x = torch.where(upd[:, None], x_new, x)
        cost = torch.where(upd, cost_new, cost)
        lam = torch.where(alive, torch.where(better, torch.clamp(lam / 10.0, min=1e-10),
                                             torch.clamp(lam * 10.0, max=1e12)), lam)
        dnorm = torch.where(alive, dnorm_new, dnorm)
        group_start = torch.where(alive, better, group_start)
    return _finish(v, x)


def _finish(v: TriangulationViews, x):
    final = torch.stack([x[:, 0], x[:, 1], torch.ones_like(x[:, 0])], dim=-1) / x[:, 2:3]
    depths = torch.einsum("bnij,bj->bni", v.R, final)[..., 2] + v.t[..., 2]
    ok = torch.where(v.mask, depths > 0, True).all(-1)
    pos = torch.einsum("bij,bj->bi", v.R_anchor, final) + v.t_anchor
    return pos, ok


def check_motion(cam_q, cam_p, obs, obs_mask, tri: TriangulationConfig):
    """The baseline check before triangulation (JAX triangulation.py:294-314,
    reference feature_motion_checker.py:16-45), batched over B features: the
    camera translation from a feature's first to its last observation,
    orthogonal to the first observation's ray, must exceed
    ``translation_threshold``.  cam_q (N,4), cam_p (N,3), obs (B,N,4),
    obs_mask (B,N).  Returns (B,) bool.  Plain PyTorch on the views' inputs
    (no kernel: the JAX package's is an XLA function)."""
    B, N = obs_mask.shape
    m = obs_mask.to(torch.int32)
    first = torch.argmax(m, dim=1)
    last = (N - 1) - torch.argmax(m.flip(1), dim=1)
    R_first = quat.to_rotation(cam_q[first]).transpose(-1, -2)  # cam -> world
    z = _take(obs, first)[:, :2]
    direction = torch.cat([z, torch.ones_like(z[:, :1])], dim=-1)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    direction = torch.einsum("bij,bj->bi", R_first, direction)
    translation = cam_p[last] - cam_p[first]
    parallel = (translation * direction).sum(-1)
    ortho = translation - parallel[:, None] * direction
    return torch.linalg.norm(ortho, dim=-1) > tri.translation_threshold


def triangulate_plain(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1, tri: TriangulationConfig,
                      active=None):
    return triangulate_views(build_views(cam_q, cam_p, obs, obs_mask, R_c0c1, t_c0c1), tri,
                             active)


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
    Returns (position (M, 3), initialized (M,), init_fail (B,)), new tensors."""
    need_init = sel_ok & ~initialized[sel]
    mask = obs_mask[sel]
    new_pos, tri_ok = triangulate_plain(cam_q, cam_p, obs[sel], mask, R_c0c1, t_c0c1, tri,
                                        active=need_init)
    if tri.translation_threshold >= 0:  # the motion check (JAX step.py:191-196)
        tri_ok = tri_ok & check_motion(cam_q, cam_p, obs[sel], mask, tri)
    init_done = need_init & tri_ok
    position = position.index_put((sel,), torch.where(init_done[:, None], new_pos,
                                                      position[sel]))
    initialized = initialized.index_put((sel,), initialized[sel] | init_done)
    return position, initialized, need_init & ~tri_ok


def triangulate_rows(cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok, R_c0c1,
                     t_c0c1, tri: TriangulationConfig):
    """Triangulate the map rows ``sel`` (B,) int64 of the feature table
    (obs (M, N, 4), obs_mask (M, N), position (M, 3), initialized (M,))
    whose ``sel_ok`` (B,) holds and that are not initialized yet, over the
    window cam_q (N, 4), cam_p (N, 3), behind the motion check where
    ``tri.translation_threshold >= 0``.  ``sel`` holds distinct rows.
    Returns (position, initialized, init_fail (B,)): the new columns (the
    inputs are left as they are) and the rows that needed a position and
    got none.  On CUDA tensors ONE launch of K13 gathers, checks,
    triangulates and writes the new columns."""
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
    """K13's row entry's launch (``clocks`` as in ``_triangulate_kernel``)."""
    dtype, dev = obs.dtype, obs.device
    entry = {torch.float32: "triangulate_rows_f32",
             torch.float64: "triangulate_rows_f64"}.get(dtype)
    if entry is None:
        raise ValueError(f"K13 takes float32 or float64, got {dtype}")
    M, N = obs_mask.shape
    B = sel.shape[0]
    cam_q, cam_p, obs, position, R_c0c1, t_c0c1 = (
        x.to(dtype).contiguous() for x in (cam_q, cam_p, obs, position, R_c0c1, t_c0c1))
    obs_mask, initialized, sel_ok = (x.to(torch.bool).contiguous()
                                     for x in (obs_mask, initialized, sel_ok))
    sel = sel.contiguous()
    kernels.check_cuda(cam_q, cam_p, obs, obs_mask, position, initialized, sel, sel_ok, R_c0c1,
                       t_c0c1)
    if (cam_q.shape != (N, 4) or cam_p.shape != (N, 3) or obs.shape != (M, N, 4)
            or position.shape != (M, 3) or initialized.shape != (M,)
            or sel.dtype != torch.int64 or sel.shape != (B,) or sel_ok.shape != (B,)
            or R_c0c1.shape != (3, 3) or t_c0c1.shape != (3,)):
        raise ValueError("triangulate_rows: inconsistent window / table / row shapes")
    pos_out = torch.empty_like(position)
    init_out = torch.empty_like(initialized)
    fail = torch.empty((B,), dtype=torch.bool, device=dev)
    kernels.launch(entry, kernels.ptr(cam_q), kernels.ptr(cam_p), N, kernels.ptr(obs),
                   kernels.ptr(obs_mask), M, kernels.ptr(position), kernels.ptr(initialized),
                   kernels.ptr(sel), kernels.ptr(sel_ok), B, kernels.ptr(R_c0c1),
                   kernels.ptr(t_c0c1), float(tri.huber_epsilon),
                   float(tri.estimation_precision), float(tri.initial_damping),
                   int(tri.outer_loop_max_iteration), int(tri.inner_loop_max_iteration),
                   float(tri.translation_threshold), kernels.ptr(pos_out),
                   kernels.ptr(init_out), kernels.ptr(fail),
                   kernels.ptr(clocks) if clocks is not None else None)
    return pos_out, init_out, fail
