"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: exits 1 unless CUDA is available; prints the card's name and
   power limit (nvidia-smi) and builds the kernels of
   ``uav_airvision_tpu_torch/csrc`` (nvcc, sm_90a, one process per source).
2. Front-end kernels against their plain PyTorch versions on the card, at
   main-path shapes, on a rendered 752x480 bench-world frame pair: K2
   (pyramid) and K4+K6 (FAST + mask + NMS) exactly, K1 (LK; temporal 104
   points x 2 levels, stereo forward 204 x 2, backward 204 x level 0) status
   agreeing on >= 99% of points and agreeing points within 1e-3 px.
3. Main path, warm run: the bench world as bench.py renders it
   (euroc_config, seed 5, 200 frames) through ``run_sequence`` on the card,
   with an observer (``kernels.observer``) recording the arguments of the
   kernels' calls, the latest per shape, and counting the calls per shape.
4. Back-end kernels against their plain versions on those recorded calls
   (real filter states of the bench world), plus forced cases the bench
   world may not reach:
   - K14 (propagation, 11 IMU samples): within 1e-5 relative;
   - K13 (triangulation, every recorded B and B = 128): validity identical,
     positions within 1e-4 of max(|p|, 1) for 95% of the features and within
     1e-3 for each (a cost comparison that ties within rounding can take the
     other LM branch, and an unconverged solve ends a step apart);
   - K9 (feature block, N = 20 and the prune's N = 2): H_proj, r_proj within
     3e-5 (N = 20) / 1e-4 (N = 2: the reflections of two close views
     cancel) of each block's largest entry, rows_true exact.  Both sides
     are float32 and sum the reflections in another order (1.8e-5 seen on a
     one-view block, where the projection is all cancellation); the phase
     also prints how far each is from the float64 plain version, and the
     views and depth of the block on which they differ most;
   - K10 (gate; bounds on the 77-row blocks, gamma on the 5-, 32- and
     77-row prefixes, residual scales 1e-3, 1, 10, 30, 1e3): gamma within
     1e-4 relative, bound flags and decisions identical except within 1e-4
     of a threshold;
   - K12 (rank-12 prune update, as recorded and with an exactly singular
     P12): P_new and delta within 1e-4 of max(|P|, 1).
   - K7 (camera models: the stereo prologue, the epilogue's and the
     publish's undistort, the homography warp, and ``distort_points`` on
     the prologue's output; as recorded with the radtan model and again
     with equidistant coefficients): normalized outputs within 1e-6, pixel
     outputs within one float32 ulp at 752 px (6.1e-5 px), two for the
     prologue's re-distorted points (its undistorted input already differs
     by an ulp of the normalized coordinate, times fx); the fused prologue
     equal, bit for bit, to the kernel's two separate calls;
   - K5 (per-cell top-k, k = 8 and k = 5) and K8 (``rank_in_cell``,
     ``kept_order_stats``, ``compact_kept``, ``smallest_k_indices``,
     ``stable_compact_indices`` on every recorded shape): exactly equal;
   - K11 (the EKF update) at the row tiers T1, T2 and QR, in float32 and
     float64, on recorded calls; a tier the bench world did not take is
     reached by stacking a recorded call's rows.  float64: delta and P_new
     within 1e-10 of max|delta| and max(|P|, 1) of the plain version.
     float32: both held to the float64 plain version, P_new within 1e-5 of
     max(|P|, 1) and delta within 1e-4 of max|delta|, or within 4 x the
     float32 plain version's own distance from float64 where that is
     larger (S has s2 on its diagonal, so its condition number, which both
     float32 solves feel, is bounded by tr(H P H') / s2).
   Median times by CUDA events, warm; the JSON line's times and bound are
   those of each kernel's (each entry point's) most frequent shape.
5. Main path, timed run: every launch counter set to 0 just before it.
   Checks: every kernel (each entry point on the path) launched, finite
   poses, >= 150 active frames, ATE max (per-frame |p - groundtruth|, no
   alignment) under ATE_BAR_M.  The first 40 frames also run through the
   port's plain PyTorch path on the host; poses must agree within 1e-4 m.
   Prints how many EKF updates took each row tier.
6. Streaming path: the same IMU and stereo messages through
   ``DataPublisher`` -> queues -> ``vio.VIO`` (three threads) after
   ``warmup``, at STREAM_RATIO x real time, launch counters set to 0 just
   before.  The stereo publisher is anchored STREAM_IMG_LAG_S of dataset
   time after the IMU publisher: a frame and the IMU sample stamped at the
   frame's time share one deadline, and the orchestrator's (last, frame_t]
   window drops a sample that arrives after its frame.  The interpreter's
   thread switch interval is 1 ms during the phase, so that the IMU thread
   is not held behind the image thread for 5 ms a message.  Checks: every kernel launched,
   as many poses as the batch run has active frames, positions within
   STREAM_TOL_M of the batch run's, ATE max under ATE_BAR_M, no thread died.
   Prints poses/s and the median and p95 latency from a frame's arrival in
   the queue to its publish.  Then the same messages once more with both
   publishers started together and the default switch interval, as
   ``main.py --mode realtime`` runs them: there a frame can overtake the IMU
   sample of its own timestamp, so this run is held to the ground truth
   (>= 150 finite poses, ATE max under ATE_BAR_M, every kernel launched, no
   thread died), not to the batch run's digits.
7. Prints the per-kernel JSON line (launches of the batch run, max error,
   ms, plain ms, the bound and what binds it, the library call's ms where
   one PyTorch call does most of the function), then the result line
   ``{"ok": true, "device": {...}}`` last.  Any failure exits nonzero.

Bounds: bytes each input read once and each output written once over
3.35 TB/s, against the operations counted from this run's shapes over
67 TFLOP/s (float32 outside the tensor cores; H100 SXM data sheet).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# 1.25 x the JAX package's ATE max on the same 200 frames rendered without
# cv2 (0.03286 m, measured on the CPU; PERF.md).  The card's machine has no
# OpenCV, so the world renders its texture without cv2 there.
ATE_BAR_M = 0.0411
MIN_ACTIVE = 150
N_FRAMES = 200
STREAM_RATIO = 1.0  # playback speed of the streaming phase (10 s of data)
# the stereo stream lags the IMU stream by this much dataset time: more than
# the threads' hand-over jitter, less than the 45 ms after which frame 19
# would see the 200th IMU message and become active, unlike in the batch run
STREAM_IMG_LAG_S = 0.02
STREAM_TOL_M = 1e-4  # streamed poses against the batch run's (equal windows: ~1e-6)
PX_ULP = 2.0 ** -14  # one float32 ulp at 752 px (6.1e-5 px)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


FAILURES: list = []


def fail(msg: str) -> None:
    """Record a failed check; the script goes on to the end of the phase
    that can still run and exits nonzero."""
    print(f"FAIL: {msg}", flush=True)
    FAILURES.append(msg)


def fatal(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 30) -> float:
    """Median wall time of one call on the card, by CUDA events, warm."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float):
    """(ms, what binds): the least time the card could take for the work,
    bytes over the memory rate or operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def render_bench_world(n_frames: int):
    import numpy as np

    from uav_airvision_tpu_torch.config import euroc_config
    from uav_airvision_tpu_torch.simulation.world import StereoWorld
    from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu

    config = euroc_config()
    world = StereoWorld(config)
    dur = n_frames / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(dur)
    fts = world.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    return config, world, pb, np.stack(cam0), np.stack(cam1), (imu_t, imu_w, imu_a), fts


def check_kernels(config, frames, dev):
    """Each kernel against its plain version at main-path shapes (K1, K2,
    K4+K6).  Returns {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from uav_airvision_tpu_torch.models.frontend import pipeline
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
    from uav_airvision_tpu_torch.ops import fast, gridops, lk, pyramid

    fe = config.frontend
    fparams = make_frontend_params(config, dev)
    state = pipeline.init_frontend_state(config, dev)
    for k in range(2):  # a tracking state: first frame + one tracked frame
        state, _ = pipeline.frontend_step(state, frames.cam0[k], frames.cam1[k],
                                          frames.fe_mean_w[k], frames.fe_dt[k], fparams, config)
    cam0, cam1 = frames.cam0[2], frames.cam1[2]
    res = {}

    # K2: every padded level exactly equal, both cameras
    for cam in (cam0, cam1):
        got = pyramid.build_pyramid_padded(cam, fe.pyramid_levels)
        want = pyramid.build_pyramid_padded_plain(cam, fe.pyramid_levels)
        err = max(float((g - w).abs().max()) for g, w in zip(got.levels, want.levels))
        if err != 0.0:
            fail(f"K2 pyramid differs from its plain version by {err}")
    # ~20 integer operations per output pixel (two separable 5-tap passes)
    k2_bound = bound(nbytes(cam0, got.flat),
                     20 * sum(lv.numel() for lv in got.levels[1:]))
    res["K2"] = (0.0,
                 cuda_ms(lambda: pyramid.build_pyramid_padded(cam0, fe.pyramid_levels)),
                 cuda_ms(lambda: pyramid.build_pyramid_padded_plain(cam0, fe.pyramid_levels)),
                 *k2_bound)
    print(f"[K2] pyramid 480x752 -> 4 padded levels: exact; "
          f"{res['K2'][1]:.4f} ms vs plain {res['K2'][2]:.4f} ms")

    # K4+K6: FAST + the 104-point detection mask + NMS, exactly equal
    pts, valid = state.cam0, state.valid
    kk, ks = fast.detect_fast(cam0, fe.fast_threshold, pts, valid)
    pk, ps = fast.detect_fast_plain(cam0, fe.fast_threshold, pts, valid)
    if not (torch.equal(kk, pk) and torch.equal(ks, ps)):
        bad = torch.nonzero((kk != pk) | (ks != ps))
        y, x = (int(v) for v in bad[0])
        fail(f"K4+K6 FAST differs from its plain version at {len(bad)} pixels, "
             f"first ({y}, {x}): kernel keep/score {bool(kk[y, x])}/{int(ks[y, x])}, "
             f"plain {bool(pk[y, x])}/{int(ps[y, x])}")
        uk, us = fast.detect_fast(cam0, fe.fast_threshold)
        pk2, ps2 = fast.detect_fast_plain(cam0, fe.fast_threshold)
        ck, cs = fast.detect_fast_plain(cam0.cpu(), fe.fast_threshold)
        import hashlib
        print(f"[K4+K6] frame sha {hashlib.sha256(cam0.cpu().numpy().tobytes()).hexdigest()[:16]}"
              f"; without the mask: kernel keeps {int(uk.sum())}, plain {int(pk2.sum())}, "
              f"plain on the host {int(ck.sum())}; kernel vs plain differ at "
              f"{int((uk != pk2).sum())}, plain vs host plain at "
              f"{int((pk2.cpu() != ck).sum())} pixels")
    if int(kk.sum()) < 100:
        fail(f"K4+K6 kept only {int(kk.sum())} corners")
    # ~48 operations per pixel: 16 ring differences against two thresholds,
    # the arc test and the 3x3 maximum
    res["K4+K6"] = (0.0, cuda_ms(lambda: fast.detect_fast(cam0, fe.fast_threshold, pts, valid)),
                    cuda_ms(lambda: fast.detect_fast_plain(cam0, fe.fast_threshold, pts, valid)),
                    *bound(nbytes(cam0, pts, valid, kk, ks), 48 * cam0.numel()))
    print(f"[K4+K6] FAST + 104-point mask + NMS, 480x752: exact ({int(kk.sum())} corners); "
          f"{res['K4+K6'][1]:.4f} ms vs plain {res['K4+K6'][2]:.4f} ms")

    # K1: the three LK call shapes of a tracked frame
    pyr0 = pyramid.build_pyramid_padded(cam0, fe.pyramid_levels)
    pyr1 = pyramid.build_pyramid_padded(cam1, fe.pyramid_levels)
    curr, st = lk.pyramidal_lk(state.prev_pyr, pyr0, state.cam0, state.cam0, state.valid,
                               n_levels=2, max_iter=10, max_iter_upper=5)
    ks_, kscore = fast.detect_fast(cam0, fe.fast_threshold, curr, st)
    ys, xs, vals = gridops.dense_grid_topk(kscore, fe.grid_row, fe.grid_col,
                                           fe.grid_max_feature_num)
    cand = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    both = torch.cat([curr, cand])
    both_valid = torch.cat([st, vals.reshape(-1) > 0])
    disp = (state.cam1 - state.cam0)[state.valid].median(0).values
    shapes = {
        "temporal 104 pts x 2 levels": (state.prev_pyr, pyr0, state.cam0, state.cam0,
                                        state.valid, 2, 5),
        "stereo fwd 204 pts x 2 levels": (pyr0, pyr1, both, both + disp, both_valid, 2, 5),
        "stereo bwd 204 pts x level 0": (pyr1, pyr0, both + disp, both, both_valid, 1, None),
    }
    err_all, ms_all, plain_all, bytes_all, ops_all = 0.0, 0.0, 0.0, 0, 0
    for label, (pp, cp, p0, p1, v, nl, up) in shapes.items():
        args = dict(win=15, max_iter=10, eps=0.01, min_eig_threshold=1e-4, n_levels=nl,
                    max_iter_upper=up)
        kn, kst = lk.pyramidal_lk(pp, cp, p0, p1, v, **args)
        pn, pst = lk.pyramidal_lk_plain(pp, cp, p0, p1, v, **args)
        agree = float((kst == pst).float().mean())
        both_ok = kst & pst
        err = float((kn[both_ok] - pn[both_ok]).abs().max()) if bool(both_ok.any()) else 0.0
        if agree < 0.99 or err > 1e-3 or int(both_ok.sum()) < 20:
            fail(f"K1 {label}: status agreement {agree:.4f}, max err {err:.2e} px, "
                 f"{int(both_ok.sum())} tracked")
        ms = cuda_ms(lambda: lk.pyramidal_lk(pp, cp, p0, p1, v, **args))
        pms = cuda_ms(lambda: lk.pyramidal_lk_plain(pp, cp, p0, p1, v, **args), reps=10)
        print(f"[K1] {label}: status agreement {agree:.4f}, max err {err:.3e} px "
              f"({int(both_ok.sum())} tracked); {ms:.4f} ms vs plain {pms:.4f} ms")
        err_all, ms_all, plain_all = max(err_all, err), ms_all + ms, plain_all + pms
        # per valid point and level, the (15+2)^2 patch of the previous image
        # (template and its gradients) and at least one of the current image;
        # the points and status in and out.  ~31 operations per window pixel:
        # the template gradients and at least one iteration
        point_levels = int(v.sum()) * nl
        bytes_all += (point_levels * 2 * 17 ** 2 * pp.flat.element_size()
                      + nbytes(p0, p1, v, kn, kst))
        ops_all += point_levels * 225 * 31
    res["K1"] = (err_all, ms_all, plain_all, *bound(bytes_all, ops_all))
    return res


def check_propagate(filter_state, params, frames, k):
    """K14 against its plain version on a real covariance."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import propagation

    dtype = filter_state.cov.dtype
    # frame k's IMU samples, re-stamped to follow the state's timestamp
    mask = frames.imu_mask[k]
    steps = torch.arange(1, mask.shape[0] + 1, device=mask.device, dtype=dtype)
    imu_t = torch.where(mask, filter_state.imu.timestamp + 0.005 * steps, 0.0)
    args = (filter_state, params, imu_t, frames.imu_w[k].to(dtype),
            frames.imu_a[k].to(dtype), mask)
    n_valid = int(frames.imu_mask[k].sum())
    got = propagation.propagate(*args)
    want = propagation.propagate_plain(*args)
    err = 0.0
    for g, w in ((got.cov, want.cov), (got.imu.q, want.imu.q), (got.imu.v, want.imu.v),
                 (got.imu.p, want.imu.p), (got.imu.q_null, want.imu.q_null)):
        err = max(err, float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)))
    abs_err = float((got.cov - want.cov).abs().max())
    if not err <= 1e-5 or not torch.isfinite(got.cov).all():
        fail(f"K14 propagate: relative error {err:.3e} > 1e-5")
    ms = cuda_ms(lambda: propagation.propagate(*args))
    pms = cuda_ms(lambda: propagation.propagate_plain(*args), reps=10)
    print(f"[K14] propagate {n_valid} IMU samples, {tuple(got.cov.shape)} covariance: "
          f"relative error {err:.3e}; {ms:.4f} ms vs plain {pms:.4f} ms")
    # per valid sample ~119 kFLOP of 21x21 products (Fdt^2, Fdt^3, the
    # composition, Phi G, Q); then Phi P_ii Phi^T, Phi P_ic, the symmetrization
    D = filter_state.cov.shape[0]
    ops = n_valid * 119_000 + 2 * 2 * 21 ** 3 + 2 * 21 * 21 * (D - 21) + D * D
    b = bound(nbytes(filter_state.cov, got.cov, *args[2:]), ops)
    return abs_err, ms, pms, *b


class Recorder:
    """Installed as the kernels' observer (``kernels.observer``), keeps the
    arguments of the latest call of each observed kernel wrapper for each
    shape (and of a few earlier ones), and counts the calls per shape."""

    KEYS = {  # wrapper: (label, shape from its arguments)
        "triangulate": ("K13", lambda a: a[2].shape[0]),
        "feature_block": ("K9", lambda a: tuple(a[5].shape)),
        "gating_test_batch": ("K10", lambda a: tuple(a[0].shape)),
        "gate_bounds": ("K10 bounds", lambda a: tuple(a[0].shape)),
        "gate_gamma": ("K10 gamma", lambda a: tuple(a[0].shape)),
        "rank12_update": ("K12", lambda a: tuple(a[1].shape)),
        "ekf_update": ("K11", lambda a: _update_tier(a)),
        "dense_grid_topk": ("K5", lambda a: a[3]),
        "rank_in_cell": ("K8 rank_in_cell", lambda a: a[0].shape[0]),
        "kept_order_stats": ("K8 kept_order_stats", lambda a: a[0].shape[0]),
        "compact_kept": ("K8 compact_kept", lambda a: (a[0].shape[0], a[2])),
        "smallest_k_indices": ("K8 smallest_k_indices", lambda a: (a[0].shape[0], a[1])),
        "stable_compact_indices": ("K8 stable_compact_indices", lambda a: a[0].shape[0]),
        "undistort_points": ("K7 undistort_points",
                             lambda a: (a[0].shape[0], a[4] is not None)),
        "distort_points": ("K7 distort_points", lambda a: a[0].shape[0]),
        "undistort_distort_points": ("K7 undistort_distort_points", lambda a: a[0].shape[0]),
        "homography_warp_points": ("K7 homography_warp_points", lambda a: a[0].shape[0]),
    }

    def __init__(self):
        self.calls, self.counts, self.history = {}, {}, {}

    def __call__(self, name, args):
        label, shape = self.KEYS[name]
        key = (label, shape(args))
        self.calls[key] = args
        n = self.counts[key] = self.counts.get(key, 0) + 1
        if n <= 2 or n % 40 == 0:  # a few earlier calls of each shape, too
            self.history.setdefault(key, []).append(args)

    def __enter__(self):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = self
        return self

    def __exit__(self, *exc):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = None

    def of(self, kind):
        return {k[1]: v for k, v in sorted(self.calls.items(), key=str) if k[0] == kind}

    def samples(self, kind):
        """[(shape, args)]: the kept calls of a kind, every shape."""
        return [(k[1], a) for k in sorted(self.history, key=str) if k[0] == kind
                for a in self.history[k]]

    def most_frequent(self, kind):
        """The shape of the kind's most frequent call (on a tie, the first in
        ``of``'s order)."""
        keys = sorted((k for k in self.counts if k[0] == kind), key=str)
        return max(keys, key=lambda k: self.counts[k])[1] if keys else None


def _update_tier(a):
    from uav_airvision_tpu_torch.models.msckf.update import update_tier

    return update_tier(a[1].shape[0], a[1].shape[1], a[4])


def _rows_needed(H, r):
    """Per block, the rows up to the last one with a nonzero entry of H or r."""
    import torch

    nz = (H.abs().amax(2) != 0) | (r != 0)
    idx = torch.arange(nz.shape[1], device=nz.device).expand_as(nz)
    return (torch.where(nz, idx, -1).amax(1) + 1).to(torch.float64).cpu()


def check_backend_kernels(rec: Recorder, config, params):
    """K13, K9, K10 and K12 against their plain versions on the calls the
    warm run recorded, and on forced cases.  Returns {name: (max_abs_err,
    ms, plain_ms, bound_ms, bound_by)} with the times and bound at each
    kernel's (each K10 entry point's) most frequent shape in the warm run."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import triangulation as tri
    from uav_airvision_tpu_torch.models.msckf import update as upd

    res = {}

    # K13: every recorded batch size, and B = 128 by repeating a call
    calls = rec.of("K13")
    if not calls:
        fail("the warm run made no triangulation call")
        return res
    if 128 not in calls:
        a = list(calls[max(calls)])
        idx = torch.arange(128, device=a[2].device) % a[2].shape[0]
        a[2], a[3] = a[2][idx], a[3][idx]
        if a[7] is not None:
            a[7] = a[7][idx]
        calls[128] = tuple(a)
    for B, a in sorted(calls.items()):
        pos, ok = tri.triangulate(*a)
        ppos, pok = tri.triangulate_plain(*a)
        both = ok & pok & torch.isfinite(ppos).all(1)
        rel = ((pos - ppos).abs().max(1).values / ppos.abs().max(1).values.clamp(min=1.0))[both]
        err = float(rel.max()) if len(rel) else 0.0
        abs_err = float((pos - ppos)[both].abs().max()) if bool(both.any()) else 0.0
        close = float((rel <= 1e-4).float().mean()) if len(rel) else 1.0
        if not torch.equal(ok, pok) or not err <= 1e-3 or close < 0.95:
            fail(f"K13 B={B}: validity differs on {int((ok != pok).sum())} features, "
                 f"position error {err:.3e}, {close:.3f} of features within 1e-4")
        ms = cuda_ms(lambda: tri.triangulate(*a))
        pms = cuda_ms(lambda: tri.triangulate_plain(*a), reps=10)
        n_obs = a[3].sum(1).to(torch.float64)
        act = a[7] if a[7] is not None else torch.ones_like(ok)
        # per observing slot ~230 FLOP to build its two views; per view ~27
        # FLOP for a cost, ~75 for the normal equations, ~7 for the depth
        # check; an active feature takes at least one step
        ops = float((n_obs * 230 + 2 * n_obs * (27 + 7) + act * 2 * n_obs * (75 + 27)).sum())
        b = bound(nbytes(*a[:6], pos, ok) + (nbytes(a[7]) if a[7] is not None else 0), ops)
        print(f"[K13] triangulate B={B} x N={a[3].shape[1]}: validity identical, max position "
              f"error {err:.3e} of max(|p|, 1), {close:.3f} of features within 1e-4; "
              f"{ms:.4f} ms vs plain {pms:.4f} ms; "
              f"bound {b[0] * 1e3:.3f} us ({b[1]})")
        if B == rec.most_frequent("K13"):
            res["K13"] = (abs_err, ms, pms, *b)

    # K9: the lost features' N = 20 blocks and the prune's N = 2 blocks
    calls = rec.of("K9")
    for (B, N), a in sorted(calls.items()):
        H, r, rows = upd.feature_block(*a)
        pH, pr, prows = upd.feature_block_plain(*a)
        scale = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
        err = max(float(((g - w).abs().flatten(1).amax(1) / scale).max())
                  for g, w in ((H, pH), (r, pr)))
        abs_err = max(float((H - pH).abs().max()), float((r - pr).abs().max()))
        # float32 against float32: the reflections are summed in another
        # order, and a block that the projection leaves almost nothing of (a
        # feature seen in one view keeps one row of four) is all cancellation
        # in both, so the two differ by up to the sum of what each is off the
        # float64 result (1.8e-5 seen on such a block of the bench world)
        tol = 3e-5 if N > 2 else 1e-4
        a64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                    for x in a)
        H64, r64, _ = upd.feature_block_plain(*a64)
        e_k, e_p = (max(float(((g - w).abs().flatten(1).amax(1) / scale).max())
                        for g, w in pair) for pair in (((H, H64), (r, r64)),
                                                       ((pH, H64), (pr, r64))))
        worst = int(((H - pH).abs().flatten(1).amax(1) / scale).argmax())
        seen = a[5][worst]
        cams = a[1][seen]
        base = float(torch.cdist(cams, cams).max())
        depth = float((a[6][worst] - cams).norm(dim=1).min())
        print(f"[K9] B={B} N={N}: against the float64 plain version the kernel is {e_k:.3e} "
              f"off, the float32 plain version {e_p:.3e}; the block where the two differ most "
              f"has {int(seen.sum())} view(s) over a baseline of {base:.3f} m at depth "
              f"{depth:.2f} m")
        if not torch.equal(rows, prows) or not err <= tol:
            fail(f"K9 B={B} N={N}: error {err:.3e} of the block maximum, rows equal "
                 f"{torch.equal(rows, prows)}")
        ms = cuda_ms(lambda: upd.feature_block(*a))
        pms = cuda_ms(lambda: upd.feature_block_plain(*a), reps=10)
        n_obs = a[5].sum(1).to(torch.float64)
        # ~400 FLOP per observing slot for its Jacobians; three reflections
        # of ~5 FLOP per entry over the 4 n_obs x (4 + 6 n_obs) live tile
        ops = float((n_obs * 400 + 15 * 4 * n_obs * (4 + 6 * n_obs)).sum())
        b = bound(nbytes(*a[:10], H, r, rows), ops)
        print(f"[K9] feature_block B={B} x N={N} -> {tuple(H.shape)}: error {err:.3e} of the "
              f"block maximum; {ms:.4f} ms vs plain {pms:.4f} ms; bound {b[0] * 1e3:.3f} us "
              f"({b[1]})")
        if (B, N) == rec.most_frequent("K9"):
            res["K9"] = (abs_err, ms, pms, *b)

    # K10: the recorded gate calls at forced residual scales and row tiers
    gates = rec.of("K10")
    gate_err = 0.0
    for shape, a in sorted(gates.items()):
        H, r, rows, cov, noise, table, dof = a
        tiers = [rows] if H.shape[1] <= 32 else [rows, torch.full_like(rows, H.shape[1])]
        thresh = table[torch.clamp(dof, 0, table.shape[0] - 1).long()]
        for scale in (1e-3, 1.0, 10.0, 30.0, 1e3):
            rs = r * scale
            for rt in tiers:
                got = upd.gating_test_batch(H, rs, rt, cov, noise, table, dof)
                want = upd.gating_test_batch_plain(H, rs, rt, cov, noise, table, dof)
                gamma = upd.gate_gamma_plain(H, rs, cov, noise)
                near = (gamma - thresh).abs() <= 1e-4 * thresh
                if not bool(((got == want) | near).all()):
                    fail(f"K10 {tuple(shape)} scale {scale}: decisions differ on "
                         f"{int(((got != want) & ~near).sum())} blocks")
            for m in sorted({min(H.shape[1], 32), H.shape[1]}):
                g = upd.gate_gamma(H[:, :m], rs[:, :m], cov, noise)
                w = upd.gate_gamma_plain(H[:, :m], rs[:, :m], cov, noise)
                same_nan = torch.equal(g.isnan(), w.isnan())
                rel = float(((g - w).abs() / w.abs().clamp(min=1e-30)).nan_to_num().max())
                if scale == 1.0:
                    gate_err = max(gate_err, float((g - w).abs().nan_to_num().max()))
                if not same_nan or not rel <= 1e-4:
                    fail(f"K10 gamma {tuple(H[:, :m].shape)} scale {scale}: relative "
                         f"error {rel:.3e}, NaN pattern equal {same_nan}")
            if H.shape[1] > 32:
                ps, fs = upd.gate_bounds(H, rs, cov, noise, thresh)
                pps, pfs = upd.gate_bounds_plain(H, rs, cov, noise, thresh)
                rtr = (rs * rs).sum(-1)
                tr = ((H @ cov) * H).sum((1, 2))
                near = ((rtr - thresh * noise).abs() <= 1e-4 * rtr) | (
                    (rtr - thresh * (noise + tr)).abs() <= 1e-4 * rtr)
                if not bool(((ps == pps) & (fs == pfs) | near).all()):
                    fail(f"K10 bounds {tuple(shape)} scale {scale}: flags differ")
        print(f"[K10] gate {tuple(shape)}: decisions, bounds and gamma agree at scales "
              f"1e-3..1e3 on the {'/'.join(str(int(t.max())) for t in tiers)}-row tiers")
    if not any(shape[1] > 32 for shape in gates):
        fail("the warm run made no 77-row gate call")
        return res
    # each entry point timed at its most frequent shape in the warm run
    ms, pms, n_bytes, ops, timed = 0.0, 0.0, 0, 0.0, []
    for entry, kernel, plain in (("bounds", upd.gate_bounds, upd.gate_bounds_plain),
                                 ("gamma", upd.gate_gamma, upd.gate_gamma_plain)):
        shape = rec.most_frequent(f"K10 {entry}")
        if shape is None:
            fail(f"the warm run made no gate_{entry} call")
            return res
        a = rec.of(f"K10 {entry}")[shape]
        ms += cuda_ms(lambda: kernel(*a))
        pms += cuda_ms(lambda: plain(*a), reps=10)
        H, nz, D = a[0], _rows_needed(a[0], a[1]), a[0].shape[2]
        if entry == "bounds":
            # H P over the rows that hold data (2 nz D^2) and the trace
            ops += float((2 * nz * D * D + 2 * nz * D).sum())
            n_bytes += nbytes(*a) + 2 * H.shape[0]
        else:
            # and S's lower triangle (nz^2 D), the Cholesky (nz^3 / 3) and
            # the border row
            ops += float((2 * nz * D * D + nz * (nz + 1) * D + nz ** 3 / 3 + nz ** 2).sum())
            n_bytes += nbytes(*a) + H.element_size() * H.shape[0]
        timed.append(f"{entry} {shape} ({rec.counts[(f'K10 {entry}', shape)]} calls)")
    b = bound(n_bytes, ops)
    print(f"[K10] {' + '.join(timed)}: {ms:.4f} ms vs plain {pms:.4f} ms; "
          f"bound {b[0] * 1e3:.3f} us ({b[1]})")
    res["K10"] = (gate_err, ms, pms, *b)

    # K12: the recorded prune updates, and one with an exactly singular P12
    calls = rec.of("K12")
    if not calls:
        fail("the warm run made no rank-12 prune update")
        return res
    cases = {f"B {k}": v for k, v in calls.items()}
    P, Bm, rr, cols, noise = calls[max(calls)]
    P = P.clone()
    P[cols[6:], :] = 0.0  # the second camera's block: P12 of rank 6
    P[:, cols[6:]] = 0.0
    cases["singular P12"] = (P, Bm, rr, cols, noise)
    for label, a in cases.items():
        P, Bm, rr, cols, noise = a
        rank = int(torch.linalg.matrix_rank(P[cols][:, cols].double()))
        delta, P_new = upd.rank12_update(*a)
        pdelta, pP_new = upd.rank12_update_plain(*a)
        scale = max(float(pP_new.abs().max()), 1.0)
        err = max(float((P_new - pP_new).abs().max()), float((delta - pdelta).abs().max()))
        if not err <= 1e-4 * scale or not torch.isfinite(P_new).all():
            fail(f"K12 {label}: error {err:.3e} (max |P| {scale:.3e})")
        ms = cuda_ms(lambda: upd.rank12_update(*a))
        pms = cuda_ms(lambda: upd.rank12_update_plain(*a), reps=10)
        n, D = Bm.shape[0], P.shape[0]
        # B'B, B'r, W, the LU and its 13 right-hand sides, Pc G, delta, and
        # 26 FLOP per entry of sym(P - Pc G Pc')
        ops = 2 * n * 156 + 3 * 12 ** 3 + 13 * 144 + 2 * D * 156 + 26 * D * D
        b = bound(nbytes(P, Bm, rr, cols, noise, delta, P_new), ops)
        print(f"[K12] rank-12 update, {label}, P12 rank {rank}: error {err:.3e}; {ms:.4f} ms "
              f"vs plain {pms:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
        if label == f"B {rec.most_frequent('K12')}":
            res["K12"] = (err, ms, pms, *b)
    return res


def _timed_sum(rec: Recorder, entries):
    """Sum over entry points of the kernel's and the plain version's median
    ms at the entry point's most frequent shape.  ``entries``: (kind, kernel,
    plain).  Returns (ms, plain_ms, [(kind, shape, args)])."""
    ms = pms = 0.0
    timed = []
    for kind, kernel, plain in entries:
        shape = rec.most_frequent(kind)
        if shape is None:
            fail(f"the warm run made no {kind} call")
            continue
        a = rec.of(kind)[shape]
        ms += cuda_ms(lambda: kernel(*a))
        pms += cuda_ms(lambda: plain(*a), reps=10)
        timed.append((kind, shape, a))
    return ms, pms, timed


def check_camera(rec: Recorder):
    """K7 against its plain version on the recorded calls, with the recorded
    (radtan) model and with equidistant coefficients."""
    import torch

    from uav_airvision_tpu_torch.ops import camera

    # the entry points on the main path (distort_points is checked below on
    # the prologue's output)
    entries = [
        ("K7 undistort_distort_points", camera.undistort_distort_points,
         camera.undistort_distort_points_plain),
        ("K7 undistort_points", camera.undistort_points, camera.undistort_points_plain),
        ("K7 homography_warp_points", camera.homography_warp_points,
         camera.homography_warp_points_plain),
    ]
    equi = (-0.0113, 0.0052, -0.0021, 0.0005)
    worst = 0.0
    n_calls = 0
    for kind, kernel, plain in entries:
        for shape, a in rec.samples(kind):
            variants = [a]
            if "warp" not in kind:  # the same call under the equidistant model
                coeffs = a[3]
                co = torch.tensor(equi, dtype=torch.float32, device=a[0].device)
                co = co[:, None].expand(4, coeffs.shape[1]) if coeffs.ndim == 2 else co
                variants.append((a[0], a[1], "equidistant", co) + tuple(a[4:]))
            for v in variants:
                got, want = kernel(*v), plain(*v)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                # undistorted points are normalized coordinates, the rest pixels
                tols = (1e-6, 2 * PX_ULP) if len(got) == 2 else (
                    (PX_ULP,) if "warp" in kind else (1e-6,))
                for g, w, tol in zip(got, want, tols):
                    err = float((g - w).abs().max())
                    worst = max(worst, err)
                    if not err <= tol or not torch.isfinite(g).all():
                        fail(f"{kind} {shape} {v[2] if 'warp' not in kind else ''}: "
                             f"error {err:.3e} > {tol:.1e}")
                n_calls += 1
                if "undistort_distort" in kind:  # distort_points alone, on that output
                    two = camera.undistort_points(v[0], v[1], v[2], v[3], v[4])
                    if not (torch.equal(got[0], two) and torch.equal(
                            got[1], camera.distort_points(two, v[1], v[2], v[3]))):
                        fail(f"K7 {shape} {v[2]}: the fused prologue differs from the two calls")
                    und = want[0]
                    g = camera.distort_points(und, v[1], v[2], v[3])
                    w = camera.distort_points_plain(und, v[1], v[2], v[3])
                    err = float((g - w).abs().max())
                    worst = max(worst, err)
                    if not err <= PX_ULP:
                        fail(f"K7 distort_points {shape} {v[2]}: error {err:.3e} px")
    ms, pms, timed = _timed_sum(rec, entries)
    n_bytes = ops = 0
    for kind, shape, a in timed:
        n_pts = a[0].reshape(-1, 2).shape[0]
        outs = 2 if "undistort_distort" in kind else 1
        n_bytes += 8 * n_pts * (1 + outs) + 32 + 36  # points in and out, 8 values, R
        ops += n_pts * (30 if "warp" in kind else 100 * outs)  # 5 fixed-point iterations
    b = bound(n_bytes, ops)
    print(f"[K7] camera models, {n_calls} recorded calls x radtan/equidistant: max error "
          f"{worst:.3e} (normalized 1e-6, pixels {PX_ULP:.1e}); "
          f"{' + '.join(f'{k[3:]} {sh}' for k, sh, _ in timed)}: {ms:.4f} ms vs plain "
          f"{pms:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
    return {"K7": (worst, ms, pms, *b, None)}


def check_gridops(rec: Recorder):
    """K5 and K8 against their plain versions on the recorded calls: exact."""
    import torch

    from uav_airvision_tpu_torch.ops import gridops

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))

    res = {}
    calls = rec.samples("K5")
    if not {5, 8} <= {k for k, _ in calls}:
        fail(f"the warm run made top-k calls for k in { {k for k, _ in calls} }, not 5 and 8")
    n_empty = 0
    for k, a in calls:
        got, want = gridops.dense_grid_topk(*a), gridops.dense_grid_topk_plain(*a)
        n_empty += int((want[2] <= 0).sum())
        if not same(got, want):
            fail(f"K5 dense_grid_topk k={k} differs from its plain version")
    ms, pms, timed = _timed_sum(rec, [("K5", gridops.dense_grid_topk,
                                       gridops.dense_grid_topk_plain)])
    if timed:
        score, gr, gc, k = timed[0][2]
        H, W = score.shape
        ch, cw = gridops._cell_shape(H, W, gr, gc)
        padded = torch.full((ch * gr, cw * gc), -1, dtype=score.dtype, device=score.device)
        padded[:H, :W] = score
        cells = padded.reshape(gr, ch, gc, cw).permute(0, 2, 1, 3).reshape(gr * gc, ch * cw)
        cells = cells.contiguous()
        sort_ms = cuda_ms(lambda: torch.sort(cells, dim=1, descending=True, stable=True))
        topk_ms = cuda_ms(lambda: torch.topk(cells, k, dim=1))
        # one comparison per pixel and kept slot at most; the map in, 3 k values per cell out
        b = bound(nbytes(score) + 12 * gr * gc * k, 2 * score.numel())
        print(f"[K5] dense_grid_topk {H}x{W} -> {gr * gc} cells x k={k} ({len(calls)} calls, "
              f"k=5 and 8, {n_empty} empty slots): exact; {ms:.4f} ms vs plain {pms:.4f} ms; "
              f"torch.sort of the cells {sort_ms:.4f} ms, torch.topk {topk_ms:.4f} ms; "
              f"bound {b[0] * 1e3:.3f} us ({b[1]})")
        res["K5"] = (0.0, ms, pms, *b, sort_ms)

    entries = [(f"K8 {fn.__name__}", fn, getattr(gridops, fn.__name__ + "_plain"))
               for fn in gridops.K8_WRAPPERS]
    n_calls, shapes = 0, set()
    for kind, kernel, plain in entries:
        for shape, a in rec.samples(kind):
            n_calls += 1
            shapes.add(shape if isinstance(shape, int) else shape[0])
            if not same(kernel(*a), plain(*a)):
                fail(f"{kind} {shape} differs from its plain version")
    ms, pms, timed = _timed_sum(rec, entries)
    n_bytes = sum(sum(nbytes(x) for x in a if isinstance(x, torch.Tensor)) for _, _, a in timed)
    n_bytes += sum(8 * a[0].shape[0] for _, _, a in timed)  # outputs: at most two int32 arrays
    # what the functions need, not the kernels' pairwise count: a stable sort
    # of n keys, n log2 n comparisons of ~3 operations (cell, primary, arrival)
    ops = sum(3 * a[0].shape[0] * math.log2(max(a[0].shape[0], 2)) for _, _, a in timed)
    b = bound(n_bytes, ops)
    print(f"[K8] {n_calls} recorded calls, n in {sorted(shapes)}: exact; "
          f"{' + '.join(f'{k[3:]} {sh}' for k, sh, _ in timed)}: {ms:.4f} ms vs plain "
          f"{pms:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
    res["K8"] = (0.0, ms, pms, *b, None)
    return res


def check_ekf_update(rec: Recorder):
    """K11 against its plain version at the tiers T1, T2 and QR in float32
    and float64, on recorded calls (stacked to reach a tier the run did not
    take)."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import update as upd

    calls = rec.of("K11")
    if not calls:
        fail("the warm run made no EKF update")
        return {}
    P0, H0, r0, noise0, rows0 = calls.get("T1") or next(iter(calls.values()))
    D = H0.shape[1]
    T1, T2 = upd.update_tiers(D)

    def stacked(rows):
        """The latest recorded call with its true rows repeated (each copy
        scaled a little differently) up to ``rows`` rows."""
        idx = torch.arange(rows, device=H0.device)
        scale = (1.0 + 0.05 * (idx // rows0)).to(H0.dtype)
        H = torch.zeros_like(H0)
        r = torch.zeros_like(r0)
        H[:rows] = H0[idx % rows0] * scale[:, None]
        r[:rows] = r0[idx % rows0] * scale
        return (P0, H, r, noise0, rows)

    cases = {tier: [a] for tier, a in calls.items()}
    for tier, rows in (("T1", T1 - 3), ("T2", T2 - 5), ("QR", 3 * D + 11)):
        if tier not in cases:
            cases[tier] = [stacked(rows)]
            print(f"[K11] the warm run took no {tier} update: stacked a recorded call of "
                  f"{rows0} rows to {rows}")
    res = {}
    for tier in ("T1", "T2", "QR"):
        for P, H, r, noise, rows in cases[tier]:
            want_d, want_P = upd.ekf_update_plain(P.double(), H.double(), r.double(),
                                                  noise.double(), rows)
            sc_d, sc_P = float(want_d.abs().max()), max(float(want_P.abs().max()), 1.0)
            for dtype in (torch.float64, torch.float32):
                a = (P.to(dtype), H.to(dtype), r.to(dtype), noise.to(dtype), rows)
                d, Pn = upd.ekf_update(*a)
                pd, pPn = upd.ekf_update_plain(*a)
                e_d = float((d - want_d).abs().max())
                e_P = float((Pn - want_P).abs().max())
                p_d = float((pd - want_d).abs().max())
                p_P = float((pPn - want_P).abs().max())
                if dtype == torch.float64:
                    ok = e_d <= 1e-10 * sc_d and e_P <= 1e-10 * sc_P
                else:
                    ok = e_d <= max(1e-4 * sc_d, 4 * p_d) and e_P <= max(1e-5 * sc_P, 4 * p_P)
                ok = ok and torch.equal(Pn, Pn.T) and bool(torch.isfinite(Pn).all())
                if not ok:
                    fail(f"K11 {tier} {rows} rows {dtype}: delta error {e_d:.3e} of max "
                         f"{sc_d:.3e} (plain {p_d:.3e}), P error {e_P:.3e} of {sc_P:.3e} "
                         f"(plain {p_P:.3e})")
                print(f"[K11] {tier} ({rows} rows) {str(dtype)[6:]}: against the float64 plain "
                      f"version, delta {e_d:.3e} of max {sc_d:.3e} (the plain version "
                      f"{p_d:.3e}), P {e_P:.3e} of {sc_P:.3e} (the plain version {p_P:.3e})")
                if dtype == torch.float32 and tier == "T1":
                    res["err"] = e_P
    # a failed factorisation is NaN, as the plain version's
    d, Pn = upd.ekf_update(-1e6 * torch.eye(D, dtype=P0.dtype, device=P0.device), H0, r0,
                           noise0, rows0)
    if not (bool(d.isnan().all()) and bool(Pn.isnan().all())):
        fail("K11: a failed Cholesky did not give NaN")

    tier = rec.most_frequent("K11")
    a = calls[tier]
    P, H, r, noise, rows = a
    ms = cuda_ms(lambda: upd.ekf_update(*a))
    pms = cuda_ms(lambda: upd.ekf_update_plain(*a), reps=10)
    # the library's solve at the rows the kernel factors (the true-row prefix
    # on T1 and T2; past T2 the stack's first D rows stand for the D rows of
    # R), and at the plain version's tier
    m_tier = {"T1": T1, "T2": T2}.get(tier, D)
    m = min(rows, m_tier)
    lib = {}
    for mm in (m, m_tier):
        S = H[:mm] @ P @ H[:mm].T + noise * torch.eye(mm, device=P.device, dtype=P.dtype)
        HP = H[:mm] @ P
        lib[mm] = cuda_ms(lambda: torch.linalg.solve(S, HP))
    a_tier = (P, H, r, noise, m_tier) if tier != "QR" else a
    ms_tier = cuda_ms(lambda: upd.ekf_update(*a_tier))
    nz = float(rows)
    # the least the function needs over the rows that hold data: H P, S's
    # lower triangle, the Cholesky, two substitutions over D columns, K r and
    # P - K (H P) with the symmetrisation; past T2 the Householder QR of the
    # stack first (2 rows D^2) and then the same at D rows
    qr_ops = 0.0
    if tier == "QR":
        qr_ops, nz = 2 * nz * D * D, float(D)
    ops = (qr_ops + 2 * nz * D * D + nz * nz * D + nz ** 3 / 3 + 2 * nz * nz * D + 2 * nz * D
           + 2 * nz * D * D + 3 * D * D)
    nz = float(rows)
    b = bound(2 * nbytes(P) + (nz * (D + 1) + D + 1) * P.element_size(), ops)
    print(f"[K11] ekf_update {tier} ({rows} true rows, {rec.counts[('K11', tier)]} calls): "
          f"{ms:.4f} ms vs plain {pms:.4f} ms; torch.linalg.solve(S, HP) alone on the same "
          f"{m} rows {lib[m]:.4f} ms; on the tier's {m_tier} rows the kernel {ms_tier:.4f} ms, "
          f"the solve {lib[m_tier]:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
    lib_ms = lib[m]
    return {"K11": (res.get("err", 0.0), ms, pms, *b, lib_ms)}


class _StampedQueue:
    """A queue that notes when each message arrived (monotonic clock)."""

    def __init__(self):
        from queue import Queue

        self.queue, self.arrivals = Queue(), []

    def put(self, item):
        if item is not None:
            self.arrivals.append(time.monotonic())
        self.queue.put(item)

    def get(self):
        return self.queue.get()


class _PublishClock:
    """Stands where the orchestrator's viewer stands: notes when each pose
    was published."""

    def __init__(self):
        self.published = []

    def update_image(self, image):
        pass

    def update_pose(self, pose):
        self.published.append(time.monotonic())


def run_stream(config, world, imu, fts, cam0, cam1, batch_t, batch_p, wrappers, lagged=True):
    """The streaming path: publishers -> queues -> VIO's three threads.
    ``batch_t``/``batch_p``: the batch run's active timestamps (absolute)
    and positions.  ``lagged``: the stereo publisher starts STREAM_IMG_LAG_S
    late and the poses are held to the batch run's; else both publishers
    start together as ``main.py --mode realtime`` starts them, a frame races
    the IMU sample of its own timestamp, and the poses are held to the
    ground truth only.  Returns the launch counts of the phase."""
    import os
    from queue import Queue

    import numpy as np

    from uav_airvision_tpu_torch import device
    from uav_airvision_tpu_torch.main import _ListStream
    from uav_airvision_tpu_torch.streaming.dataset import imu_msg, stereo_msg
    from uav_airvision_tpu_torch.streaming.publisher import DataPublisher
    from uav_airvision_tpu_torch.utils.trajectory import TrajectoryWriter
    from uav_airvision_tpu_torch.vio import VIO

    imu_msgs = [imu_msg(t, w, a) for t, w, a in zip(*imu)]
    img_msgs = [stereo_msg(t, i0, i1, None, None) for t, i0, i1 in zip(fts, cam0, cam1)]
    os.makedirs("build", exist_ok=True)
    tag = "[stream]" if lagged else "[stream, command-line start order]"
    path = os.path.join("build", "chip_smoke_stream.txt")
    if os.path.exists(path):
        os.remove(path)
    img_q, imu_q, clock = _StampedQueue(), Queue(), _PublishClock()
    vio = VIO(config, img_q, imu_q, viewer=clock, trajectory_writer=TrajectoryWriter(path=path))
    vio.start()
    t0 = time.time()
    vio.warmup()
    print(f"{tag} warmup {time.time() - t0:.2f} s")
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    syncs0, reads0 = device.host_syncs["sync"], vio.publish_reads
    now = time.time()
    imu_pub = DataPublisher(_ListStream(imu_msgs), imu_q, ratio=STREAM_RATIO)
    img_pub = DataPublisher(_ListStream(img_msgs), img_q, ratio=STREAM_RATIO)
    switch = sys.getswitchinterval()
    if lagged:
        sys.setswitchinterval(1e-3)
    try:
        imu_pub.start(now)
        img_pub.start(now + (STREAM_IMG_LAG_S / STREAM_RATIO if lagged else 0.0))
        vio.join()
    except RuntimeError as e:
        fail(f"{tag} {e}: {e.__cause__!r}")
    finally:
        sys.setswitchinterval(switch)
    wall = time.time() - now
    vio.imu_thread.join(timeout=10)
    alive = [t.name for t in (vio.imu_thread, vio.img_thread, vio.publish_thread)
             if t.is_alive()]
    if alive:
        fail(f"{tag} threads still alive after join: {alive}")
    launches = {name: sum(fn.launches for fn in fns) for name, fns in wrappers.items()}
    for name, n in launches.items():
        if n == 0:
            fail(f"{tag} the streaming path never launched kernel {name}")

    n = len(vio.results)
    syncs = (device.host_syncs["sync"] - syncs0) / len(fts)
    reads = (vio.publish_reads - reads0) / max(n, 1)
    print(f"{tag} {n} poses in {wall:.2f} s at {STREAM_RATIO} x real time = "
          f"{n / wall:.2f} poses/s; {syncs:.2f} step syncs/frame + {reads:.2f} publish "
          f"read/pose; launches {launches}")
    traj = np.loadtxt(path, ndmin=2) if n else np.zeros((0, 8))
    lat = np.asarray(clock.published) - np.asarray(img_q.arrivals[len(img_q.arrivals) - n:])
    if not lagged:
        # the frames' own deadline decides which IMU samples a step sees, so
        # neither the number of poses nor their digits repeat the batch run's
        if n < MIN_ACTIVE or not np.isfinite(traj).all():
            fail(f"{tag} {n} finite poses published (< {MIN_ACTIVE})")
            return launches
        err = np.linalg.norm(traj[:, 1:4] - world.groundtruth(traj[:, 0]), axis=1)
        both = np.isin(np.round(traj[:, 0], 6), np.round(batch_t, 6))
        dp = float(np.abs(traj[both, 1:4] - batch_p[np.isin(
            np.round(batch_t, 6), np.round(traj[:, 0], 6))]).max()) if both.any() else float("nan")
        print(f"{tag} ATE max {float(err.max()):.5f} m, rmse "
              f"{float(np.sqrt(np.mean(err ** 2))):.5f} m (bar {ATE_BAR_M} m); max pose "
              f"difference to the batch run {dp:.3e} m over {int(both.sum())} common frames; "
              f"latency median {float(np.median(lat)) * 1e3:.2f} ms, p95 "
              f"{float(np.percentile(lat, 95)) * 1e3:.2f} ms")
        if not float(err.max()) < ATE_BAR_M:
            fail(f"{tag} ATE max {float(err.max()):.5f} m is not under the bar")
        return launches
    if n != len(batch_p):
        fail(f"[stream] {n} poses published, the batch run has {len(batch_p)}")
        return launches
    dt = float(np.abs(traj[:, 0] - batch_t).max())
    dp = float(np.abs(traj[:, 1:4] - batch_p).max())
    err = np.linalg.norm(traj[:, 1:4] - world.groundtruth(batch_t), axis=1)
    print(f"[stream] against the batch run: max pose difference {dp:.3e} m, timestamps "
          f"{dt:.1e} s (tolerance {STREAM_TOL_M} m); ATE max {float(err.max()):.5f} m "
          f"(bar {ATE_BAR_M} m); latency from arrival to publish: median "
          f"{float(np.median(lat)) * 1e3:.2f} ms, p95 {float(np.percentile(lat, 95)) * 1e3:.2f} ms")
    if not dp <= STREAM_TOL_M or not dt <= 1e-5:
        fail(f"[stream] poses differ from the batch run's by {dp:.3e} m")
    if not float(err.max()) < ATE_BAR_M:
        fail(f"[stream] ATE max {float(err.max()):.5f} m is not under the bar")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fatal("PyTorch is not installed")
    if not torch.cuda.is_available():
        fatal("torch.cuda.is_available() is False: this smoke test needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import numpy as np

    from uav_airvision_tpu_torch import device, kernels
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.models.msckf import propagation, triangulation, update
    from uav_airvision_tpu_torch.models.msckf.state import make_params
    from uav_airvision_tpu_torch.ops import camera, fast, gridops, lk, pyramid

    dev = device.get_device("cuda")
    t0 = time.time()
    kernels.lib()
    print(f"[build] {kernels.build_info['path']} in {time.time() - t0:.1f} s "
          f"(cached: {kernels.build_info['cached']})")
    for line in kernels.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    t0 = time.time()
    config, world, pb, cam0, cam1, imu, fts = render_bench_world(N_FRAMES)
    frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)
    print(f"[render] {N_FRAMES} bench-world frames in {time.time() - t0:.1f} s")

    results = check_kernels(config, frames, dev)

    # main path, warm run, recording the back-end kernels' calls
    t0 = time.time()
    with Recorder() as rec:
        state, _ = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    print(f"[main] warm run: {N_FRAMES} frames in {time.time() - t0:.2f} s; calls per shape "
          f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(rec.counts.items(), key=str)} }")
    params = make_params(config, dev)
    results["K14"] = check_propagate(state.filter, params, frames, N_FRAMES // 2)
    results.update(check_backend_kernels(rec, config, params))
    results.update(check_ekf_update(rec))
    results.update(check_gridops(rec))
    results.update(check_camera(rec))

    # every entry point the main path launches (camera.distort_points runs
    # there only inside the fused stereo prologue)
    wrappers = {"K1": [lk.pyramidal_lk], "K2": [pyramid.build_pyramid_padded],
                "K4+K6": [fast.detect_fast], "K14": [propagation.propagate],
                "K13": [triangulation.triangulate], "K9": [update.feature_block],
                "K10": [update.gate_bounds, update.gate_gamma],
                "K12": [update.rank12_update], "K11": [update.ekf_update],
                "K5": [gridops.dense_grid_topk], "K8": list(gridops.K8_WRAPPERS),
                "K7": [camera.undistort_distort_points, camera.undistort_points,
                       camera.homography_warp_points]}
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    update.ekf_update.tiers = dict.fromkeys(update.ekf_update.tiers, 0)
    syncs0 = device.host_syncs["sync"]
    torch.cuda.synchronize()
    t0 = time.time()
    state, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.time() - t0
    per_entry = {f"{name} {fn.__name__}": fn.launches
                 for name, fns in wrappers.items() for fn in fns}
    launches = {name: sum(fn.launches for fn in fns) for name, fns in wrappers.items()}
    syncs = (device.host_syncs["sync"] - syncs0) / N_FRAMES
    print(f"[main] timed run: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.2f} "
          f"frames/s; {syncs:.2f} host syncs/frame; launches {per_entry}")
    print(f"[main] EKF updates per row tier: {update.ekf_update.tiers}")
    for name, n in per_entry.items():
        if n == 0:
            fail(f"the main path never launched kernel {name}")

    act = outs.active.cpu().numpy()
    p = outs.p.cpu().numpy()
    if not np.isfinite(p).all() or not np.isfinite(outs.q.cpu().numpy()).all():
        fail("non-finite poses")
    if act.sum() < MIN_ACTIVE:
        fail(f"only {act.sum()} active frames (< {MIN_ACTIVE})")
    err = np.linalg.norm(p[act] - world.groundtruth(pb.timestamps[act]), axis=1)
    ate_max, ate_rmse = float(err.max()), float(np.sqrt(np.mean(err ** 2)))
    print(f"[main] {int(act.sum())} active frames; ATE max {ate_max:.5f} m, "
          f"rmse {ate_rmse:.5f} m (bar {ATE_BAR_M} m)")
    if not ate_max < ATE_BAR_M:
        fail(f"ATE max {ate_max:.5f} m is not under the bar {ATE_BAR_M} m")

    sources = {"K1": ("lk.cu", "uav_airvision_tpu/ops/lk.py:341", "pyramidal_lk"),
               "K2": ("pyramid.cu", "uav_airvision_tpu/ops/pyramid.py:115",
                      "build_pyramid_padded"),
               "K4+K6": ("fast.cu", "uav_airvision_tpu/ops/fast.py:103", "fast_detect_masked"),
               "K14": ("propagate.cu", "uav_airvision_tpu/models/msckf/propagation.py:88",
                       "propagate"),
               "K13": ("triangulate.cu",
                       "uav_airvision_tpu/models/msckf/triangulation.py:159", "triangulate"),
               "K9": ("feature_block.cu", "uav_airvision_tpu/models/msckf/update.py:103",
                      "feature_block"),
               "K10": ("gate.cu", "uav_airvision_tpu/models/msckf/update.py:170",
                       "gating_test_batch"),
               "K12": ("rank12.cu", "uav_airvision_tpu/models/msckf/update.py:239",
                       "rank12_update"),
               "K11": ("ekf_update.cu", "uav_airvision_tpu/models/msckf/update.py:296",
                       "ekf_update"),
               "K5": ("gridops.cu", "uav_airvision_tpu/ops/gridops.py:147", "dense_grid_topk"),
               "K8": ("gridops.cu", "uav_airvision_tpu/ops/gridops.py:58", "rank_in_cell + "
                      "kept_order_stats + compact_kept + smallest_k_indices + "
                      "stable_compact_indices"),
               "K7": ("camera.cu", "uav_airvision_tpu/ops/camera.py:99", "undistort_points + "
                      "distort_points + homography_warp_points")}
    # the same frames through the port's plain PyTorch path on the host
    n_ref = 40
    cpu_frames = vio.VioFrame(*(x[:n_ref].cpu() for x in frames))
    _, ref = vio.run_sequence(config, cpu_frames, pb.gyro_bias, pb.acc_mean)
    ref_act = ref.active.numpy()
    if not np.array_equal(ref_act, act[:n_ref]) or ref_act.sum() < 10:
        fail("the host reference run disagrees on which frames are active")
    dp = float(np.abs(ref.p.numpy()[ref_act] - p[:n_ref][ref_act]).max())
    print(f"[main] first {n_ref} frames against the plain PyTorch path on the host: "
          f"max pose difference {dp:.3e} m over {int(ref_act.sum())} active frames")
    if not dp < 1e-4:
        fail(f"the card's poses differ from the host reference by {dp:.3e} m")

    # the streaming path: the same messages through the orchestrator's threads
    batch_t = pb.time_base + outs.timestamp.cpu().numpy().astype(np.float64)[act]
    for lagged in (True, False):
        run_stream(config, world, imu, fts, cam0, cam1, batch_t, p[act].astype(np.float64),
                   wrappers, lagged=lagged)

    if FAILURES:
        fatal(f"{len(FAILURES)} check(s) failed: " + "; ".join(FAILURES))
    missing = [name for name in sources if name not in results]
    if missing:
        fatal(f"no kernel check result for {missing}")
    print(json.dumps({"kernels": [
        {"name": f"{name} {sources[name][2]}", "route": "cuda",
         "source": f"uav_airvision_tpu_torch/csrc/{sources[name][0]}",
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2], "bound_ms": results[name][3],
         "bound_by": results[name][4],
         "library_ms": results[name][5] if len(results[name]) > 5 else None}
        for name in sources]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
