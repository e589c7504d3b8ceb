"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: exits 1 unless CUDA is available; prints the card's name and
   power limit (nvidia-smi) and builds the kernels of
   ``uav_airvision_tpu_torch/csrc`` (nvcc, sm_90a, one process per source).
2. Front-end kernels against their plain PyTorch versions on the card, at
   main-path shapes, on a rendered 752x480 bench-world frame pair: K2
   (both cameras' pyramids in one launch, and one camera's) and K4+K6
   (FAST + mask + NMS) exactly, K1 (LK; temporal 104
   points x 2 levels, stereo forward 204 x 2, backward 204 x level 0) status
   agreeing on >= 99% of points and agreeing points within 1e-3 px; after
   the warm run (3.) K1 again, with the same bars, on a few of the warm
   run's recorded calls of each shape (temporal, stereo forward and
   backward), each shape timed through the wrapper and on the device,
   beside its bound and block 0's SM clock cycles a level; and
   K4+K6 on every call of the warm run, exactly, one launch a call (device
   us printed).
3. Main path, warm run: the bench world as bench.py renders it
   (euroc_config, seed 5, 200 frames) through ``run_sequence`` on the card,
   with an observer (``kernels.observer``) recording the arguments of the
   kernels' calls, the latest per shape, and counting the calls per shape.
4. Back-end kernels against their plain versions on those recorded calls
   (real filter states of the bench world), plus forced cases the bench
   world may not reach:
   - K14 (propagation, on every call of the warm run and a forced call of
     11 IMU samples): every field it writes within 1e-5 relative, one
     launch a call; timed through the wrapper and on the device;
   - K13 (triangulation through its row entry ``triangulate_rows``, the
     call site's gathers, need_init, the motion check and the new position
     and initialized columns in one launch; every call of the warm run, and
     of the [compact] run under the motion check): initialized and
     init_fail identical to the plain version's, the new positions within
     1e-4 of max(|p|, 1) for 95% of the rows and within 1e-3 for each (a
     cost comparison that ties within rounding can take the other LM
     branch, and an unconverged solve ends a step apart), every other row
     unchanged, and every output bit for bit equal to the call site's glue
     around ``triangulate``, the kernel's separate cost and
     normal-equation passes (the parent kernel's recurrence in this
     kernel's layout); one launch a call (device us printed);
   - K9 (feature block through its row-indexed entry ``feature_block_rows``,
     the call sites' gathers and ``proc`` masks in its launch; every call of
     the warm run, N = 20 and the prune's N = 2): H_proj, r_proj within
     3e-5 (N = 20) / 1e-4 (N = 2: the reflections of two close views
     cancel) of each block's largest entry, rows_true exact, masked blocks
     zero, one launch a call (device us printed).  Both sides are float32
     and sum the reflections in another order; the phase also runs every
     gathered block (the padding's one-view blocks too, where the
     projection is all cancellation) through ``feature_block`` and prints
     how far the kernel and the float32 plain version are from the float64
     plain version, and the views and depth of the block on which they
     differ most;
   - K10 (the whole gate in one launch, on every recorded shape: the
     77-row blocks on the 32-row and the full tier, the prune's 5-row
     blocks; residual scales 1e-3, 1, 10, 30, 1e3 and one that puts a block
     in the bounds' undecided band): decisions identical to the plain
     version's and to its pieces' (the bounds' pass flags where they decide
     every block, else gamma < thresh on the tier's rows) except where
     gamma lies within 1e-4 of the threshold or r'r within 1e-4 of a bound;
     where the kernel computes gamma, within 1e-4 relative of the plain
     gamma, NaN where it is (max_abs_err: gamma's at scale 1);
   - K12 (rank-12 prune update): the main path's row-indexed entry
     ``apply_update_rank12_rows`` (the call site's masks in the launch) on
     every recorded prune call, P_new and every other field of the new
     state within 1e-4 of max(|P|, 1) (test_rank12_kernel_matches_plain's
     bars), P_new exactly symmetric, and the kernel's and the float32 plain
     version's distance from the float64 plain version printed, with the
     calls on which the kernel is within max(1.25 x the float32 plain
     version's distance, 1e-4) in every field (ROADMAP fault 11); on the
     latest call of each shape also every field within 1e-4 of the field's
     largest entry; one launch a call (torch.profiler, device us printed);
     then the dense entries on the latest call's masked stack and with an
     exactly singular P12: P_new and delta within 1e-4 of max(|P|, 1);
     ``apply_update_rank12`` (the same launch ending in the injection) on
     every field within 1e-4, P_new equal to the delta entry's.
   - K7 (camera models: the stereo prologue, the publish's undistort, and
     ``distort_points`` on the prologue's output; as recorded with the
     radtan model and again with equidistant coefficients): normalized
     outputs within 1e-6, pixel outputs within one float32 ulp at 752 px
     (6.1e-5 px), two for the prologue's re-distorted points (its
     undistorted input already differs by an ulp of the normalized
     coordinate, times fx); the fused prologue equal, bit for bit, to the
     kernel's two separate calls.  The fused prediction
     (``predict_warp_points``) on every call of the warm run: the rotation
     within 4 float32 ulps of 1.0, the points within 4 ulps at 752 px (the
     plain version's 3x3 products fuse multiply-adds), and
     ``homography_warp_points`` on the same points within two.  The fused
     stereo gate (``stereo_gate``) on every call, radtan and equidistant:
     decisions identical to the plain version's, each flip printed with
     its distance from the nearer threshold, more than 8 ulps failing;
   - K5 (per-cell top-k, k = 8 and k = 5, on every call of the warm run;
     one launch a call, device us printed) and K8 (``rank_in_cell``,
     ``kept_order_stats``, ``compact_kept``, ``smallest_k_indices``,
     ``stable_compact_indices`` on every recorded shape, and the fused
     per-cell selection ``select_track`` on every call of the warm run):
     exactly equal;
   - K11 (the EKF update and the injection, one launch) at the row tiers
     T1, T2 and QR, in float32 and float64, on recorded calls; a tier the
     bench world did not take is reached by stacking a recorded call's
     rows.  float64: delta and P_new within 1e-10 of max|delta| and
     max(|P|, 1) of the plain version, ``apply_update``'s new state within
     1e-12 of each field's largest entry.  One launch a call
     (torch.profiler), timed at the recorded rows and at 144 beside
     ``torch.linalg.solve(S, HP)`` alone, with its device us.
     float32: both held to the float64 plain version, P_new within 1e-5 of
     max(|P|, 1) and delta within 1e-4 of max|delta|, or within 4 x the
     float32 plain version's own distance from float64 where that is
     larger (S has s2 on its diagonal, so its condition number, which both
     float32 solves feel, is bounded by tr(H P H') / s2).
   Median times by CUDA events, warm; the JSON line's times and bound are
   those of each kernel's (each entry point's) most frequent shape (K10:
   the sum over its two most frequent shapes).
5. Main path, timed run: every launch counter set to 0 just before it.
   (The warm run already checked one K2 launch per frame and one K10
   launch per gate call.)  Prints the host syncs and, by torch.profiler,
   the CUDA launches per frame.
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
7. [compact]: the bench world through ``run_sequence`` under
   ``frontend.lk_compact_windows`` with the triangulation motion check on
   (``translation_threshold`` 0.05 m), warm (recorded) and timed, counters
   at 0 before the timed run.  Checks: every kernel of that path launched
   (K1's compact entry, which stages P1's windows itself, in place of K1's
   launch), the motion check rejected some features, >= 150 active finite
   poses, ATE max under COMPACT_ATE_BAR_M, the first 40 frames within
   1e-4 m of the host path.  Prints frames/s, host syncs and CUDA launches
   per frame (torch.profiler over PROFILE_WINDOW).  Then [K13] on the run's
   triangulation calls (as in 4.), and [P1]: K1's compact entry on every
   compact LK call of the run, one launch a call, bit for bit equal to the
   route it replaced (P1's ``extract_windows`` and K1's level entry per
   level): points, status and each level's window origin; against its
   plain version with K1's bars; timed beside that route.  On that route's
   calls [K1 level]: K1's level entry against its plain version (K1's
   bars), and ``extract_windows`` bit-exact against its plain version,
   timed beside one indexing call that gathers the same windows.
8. [exact]: the compat facade (``ImageProcessor`` / ``MSCKF``) message by
   message over the same frames under the reference-semantics
   configuration (scripts/diag_long_drift.py's ``exact`` variant plus the
   stacked camera-prune update ``prune_rank12=False``), counters at 0
   before it.  Checks: every kernel of that path launched, >= 150 finite
   poses, ATE max under EXACT_ATE_BAR_M, the poses within FACADE_TOL_M of
   ``run_sequence``'s under the same configuration, and every EKF update
   it took on the QR tier (real stacked-prune calls) against the float64
   plain version with check_ekf_update's float32 bars.  Prints the row
   tiers, frames/s, host syncs and CUDA launches per frame.
9. [limits]: every kernel whose size limit was lifted, past it, against
   its plain version (K5 k = 9, 12, 32, 33, 40, 1440x1080 at k = 5 and 8,
   and k = a cell's every pixel; K8 n = 1025, 1500, and
   ``select_track`` at 1,100 slots and 200 candidates; K4+K6 1025 and
   1500 mask points; K2 1440x1080 and 2048x1536 at four levels, exactly,
   and 752x480 still one launch; K13 N = 65 and 300, both entries (the row
   entry equal to the other); K9 N = 35, 49, 70
   through ``feature_block_rows`` (one block masked);
   K10 on those blocks; K11 at D = 561 on T1, T2 = 1,122 rows and QR; K12's
   row-indexed entry at D = 441 (float32, float64) and 1,221 (float64),
   1e-4 / 1e-10 of max(|P|, 1); K1
   at window sides 17, 21, 33 on both trackers, K1's bars, the compact
   entry bit for bit equal to P1 + the level entry; K14 at D = 441,
   float32 and float64, its bars 1e-5 and 1e-12 relative, with 64 IMU
   slots and with 256 (float32) or 128 (float64), past the block's shared
   memory: the device workspace); then
   LIMIT_FRAMES frames of run_sequence under LIMITS, counters at 0: every
   kernel of that path launched, the active frames' poses within 1e-4 m
   of the port's plain path on the host.
10. [euroc]: the EuRoC dataset path, in a temporary directory (``run_euroc``):
   the PNG loader built (g++, zlib; build seconds printed); the bench
   world's first EUROC_FRAMES frames written as a EuRoC sequence by the
   port's writer; the loader's decode rate and the decoded frames' SHA-256
   against the rendered arrays'; ``main.py --path <dir> --offset 0 --eval``
   on the card (counters at 0 before it: every kernel of the path
   launched), its load and run seconds and ATE/RTE printed, ATE rmse under
   EUROC_ATE_RMSE_M, its outputs bit for bit those of ``run_sequence`` on
   the rendered frames; ``run_sequence_checkpointed`` killed after
   EUROC_CKPT_KILL frames and resumed, p and q bit for bit the
   uninterrupted run's (save and restore ms printed); ``--long-horizon
   --profile`` over the second half, its 3-level K1 calls against the plain
   version with K1's bars, profile_stages.json and a trace holding kernel
   events; ``--mode realtime`` over 2 s of the directory (poses printed).
11. [fleet]: FLEET_B = 4 decorrelated instances of the bench world
   (instance b from frame 7 b, 60 frames each, as ``fleet_bench.py
   --decorrelated``) through ``parallel.fleet.run_fleet``, counters at 0
   (every default-path kernel launched) and the batched kernels' calls
   recorded.  Every step: K7's prediction and K8's selection once (K8's
   first-frame entries once on the first), K14 once, K13, K9 and K10 once
   a stage, K11 and K12 together at most once an update stage (K12 at
   most once a step).  Each instance against ``run_sequence`` on its frames
   in p, q, v, active, n_features, n_update_rows and did_reset: bit for bit
   is the target; a field that is not gets its largest difference and
   first frame printed, positions held to FLEET_TOL_M.  Every 10th
   frame's K2, K4+K6 and K5 batched launch again, bit for bit its batched
   plain version and its B single launches; K1's (temporal, stereo
   forward and backward, and, in a two-frame fleet run under the compact
   configuration, the compact entry) bit for bit the single launches and
   within K1's bars of the plain version, device us per batched launch
   printed.  Every 8th recorded batched launch of K14, K13, K9, K10, K11,
   K12, K7's prediction and K8's selection (and the first frame's K8
   entries) again, within the kernel's bars of its batched plain version
   and bit for bit its single launches; K11's, K12's, K7's and K8's device
   us per batched launch and their bounds at B = 4 and 8 (a recorded
   B = 8 run) printed.  A forced stereo-seed fallback: instance 1's
   tracks cut after 25 frames; it alone falls back (seed counts printed, 5
   K1 launches in that frame) and every instance equals its single run
   from the same state.  Then ``fleet_bench.measure`` at B = 1, 4, 8: instance-frames/s
   (warm, host clock), host syncs, CUDA launches (torch.profiler), the
   batched front-end kernels' launches per step (which must not grow with
   B), the back-end's, every batched kernel's device us per launch and
   per step, and peak device memory.
12. [long]: LONG_S = 60 s of the easy preset (1,200 frames) through
   ``long_run.run`` (``long_horizon_config()``: K1's temporal calls at 3
   levels; seed 7; chunks of LONG_CHUNK_S = 10 s; the world rendered on the
   card by ``simulation/render.py``, as on a machine without OpenCV:
   ``render.without_opencv``), counters at 0 before it.  First
   frames 0, 599, 1,199 and one inside a starve window rendered on the card
   and by ``world.render_frame`` on the host, each pair from one generator
   state: the renderer's bar (at most one pixel in 10,000 of an image off,
   each by one grey level unless on a plane's rectangle border) and the
   generator states equal after; ms a frame on the card and on the host
   printed.  Checks: every default-path kernel launched, each frame's
   temporal K1 call at 3 levels, >= LONG_MIN_ACTIVE active finite poses,
   the covariance finite at every chunk boundary, no online reset, ATE rmse
   under LONG_ATE_BAR_M (1.25 x the JAX package's over the same 60 s,
   tools/jax_long_bar.py); each chunk's row, the filter's frames/s and the
   wall time with rendering printed.  The first LONG_SPLIT frames (two
   chunks) against one ``run_sequence`` call on the same frames: p, q, v,
   active and did_reset bit for bit.  Then the same frames with
   ``dtype="float64"``: every back-end kernel launched in its float64
   instantiation and never in its float32 one (C entry names counted),
   the same run checks, the largest |p_float32 - p_float64| per chunk and
   both ATEs printed; each back-end kernel's latest float64 calls against
   its float64 plain version (K14 1e-12 relative, K11 1e-10, K12's P_new
   1e-10 of max(|P|, 1), K9 1e-10, K13 and K10 with [limits]' bars).
13. Prints the per-kernel JSON line (launches of the batch run, for P1 of
   the compact run: K1's compact entry, which does P1's copy; max error, ms, plain ms, the bound and what binds it,
   the library call's ms where one PyTorch call does most of the
   function), then the result line ``{"ok": true, "device": {...}}`` last.
   Any failure exits nonzero.

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
# The two further configurations, as tools/jax_ate_bar.py defines them, and
# their bars: 1.25 x the JAX package's ATE max on the same 200 frames
# rendered without cv2 (CPU; PERF.md): compact 0.032856 m, exact 0.027146 m
VARIANTS = {
    "compact": {"frontend": {"lk_compact_windows": True},
                "triangulation": {"translation_threshold": 0.05}},
    "exact": {"frontend": {"lk_max_iteration": 30, "lk_max_iteration_upper": 0,
                           "lk_temporal_levels": 0, "stereo_seeded": False,
                           "stereo_full_backward": True, "exact_adder_mask": True},
              "filter": {"prune_rank12": False}},
}
COMPACT_ATE_BAR_M = 0.0411
EXACT_ATE_BAR_M = 0.0339
FACADE_TOL_M = 1e-3  # facade poses against run_sequence's (another time base)
PROFILE_WINDOW = (100, 130)  # frames profiled for the variants' launches per frame


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


def variant_config(config, name):
    import dataclasses

    return dataclasses.replace(config, **{
        group: dataclasses.replace(getattr(config, group), **fields)
        for group, fields in VARIANTS[name].items()})


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

    # K2: both cameras' padded levels from one launch, exactly equal
    got = pyramid.build_pyramid_pair(cam0, cam1, fe.pyramid_levels)
    want = pyramid.build_pyramid_pair_plain(cam0, cam1, fe.pyramid_levels)
    err = max(float((g - w).abs().max()) for gp, wp in zip(got, want)
              for g, w in zip(gp.levels, wp.levels))
    if err != 0.0:
        fail(f"K2 pyramid pair differs from its plain version by {err}")
    one = pyramid.build_pyramid_padded(cam0, fe.pyramid_levels)
    if not all(torch.equal(g, w) for g, w in zip(one.levels, want[0].levels)):
        fail("K2 one-camera pyramid differs from its plain version")
    # ~20 integer operations per output pixel (two separable 5-tap passes)
    k2_bound = bound(nbytes(cam0, cam1, got[0].flat, got[1].flat),
                     20 * sum(lv.numel() for p in got for lv in p.levels[1:]))
    # the library's pyramid step: F.conv2d of the 5x5 binomial at stride 2
    # on the (2, 1, H, W) batch of both cameras' REFLECT_101-padded levels
    # (padded beforehand), three steps summed
    import torch.nn.functional as tnf

    w5 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev)
    k5 = (w5[:, None] * w5[None, :] / 256.0).reshape(1, 1, 5, 5)
    pad = pyramid.LK_PAD
    srcs = [tnf.pad(torch.stack([a[pad:-pad, pad:-pad], b[pad:-pad, pad:-pad]])[:, None],
                    (2, 2, 2, 2), mode="reflect")
            for a, b in zip(got[0].levels[:-1], got[1].levels[:-1])]
    k2_lib = sum(cuda_ms(lambda x=x: tnf.conv2d(x, k5, stride=2)) for x in srcs)
    one_ms = cuda_ms(lambda: pyramid.build_pyramid_padded(cam0, fe.pyramid_levels))
    res["K2"] = (0.0,
                 cuda_ms(lambda: pyramid.build_pyramid_pair(cam0, cam1, fe.pyramid_levels)),
                 cuda_ms(lambda: pyramid.build_pyramid_pair_plain(cam0, cam1, fe.pyramid_levels)),
                 *k2_bound, k2_lib)
    print(f"[K2] pyramid pair 2 x 480x752 -> 2 x 4 padded levels, one launch: exact; "
          f"{res['K2'][1]:.4f} ms vs plain {res['K2'][2]:.4f} ms; one camera {one_ms:.4f} ms; "
          f"F.conv2d 5x5 stride 2 on the (2, 1, H, W) batch, three levels {k2_lib:.4f} ms; "
          f"bound {k2_bound[0] * 1e3:.3f} us ({k2_bound[1]})")

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
    pyr0, pyr1 = pyramid.build_pyramid_pair(cam0, cam1, fe.pyramid_levels)
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
        _, us = _profile_calls(lambda: lk.pyramidal_lk(pp, cp, p0, p1, v, **args),
                               kernels=("lk_kernel",))
        print(f"[K1] {label}: status agreement {agree:.4f}, max err {err:.3e} px "
              f"({int(both_ok.sum())} tracked); {ms:.4f} ms through the wrapper, {us:.1f} us "
              f"on the device, vs plain {pms:.4f} ms")
        err_all, ms_all, plain_all = max(err_all, err), ms_all + ms, plain_all + pms
        n_bytes, ops = _lk_work(pp, p0, p1, v, kn, kst, nl)
        bytes_all += n_bytes
        ops_all += ops
    res["K1"] = (err_all, ms_all, plain_all, *bound(bytes_all, ops_all))
    return res


def _lk_work(pp, p0, p1, v, kn, kst, nl):
    """(bytes, operations) of one K1 call: per valid point and level, the
    (15+2)^2 patch of the previous image (template and its gradients) and
    at least one of the current image; the points and status in and out.
    ~31 operations per window pixel: the template gradients and at least
    one iteration."""
    point_levels = int(v.sum()) * nl
    return (point_levels * 2 * 17 ** 2 * pp.flat.element_size() + nbytes(p0, p1, v, kn, kst),
            point_levels * 225 * 31)


def _lk_phases(a):
    """K1's phases on call ``a`` (pyramidal_lk's positional arguments): block
    0's SM clock cycles a level, coarse to fine, as text."""
    import torch

    from uav_airvision_tpu_torch.ops import lk

    levels = a[9]
    clocks = torch.zeros(1 + 3 * levels, dtype=torch.int64, device=a[2].device)
    lk.pyramidal_lk(*a, clocks=clocks)
    c = clocks.tolist()
    start, parts = c[0], []
    for k in range(levels):
        ready, done, steps = c[1 + 3 * k: 4 + 3 * k]
        parts.append(f"level {levels - 1 - k}: template {ready - start}, Gauss-Newton "
                     f"{done - ready} ({steps} steps)")
        start = done
    return "; ".join(parts) + f"; total {start - c[0]}"


def _prop_err(got, want):
    """The largest difference over the fields K14 writes, each relative to
    the field's largest entry."""
    fields = ("q", "v", "p", "q_null", "v_null", "p_null", "timestamp")
    pairs = [(got.cov, want.cov)] + [(getattr(got.imu, f), getattr(want.imu, f)) for f in fields]
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)) for g, w in pairs)


def check_propagate(rec, filter_state, params, frames, k):
    """K14 against its plain version on every call of the warm run (real
    filter states and IMU slices) and on a forced 11-sample call; timed
    (and its device us and launches a call taken) on the forced call."""
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
    err = _prop_err(got, want)
    abs_err = float((got.cov - want.cov).abs().max())
    if not err <= 1e-5 or not torch.isfinite(got.cov).all():
        fail(f"K14 propagate: relative error {err:.3e} > 1e-5")
    calls = rec.samples("K14")
    worst, bad = 0.0, 0
    for shape, a in calls:
        e = _prop_err(propagation.propagate(*a), propagation.propagate_plain(*a))
        worst = max(worst, e)
        bad += not e <= 1e-5
    if not calls or bad:
        fail(f"K14 propagate: {bad} of {len(calls)} recorded calls past 1e-5 relative "
             f"(worst {worst:.3e})")
    ms = cuda_ms(lambda: propagation.propagate(*args))
    pms = cuda_ms(lambda: propagation.propagate_plain(*args), reps=10)
    launches, us = _profile_calls(lambda: propagation.propagate(*args),
                                  kernels=("propagate_kernel",))
    if launches != 1.0:
        fail(f"K14 propagate made {launches:.2f} launches a call, not one")
    print(f"[K14] propagate, every call of the warm run ({len(calls)}, shapes "
          f"{sorted({sh for sh, _ in calls})}): max relative error {worst:.3e} (bar 1e-5); "
          f"forced {n_valid} IMU samples, {tuple(got.cov.shape)} covariance: relative error "
          f"{err:.3e}; {ms:.4f} ms through the wrapper, {us:.1f} us on the device, "
          f"{launches:.2f} launches a call, vs plain {pms:.4f} ms")
    # per valid sample ~22 kFLOP: the transition and noise by 3x3 block
    # (Q = (Phi G qc) (Phi G)^T: 8 kFLOP) and one fold step (two 15x15
    # products: 13.5 kFLOP); then Phi P_ii Phi^T, Phi P_ic, the symmetrization
    D = filter_state.cov.shape[0]
    ops = n_valid * 22_000 + 2 * 2 * 21 ** 3 + 2 * 21 * 21 * (D - 21) + D * D
    b = bound(nbytes(filter_state.cov, got.cov, *args[2:]), ops)
    return abs_err, ms, pms, *b


def check_lk_recorded(rec, levels=None, tag="[K1]"):
    """K1 against its plain version on the warm run's recorded calls (the
    temporal, stereo forward and backward calls; a few calls of each shape;
    only the calls of ``levels`` pyramid levels where given), with K1's bars;
    each shape timed through the wrapper and on the device."""
    from uav_airvision_tpu_torch.ops import lk

    calls = [(sh, a) for sh, a in rec.samples("K1") if levels is None or sh[1] == levels]
    if not calls:
        fail(f"{tag} the run made no K1 call" + (f" of {levels} levels" if levels else ""))
        return
    worst = 0.0
    for shape, a in calls:
        kn, ks = lk.pyramidal_lk(*a)
        pn, ps = lk.pyramidal_lk_plain(*a)
        agree = float((ks == ps).float().mean())
        both = ks & ps
        err = float((kn[both] - pn[both]).abs().max()) if bool(both.any()) else 0.0
        worst = max(worst, err)
        if agree < 0.99 or err > 1e-3:
            fail(f"{tag} K1 recorded call {shape}: status agreement {agree:.4f}, max err "
                 f"{err:.2e} px")
    for shape, a in sorted(rec.of("K1").items()):
        if levels is not None and shape[1] != levels:
            continue
        ms = cuda_ms(lambda: lk.pyramidal_lk(*a))
        _, us = _profile_calls(lambda: lk.pyramidal_lk(*a), kernels=("lk_kernel",))
        kn, ks = lk.pyramidal_lk(*a)
        b_ms, b_by = bound(*_lk_work(a[0], a[2], a[3], a[4], kn, ks, a[9]))
        print(f"{tag} recorded (F, levels) {shape} ({rec.counts[('K1', shape)]} calls): "
              f"{ms:.4f} ms through the wrapper, {us:.2f} us on the device, bound "
              f"{b_ms * 1e3:.3f} us ({b_by}); block 0's SM clock cycles: {_lk_phases(a)}")
    print(f"{tag} pyramidal_lk, {len(calls)} recorded calls (F, levels) in "
          f"{sorted({sh for sh, _ in calls})}: within the bars (max err {worst:.3e} px)")


# the batched front-end wrappers' per-instance arguments, by position, and
# the dimensions of the first of them with the instance axis
BATCHED_ARGS = {"build_pyramid_pair": ((0, 1), 3), "detect_fast": ((0, 2, 3), 3),
                "dense_grid_topk": ((0,), 3), "pyramidal_lk": ((2, 3, 4), 3),
                "pyramidal_lk_compact": ((2, 3, 4), 3), "predict_warp_points": ((0, 1, 2), 3),
                "select_track": (tuple(range(11)), 3), "rank_in_cell": ((0, 1, 2, 3), 2),
                "kept_order_stats": ((0, 1, 2, 3), 2), "compact_kept": ((0, 1), 2)}


def _single_call(name, args):
    """A call of a batched kernel's wrapper on one instance (a leading axis
    of 1: the single path is the fleet's B = 1 step) as its single-instance
    call, the same launch: the leading axis dropped."""
    pos, ndim = BATCHED_ARGS.get(name, ((), 0))
    if not pos or args[pos[0]].dim() != ndim or args[pos[0]].shape[0] != 1:
        return args
    return tuple(a[0] if i in pos and a is not None else a for i, a in enumerate(args))


class Recorder:
    """Installed as the kernels' observer (``kernels.observer``), keeps the
    arguments of the latest call of each observed kernel wrapper for each
    shape (and of a few earlier ones), and counts the calls per shape."""

    KEYS = {  # wrapper: (label, shape from its arguments)
        "triangulate": ("K13", lambda a: a[2].shape[0]),
        "triangulate_rows": ("K13 rows", lambda a: a[6].shape[0]),
        "feature_block": ("K9", lambda a: tuple(a[5].shape)),
        "feature_block_rows": ("K9 rows", lambda a: (a[7].shape[0], a[4].shape[1]
                                                     if a[13] is None else a[13].shape[0])),
        "detect_fast": ("K4+K6", lambda a: (tuple(a[0].shape),
                                            0 if a[2] is None else a[2].shape[0])),
        "gating_test_batch": ("K10", lambda a: tuple(a[0].shape)),
        "apply_update_rank12": ("K12", lambda a: tuple(a[2].shape)),
        "apply_update_rank12_rows": ("K12 rows", lambda a: tuple(a[2].shape)),
        "apply_update": ("K11", lambda a: _update_tier(a)),
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
        "select_track": ("K8 select_track", lambda a: (a[0].shape[0], a[5].shape[0])),
        "predict_warp_points": ("K7 predict_warp_points", lambda a: a[0].shape[0]),
        "stereo_gate": ("K7 stereo_gate", lambda a: a[0].shape[0]),
        "extract_windows": ("P1", lambda a: (a[1].shape[0], a[3])),
        "pyramidal_lk_level": ("K1 level", lambda a: (a[2].shape[0], a[6])),
        "pyramidal_lk_compact": ("P1 compact", lambda a: (a[2].shape[0], a[9], a[5])),
        "propagate": ("K14", lambda a: (tuple(a[0].cov.shape), a[2].shape[0])),
        "pyramidal_lk": ("K1", lambda a: (a[2].shape[0], a[9])),
        "build_pyramid_pair": ("K2", lambda a: tuple(a[0].shape)),
        "build_pyramid_padded": ("K2 one camera", lambda a: tuple(a[0].shape)),
    }
    # kinds whose every call is kept (the fused front-end entry points: a
    # few hundred small calls a run)
    EVERY_CALL = {"K8 select_track", "K7 predict_warp_points", "K7 stereo_gate", "K14",
                  "K4+K6", "K9 rows", "K5", "K12 rows", "K13 rows", "P1 compact"}

    def __init__(self):
        self.calls, self.counts, self.history = {}, {}, {}
        self.qr_calls = []  # every EKF update on the QR tier
        self.motion = None  # [features the motion check decided, rejected], on the card

    def __call__(self, name, args):
        args = _single_call(name, args)
        if name == "triangulate_rows" and args[10].translation_threshold >= 0:
            # the motion check's decisions, by its plain version on the call's
            # rows (on the card: no host read in the run)
            import torch

            from uav_airvision_tpu_torch.models.msckf import triangulation as tri

            cq, cp, obs, mask, _, initialized, sel, sel_ok = args[:8]
            need = sel_ok & ~initialized[sel]
            ok = tri.check_motion(cq, cp, obs[sel], mask[sel], args[10])
            n = torch.stack([need.sum(), (need & ~ok).sum()])
            self.motion = n if self.motion is None else self.motion + n
        label, shape = self.KEYS[name]
        if label == "K14":  # propagation reads the IMU state and the covariance only
            args = (args[0]._replace(features=None, cams=None), *args[1:])
        key = (label, shape(args))
        self.calls[key] = args
        n = self.counts[key] = self.counts.get(key, 0) + 1
        if n <= 2 or n % 40 == 0 or label in self.EVERY_CALL:  # a few earlier calls, too
            self.history.setdefault(key, []).append(args)
        if key == ("K11", "QR"):
            self.qr_calls.append(_ekf_args(args))

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


def k11_tiers(snapshot):
    """K11's instance-updates by row tier in a recorder snapshot."""
    return {t: snapshot["counters"].get(f"k11.updates.{t}", 0) for t in ("T1", "T2", "QR", "all")}


def _update_tier(a):
    """The row tier of a recorded apply_update call (state, params, H, r, rows)."""
    from uav_airvision_tpu_torch.models.msckf.update import update_tier

    return update_tier(a[2].shape[0], a[2].shape[1], a[4])


def _ekf_args(a):
    """(P, H, r, obs_noise, rows) of a recorded apply_update call."""
    return a[0].cov, a[2], a[3], a[1].obs_noise, a[4]


def _state_fields(state):
    """The fields an EKF update changes, by name."""
    i, c = state.imu, state.cams
    return {"q": i.q, "bg": i.bg, "v": i.v, "ba": i.ba, "p": i.p, "R_imu_cam0": i.R_imu_cam0,
            "t_cam0_imu": i.t_cam0_imu, "cams.q": c.q, "cams.p": c.p, "cov": state.cov}


def _field_errs(got, want):
    """{field: the largest difference relative to the field's largest entry
    (at least 1e-30)} over the changed fields."""
    w = _state_fields(want)
    return {k: float((g.double() - w[k].double()).abs().max())
            / max(float(w[k].double().abs().max()), 1e-30)
            for k, g in _state_fields(got).items()}


def _state_err(got, want):
    """The largest difference over the changed fields, each relative to the
    field's largest entry (at least 1e-30)."""
    return max(_field_errs(got, want).values())


def _rows_needed(H, r):
    """Per block, the rows up to the last one with a nonzero entry of H or r."""
    import torch

    nz = (H.abs().amax(2) != 0) | (r != 0)
    idx = torch.arange(nz.shape[1], device=nz.device).expand_as(nz)
    return (torch.where(nz, idx, -1).amax(1) + 1).to(torch.float64).cpu()


def check_gate(rec: Recorder):
    """K10 against its plain version and the plain pieces on the recorded
    gate calls at forced residual scales and row tiers; timed at its two
    most frequent shapes.  Returns {"K10": (...)}."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import update as upd

    gates = rec.of("K10")
    gate_err = 0.0
    for shape, a in sorted(gates.items()):
        H, r, rows, cov, noise, table, dof = a
        B, R = r.shape
        thresh = table[torch.clamp(dof, 0, table.shape[0] - 1).long()]
        tiers = [rows] if R <= 32 else [rows, torch.full_like(rows, R)]
        tr = ((H @ cov) * H).sum((1, 2))
        # beside the uniform scales, one that puts the first block with a
        # residual at the geometric middle of its undecided band, the rest
        # on the pass side: the gamma branch on every block
        rtr0 = (r * r).sum(-1)
        first = int(torch.nonzero(rtr0 > 0)[0, 0]) if bool((rtr0 > 0).any()) else 0
        mid = torch.sqrt(thresh * torch.sqrt(noise * (noise + tr)) / rtr0.clamp(min=1e-30))
        forced = torch.where(torch.arange(B, device=H.device) == first, mid,
                             torch.full_like(mid, 1e-3))
        scales = {**{f"{s:g}": s for s in (1e-3, 1.0, 10.0, 30.0, 1e3)},
                  "one undecided": forced[:, None]}
        solved = []
        for label, scale in scales.items():
            rs = r * scale
            rtr = (rs * rs).sum(-1)
            ps, fs = upd.gate_bounds_plain(H, rs, cov, noise, thresh)
            undecided = bool((~(ps | fs)).any())
            near_b = ((rtr - thresh * noise).abs() <= 1e-4 * rtr) | (
                (rtr - thresh * (noise + tr)).abs() <= 1e-4 * rtr)
            for rt in tiers:
                got = upd.gating_test_batch(H, rs, rt, cov, noise, table, dof)
                want = upd.gating_test_batch_plain(H, rs, rt, cov, noise, table, dof)
                m = R if R <= 32 or int(rt.max()) > 32 else 32
                gamma = upd.gate_gamma_plain(H[:, :m], rs[:, :m], cov, noise)
                near = ((gamma - thresh).abs() <= 1e-4 * thresh) | near_b
                bad = (got != want) & ~near
                if bool(bad.any()):
                    fail(f"K10 {tuple(shape)} scale {label}, max rows {int(rt.max())}: "
                         f"decisions differ on {int(bad.sum())} blocks")
                # the plain pieces: decided by the bounds, every block takes
                # pass_sure; else gamma < thresh on the tier's rows, and the
                # kernel's gamma within 1e-4 relative of the plain gamma
                solve = R <= 32 or undecided
                piece = gamma < thresh if solve else ps
                if not bool(((got == piece) | near).all()):
                    fail(f"K10 {tuple(shape)} scale {label}, max rows {int(rt.max())}: the "
                         f"decisions differ from the plain {'gamma' if solve else 'bounds'}")
                if not solve:
                    continue
                _, g = upd._gate_kernel(H, rs, rt, cov, noise, table, dof, with_gamma=True)
                same_nan = torch.equal(g.isnan(), gamma.isnan())
                rel = float(((g - gamma).abs() / gamma.abs().clamp(min=1e-30)).nan_to_num().max())
                if label == "1":
                    gate_err = max(gate_err, float((g - gamma).abs().nan_to_num().max()))
                if not same_nan or not rel <= 1e-4:
                    fail(f"K10 gamma {tuple(shape)} scale {label} on {m} rows: relative error "
                         f"{rel:.3e}, NaN pattern equal {same_nan}")
                if R > 32:
                    solved.append(f"{label}/{m}")
        print(f"[K10] gate {tuple(shape)}: decisions agree with the plain version and its "
              f"pieces, gamma within 1e-4, at scales {'/'.join(scales)} on the "
              f"{'/'.join(str(int(t.max())) for t in tiers)}-row tiers"
              + (f"; gamma ran at scale/rows {', '.join(dict.fromkeys(solved))}"
                 if solved else ""))
    if not any(shape[1] > 32 for shape in gates):
        fail("the warm run made no 77-row gate call")
        return {}
    # timed at its two most frequent shapes in the warm run (the lost
    # features' 77-row gate and the prune's 5-row gate)
    top = sorted(gates, key=lambda sh: (-rec.counts[("K10", sh)], str(sh)))[:2]
    ms, pms, n_bytes, ops, timed, lib = 0.0, 0.0, 0, 0.0, [], None
    for shape in top:
        a = gates[shape]
        H, r, rows, cov, noise, table, dof = a
        B, R, D = H.shape
        t_ms = cuda_ms(lambda: upd.gating_test_batch(*a))
        ms += t_ms
        pms += cuda_ms(lambda: upd.gating_test_batch_plain(*a), reps=10)
        thresh = table[torch.clamp(dof, 0, table.shape[0] - 1).long()]
        ps, fs = upd.gate_bounds_plain(H, r, cov, noise, thresh)
        solve = R <= 32 or bool((~(ps | fs)).any())
        if R > 32:  # H P over the rows that hold data (2 nz D^2) and the trace
            nz = _rows_needed(H, r)
            ops += float((2 * nz * D * D + 2 * nz * D).sum())
        if solve:  # and S's lower triangle, the Cholesky and the border row on the tier
            m = R if R <= 32 or int(rows.max()) > 32 else 32
            nz = _rows_needed(H[:, :m], r[:, :m])
            ops += float((2 * nz * D * D + nz * (nz + 1) * D + nz ** 3 / 3 + nz ** 2).sum())
        n_bytes += nbytes(H, r, rows, cov, noise, table, dof) + B
        # the library's gate on the same blocks: S's Cholesky, the whitened
        # residual by a triangular solve, gamma < thresh (S given), and the
        # same with S = H P H' + noise I formed first
        S = H @ cov @ H.transpose(1, 2) + noise * torch.eye(R, dtype=H.dtype, device=H.device)

        def library(S):
            chol = torch.linalg.cholesky_ex(S)[0]
            y = torch.linalg.solve_triangular(chol, r[..., None], upper=False)
            return (y * y).sum((1, 2)) < thresh

        l_ms = cuda_ms(lambda: library(S))
        ls_ms = cuda_ms(lambda: library(H @ cov @ H.transpose(1, 2) + noise * torch.eye(
            R, dtype=H.dtype, device=H.device)))
        lib = l_ms + (lib or 0.0)
        timed.append(f"{tuple(shape)} ({rec.counts[('K10', shape)]} calls, "
                     f"{'gamma' if solve else 'bounds only'}) {t_ms:.4f} ms (the library's "
                     f"cholesky_ex + solve_triangular + compare {l_ms:.4f} ms, with S formed "
                     f"{ls_ms:.4f} ms)")
    b = bound(n_bytes, ops)
    print(f"[K10] gating_test_batch, one launch a call: {' + '.join(timed)} = {ms:.4f} ms vs "
          f"plain {pms:.4f} ms, library {lib:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
    return {"K10": (gate_err, ms, pms, *b, lib)}


def check_backend_kernels(rec: Recorder, config, params):
    """K13, K9, K10 and K12 against their plain versions on the calls the
    warm run recorded, and on forced cases.  Returns {name: (max_abs_err,
    ms, plain_ms, bound_ms, bound_by)} with the times and bound at each
    kernel's most frequent shape in the warm run (K10: its two)."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import triangulation as tri
    from uav_airvision_tpu_torch.models.msckf import update as upd

    res = {}

    res.update(check_triangulate_rows(rec, "main"))
    res.update(check_feature_rows(rec))
    res.update(check_gate(rec))

    # K12: the row-indexed entry on every recorded prune call (the main
    # path's); then the dense entries on the latest call's masked stack, and
    # with an exactly singular P12
    calls = rec.samples("K12 rows")
    if not calls:
        fail("the warm run made no rank-12 prune update")
        return res
    # every call: test_rank12_kernel_matches_plain's bars (every changed field
    # within 1e-4 of max(|P|, 1)), and both float32 versions' distance from
    # the float64 plain version, field by field relative; the latest call of
    # each shape also with every field within 1e-4 of its own largest entry.
    # Printed: the calls on which the kernel is no farther from float64 than
    # max(1.25 x the float32 plain version, 1e-4) in every field (ROADMAP
    # fault 11: not held, the float32 kernel is not there on every call)
    worst = worst_abs = k64 = p64 = 0.0
    n_far = 0
    latest = {id(a) for a in rec.of("K12 rows").values()}
    for _, full in calls:
        got, warn = upd.apply_update_rank12_rows(*full)
        want, pwarn = upd.apply_update_rank12_rows_plain(*full)
        scale = max(float(want.cov.abs().max()), 1.0)
        fg, fw = _state_fields(got), _state_fields(want)
        err_abs = max(float((fg[k] - fw[k]).abs().max()) for k in fg)
        err = err_abs / scale
        worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
        ref, _ = upd.apply_update_rank12_rows_plain(*_cast(full[:2], torch.float64),
                                                    full[2].double(), full[3].double(),
                                                    *full[4:])
        dk, dp = _field_errs(got, ref), _field_errs(want, ref)
        k64, p64 = max(k64, max(dk.values())), max(p64, max(dp.values()))
        n_far += any(not dk[k] <= max(1.25 * dp[k], 1e-4) for k in dk)
        e_state = _state_err(got, want) if id(full) in latest else 0.0
        if (not err <= 1e-4 or not e_state <= 1e-4 or bool(warn) != bool(pwarn)
                or not torch.equal(got.cov, got.cov.T)):
            fail(f"K12 rows {tuple(full[2].shape)}: error {err:.3e} of max(|P|, 1), state "
                 f"{e_state:.3e} of each field's max")
    # timed at the most frequent shape's latest call
    timed = rec.of("K12 rows")[rec.most_frequent("K12 rows")]
    state, params, H12, r_blk, include, cols = timed
    n_inc = int(include.sum())
    n_launch, dev_us = _profile_calls(lambda: upd.apply_update_rank12_rows(*timed),
                                      kernels=("rank12_kernel",))
    if n_launch != 1.0:
        fail(f"K12 apply_update_rank12_rows made {n_launch} launches a call")
    ms = cuda_ms(lambda: upd.apply_update_rank12_rows(*timed))
    pms = cuda_ms(lambda: upd.apply_update_rank12_rows_plain(*timed), reps=10)
    P, noise, D = state.cov, params.obs_noise, state.cov.shape[0]
    n = 5 * n_inc
    # B'B, B'r over the included rows, W, the LU and its 13 right-hand
    # sides, Pc G, delta, and 26 FLOP per entry of sym(P - Pc G Pc'); the
    # injection's few hundred
    ops = 2 * n * 90 + 3 * 12 ** 3 + 13 * 144 + 2 * D * 156 + 26 * D * D + 40 * D
    got, _ = upd.apply_update_rank12_rows(*timed)
    b = bound(nbytes(*_state_fields(got).values()) + nbytes(*_state_fields(state).values())
              + n * 13 * P.element_size() + nbytes(include, cols, noise), ops)
    Bm = torch.where(include[:, None, None], H12, 0.0).reshape(-1, 12)
    rr = torch.where(include[:, None], r_blk, 0.0).reshape(-1)
    P12 = P[cols][:, cols]
    BtB = Bm.T @ Bm
    W = noise * torch.eye(12, dtype=P.dtype, device=P.device) + BtB @ P12
    rhs = torch.cat([(Bm.T @ rr)[:, None], BtB], dim=1)
    lib = cuda_ms(lambda: torch.linalg.solve(W, rhs))
    print(f"[K12] apply_update_rank12_rows on the {len(calls)} recorded prune calls "
          f"({sorted({sh for sh, _ in calls})}): error up to {worst:.3e} of max(|P|, 1); "
          f"from the float64 plain version, field by field, the kernel {k64:.3e} and the "
          f"float32 plain version {p64:.3e} (each call's fields within max(1.25 x the plain "
          f"version's, 1e-4) on {len(calls) - n_far} of {len(calls)}); the most frequent "
          f"shape's latest ({n_inc} of "
          f"{include.shape[0]} features included): {n_launch:.0f} launch a "
          f"call, {dev_us:.2f} us on the device; {ms:.4f} ms through the wrapper vs plain "
          f"{pms:.4f} ms; torch.linalg.solve of the 12x12 system {lib:.4f} ms; bound "
          f"{b[0] * 1e3:.3f} us ({b[1]})")
    res["K12"] = (worst_abs, ms, pms, *b, lib)
    Psing = P.clone()
    Psing[cols[6:], :] = 0.0  # the second camera's block: P12 of rank 6
    Psing[:, cols[6:]] = 0.0
    cases = {"dense stack": (state, params, Bm, rr, cols),
             "singular P12": (state._replace(cov=Psing), params, Bm, rr, cols)}
    for label, full in cases.items():
        state, params = full[0], full[1]
        a = (state.cov, full[2], full[3], full[4], params.obs_noise)
        P, Bm, rr, cols, noise = a
        rank = int(torch.linalg.matrix_rank(P[cols][:, cols].double()))
        delta, P_new = upd.rank12_update(*a)
        pdelta, pP_new = upd.rank12_update_plain(*a)
        scale = max(float(pP_new.abs().max()), 1.0)
        err = max(float((P_new - pP_new).abs().max()), float((delta - pdelta).abs().max()))
        got, warn = upd.apply_update_rank12(*full)
        want, pwarn = upd.apply_update_rank12_plain(*full)
        e_state = _state_err(got, want)
        if (not err <= 1e-4 * scale or not torch.isfinite(P_new).all() or bool(warn) != bool(pwarn)
                or not torch.equal(got.cov, P_new) or not e_state <= 1e-4):
            fail(f"K12 {label}: error {err:.3e} (max |P| {scale:.3e}), state {e_state:.3e}")
        print(f"[K12] rank12_update and apply_update_rank12, {label} {tuple(Bm.shape)}, P12 "
              f"rank {rank}: error {err:.3e}, injected state {e_state:.3e} of each field's "
              f"max; apply_update_rank12 {cuda_ms(lambda: upd.apply_update_rank12(*full)):.4f} "
              f"ms")
    return res


def check_triangulate_rows(rec: Recorder, run: str):
    """K13's row entry on every triangulate_rows call that ``run`` recorded:
    initialized and init_fail identical to the plain version's, the rows
    that got a position within K13's bars (1e-3 of max(|p|, 1) for each
    and 1e-4 for 95%: a cost comparison that ties within rounding can take
    the other LM branch, and an unconverged solve ends a step apart),
    every other row unchanged; and bit for bit equal to the call site's
    glue around ``triangulate``, the kernel's separate cost and
    normal-equation passes (the parent kernel's recurrence, in this
    kernel's thread layout and sum order).  Timed at the most frequent shape: one launch a call
    (torch.profiler), device us.  Returns {"K13": (...)} for the main
    run."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import triangulation as tri

    calls = rec.samples("K13 rows")
    if not calls:
        fail(f"[K13] the {run} run made no triangulation call")
        return {}
    worst = worst_abs = 0.0
    n_new = n_fail = n_bad = 0
    close = []
    for B, a in calls:
        cq, cp, obs, mask, position, initialized, sel, sel_ok, R, t, cfg = a
        pos, init, failed = tri.triangulate_rows(*a)
        ppos, pinit, pfail = tri.triangulate_rows_plain(*a)
        new = init & ~initialized
        need = sel_ok & ~initialized[sel]
        wpos, wok = tri.triangulate(cq, cp, obs[sel], mask[sel], R, t, cfg, active=need)
        if cfg.translation_threshold >= 0:
            wok = wok & tri.check_motion(cq, cp, obs[sel], mask[sel], cfg)
        done = need & wok
        same = (torch.equal(failed, need & ~wok)
                and torch.equal(init, initialized.index_put((sel,), initialized[sel] | done))
                and torch.equal(pos, position.index_put((sel,), torch.where(
                    done[:, None], wpos, position[sel]))))
        ok = torch.equal(init, pinit) and torch.equal(failed, pfail) and torch.equal(
            pos[~new], position[~new])
        if bool(new.any()):
            rel = ((pos - ppos).abs().max(1).values
                   / ppos.abs().max(1).values.clamp(min=1.0))[new]
            worst = max(worst, float(rel.max()))
            worst_abs = max(worst_abs, float((pos - ppos)[new].abs().max()))
            close.append(rel <= 1e-4)
        n_new += int(new.sum())
        n_fail += int(failed.sum())
        if not ok or not same:
            n_bad += 1
            fail(f"[K13] {run} run, B={B}: initialized/init_fail/unchanged rows agree with "
                 f"the plain version {ok}, bit for bit equal to the separate passes {same}")
    frac = float(torch.cat(close).float().mean()) if close else 1.0
    if not worst <= 1e-3 or frac < 0.95:
        fail(f"[K13] {run} run: position error {worst:.3e}, {frac:.3f} within 1e-4")
    shape = rec.most_frequent("K13 rows")
    a = rec.of("K13 rows")[shape]
    n_launch, dev_us = _profile_calls(lambda: tri.triangulate_rows(*a),
                                      kernels=("triangulate_kernel",))
    if n_launch != 1.0:
        fail(f"[K13] triangulate_rows made {n_launch} launches a call")
    ms = cuda_ms(lambda: tri.triangulate_rows(*a))
    pms = cuda_ms(lambda: tri.triangulate_rows_plain(*a), reps=10)
    cq, cp, obs, mask, position, initialized, sel, sel_ok, R, t, cfg = a
    n_obs = mask[sel].sum(1).to(torch.float64)
    act = (sel_ok & ~initialized[sel]).to(torch.float64)
    # per observing slot of an active row ~230 FLOP to build its two views,
    # per view and pass ~75 for the cost and the normal equations, ~7 for the
    # depth check; at least two passes (x0 and one trial)
    ops = float((act * n_obs * (230 + 2 * 2 * 75 + 2 * 7)).sum())
    M, N = mask.shape
    b = bound(nbytes(cq, cp, R, t, sel, sel_ok) + float(act.sum()) * N * (4 * obs.element_size() + 1)
              + 2 * nbytes(position, initialized) + sel.shape[0], ops)
    print(f"[K13] triangulate_rows, {len(calls)} recorded calls of the {run} run (B in "
          f"{sorted({B for B, _ in calls})}): {n_new} rows initialized, {n_fail} failed; "
          f"initialized and init_fail identical to the plain version, positions within "
          f"{worst:.3e} of max(|p|, 1) ({frac:.3f} within 1e-4), bit for bit equal to the "
          f"separate passes on {len(calls) - n_bad} of {len(calls)}; at B={shape} "
          f"({rec.counts[('K13 rows', shape)]} calls): {n_launch:.0f} launch a call, "
          f"{dev_us:.2f} us on the device, {ms:.4f} ms through the wrapper vs plain "
          f"{pms:.4f} ms; bound {b[0] * 1e3:.4f} us ({b[1]})")
    return {"K13": (worst_abs, ms, pms, *b)}


def _gathered(a):
    """feature_block's arguments of a recorded feature_block_rows call (the
    map rows and window slots gathered as the call sites once did)."""
    cq, cp, cqn, cpn, obs, mask, pos, sel, proc, g, Rc, tc, D, rm = a
    if rm is not None:
        cq, cp, cqn, cpn, obs, mask = cq[rm], cp[rm], cqn[rm], cpn[rm], obs[:, rm], mask[:, rm]
    return (cq, cp, cqn, cpn, obs[sel], mask[sel], pos[sel], g, Rc, tc, D)


def check_feature_rows(rec: Recorder):
    """K9 through its row-indexed entry on every call of the warm run (the
    lost features' N = 20 blocks and the prune's N = 2 blocks): H_proj and
    r_proj within 3e-5 (N = 20) / 1e-4 (N = 2: the reflections of two close
    views cancel) of each block's largest entry, rows_true exact, blocks
    whose proc is false zeros; one launch a call.  The same calls' gathered
    blocks through ``feature_block`` (every block, the padding too) show how
    far the kernel and the float32 plain version are from the float64 plain
    version, and where they differ most (the views and depth of that
    block).  Returns {"K9": (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)} at the most frequent shape."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import update as upd

    res = {}
    samples = rec.samples("K9 rows")
    if not samples:
        fail("the warm run made no feature_block_rows call")
        return res
    worst = {}  # shape: [largest error of the block maximum, absolute error, calls]
    for (B, N), a in samples:
        H, r, rows = upd.feature_block_rows(*a[:13], rm=a[13])
        pH, pr, prows = upd.feature_block_rows_plain(*a[:13], rm=a[13])
        proc = a[8]
        scale = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
        err = max(float(((g - w).abs().flatten(1).amax(1) / scale).max())
                  for g, w in ((H, pH), (r, pr)))
        abs_err = max(float((H - pH).abs().max()), float((r - pr).abs().max()))
        tol = 3e-5 if N > 2 else 1e-4
        zero = not (bool(H[~proc].any()) or bool(r[~proc].any()) or bool(rows[~proc].any()))
        if not torch.equal(rows, prows) or not err <= tol or not zero:
            fail(f"K9 rows B={B} N={N}: error {err:.3e} of the block maximum, rows equal "
                 f"{torch.equal(rows, prows)}, padding zero {zero}")
        w = worst.setdefault((B, N), [0.0, 0.0, 0])
        w[0], w[1], w[2] = max(w[0], err), max(w[1], abs_err), w[2] + 1
    for (B, N), w in sorted(worst.items()):
        a = rec.of("K9 rows")[(B, N)]
        g = _gathered(a)
        # every gathered block, the padding's one-view blocks too, against
        # the float64 plain version
        H, r, _ = upd.feature_block(*g)
        pH, pr, _ = upd.feature_block_plain(*g)
        g64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                    for x in g)
        H64, r64, _ = upd.feature_block_plain(*g64)
        sc = torch.maximum(H64.abs().amax((1, 2)), r64.abs().amax(1)).clamp(min=1e-30)

        def off(h, v):
            return torch.maximum((h.double() - H64).abs().flatten(1).amax(1),
                                 (v.double() - r64).abs().flatten(1).amax(1)) / sc

        e_k, e_p = off(H, r), off(pH, pr)
        b = int((e_k - e_p).abs().argmax())
        seen = g[5][b]
        cams = g[1][seen]
        base = float(torch.cdist(cams, cams).max()) if int(seen.sum()) else 0.0
        depth = float((g[6][b] - cams).norm(dim=1).min()) if int(seen.sum()) else 0.0
        views = g[5].sum(1)
        one = views == 1
        one_txt = (f"; on the {int(one.sum())} one-view block(s) the kernel is "
                   f"{float(e_k[one].max()):.3e} off float64, the float32 plain version "
                   f"{float(e_p[one].max()):.3e}" if bool(one.any()) else "")
        print(f"[K9] B={B} N={N}: {w[2]} recorded calls through feature_block_rows, largest "
              f"error {w[0]:.3e} of the block maximum (bar {3e-5 if N > 2 else 1e-4}); every "
              f"gathered block through feature_block against the float64 plain version: the "
              f"kernel {float(e_k.max()):.3e} off, the float32 plain version "
              f"{float(e_p.max()):.3e}{one_txt}; they differ most on a block of "
              f"{int(seen.sum())} view(s) over a baseline of {base:.3f} m at depth "
              f"{depth:.2f} m")
        kw = dict(rm=a[13])
        n_launch, dev_us = _profile_calls(lambda: upd.feature_block_rows(*a[:13], **kw),
                                          kernels=("feature_block_kernel",))
        if n_launch != 1.0:
            fail(f"K9 rows B={B} N={N}: {n_launch} launches a call")
        ms = cuda_ms(lambda: upd.feature_block_rows(*a[:13], **kw))
        pms = cuda_ms(lambda: upd.feature_block_rows_plain(*a[:13], **kw), reps=10)
        proc = a[8]
        n_obs = (g[5].sum(1) * proc).to(torch.float64)
        # per computed block: ~400 FLOP a view for its Jacobians, ~30 a column
        # for w_j, ~6 an output value on its 4 n_obs live rows
        D = 21 + 6 * N
        ops = float((n_obs * 400 + 90 * N + 6 * 4 * n_obs * D).sum())
        Hout, rout, rowsout = upd.feature_block_rows(*a[:13], **kw)
        # the kernel reads the map rows it is given, the window, sel and proc
        b_in = nbytes(*g[:7], *g[7:10], a[7], a[8]) + (nbytes(a[13]) if a[13] is not None else 0)
        bnd = bound(b_in + nbytes(Hout, rout, rowsout), ops)
        # the library's nullspace basis: a complete QR of the stacked feature
        # Jacobians H_f (B, 4N, 3), from which the projection is one product
        Hf = upd.stacked_tile(*g[:10])[0][:, :, :3].contiguous()
        lib = cuda_ms(lambda: torch.linalg.qr(Hf, mode="complete"))
        print(f"[K9] feature_block_rows B={B} x N={N} -> {tuple(Hout.shape)}: {n_launch:.0f} "
              f"launch a call, {dev_us:.2f} us on the device; {ms:.4f} ms through the wrapper "
              f"vs plain {pms:.4f} ms; torch.linalg.qr of the {tuple(Hf.shape)} H_f stack "
              f"{lib:.4f} ms; bound {bnd[0] * 1e3:.3f} us ({bnd[1]})")
        if (B, N) == rec.most_frequent("K9 rows"):
            res["K9"] = (w[1], ms, pms, *bnd, lib)
    return res


def check_fast_recorded(rec: Recorder):
    """K4+K6 on every call of the warm run: keep and score equal to the plain
    version's, bit for bit; one launch a call (device us printed)."""
    import torch

    from uav_airvision_tpu_torch.ops import fast

    samples = rec.samples("K4+K6")
    if not samples:
        fail("the warm run made no detect_fast call")
        return
    bad = 0
    for _, a in samples:
        got, want = fast.detect_fast(*a), fast.detect_fast_plain(*a)
        bad += not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    if bad:
        fail(f"K4+K6 differs from its plain version on {bad} of {len(samples)} recorded calls")
    a = rec.of("K4+K6")[rec.most_frequent("K4+K6")]
    n_launch, dev_us = _profile_calls(lambda: fast.detect_fast(*a), kernels=("fast_tile_kernel",))
    if n_launch != 1.0:
        fail(f"K4+K6: {n_launch} launches a call")
    print(f"[K4+K6] {len(samples)} recorded calls ({sorted({sh for sh, _ in samples})}): "
          f"{'exact' if not bad else f'{bad} differ'}; {n_launch:.0f} launch a call, "
          f"{dev_us:.2f} us on the device")


def _timed_sum(rec: Recorder, entries):
    """Sum over entry points of the kernel's and the plain version's median
    ms at the entry point's most frequent shape.  ``entries``: (kind, kernel,
    plain).  Returns (ms, plain_ms, [(kind, shape, args, ms, plain_ms)])."""
    timed = []
    for kind, kernel, plain in entries:
        shape = rec.most_frequent(kind)
        if shape is None:
            fail(f"the warm run made no {kind} call")
            continue
        a = rec.of(kind)[shape]
        timed.append((kind, shape, a, cuda_ms(lambda: kernel(*a)),
                      cuda_ms(lambda: plain(*a), reps=10)))
    return sum(t[3] for t in timed), sum(t[4] for t in timed), timed


def _ulps_from(value, thresh):
    """|value - thresh| in float32 ulps of ``thresh``, elementwise (numpy)."""
    import numpy as np

    thresh = np.float32(thresh)
    return np.abs(np.asarray(value, np.float32) - thresh) / np.spacing(np.abs(thresh))


def _gate_flips(kind, a, got, want):
    """Report each point whose stereo-gate decision differs between the
    kernel and the plain version, with the distance of the nearest cut's
    value (the fwd/bwd error, the epipolar residual) from its threshold in
    float32 ulps; fail past 8.  Returns the largest such distance."""
    import torch

    from uav_airvision_tpu_torch.ops import camera

    flips = torch.nonzero(got != want)[:, 0]
    if len(flips) == 0:
        return 0.0
    cam0, p1, p0r, intr, model, coeffs, E, fwd_bwd, thresh = (a[0], a[1], a[2], a[6], a[7], a[8],
                                                              a[9], a[10], a[12])
    epi = camera.epipolar_residual_plain(cam0, p1, intr, model, coeffs, E)
    thr = thresh * (4.0 / (2.0 * intr[0] + 2.0 * intr[1]))
    err = torch.linalg.norm(cam0 - p0r, dim=-1)
    worst = 0.0
    for i in flips.tolist():
        near = min(float(_ulps_from(float(epi[i]), float(thr))),
                   float(_ulps_from(float(err[i]), fwd_bwd)))
        worst = max(worst, near)
        print(f"{kind} {cam0.shape[0]} points, {model}: point {i} flips (kernel "
              f"{bool(got[i])}, plain {bool(want[i])}); residual {float(epi[i]):.9g} against "
              f"{float(thr):.9g}, fwd/bwd error {float(err[i]):.9g} against {fwd_bwd}: "
              f"{near:.1f} ulps from the nearer threshold")
        if not near <= 8:
            fail(f"{kind}: a decision flips {near:.1f} ulps from its threshold (> 8)")
    return worst


def check_camera(rec: Recorder):
    """K7 against its plain version on the recorded calls, with the recorded
    (radtan) model and with equidistant coefficients; the fused prediction
    and stereo gate on every call of the warm run."""
    import torch

    from uav_airvision_tpu_torch.ops import camera

    equi = (-0.0113, 0.0052, -0.0021, 0.0005)

    def equidistant(coeffs):
        co = torch.tensor(equi, dtype=torch.float32, device=coeffs.device)
        return co[:, None].expand(4, coeffs.shape[1]) if coeffs.ndim == 2 else co

    # the stereo prologue and the publish (distort_points is checked below on
    # the prologue's output)
    worst = 0.0
    n_calls = 0
    for kind, kernel, plain in [
            ("K7 undistort_distort_points", camera.undistort_distort_points,
             camera.undistort_distort_points_plain),
            ("K7 undistort_points", camera.undistort_points, camera.undistort_points_plain)]:
        for shape, a in rec.samples(kind):
            for v in (a, (a[0], a[1], "equidistant", equidistant(a[3])) + tuple(a[4:])):
                got, want = kernel(*v), plain(*v)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                # undistorted points are normalized coordinates, the rest pixels
                tols = (1e-6, 2 * PX_ULP) if len(got) == 2 else (1e-6,)
                for g, w, tol in zip(got, want, tols):
                    err = float((g - w).abs().max())
                    worst = max(worst, err)
                    if not err <= tol or not torch.isfinite(g).all():
                        fail(f"{kind} {shape} {v[2]}: error {err:.3e} > {tol:.1e}")
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

    # the prediction: the rotation within 4 float32 ulps of 1.0, the points
    # within 4 ulps at 752 px; the homography warp alone (off the main path
    # since the fused entry point) on the same points and rotation
    calls = rec.samples("K7 predict_warp_points")
    e_rot = e_pts = e_warp = 0.0
    for _, a in calls:
        (got, R), (want, pR) = camera.predict_warp_points(*a), camera.predict_warp_points_plain(*a)
        e_rot = max(e_rot, float((R - pR).abs().max()))
        e_pts = max(e_pts, float((got - want).abs().max()))
        e_warp = max(e_warp, float((camera.homography_warp_points(a[0], pR, a[4])
                                    - camera.homography_warp_points_plain(a[0], pR, a[4]))
                                   .abs().max()))
    worst = max(worst, e_pts)
    if not (e_rot <= 4 * 2.0 ** -23 and e_pts <= 4 * PX_ULP and e_warp <= 2 * PX_ULP) or not calls:
        fail(f"K7 predict_warp_points on {len(calls)} calls: rotation error {e_rot:.3e} "
             f"(bar {4 * 2.0 ** -23:.2e}), points {e_pts:.3e} px (bar {4 * PX_ULP:.2e}); "
             f"homography_warp_points {e_warp:.3e} px (bar {2 * PX_ULP:.2e})")
    print(f"[K7] predict_warp_points, every call of the warm run ({len(calls)}): rotation "
          f"within {e_rot:.3e} of the plain version (4 ulps of 1.0: {4 * 2.0 ** -23:.2e}), "
          f"points within {e_pts:.3e} px ({4 * PX_ULP:.2e}); homography_warp_points on the "
          f"same points within {e_warp:.3e} px")

    # the stereo gate: decisions identical, any flip reported with its
    # distance from the threshold (> 8 ulps fails); also under equidistant
    # coefficients
    calls = rec.samples("K7 stereo_gate")
    n_pts = n_flips = 0
    near = 0.0
    for _, a in calls:
        for v in (a, a[:7] + ("equidistant", equidistant(a[8])) + a[9:]):
            got, want = camera.stereo_gate(*v), camera.stereo_gate_plain(*v)
            n_pts += got.shape[0]
            n_flips += int((got != want).sum())
            near = max(near, _gate_flips("K7 stereo_gate", v, got, want))
    if not calls:
        fail("the warm run made no K7 stereo_gate call")
    print(f"[K7] stereo_gate, every call of the warm run ({len(calls)}) x radtan/equidistant: "
          f"{n_flips} of {n_pts} decisions differ from the plain version (the farthest "
          f"{near:.1f} ulps from its threshold; bar 8)")

    for kind, fn, kernel in (("K7 predict_warp_points", camera.predict_warp_points,
                              "predict_warp_kernel"),
                             ("K7 stereo_gate", camera.stereo_gate, "stereo_gate_kernel")):
        a = rec.of(kind).get(rec.most_frequent(kind))
        if a is None:
            continue
        n_launch, dev_us = _profile_calls(lambda: fn(*a), kernels=(kernel,))
        print(f"[K7] {kind[3:]} {a[0].shape[0]} points: {n_launch:.2f} launches a call "
              f"(torch.profiler, 20 calls), {dev_us:.1f} us a call on the device")
        if n_launch != 1.0:
            fail(f"{kind} made {n_launch} launches a call")

    entries = [("K7 undistort_distort_points", camera.undistort_distort_points,
                camera.undistort_distort_points_plain),
               ("K7 undistort_points", camera.undistort_points, camera.undistort_points_plain),
               ("K7 predict_warp_points", camera.predict_warp_points,
                camera.predict_warp_points_plain),
               ("K7 stereo_gate", camera.stereo_gate, camera.stereo_gate_plain)]
    ms, pms, timed = _timed_sum(rec, entries)
    n_bytes = ops = 0
    for kind, shape, a, _, _ in timed:
        n = a[0].reshape(-1, 2).shape[0]
        if "stereo_gate" in kind:  # four point sets and two flags in, a flag out; E, camera
            n_bytes += n * (32 + 3) + 32 + 36
            ops += n * 230  # two undistorts (5 fixed-point iterations each) and the cuts
        elif "predict" in kind:  # points in and out, rate, dt, R, intrinsics; R out
            n_bytes += 16 * n + 12 + 4 + 36 + 16 + 36
            ops += 30 * n + 150  # the warp; Rodrigues and K R K^-1 once
        else:
            outs = 2 if "undistort_distort" in kind else 1
            n_bytes += 8 * n * (1 + outs) + 32 + 36  # points in and out, 8 values, R
            ops += n * 100 * outs
    b = bound(n_bytes, ops)
    print(f"[K7] camera models, {n_calls} recorded calls x radtan/equidistant: max error "
          f"{worst:.3e} (normalized 1e-6, pixels {PX_ULP:.1e}); "
          f"{' + '.join(f'{k[3:]} {sh} {m:.4f} (plain {pm:.4f})' for k, sh, _, m, pm in timed)}"
          f" = {ms:.4f} ms vs plain {pms:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
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
        n_launch, dev_us = _profile_calls(lambda: gridops.dense_grid_topk(*timed[0][2]),
                                          kernels=("grid_topk",))
        if n_launch != 1.0:
            fail(f"K5 made {n_launch} launches a call")
        print(f"[K5] dense_grid_topk {H}x{W} -> {gr * gc} cells x k={k} (every call of the "
              f"warm run, {len(calls)}, k=5 and 8, {n_empty} empty slots): exact; "
              f"{n_launch:.0f} launch a call, {dev_us:.2f} us on the device; {ms:.4f} ms "
              f"through the wrapper vs plain {pms:.4f} ms; torch.sort of the cells "
              f"{sort_ms:.4f} ms, torch.topk {topk_ms:.4f} ms; bound {b[0] * 1e3:.3f} us "
              f"({b[1]})")
        res["K5"] = (0.0, ms, pms, *b, sort_ms)

    # the five entry points (the first frame's selection and the back-end's)
    # and the fused selection of a tracked frame, on every recorded call
    entries = [(f"K8 {fn.__name__}", fn, getattr(gridops, fn.__name__ + "_plain"))
               for fn in gridops.K8_WRAPPERS + (gridops.select_track,)]
    n_calls, shapes = 0, set()
    for kind, kernel, plain in entries:
        for shape, a in rec.samples(kind):
            n_calls += 1
            shapes.add(shape if isinstance(shape, int) else sum(shape) if "select" in kind
                       else shape[0])
            if not same(kernel(*a), plain(*a)):
                fail(f"{kind} {shape} differs from its plain version")
    n_select = len(rec.samples("K8 select_track"))
    if n_select == 0:
        fail("the warm run made no K8 select_track call")
    ms, pms, timed = _timed_sum(rec, entries)
    n_bytes = ops = 0
    keys = []
    for kind, _, a, _, _ in timed:
        n_bytes += sum(nbytes(x) for x in a if isinstance(x, torch.Tensor))
        if "select" in kind:
            F, C = a[0].shape[0], a[5].shape[0]
            n = F + C
            # outputs: ids, lifetime, cam0, cam1, valid, next_id; what the
            # function needs: the candidates' sort, the count, the prune sort
            # and the compaction, ~3 operations a comparison
            n_bytes += 25 * F + 4
            ops += 3 * (C * math.log2(C) + 2 * n * math.log2(n))
            keys.append(torch.cat([a[3], a[7]]).to(torch.int64))
        else:
            n = a[0].shape[0]
            n_bytes += 8 * n  # outputs: at most two int32 arrays
            # not the kernels' pairwise count: a stable sort of n keys,
            # n log2 n comparisons of ~3 operations (cell, primary, arrival)
            ops += 3 * n * math.log2(max(n, 2))
            keys.append(a[0].to(torch.int64).contiguous())
    b = bound(n_bytes, ops)
    sel = rec.of("K8 select_track").get(rec.most_frequent("K8 select_track"))
    if sel is not None:  # one launch a call, and its device time
        n_launch, dev_us = _profile_calls(lambda: gridops.select_track(*sel),
                                          kernels=("select_track_kernel",))
        print(f"[K8] select_track {sel[0].shape[0]} + {sel[5].shape[0]}: {n_launch:.2f} launches "
              f"a call (torch.profiler, 20 calls), {dev_us:.1f} us a call on the device")
        if n_launch != 1.0:
            fail(f"K8 select_track made {n_launch} launches a call")
    # the library: one stable torch.sort of each entry point's n keys
    lib = sum(cuda_ms(lambda k=k: torch.sort(k, stable=True)) for k in keys)
    print(f"[K8] {n_calls} recorded calls (select_track: every call of the warm run, "
          f"{n_select}), n in {sorted(shapes)}: exact; "
          f"{' + '.join(f'{k[3:]} {sh} {m:.4f} (plain {pm:.4f})' for k, sh, _, m, pm in timed)}"
          f" = {ms:.4f} ms vs plain {pms:.4f} ms; torch.sort(stable=True) of the same n keys "
          f"{lib:.4f} ms; bound {b[0] * 1e3:.3f} us ({b[1]})")
    res["K8"] = (0.0, ms, pms, *b, lib)
    return res


def _cast(tree, dtype):
    """A state or params tuple with its floating tensors cast to ``dtype``."""
    import torch

    return torch.utils._pytree.tree_map(
        lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, tree)


def _profile_calls(fn, n=20, kernels=("update_kernel", "rank12_kernel")):
    """(kernel launches per call, device us per call of csrc kernels whose
    name holds one of ``kernels``) of ``n`` calls, by torch.profiler."""
    import torch

    from uav_airvision_tpu_torch.profile_main import LAUNCH_CALLS

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in LAUNCH_CALLS)
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.key for k in kernels))
    return launches / n, dev_us / n


def check_ekf_update(rec: Recorder):
    """K11 against its plain version at the tiers T1, T2 and QR in float32
    and float64, on recorded calls (stacked to reach a tier the run did not
    take): the update through ``ekf_update`` and, as the main path calls
    it, ``apply_update`` (one launch, the injection in it) on every field
    of the new state."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import update as upd

    calls = rec.of("K11")
    if not calls:
        fail("the warm run made no EKF update")
        return {}
    state0, params0, H0, r0, rows0 = calls.get("T1") or next(iter(calls.values()))
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
        return (state0, params0, H, r, rows)

    cases = {tier: [a] for tier, a in calls.items()}
    for tier, rows in (("T1", T1 - 3), ("T2", T2 - 5), ("QR", 3 * D + 11)):
        if tier not in cases:
            cases[tier] = [stacked(rows)]
            print(f"[K11] the warm run took no {tier} update: stacked a recorded call of "
                  f"{rows0} rows to {rows}")
    res = {}
    for tier in ("T1", "T2", "QR"):
        for full in cases[tier]:
            P, H, r, noise, rows = _ekf_args(full)
            want_d, want_P = upd.ekf_update_plain(P.double(), H.double(), r.double(),
                                                  noise.double(), rows)
            want_state, want_warn = upd.apply_update_plain(
                *_cast(full[:2], torch.float64), H.double(), r.double(), rows)
            sc_d, sc_P = float(want_d.abs().max()), max(float(want_P.abs().max()), 1.0)
            for dtype in (torch.float64, torch.float32):
                a = (P.to(dtype), H.to(dtype), r.to(dtype), noise.to(dtype), rows)
                d, Pn = upd.ekf_update(*a)
                pd, pPn = upd.ekf_update_plain(*a)
                got, warn = upd.apply_update(*_cast(full[:2], dtype), a[1], a[2], rows)
                e_d = float((d - want_d).abs().max())
                e_P = float((Pn - want_P).abs().max())
                p_d = float((pd - want_d).abs().max())
                p_P = float((pPn - want_P).abs().max())
                e_s = _state_err(got, want_state)
                if dtype == torch.float64:
                    ok = e_d <= 1e-10 * sc_d and e_P <= 1e-10 * sc_P and e_s <= 1e-12
                else:
                    ok = e_d <= max(1e-4 * sc_d, 4 * p_d) and e_P <= max(1e-5 * sc_P, 4 * p_P)
                ok = (ok and torch.equal(Pn, Pn.T) and bool(torch.isfinite(Pn).all())
                      and torch.equal(got.cov, Pn) and bool(warn) == bool(want_warn))
                if not ok:
                    fail(f"K11 {tier} {rows} rows {dtype}: delta error {e_d:.3e} of max "
                         f"{sc_d:.3e} (plain {p_d:.3e}), P error {e_P:.3e} of {sc_P:.3e} "
                         f"(plain {p_P:.3e}), injected state {e_s:.3e}")
                print(f"[K11] {tier} ({rows} rows) {str(dtype)[6:]}: against the float64 plain "
                      f"version, delta {e_d:.3e} of max {sc_d:.3e} (the plain version "
                      f"{p_d:.3e}), P {e_P:.3e} of {sc_P:.3e} (the plain version {p_P:.3e}); "
                      f"apply_update's state {e_s:.3e} of each field's max")
                if dtype == torch.float32 and tier == "T1":
                    res["err"] = e_P
    # a failed factorisation is NaN, as the plain version's
    bad = state0._replace(cov=-1e6 * torch.eye(D, dtype=H0.dtype, device=H0.device))
    d, Pn = upd.ekf_update(bad.cov, H0, r0, params0.obs_noise, rows0)
    got, _ = upd.apply_update(bad, params0, H0, r0, rows0)
    if not (bool(d.isnan().all()) and bool(Pn.isnan().all()) and bool(got.cov.isnan().all())
            and bool(got.imu.p.isnan().all())):
        fail("K11: a failed Cholesky did not give NaN")

    tier = rec.most_frequent("K11")
    full = calls[tier]
    P, H, r, noise, rows = _ekf_args(full)
    ms = cuda_ms(lambda: upd.apply_update(*full))
    pms = cuda_ms(lambda: upd.apply_update_plain(*full), reps=10)
    launches, dev_us = _profile_calls(lambda: upd.apply_update(*full))
    print(f"[K11] apply_update {tier} ({rows} true rows, {rec.counts[('K11', tier)]} calls): "
          f"{ms:.4f} ms vs plain {pms:.4f} ms; {launches:.2f} launches and {dev_us:.1f} us "
          f"on the device per call")
    if launches != 1.0:
        fail(f"K11: apply_update made {launches:.2f} launches a call, not one")
    # the fused call and the library's solve alone, at the recorded call's
    # rows and at 144 rows (a full T1 stack), in the same call
    lib = {}
    for full_m in (full, stacked(144)):
        Pm, Hm, rm, noise_m, mm = _ekf_args(full_m)
        S = Hm[:mm] @ Pm @ Hm[:mm].T + noise_m * torch.eye(mm, device=Pm.device, dtype=Pm.dtype)
        HP = Hm[:mm] @ Pm
        k_ms = cuda_ms(lambda: upd.apply_update(*full_m))
        l_ms = cuda_ms(lambda: torch.linalg.solve(S, HP))
        k_launch, k_us = _profile_calls(lambda: upd.apply_update(*full_m))
        lib[mm] = l_ms
        print(f"[K11] {mm} rows: apply_update {k_ms:.4f} ms ({k_us:.1f} us on the device, "
              f"{k_launch:.2f} launches) vs torch.linalg.solve(S, HP) alone {l_ms:.4f} ms")
    nz = float(rows)
    # the least the function needs over the rows that hold data: H P, S's
    # lower triangle, the Cholesky, two substitutions over D columns, K r and
    # P - K (H P) with the symmetrisation; past T2 the Householder QR of the
    # stack first (2 rows D^2) and then the same at D rows; the injection
    qr_ops = 0.0
    if tier == "QR":
        qr_ops, nz = 2 * nz * D * D, float(D)
    ops = (qr_ops + 2 * nz * D * D + nz * nz * D + nz ** 3 / 3 + 2 * nz * nz * D + 2 * nz * D
           + 2 * nz * D * D + 3 * D * D + 40 * D)
    nz = float(rows)
    b = bound(2 * nbytes(P) + (nz * (D + 1) + D + 1) * P.element_size()
              + 2 * (nbytes(*_state_fields(full[0]).values()) - nbytes(P)), ops)
    print(f"[K11] bound {b[0] * 1e3:.3f} us ({b[1]})")
    return {"K11": (res.get("err", 0.0), ms, pms, *b, lib[rows])}


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


def check_extract(rec: Recorder):
    """P1's standalone entry against its plain version on the window
    extracts of the compact calls' witness route: bit-exact.  Times at the
    most frequent shape, beside one indexing call that gathers the same
    windows."""
    import torch

    from uav_airvision_tpu_torch.ops import extract

    calls = rec.samples("P1")
    if not calls:
        fail("the witness route made no window extract call")
        return
    err = 0.0
    for shape, a in calls:
        got, want = extract.extract_windows(*a), extract.extract_windows_plain(*a)
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"P1 extract_windows {shape} differs from its plain version")
    shape = rec.most_frequent("P1")
    level, oy, ox, n = rec.of("P1")[shape]
    a = (level, oy, ox, n)
    ms = cuda_ms(lambda: extract.extract_windows(*a))
    pms = cuda_ms(lambda: extract.extract_windows_plain(*a), reps=10)
    ar = torch.arange(n, device=level.device)
    rows = (oy.long()[:, None] + ar)[:, :, None]
    cols = (ox.long()[:, None] + ar)[:, None, :]
    lib = cuda_ms(lambda: level[rows, cols])
    F = oy.shape[0]
    b = bound(2 * F * n * n * level.element_size() + 2 * F * oy.element_size(), 0.0)
    print(f"[P1] extract_windows (the standalone entry), {len(calls)} witness calls (F, n) in "
          f"{sorted({sh for sh, _ in calls})}: bit-exact (max diff {err:.1e}); at {shape} "
          f"{ms:.4f} ms vs plain {pms:.4f} ms; the indexing call level[rows, cols] {lib:.4f} "
          f"ms; bound {b[0] * 1e3:.3f} us ({b[1]})")


def check_lk_level(rec: Recorder):
    """K1's level entry against its plain version on the level calls of
    the compact calls' witness route: at level 0 the status agrees on >= 99% of points and
    points that both track lie within 1e-3 px (K1's bar); above level 0
    >= 99% of the valid points lie within 1e-3 px and the next level's
    window origins agree on >= 99%.  Timed at the most frequent shape."""
    import torch

    from uav_airvision_tpu_torch.ops import lk

    calls = rec.samples("K1 level")
    if not calls:
        fail("the compact run made no K1 level call")
        return
    worst = 0.0
    for shape, a in calls:
        kp, kd, ks = lk.pyramidal_lk_level(*a)
        pp, pd, ps = lk.pyramidal_lk_level_plain(*a)
        valid, L = a[3], a[6]
        if L == 0:
            agree = float((ks == ps).float().mean())
            both = ks & ps
            err = float((kp - pp)[both].abs().max()) if bool(both.any()) else 0.0
            ok = agree >= 0.99 and err <= 1e-3
            what = f"status agreement {agree:.4f}, max err {err:.3e} px"
        else:
            close = ((kp - pp).abs().amax(1) <= 1e-3)[valid]
            des_same = (kd == pd).all(1)[valid]
            agree = float(close.float().mean()) if len(close) else 1.0
            err = float((kp - pp)[valid].abs().amax(1)[close].max()) if bool(close.any()) else 0.0
            d_agree = float(des_same.float().mean()) if len(des_same) else 1.0
            ok = agree >= 0.99 and d_agree >= 0.99
            what = (f"{agree:.4f} of valid points within 1e-3 px (max {err:.3e}), next "
                    f"origins equal on {d_agree:.4f}")
        worst = max(worst, err)
        if not ok:
            fail(f"K1 level entry {shape}: {what}")
    shape = rec.most_frequent("K1 level")
    a = rec.of("K1 level")[shape]
    ms = cuda_ms(lambda: lk.pyramidal_lk_level(*a))
    pms = cuda_ms(lambda: lk.pyramidal_lk_level_plain(*a), reps=10)
    print(f"[K1 level] pyramidal_lk_level, {len(calls)} witness calls (F, L) in "
          f"{sorted({sh for sh, _ in calls})}: within the bars (max err {worst:.3e} px); at "
          f"{shape} {ms:.4f} ms vs plain {pms:.4f} ms")


def check_compact(rec: Recorder):
    """[P1]: K1's compact entry (one launch: each level's des, its window
    staged in shared memory, the template and the steps) on every compact
    LK call of the compact run, bit for bit equal to the route it replaced
    (P1's extract and K1's level entry per level, the coarsest des from the
    host): points, status and each level's window origin.  That route's
    extracts and level calls (recorded) then go to check_extract and
    check_lk_level.  Against the plain version on a sample of the calls,
    with check_lk_level's bars above level 0 (a whole call carries each
    level's rounding into the next): status on >= 99% of the points and
    >= 99% of the points both track within 1e-3 px.  Timed at the most
    frequent shape with its device us, one launch a call.  Returns
    {"P1": (...)}."""
    import torch

    from uav_airvision_tpu_torch.ops import lk

    calls = rec.samples("P1 compact")
    if not calls:
        fail("[P1] the compact run made no compact LK call")
        return {}
    n_same, err, agree, close = 0, 0.0, 1.0, 1.0
    with Recorder() as witness:
        for shape, a in calls:
            pp, cp, prev, init, valid, win, it, eps, eig, levels, upper = a
            des = torch.empty((prev.shape[0], levels, 2), dtype=torch.int32, device=prev.device)
            kn, ks = lk.pyramidal_lk_compact(*a, des=des)
            wn, ws, wdes = lk.pyramidal_lk_compact_levels(*a)
            n_same += torch.equal(kn, wn) and torch.equal(ks, ws) and torch.equal(des, wdes)
    for shape, a in calls[:: max(1, len(calls) // 60)]:
        kn, ks = lk.pyramidal_lk_compact(*a)
        pn, ps = lk.pyramidal_lk_plain(*a[:9], n_levels=a[9], max_iter_upper=a[10],
                                       compact_windows=True)
        agree = min(agree, float((ks == ps).float().mean()))
        both = ks & ps
        if bool(both.any()):
            d = (kn - pn)[both].abs().amax(1)
            err = max(err, float(d.max()))
            close = min(close, float((d <= 1e-3).float().mean()))
    if n_same != len(calls):
        fail(f"[P1] the compact entry differs from P1 + K1's level entry on "
             f"{len(calls) - n_same} of {len(calls)} calls")
    if agree < 0.99 or close < 0.99:
        fail(f"[P1] the compact entry against its plain version: status agreement {agree:.4f}, "
             f"{close:.4f} of the points within 1e-3 px (max err {err:.3e} px)")
    shape = rec.most_frequent("P1 compact")
    a = rec.of("P1 compact")[shape]
    n_launch, dev_us = _profile_calls(lambda: lk.pyramidal_lk_compact(*a),
                                      kernels=("lk_compact_kernel",))
    if n_launch != 1.0:
        fail(f"[P1] pyramidal_lk_compact made {n_launch} launches a call")
    _, route_us = _profile_calls(lambda: lk.pyramidal_lk_compact_levels(*a),
                                 kernels=("extract_kernel", "lk_level_kernel"))
    ms = cuda_ms(lambda: lk.pyramidal_lk_compact(*a))
    wms = cuda_ms(lambda: lk.pyramidal_lk_compact_levels(*a))
    pms = cuda_ms(lambda: lk.pyramidal_lk_plain(*a[:9], n_levels=a[9], max_iter_upper=a[10],
                                                compact_windows=True), reps=10)
    F, levels, win = shape
    need = win + 17
    # each level: the window and the template's raw patch read once, the
    # points in and out; the Gauss-Newton sums are a few hundred FLOP a point
    b = bound(4 * F * levels * (need * need + (win + 3) ** 2) + F * (2 * 8 + 1 + 8 + 1), 0.0)
    print(f"[P1] pyramidal_lk_compact (P1's window staging in K1's compact entry), "
          f"{len(calls)} recorded calls (F, levels, side) in {sorted({sh for sh, _ in calls})}: "
          f"bit for bit equal to P1 + K1's level entry on {n_same}; against the plain version "
          f"status agreement >= {agree:.4f}, >= {close:.4f} of the points within 1e-3 px (max "
          f"err {err:.3e} px); at {shape} "
          f"({rec.counts[('P1 compact', shape)]} calls): {n_launch:.0f} launch a call, "
          f"{dev_us:.2f} us on the device (the P1 + level route's kernels {route_us:.2f} us), "
          f"{ms:.4f} ms through the wrapper vs the route {wms:.4f} ms and plain {pms:.4f} ms; "
          f"bound {b[0] * 1e3:.3f} us ({b[1]})")
    check_lk_level(witness)
    check_extract(witness)
    return {"P1": (err, ms, pms, *b, None)}


def profile_launches(config, frames, pb):
    """CUDA launches per frame of ``run_sequence`` under ``config`` over
    PROFILE_WINDOW (torch.profiler, as profile_main.py counts them)."""
    import torch

    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.profile_main import LAUNCH_CALLS

    a, b = PROFILE_WINDOW
    state, _ = vio.run_sequence(config, vio.VioFrame(*(x[:a] for x in frames)), pb.gyro_bias,
                                pb.acc_mean)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        vio.run_sequence(config, vio.VioFrame(*(x[a:b] for x in frames)), pb.gyro_bias,
                         pb.acc_mean, state=state)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS) / (b - a)


def _zero(wrappers):
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0


def _per_entry(wrappers):
    return {f"{name} {fn.__name__}": fn.launches for name, fns in wrappers.items() for fn in fns}


def run_compact(base, frames, pb, world, wrappers, off_path):
    """[compact]: the bench world through run_sequence under
    frontend.lk_compact_windows with the triangulation motion check on.
    ``off_path``: the entry points this configuration does not run.
    Returns (per-entry launches of the timed run, P1's and its K13 result)."""
    import numpy as np
    import torch

    from uav_airvision_tpu_torch import device
    from uav_airvision_tpu_torch.models import vio

    config = variant_config(base, "compact")
    with Recorder() as rec:
        vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    decided, rejected = (int(x) for x in rec.motion.cpu()) if rec.motion is not None else (0, 0)
    _zero(wrappers)
    syncs0 = device.host_syncs["sync"]
    t0 = time.time()
    _, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.time() - t0
    syncs = (device.host_syncs["sync"] - syncs0) / N_FRAMES
    per_entry = _per_entry(wrappers)
    n = frames.timestamp.shape[0]
    print(f"[compact] timed run: {n} frames in {wall:.3f} s = {n / wall:.2f} frames/s; "
          f"{syncs:.2f} host syncs/frame; K1's compact entry "
          f"{per_entry['P1 pyramidal_lk_compact'] / n:.2f} launches/frame; launches "
          f"{per_entry}")
    for name, k in per_entry.items():
        if k == 0 and name not in off_path:
            fail(f"[compact] the compact path never launched kernel {name}")
    print(f"[compact] motion check (translation_threshold "
          f"{config.triangulation.translation_threshold} m): {rejected} of {decided} features "
          f"rejected before triangulation (warm run)")
    if rejected == 0:
        fail("[compact] the motion check rejected no feature")
    act = outs.active.cpu().numpy()
    p = outs.p.cpu().numpy()
    if not np.isfinite(p).all() or act.sum() < MIN_ACTIVE:
        fail(f"[compact] {int(act.sum())} active frames, finite poses {np.isfinite(p).all()}")
    err = np.linalg.norm(p[act] - world.groundtruth(pb.timestamps[act]), axis=1)
    print(f"[compact] {int(act.sum())} active frames; ATE max {float(err.max()):.5f} m, rmse "
          f"{float(np.sqrt(np.mean(err ** 2))):.5f} m (bar {COMPACT_ATE_BAR_M} m)")
    if not float(err.max()) < COMPACT_ATE_BAR_M:
        fail(f"[compact] ATE max {float(err.max()):.5f} m is not under the bar")
    n_ref = 40
    _, ref = vio.run_sequence(config, vio.VioFrame(*(x[:n_ref].cpu() for x in frames)),
                              pb.gyro_bias, pb.acc_mean)
    ref_act = ref.active.numpy()
    dp = float(np.abs(ref.p.numpy()[ref_act] - p[:n_ref][ref_act]).max())
    print(f"[compact] first {n_ref} frames against the plain PyTorch path on the host: max "
          f"pose difference {dp:.3e} m over {int(ref_act.sum())} active frames")
    if not np.array_equal(ref_act, act[:n_ref]) or not dp < 1e-4:
        fail(f"[compact] the card's poses differ from the host reference by {dp:.3e} m")
    print(f"[compact] CUDA launches per frame over frames {PROFILE_WINDOW}: "
          f"{profile_launches(config, frames, pb):.1f}")
    check_triangulate_rows(rec, "compact")
    return per_entry, check_compact(rec)


def run_exact(base, world, imu, fts, cam0, cam1, frames, pb, wrappers, off_path):
    """[exact]: the compat facade, message by message, over the bench world
    under the reference-semantics configuration (scripts/diag_long_drift.py's
    exact variant + the stacked camera-prune update), held to run_sequence
    under the same configuration and to the ATE bar; every EKF update of the
    QR tier checked against the float64 plain version."""
    import numpy as np
    import torch

    from uav_airvision_tpu_torch import compat, device
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.streaming.dataset import imu_msg, stereo_msg
    from uav_airvision_tpu_torch.utils import profiling

    config = variant_config(base, "exact")
    dev = frames.cam0.device
    ip, filt = compat.ImageProcessor(config, dev), compat.MSCKF(config, dev)
    imu_t, imu_w, imu_a = imu
    _zero(wrappers)
    profiling.reset()
    profiling.enable()
    syncs0 = device.host_syncs["sync"]
    results, k = [], 0
    t0 = time.time()
    with Recorder() as rec:
        for t, c0, c1 in zip(fts, cam0, cam1):
            while k < len(imu_t) and imu_t[k] <= t:
                m = imu_msg(imu_t[k], imu_w[k], imu_a[k])
                ip.imu_callback(m)
                filt.imu_callback(m)
                k += 1
            out = filt.feature_callback(ip.stereo_callback(stereo_msg(t, c0, c1, None, None)))
            if out is not None:
                results.append(out)
    wall = time.time() - t0
    syncs = (device.host_syncs["sync"] - syncs0) / len(fts)
    per_entry = _per_entry(wrappers)
    profiling.disable()
    tiers = k11_tiers(profiling.snapshot())
    print(f"[exact] facade: {len(fts)} frames in {wall:.3f} s = {len(fts) / wall:.2f} frames/s, "
          f"{len(results)} poses; {syncs:.2f} host syncs/frame; EKF updates per row tier "
          f"{tiers}; launches {per_entry}")
    for name, n in per_entry.items():
        if n == 0 and name not in off_path:
            fail(f"[exact] the facade's path never launched kernel {name}")
    ts = np.array([r.timestamp for r in results])
    pos = np.array([r.position for r in results])
    if len(results) < MIN_ACTIVE or not np.isfinite(pos).all():
        fail(f"[exact] {len(results)} poses, finite {np.isfinite(pos).all()}")
        return
    err = np.linalg.norm(pos - world.groundtruth(ts), axis=1)
    print(f"[exact] ATE max {float(err.max()):.5f} m, rmse {float(np.sqrt(np.mean(err ** 2))):.5f}"
          f" m (bar {EXACT_ATE_BAR_M} m)")
    if not float(err.max()) < EXACT_ATE_BAR_M:
        fail(f"[exact] ATE max {float(err.max()):.5f} m is not under the bar")
    _, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    act = outs.active.cpu().numpy()
    bt = pb.time_base + outs.timestamp.cpu().numpy().astype(np.float64)[act]
    bp = outs.p.cpu().numpy()[act]
    if len(bt) != len(ts) or not np.abs(bt - ts).max() < 1e-5:
        fail(f"[exact] the facade published {len(ts)} poses, run_sequence {len(bt)}")
    else:
        dp = float(np.abs(bp - pos).max())
        print(f"[exact] facade against run_sequence on the same frames: max pose difference "
              f"{dp:.3e} m over {len(ts)} poses (tolerance {FACADE_TOL_M} m)")
        if not dp < FACADE_TOL_M:
            fail(f"[exact] the facade's poses differ from run_sequence's by {dp:.3e} m")
    print(f"[exact] CUDA launches per frame over frames {PROFILE_WINDOW} (run_sequence): "
          f"{profile_launches(config, frames, pb):.1f}")
    # every QR-tier update of the facade's run against the float64 plain version
    qr = None
    for P, H, r, noise, rows in rec.qr_calls:
        want_d, want_P = upd.ekf_update_plain(P.double(), H.double(), r.double(), noise.double(),
                                              rows)
        sc_d, sc_P = float(want_d.abs().max()), max(float(want_P.abs().max()), 1.0)
        d, Pn = upd.ekf_update(P, H, r, noise, rows)
        pd, pPn = upd.ekf_update_plain(P, H, r, noise, rows)
        e_d, e_P = float((d - want_d).abs().max()), float((Pn - want_P).abs().max())
        p_d, p_P = float((pd - want_d).abs().max()), float((pPn - want_P).abs().max())
        ok = e_d <= max(1e-4 * sc_d, 4 * p_d) and e_P <= max(1e-5 * sc_P, 4 * p_P)
        if not (ok and torch.equal(Pn, Pn.T) and bool(torch.isfinite(Pn).all())):
            fail(f"[exact] K11 QR {rows} rows: delta error {e_d:.3e} of {sc_d:.3e} (plain "
                 f"{p_d:.3e}), P error {e_P:.3e} of {sc_P:.3e} (plain {p_P:.3e})")
        qr = (max(e_d / sc_d, qr[0] if qr else 0.0), max(e_P / sc_P, qr[1] if qr else 0.0),
              (P, H, r, noise, rows))
    if qr is None:
        print("[exact] the stacked prune took no QR-tier update")
        return
    a = qr[2]
    ms = cuda_ms(lambda: upd.ekf_update(*a))
    pms = cuda_ms(lambda: upd.ekf_update_plain(*a), reps=10)
    print(f"[exact] K11 on the QR tier: {len(rec.qr_calls)} real calls (stacked prune, "
          f"{a[1].shape[0]}-row buffer), float32 against the float64 plain version: delta within "
          f"{qr[0]:.3e} of its max, P within {qr[1]:.3e} of max(|P|, 1); the last call "
          f"({a[4]} true rows) {ms:.4f} ms vs plain {pms:.4f} ms")


# [limits]: a configuration past the card kernels' old size limits (K5's k,
# K8's n at the front end and in the map, K4+K6's mask points, K13's and
# K9's window, K10's block, K1's window side), with the IMU initialisation
# cut to 40 messages so that most of LIMIT_FRAMES frames reach the back-end
LIMITS = {"frontend": {"grid_max_feature_num": 10, "patch_size": 21},
          "capacity": {"max_features": 1100, "max_map_features": 1100, "max_cam_states": 70,
                       "max_update_rows": 1784, "imu_init_msgs": 40},
          "filter": {"max_cam_state_size": 70}}
LIMIT_FRAMES = 30


def check_limits_kernels(dev):
    """Every kernel whose size limit this PR lifted, one step past it (and
    further), against its plain version: K5, K8, K4+K6 and K2 exactly, K13,
    K9, K10, K11 and K1 with their bars.  Returns {name: max error}."""
    import numpy as np
    import torch

    from uav_airvision_tpu_torch.models.msckf import triangulation as tri
    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.ops import fast, gridops, lk, pyramid

    rng = np.random.default_rng(66)
    out = {}

    def same(got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        return all(torch.equal(g, w) for g, w in zip(got, want))

    # K5: k past 8 (the band clusters up to 32, one block a cell past it), on a
    # frame-sized map; at 1440x1080 (bands of two staging passes); k = a
    # cell's every pixel
    score = torch.as_tensor(rng.integers(-1, 40, (480, 752)), dtype=torch.int32, device=dev)
    for k in (9, 12, 32, 33, 40):
        if not same(gridops.dense_grid_topk(score, 4, 5, k),
                    gridops.dense_grid_topk_plain(score, 4, 5, k)):
            fail(f"[limits] K5 k={k} differs from its plain version")
    big = torch.as_tensor(rng.integers(-1, 40, (1080, 1440)), dtype=torch.int32, device=dev)
    small = torch.as_tensor(rng.integers(-1, 4, (37, 53)), dtype=torch.int32, device=dev)
    for m, k in ((big, 5), (big, 8), (small, 10 * 11)):
        if not same(gridops.dense_grid_topk(m, 4, 5, k), gridops.dense_grid_topk_plain(m, 4, 5, k)):
            fail(f"[limits] K5 {tuple(m.shape)} k={k} differs from its plain version")
    # K8: past 1024 elements
    for n in (1025, 1500):
        cell = torch.as_tensor(rng.integers(0, 20, n), dtype=torch.int32, device=dev)
        pri = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.float32, device=dev)
        arr = torch.as_tensor(rng.integers(0, 6, n), dtype=torch.int32, device=dev)
        valid = torch.as_tensor(rng.uniform(size=n) < 0.7, device=dev)
        rank, perm = gridops.rank_in_cell(cell, pri, arr, valid, 20)
        keep = valid & (rank < 2)
        ok = (same((rank, perm), gridops.rank_in_cell_plain(cell, pri, arr, valid, 20))
              and same(gridops.kept_order_stats(perm, keep, cell, valid, 20),
                       gridops.kept_order_stats_plain(perm, keep, cell, valid, 20))
              and same(gridops.compact_kept(perm, keep, n),
                       gridops.compact_kept_plain(perm, keep, n))
              and same(gridops.smallest_k_indices(arr, 64),
                       gridops.smallest_k_indices_plain(arr, 64))
              and same(gridops.stable_compact_indices(valid, n),
                       gridops.stable_compact_indices_plain(valid, n)))
        if not ok:
            fail(f"[limits] K8 n={n} differs from its plain version")
    # K8's fused selection at the configuration's 1,100 slots and 200
    # candidates (n = 1,300): ties in every key, one cell overflowing
    F, C, n_cells = 1100, 200, 20
    for crowd in (False, True):
        curr = rng.uniform([0, 0], [751, 479], (F, 2))
        if crowd:
            curr[: F // 2] = rng.uniform([0, 0], [150, 119], (F // 2, 2))
        apts = np.stack([rng.integers(0, 752, C), rng.integers(0, 480, C)], 1)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        args = (torch.as_tensor(curr, **f32), torch.as_tensor(curr - 10, **f32),
                torch.as_tensor(rng.uniform(size=F) < 0.8, device=dev),
                torch.as_tensor(rng.integers(0, 5000, F), **i32),
                torch.as_tensor(rng.integers(1, 4, F), **i32), torch.as_tensor(apts, **f32),
                torch.as_tensor(rng.integers(0, 4, C), **i32),
                torch.as_tensor(rng.integers(0, 5, C), **i32),
                torch.as_tensor(rng.uniform(size=C) < 0.7, device=dev),
                torch.as_tensor(apts - 10, **f32), torch.tensor(77, **i32), 4, 5, 480, 752, 3,
                C // n_cells)
        if not same(gridops.select_track(*args), gridops.select_track_plain(*args)):
            fail(f"[limits] K8 select_track F={F}, C={C} differs from its plain version")
    # K4+K6: past 1024 mask points
    img = torch.as_tensor(rng.integers(0, 256, (480, 752)), dtype=torch.uint8, device=dev)
    for n in (1025, 1500):
        pts = torch.as_tensor(rng.uniform([0, 0], [752, 480], (n, 2)), dtype=torch.float32,
                              device=dev)
        pv = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
        if not same(fast.detect_fast(img, 20, pts, pv), fast.detect_fast_plain(img, 20, pts, pv)):
            fail(f"[limits] K4+K6 with {n} mask points differs from its plain version")
    # K2: four levels at 1440x1080 and 2048x1536 (level passes); 752x480 stays one launch
    for H, W in ((1080, 1440), (1536, 2048)):
        a, b = (torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.uint8, device=dev)
                for _ in range(2))
        got, want = pyramid.build_pyramid_pair(a, b, 3), pyramid.build_pyramid_pair_plain(a, b, 3)
        if not all(torch.equal(g.flat, w.flat) for g, w in zip(got, want)):
            fail(f"[limits] K2 at {W}x{H} differs from its plain version")
    a = torch.as_tensor(rng.integers(0, 256, (480, 752)), dtype=torch.uint8, device=dev)
    n_launch, _ = _profile_calls(lambda: pyramid.build_pyramid_pair(a, a, 3), n=5)
    if n_launch != 1.0:
        fail(f"[limits] K2 at 752x480 made {n_launch} launches a call")
    print("[limits] K5 (k = 9, 12, 32, 33, 40; 1440x1080 at k = 5, 8; 53x37 at k = 110, a "
          "cell's every pixel), K8 (n = 1025, 1500; select_track 1,100 + 200), K4+K6 "
          "(1025, 1500 mask points), "
          "K2 (1440x1080, 2048x1536 at 4 levels): exact; K2 at 752x480 "
          f"{n_launch:.0f} launch a call")

    # the back-end kernels on a window of N slots: a random SPD covariance and
    # poses, features seen from the slots' cameras
    from uav_airvision_tpu_torch.config import euroc_config
    from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params
    from uav_airvision_tpu_torch.utils import quaternion as quat

    def window(N, dtype):
        cfg = euroc_config(dtype="float64" if dtype == torch.float64 else "float32")
        params = make_params(cfg, dev)
        st = init_state(cfg, params, np.zeros(3), np.array([0.0, 0.0, 9.81]))
        D = 21 + 6 * N
        A = torch.as_tensor(rng.normal(0, 0.02, (D, D)), device=dev)
        cov = (A @ A.T / D + 1e-4 * torch.eye(D, dtype=A.dtype, device=dev)).to(dtype)
        ang = torch.as_tensor(rng.normal(0, 0.02, (N, 3)), device=dev)
        q = torch.cat([ang / 2, torch.ones((N, 1), device=dev)], 1)
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        p = torch.stack([0.02 * torch.arange(N, device=dev, dtype=torch.float64),
                         torch.zeros(N, device=dev, dtype=torch.float64),
                         torch.zeros(N, device=dev, dtype=torch.float64)], 1).to(dtype)
        cams = st.cams._replace(q=q, p=p, q_null=q.clone(), p_null=p.clone(),
                                timestamp=torch.zeros(N, dtype=dtype, device=dev),
                                sid=torch.arange(N, dtype=torch.int32, device=dev),
                                count=torch.tensor(N - 3, dtype=torch.int32, device=dev))
        st = st._replace(cams=cams, cov=cov)
        # B features 2-6 m in front, observed by every slot (with noise)
        B = 16
        pw = torch.as_tensor(rng.uniform([-1, -1, 2], [1, 1, 6], (B, 3)), device=dev).to(dtype)
        R = quat.to_rotation(q)
        pc0 = torch.einsum("nij,bnj->bni", R, pw[:, None, :] - p[None])
        Rc = params.R_cam0_cam1.to(dtype)
        pc1 = torch.einsum("ij,bnj->bni", Rc, pc0) + params.t_cam0_cam1.to(dtype)
        obs = torch.cat([pc0[..., :2] / pc0[..., 2:], pc1[..., :2] / pc1[..., 2:]], -1)
        obs = obs + torch.as_tensor(rng.normal(0, 1e-3, obs.shape), device=dev).to(dtype)
        mask = torch.as_tensor(rng.uniform(size=(B, N)) < 0.8, device=dev)
        return cfg, st, params, pw, obs, mask

    errs = {}
    for N, dtype in ((65, torch.float32), (300, torch.float64)):
        cfg, st, params, pw, obs, mask = window(N, dtype)
        args = (st.cams.q, st.cams.p, obs, mask, params.R_cam0_cam1, params.t_cam0_cam1,
                cfg.triangulation, None)
        pos, ok = tri.triangulate(*args)
        ppos, pok = tri.triangulate_plain(*args)
        both = ok & pok
        err = (pos - ppos).abs().max(1).values / ppos.abs().max(1).values.clamp(min=1.0)
        err = float(err[both].max()) if bool(both.any()) else 0.0
        errs[f"K13 N={N}"] = err
        if not torch.equal(ok, pok) or not err <= 1e-3:
            fail(f"[limits] K13 N={N}: validity differs or error {err:.3e}")
        # the row entry: the B features as map rows, none initialized yet
        B = mask.shape[0]
        rargs = (st.cams.q, st.cams.p, obs, mask, torch.zeros_like(pw),
                 torch.zeros(B, dtype=torch.bool, device=dev), torch.arange(B, device=dev),
                 torch.ones(B, dtype=torch.bool, device=dev), params.R_cam0_cam1,
                 params.t_cam0_cam1, cfg.triangulation)
        rpos, rinit, rfail = tri.triangulate_rows(*rargs)
        if (not torch.equal(rinit, ok) or not torch.equal(rfail, ~ok)
                or not torch.equal(rpos[ok], pos[ok])):
            fail(f"[limits] K13 row entry N={N}: differs from the entry with separate passes")
    for N, dtype in ((35, torch.float64), (49, torch.float32), (70, torch.float32)):
        cfg, st, params, pw, obs, mask = window(N, dtype)
        c = st.cams
        args = (c.q, c.p, c.q_null, c.p_null, obs, mask, pw, st.gravity, params.R_cam0_cam1,
                params.t_cam0_cam1, 21 + 6 * N)
        # through the main path's entry: the map rows 0.. B-1, one block masked
        sel = torch.arange(mask.shape[0], device=dev)
        proc = sel != 3
        rargs = (*args[:7], sel, proc, *args[7:])
        H, r, rows = upd.feature_block_rows(*rargs)
        pH, pr, prows = upd.feature_block_rows_plain(*rargs)
        sc = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
        err = max(float(((g - w).abs().flatten(1).amax(1) / sc).max())
                  for g, w in ((H, pH), (r, pr)))
        errs[f"K9 N={N} {str(dtype)[6:]}"] = err
        if not torch.equal(rows, prows) or not err <= (3e-5 if dtype == torch.float32 else 1e-10):
            fail(f"[limits] K9 N={N} {dtype}: error {err:.3e}")
        # K10 on these blocks (past its shared memory at N = 49 and 70 in float32)
        H, r, rows = upd.feature_block(*args)
        dof = mask.sum(1) - 1
        for scale in (1e-3, 1.0, 1e3):
            got = upd.gating_test_batch(H, r * scale, rows, st.cov, params.obs_noise,
                                        params.chi2_table, dof)
            want = upd.gating_test_batch_plain(H, r * scale, rows, st.cov, params.obs_noise,
                                               params.chi2_table, dof)
            thresh = params.chi2_table[dof]
            gamma = upd.gate_gamma_plain(H, r * scale, st.cov, params.obs_noise)
            near = (gamma - thresh).abs() <= 1e-4 * thresh
            if not bool(((got == want) | near).all()):
                fail(f"[limits] K10 N={N} {dtype} scale {scale}: decisions differ")
    # K11 at D = 561: T1, T2 = 1122 rows (past the old one-block limit) and QR, float64
    cfg, st, params, pw, obs, mask = window(90, torch.float64)
    D = 561
    for rows in (80, 1122, 1500):
        H = torch.zeros((1784, D), dtype=torch.float64, device=dev)
        H[:rows, 21:] = torch.as_tensor(rng.normal(0, 0.05, (rows, D - 21)), device=dev)
        r = torch.zeros(1784, dtype=torch.float64, device=dev)
        r[:rows] = torch.as_tensor(rng.normal(0, 0.01, rows), device=dev)
        got, warn = upd.apply_update(st, params, H, r, rows)
        want, pwarn = upd.apply_update_plain(st, params, H, r, rows)
        err = _state_err(got, want)
        errs[f"K11 D=561 {upd.update_tier(1784, D, rows)}"] = err
        if not err <= 1e-12 or bool(warn) != bool(pwarn):
            fail(f"[limits] K11 D=561, {rows} rows: state error {err:.3e}")
    # K12's row-indexed entry at the configuration's window (70 slots: D =
    # 441) and at 200 slots (D = 1221, past the old kernel's shared memory in
    # float64), some features excluded
    for N, dtype in ((70, torch.float32), (70, torch.float64), (200, torch.float64)):
        cfg, st, params, pw, obs, mask = window(N, dtype)
        Hb = torch.as_tensor(rng.normal(0, 0.8, (64, 5, 33)), device=dev).to(dtype)
        rb = torch.as_tensor(rng.normal(0, 0.02, (64, 5)), device=dev).to(dtype)
        inc = torch.as_tensor(rng.uniform(size=64) < 0.6, device=dev)
        cols = torch.cat([21 + 6 * 4 + torch.arange(6, device=dev),
                          21 + 6 * (N - 5) + torch.arange(6, device=dev)])
        args = (st, params, Hb[:, :, 21:], rb, inc, cols)
        got, warn = upd.apply_update_rank12_rows(*args)
        want, pwarn = upd.apply_update_rank12_rows_plain(*args)
        scale = max(float(want.cov.abs().max()), 1.0)
        err = float((got.cov - want.cov).abs().max()) / scale
        errs[f"K12 D={21 + 6 * N} {str(dtype)[6:]}"] = err
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        if (not err <= tol or not _state_err(got, want) <= 1e-4 or bool(warn) != bool(pwarn)
                or not torch.equal(got.cov, got.cov.T)):
            fail(f"[limits] K12 D={21 + 6 * N} {dtype}: error {err:.3e} of max |P|")
    # K14 at the configuration's window (70 slots: D = 441), float32 and
    # float64; then on the same state with a slice too long for the block's
    # shared memory (128 IMU slots in float64, 256 in float32: the device
    # workspace), all but the last 5 slots valid
    from uav_airvision_tpu_torch.models.msckf import propagation

    wrng = np.random.default_rng(141)
    for dtype in (torch.float32, torch.float64):
        cfg, st, params, pw, obs, mask = window(70, dtype)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        big = 256 if dtype == torch.float32 else 128
        for I, n, r in ((cfg.capacity.max_imu_per_frame, 11, rng), (big, big - 5, wrng)):
            ws = propagation._workspace_values(I, st.cov.element_size())
            if (ws > 0) != (I == big):
                fail(f"[limits] K14 {I} slots {dtype}: workspace of {ws} values unexpected")
            live = torch.arange(I, device=dev) < n
            imu_t = torch.where(live, st.imu.timestamp + 0.005 * torch.arange(
                1, I + 1, device=dev, dtype=dtype), 0.0)
            w = torch.as_tensor(r.normal(0, 0.3, (I, 3)), device=dev).to(dtype)
            a = torch.as_tensor(r.normal([0, 0, 9.81], 0.5, (I, 3)), device=dev).to(dtype)
            args = (st, params, imu_t, w, a, live)
            err = _prop_err(propagation.propagate(*args), propagation.propagate_plain(*args))
            name = f"K14 D=441 {str(dtype)[6:]}" + (f" {I} slots" if I == big else "")
            errs[name] = err
            if not err <= tol:
                fail(f"[limits] {name}: relative error {err:.3e}")
    # K1: window sides 17, 21 and 33 (the looped instantiation), both trackers
    base = rng.uniform(0, 255, (480 // 6 + 2, 752 // 6 + 2))
    img0 = np.clip(np.kron(base, np.ones((6, 6)))[:480, :752] + rng.normal(0, 2, (480, 752)),
                   0, 255).astype(np.uint8)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    pts = torch.as_tensor(rng.uniform([5, 5], [747, 475], (200, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.ones(200, dtype=torch.bool, device=dev)
    for win in (17, 21, 33):
        for compact in (False, True):
            kw = dict(win=win, max_iter=10, n_levels=4, max_iter_upper=5,
                      compact_windows=compact)
            kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **kw)
            pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **kw)
            agree = float((ks == ps).float().mean())
            both = ks & ps
            err = float((kn[both] - pn[both]).abs().max()) if bool(both.any()) else 0.0
            errs[f"K1 win={win}{' compact' if compact else ''}"] = err
            if compact:  # the one launch against the P1 + level route, bit for bit
                wn, ws, _ = lk.pyramidal_lk_compact_levels(p0, p1, pts, pts, valid, win, 10,
                                                           n_levels=4, max_iter_upper=5)
                if not (torch.equal(kn, wn) and torch.equal(ks, ws)):
                    fail(f"[limits] K1 compact entry win={win} differs from P1 + level entry")
            if agree < 0.99 or not err <= 1e-3 or int(both.sum()) < 100:
                fail(f"[limits] K1 win={win} compact={compact}: status agreement {agree:.3f}, "
                     f"error {err:.3e} px on {int(both.sum())} points")
    print(f"[limits] against the plain versions: { {k: f'{v:.3e}' for k, v in errs.items()} }")
    return errs


def run_limits(base, world, imu, fts, cam0, cam1, wrappers, off_path):
    """[limits]: LIMIT_FRAMES frames of the bench world through run_sequence
    under LIMITS, counters at 0 before it: every kernel of the path launched,
    finite poses, and the active frames' poses within 1e-4 m of the port's
    plain path on the host on the same frames."""
    import dataclasses

    import numpy as np
    import torch

    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu

    config = dataclasses.replace(base, **{
        group: dataclasses.replace(getattr(base, group), **fields)
        for group, fields in LIMITS.items()})
    imu_t, imu_w, imu_a = imu
    n = LIMIT_FRAMES
    pb = prebatch_imu(fts[:n], imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    dev = torch.device("cuda")
    frames = vio.frames_from_prebatch(pb, cam0[:n], cam1[:n], dev)
    vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)  # warm
    torch.cuda.synchronize()
    _zero(wrappers)
    t0 = time.time()
    _, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.time() - t0
    per_entry = _per_entry(wrappers)
    print(f"[limits] {n} frames under {LIMITS} in {wall:.2f} s; launches {per_entry}")
    for name, k in per_entry.items():
        if k == 0 and name not in off_path:
            fail(f"[limits] the path never launched kernel {name}")
    act = outs.active.cpu().numpy()
    p = outs.p.cpu().numpy()
    cpu_frames = vio.VioFrame(*(x.cpu() for x in frames))
    t0 = time.time()
    _, ref = vio.run_sequence(config, cpu_frames, pb.gyro_bias, pb.acc_mean)
    ref_act = ref.active.numpy()
    if not np.isfinite(p[act]).all() or act.sum() < n // 2:
        fail(f"[limits] {int(act.sum())} active frames, finite {np.isfinite(p[act]).all()}")
    elif not np.array_equal(ref_act, act):
        fail("[limits] the host run disagrees on which frames are active")
    else:
        dp = float(np.abs(ref.p.numpy()[act] - p[act]).max())
        err = np.linalg.norm(p[act] - world.groundtruth(pb.timestamps[act]), axis=1)
        print(f"[limits] {int(act.sum())} active frames; against the plain PyTorch path on the "
              f"host ({time.time() - t0:.1f} s): max pose difference {dp:.3e} m; ATE max "
              f"{float(err.max()):.5f} m")
        if not dp < 1e-4:
            fail(f"[limits] the card's poses differ from the host reference by {dp:.3e} m")


EUROC_FRAMES = 80  # 4 s of 20 Hz stereo, written as a EuRoC sequence
EUROC_ATE_RMSE_M = 0.1  # the JAX package's end-to-end bar (tests/test_e2e.py:80)
EUROC_CKPT_KILL = 40  # frames the "killed" checkpointed run sees


class _Replay:
    """The bench world, its frames replayed from the arrays already rendered
    (the writer asks for them in order), so the sequence on disk holds the
    frames the earlier phases ran."""

    def __init__(self, world, cam0, cam1):
        self.world, self.pairs = world, iter(zip(cam0, cam1))

    def __getattr__(self, name):
        return getattr(self.world, name)

    def render_frame(self, t, rng=None, starve_window=None):
        return next(self.pairs)


def _same_bits(got, want, fields=("p", "q", "v", "active", "timestamp")):
    import torch

    return [f for f in fields if not torch.equal(getattr(got, f), getattr(want, f))]


def run_euroc(config, world, cam0, cam1, wrappers, card):
    """[euroc]: the EuRoC dataset path.  In a temporary directory: the
    loader's build; 4 s of the bench world written by the port's writer; the
    command line ``--path <dir> --offset 0 --eval`` on the card (decode ->
    prebatch -> run_sequence -> trajectory, ATE/RTE), counters at 0 before
    it; the decoded frames' SHA-256 against the rendered arrays', the poses
    bit for bit against ``run_sequence`` of the rendered frames, ATE rmse
    under EUROC_ATE_RMSE_M; a checkpointed run killed after EUROC_CKPT_KILL
    frames and resumed, bit for bit the uninterrupted run; ``--long-horizon
    --profile`` over the second half, its 3-level K1 calls against the plain
    version and both profile artifacts; the realtime mode over 2 s of the
    sequence, decoding on the card's host.  Returns the measurements."""
    import hashlib
    import json as json_
    import os
    import tempfile

    import numpy as np
    import torch

    from uav_airvision_tpu_torch import main as cli
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.runtime import native
    from uav_airvision_tpu_torch.simulation.euroc_writer import write_euroc_dataset
    from uav_airvision_tpu_torch.streaming.dataset import EuRoCDataset
    from uav_airvision_tpu_torch.utils import checkpoint as ckpt
    from uav_airvision_tpu_torch.utils.profiling import TRACE_FILE

    t_phase = time.time()
    native.get_lib()
    print(f"[euroc] loader {native.build_info['path']} built in "
          f"{native.build_info['seconds']:.2f} s (cached: {native.build_info['cached']})")
    cam0, cam1 = cam0[:EUROC_FRAMES], cam1[:EUROC_FRAMES]
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_euroc_") as tmp:
        os.chdir(tmp)
        try:
            seq = os.path.join(tmp, "SYN_EUROC")
            t0 = time.time()
            write_euroc_dataset(_Replay(world, cam0, cam1), seq, EUROC_FRAMES / 20.0, seed=5)
            print(f"[euroc] wrote {EUROC_FRAMES} stereo frames to {seq} in "
                  f"{time.time() - t0:.2f} s")

            # decode alone: the loader's rate, and its bits against the rendered arrays
            ds = EuRoCDataset(seq)
            t0 = time.time()
            dec = [native.decode_pngs(list(r.paths), *native.png_size(r.paths[0]))
                   for r in (ds.cam0, ds.cam1)]
            decode_s = time.time() - t0
            sha = [hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                   for a in (*dec, cam0, cam1)]
            print(f"[euroc] decode: {2 * EUROC_FRAMES} PNGs in {decode_s:.4f} s = "
                  f"{EUROC_FRAMES / decode_s:.1f} stereo frames/s on {card}; SHA-256 cam0 "
                  f"{sha[0][:16]} (rendered {sha[2][:16]}), cam1 {sha[1][:16]} (rendered "
                  f"{sha[3][:16]})")
            if sha[:2] != sha[2:]:
                fail("[euroc] the decoded frames differ from the rendered arrays")

            # the command line, on the card by default, counters at 0 before it
            _zero(wrappers)
            run = cli.main(["--path", seq, "--offset", "0", "--eval"])
            torch.cuda.synchronize()
            launches = _per_entry(wrappers)
            for name, n in launches.items():
                if n == 0:
                    fail(f"[euroc] the command line never launched kernel {name}")
            n_act = int(run.outputs.active.sum())
            print(f"[euroc] command line: load {run.load_s:.3f} s, run {EUROC_FRAMES} frames "
                  f"in {run.run_s:.3f} s = {EUROC_FRAMES / run.run_s:.2f} frames/s on {card}; "
                  f"{n_act} poses; ATE rmse {run.ate['rmse']:.5f} m (bar {EUROC_ATE_RMSE_M} "
                  f"m), RTE rmse {run.rte['rmse']:.5f} m; launches {launches}")
            if run.outputs.p.device.type != "cuda":
                fail(f"[euroc] the command line ran on {run.outputs.p.device}")
            if not run.ate["rmse"] < EUROC_ATE_RMSE_M:
                fail(f"[euroc] ATE rmse {run.ate['rmse']} m is not under {EUROC_ATE_RMSE_M} m")
            frames = vio.frames_from_prebatch(run.pb, cam0, cam1, torch.device("cuda"))
            _, ref = vio.run_sequence(config, frames, run.pb.gyro_bias, run.pb.acc_mean)
            diff = _same_bits(run.outputs, ref)
            print(f"[euroc] command line against run_sequence of the rendered frames on the "
                  f"card: {'bit for bit equal' if not diff else 'DIFFERENT in ' + str(diff)}")
            if diff:
                fail(f"[euroc] the command line's outputs differ from run_sequence's in {diff}")

            # checkpoint: a run killed after EUROC_CKPT_KILL frames, then resumed
            ckdir = os.path.join(tmp, "ck")
            part = vio.VioFrame(*(x[:EUROC_CKPT_KILL] for x in frames))
            vio.run_sequence_checkpointed(config, part, run.pb.gyro_bias, run.pb.acc_mean,
                                          ckdir, every=20)
            state, outs, start = vio.run_sequence_checkpointed(
                config, frames, run.pb.gyro_bias, run.pb.acc_mean, ckdir, every=20)
            tail = type(ref)(*(x[EUROC_CKPT_KILL:] for x in ref))
            diff = _same_bits(outs, tail, ("p", "q")) if start == EUROC_CKPT_KILL else ["start"]
            torch.cuda.synchronize()
            t0 = time.time()
            ckpt.save_state(ckdir, state, 10_000)
            save_ms = (time.time() - t0) * 1e3
            template = vio.init_vio_state(config, device="cuda")
            t0 = time.time()
            restored, _ = ckpt.restore_state(ckdir, template, 10_000)
            torch.cuda.synchronize()
            restore_ms = (time.time() - t0) * 1e3
            same = all(torch.equal(a, b) for a, b in zip(
                torch.utils._pytree.tree_leaves(restored.filter),
                torch.utils._pytree.tree_leaves(state.filter)))
            print(f"[euroc] checkpoint: resumed at frame {start} (killed at "
                  f"{EUROC_CKPT_KILL}); p, q of frames {start}-{EUROC_FRAMES - 1} "
                  f"{'bit for bit the uninterrupted run' if not diff else 'DIFFERENT'}; "
                  f"save {save_ms:.2f} ms, restore {restore_ms:.2f} ms on {card}")
            if diff or not same:
                fail(f"[euroc] kill and resume differ from the uninterrupted run ({diff}, "
                     f"restored state equal: {same})")

            # --long-horizon --profile over the second half: K1 at three levels
            with Recorder() as rec:
                half = str(EUROC_FRAMES / 40.0)
                prof = cli.main(["--path", seq, "--offset", half, "--long-horizon",
                                 "--profile"])
            torch.cuda.synchronize()
            print(f"[euroc] --long-horizon --profile: {len(prof.pb.timestamps)} frames from "
                  f"{half} s in {prof.run_s:.3f} s (traced)")
            check_lk_recorded(rec, levels=3, tag="[euroc, long horizon]")
            stages = os.path.join("reports", "profile_stages.json")
            trace = os.path.join("reports", "torch_trace", TRACE_FILE)
            if not (os.path.isfile(stages) and os.path.isfile(trace)):
                fail(f"[euroc] --profile wrote no {stages} or {trace}")
            else:
                with open(trace, "rb") as f:
                    kernels_traced = f.read().count(b'"cat": "kernel"')
                with open(stages) as f:
                    stage_names = sorted(json_.load(f))
                print(f"[euroc] profile: stages {stage_names}, trace "
                      f"{os.path.getsize(trace) / 1e6:.1f} MB with {kernels_traced} kernel "
                      f"events")
                if not kernels_traced:
                    fail("[euroc] the trace holds no kernel event of the card")

            # the realtime mode reads the directory frame by frame
            results = cli.main(["--mode", "realtime", "--path", seq, "--offset", "0",
                                "--ratio", "1.0", "--duration", "2"])
            print(f"[euroc] realtime --path, 2 s at 1.0 x real time: {len(results)} poses")
            if not results:
                fail("[euroc] the realtime mode published no pose")
        finally:
            os.chdir(old_cwd)
    print(f"[euroc] phase {time.time() - t_phase:.1f} s")
    return dict(decode_fps=EUROC_FRAMES / decode_s, load_s=run.load_s, run_s=run.run_s,
                save_ms=save_ms, restore_ms=restore_ms)


FLEET_B = 4  # instances of the [fleet] run
FLEET_FRAMES = 60  # frames each instance runs
FLEET_STRIDE = 7  # instance b starts FLEET_STRIDE * b frames in (fleet_bench --decorrelated)
FLEET_SIZES = (1, 4, 8)  # the batch sizes measured
FLEET_TOL_M = 1e-5  # a pose that is not bit for bit its single run's (fault 2's bar)
FLEET_STARVE = (25, 3)  # instance 1 starved after this many frames, then this many more
FLEET_FIELDS = ("p", "q", "v", "active", "n_features", "n_update_rows", "did_reset")


class FleetRecorder:
    """Observer of the batched kernels' wrappers (the front-end's K2, K4+K6,
    K5, K1, K7's prediction and K8's entries, the back-end's K14, K13, K9,
    K10, K11 and K12): keeps the arguments of every call, by wrapper name."""

    NAMES = ("build_pyramid_pair", "detect_fast", "dense_grid_topk", "pyramidal_lk",
             "pyramidal_lk_compact", "propagate", "triangulate_rows", "feature_block_rows",
             "gating_test_batch", "apply_update_fleet", "apply_update_rank12_rows_fleet",
             "predict_warp_points", "select_track", "rank_in_cell", "kept_order_stats",
             "compact_kept")

    def __init__(self):
        self.calls = {name: [] for name in self.NAMES}

    def __call__(self, name, args):
        if name in self.calls:
            self.calls[name].append(args)

    def __enter__(self):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = self
        return self

    def __exit__(self, *exc):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = None


def _fleet_vs_single(tag, out, singles, b, k0=0):
    """Instance b's fleet outputs against its single run's, field by field:
    bit for bit, or the largest difference and the first frame where it
    appears printed, and the positions within FLEET_TOL_M."""
    import torch

    notes = []
    for name in FLEET_FIELDS:
        got, want = getattr(out, name)[:, b], getattr(singles, name)
        if torch.equal(got, want):
            continue
        diff = (got.double() - want.double()).abs().reshape(got.shape[0], -1).amax(1)
        first = int(torch.nonzero(diff)[0, 0]) + k0
        notes.append(f"{name} max {float(diff.max()):.3e} from frame {first}")
        if name == "p" and float(diff.max()) > FLEET_TOL_M:
            fail(f"{tag} instance {b}: positions {float(diff.max()):.3e} m from its single run")
        if name == "active":
            fail(f"{tag} instance {b}: active differs from its single run from frame {first}")
    print(f"{tag} instance {b} vs run_sequence on its frames: "
          + ("bit for bit in " + ", ".join(FLEET_FIELDS) if not notes else "; ".join(notes)))


def _check_batched(tag, got, want_batched, singles):
    """A batched launch's outputs against the batched plain version's and
    against the B single launches', bit for bit."""
    import torch

    if not all(torch.equal(g, w) for g, w in zip(got, want_batched)):
        fail(f"{tag}: the batched launch differs from the batched plain version")
    for b, one in enumerate(singles):
        if not all(torch.equal(g[b], o) for g, o in zip(got, one)):
            fail(f"{tag}: instance {b} of the batched launch differs from its single launch")


def _fleet_backend_steps(steps, outs):
    """The back-end's launches per fleet step, from the wrappers' counts
    after each step (``steps``: [(back-end counts, front-end counts)]) and
    the step's outputs: K14 once a step with an active instance, K13, K9
    and K10 once a stage each (the lost pass, its overflow pass, the
    prune: at most three) and at least once where an instance updated or
    pruned; K11 and K12 at most once an update stage together (so at most
    K13's count), K12 at most once a step, and K11 at least once where an
    instance's lost pass updated.  Returns each kernel's launches per step."""
    prev = {k: 0 for k in steps[0][0]}
    bad = []
    for k, (be, _) in enumerate(steps):
        d = {n: be[n] - prev[n] for n in be}
        prev = be
        active = bool(outs.active[k].any())
        updated = bool((outs.n_update_rows[k] > 0).any())
        stage = updated or bool((outs.n_prune_feats[k] > 0).any())
        if (d["K14"] != int(active) or not d["K13"] == d["K9"] == d["K10"] <= 3
                or (stage and d["K13"] == 0) or d["K12"] > 1 or d["K11"] + d["K12"] > d["K13"]
                or (updated and d["K11"] == 0)):
            bad.append((k, d))
    if bad:
        fail(f"[fleet] the back-end's batched kernels not once a stage on steps {bad[:5]}")
    return {n: v / len(steps) for n, v in steps[-1][0].items()}


def _fleet_frontend_steps(steps):
    """The front-end's K7 prediction and K8 entries per fleet step, from
    the wrappers' counts after each step: K8's first-frame entries (ranking,
    kept-order statistics, compaction) once each on the first step, where
    every instance starts, and K7's prediction and K8's selection once a
    step after it, for all instances at once."""
    prev = {k: 0 for k in steps[0][1]}
    bad = []
    for k, (_, fe) in enumerate(steps):
        d = {n: fe[n] - prev[n] for n in fe}
        prev = fe
        want = ({"K7 predict": 0, "K8 select": 0, "K8 first frame": 3} if k == 0
                else {"K7 predict": 1, "K8 select": 1, "K8 first frame": 0})
        if d != want:
            bad.append((k, d))
    if bad:
        fail(f"[fleet] K7's prediction and K8's entries not once a step on steps {bad[:5]}")


def _check_backend_batched(rec):
    """Every 8th recorded batched launch of K14, K13, K9 and K10 again:
    within the bars of its single-launch checks (check_limits_kernels) of
    its batched plain version, and each instance bit for bit its single
    launch.  Returns {kernel: (launches checked, largest error)}."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import propagation
    from uav_airvision_tpu_torch.models.msckf import triangulation as tri
    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.utils import tree

    res = {}

    def single(tag, b, got, one):
        if not all(torch.equal(g, o) for g, o in zip(got, one)):
            fail(f"[fleet] {tag}: instance {b} of the batched launch differs from its single "
                 f"launch")

    calls = rec.calls["propagate"][::8]
    worst = 0.0
    for a in calls:
        st, params, t, w, acc, m = a
        got = propagation.propagate(*a)
        err = _prop_err(got, propagation.propagate_plain(*a))
        worst = max(worst, err)
        if not err <= 1e-5:
            fail(f"[fleet] K14 batched: relative error {err:.3e} > 1e-5")
        for b in range(st.cov.shape[0]):
            one = propagation.propagate(tree.index(st, b), params, t[b], w[b], acc[b], m[b])
            g = tree.index(got, b)
            single("K14", b, (g.cov, *g.imu), (one.cov, *one.imu))
    res["K14"] = (len(calls), worst)

    calls = rec.calls["triangulate_rows"][::8]
    worst = 0.0
    for a in calls:
        pos, init, failed = got = tri.triangulate_rows(*a)
        ppos, pinit, pfail = tri.triangulate_rows_plain(*a)
        position, initialized = a[4], a[5]
        new = init & ~initialized
        if not (torch.equal(init, pinit) and torch.equal(failed, pfail)
                and torch.equal(pos[~new], position[~new])):
            fail("[fleet] K13 batched: initialized / init_fail / unchanged rows differ from "
                 "the plain version")
        if bool(new.any()):
            rel = ((pos - ppos).abs().amax(-1) / ppos.abs().amax(-1).clamp(min=1.0))[new]
            worst = max(worst, float(rel.max()))
        for b in range(a[0].shape[0]):
            single("K13", b, [x[b] for x in got],
                   tri.triangulate_rows(*(x[b] for x in a[:8]), *a[8:]))
    if not worst <= 1e-3:
        fail(f"[fleet] K13 batched: position error {worst:.3e} of max(|p|, 1) > 1e-3")
    res["K13"] = (len(calls), worst)

    calls = rec.calls["feature_block_rows"][::8]
    worst = 0.0
    for a in calls:
        rm = a[13]
        got = H, r, rows = upd.feature_block_rows(*a[:13], rm=rm)
        pH, pr, prows = upd.feature_block_rows_plain(*a[:13], rm=rm)
        scale = torch.maximum(pH.abs().amax((-2, -1)), pr.abs().amax(-1)).clamp(min=1e-30)
        err = max(float(((g - w).abs().amax((-2, -1) if g.dim() == 4 else -1) / scale).max())
                  for g, w in ((H, pH), (r, pr)))
        worst = max(worst, err)
        if not torch.equal(rows, prows) or not err <= (1e-4 if rm is not None else 3e-5):
            fail(f"[fleet] K9 batched ({'prune' if rm is not None else 'lost'}): error "
                 f"{err:.3e} of the block maximum, rows equal {torch.equal(rows, prows)}")
        for b in range(a[0].shape[0]):
            single("K9", b, [x[b] for x in got], upd.feature_block_rows(
                *(x[b] for x in a[:10]), *a[10:13], rm=rm[b] if rm is not None else None))
    res["K9"] = (len(calls), worst)

    calls = rec.calls["gating_test_batch"][::8]
    flips = 0
    for a in calls:
        H, r, rows, cov, noise, table, dof = a
        got = upd.gating_test_batch(*a)
        want = upd.gating_test_batch_plain(*a)
        thresh = table[dof.clamp(0, table.shape[0] - 1).long()]
        gamma = upd.gate_gamma_plain(H, r, cov, noise)
        near = (gamma - thresh).abs() <= 1e-4 * thresh
        flips += int((got != want).sum())
        if not bool(((got == want) | near).all()):
            fail("[fleet] K10 batched: a decision differs from the plain version away from "
                 "its threshold")
        for b in range(cov.shape[0]):
            single("K10", b, (got[b],), (upd.gating_test_batch(H[b], r[b], rows[b], cov[b],
                                                               noise, table, dof[b]),))
    res["K10"] = (len(calls), flips)
    return res


def _check_update_batched(rec, B):
    """Every 8th recorded batched launch of K11 (``apply_update_fleet``), K12
    (``apply_update_rank12_rows_fleet``), K7's prediction and K8's selection
    of the fleet run, and its first frame's K8 entries, again: K11 within
    check_ekf_update's float32 bar (P within max(1e-5 of max(|P|, 1), 4 x the
    float32 plain version's distance) of the float64 batched plain version),
    K12 within 1e-4 of max(|P|, 1) of the batched plain version (each
    changed field), K7 within its bars (the rotation 4 ulps of 1.0, the
    points 4 ulps at 752 px), K8 exact; each instance bit for bit its single
    launch.  Device us per batched launch (torch.profiler, the latest
    call).  Returns {kernel: (launches checked, largest error)}."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.ops import camera, gridops
    from uav_airvision_tpu_torch.utils import tree

    res, us = {}, {}

    def single(tag, b, got, one):
        if not all(torch.equal(g, o) for g, o in zip(got, one)):
            fail(f"[fleet] {tag}: instance {b} of the batched launch differs from its single "
                 f"launch")

    def timed(tag, fn, calls, kernels):
        if calls:
            n, dev_us = _profile_calls(lambda: fn(*calls[-1]), kernels=kernels)
            us[tag] = round(dev_us, 2)
            if n != 1.0:
                fail(f"[fleet] {tag}: {n} launches a batched call, not one")

    calls = rec.calls["apply_update_fleet"]
    worst = 0.0
    for a in calls[::8]:
        st, params, H, r, rows, flags, mask = a
        got, warn = upd.apply_update_fleet(*a)
        want, _ = upd.apply_update_fleet_plain(*_cast((st, params), torch.float64), H.double(),
                                               r.double(), rows, flags, mask)
        p32, _ = upd.apply_update_fleet_plain(*a)
        for b in (b for b, f in enumerate(flags) if f):
            g, w, p = (tree.index(x, b) for x in (got, want, p32))
            e = float((g.cov.double() - w.cov).abs().max())
            e32 = float((p.cov.double() - w.cov).abs().max())
            worst = max(worst, e)
            if not e <= max(1e-5 * max(float(w.cov.abs().max()), 1.0), 4 * e32) or not \
                    torch.equal(g.cov, g.cov.T):
                fail(f"[fleet] K11 batched, instance {b} ({rows[b]} rows): P error {e:.3e}, "
                     f"the float32 plain version's {e32:.3e}")
            one, owarn = upd.apply_update(tree.index(st, b), params, H[b], r[b], rows[b])
            single("K11", b, (*_state_fields(g).values(), warn[b]),
                   (*_state_fields(one).values(), owarn))
    res["K11"] = (len(calls[::8]), worst)
    timed("K11", upd.apply_update_fleet, calls, ("update_kernel",))

    calls = rec.calls["apply_update_rank12_rows_fleet"]
    worst = 0.0
    for a in calls[::8]:
        st, params, H12, r_blk, include, cols, flags, mask, n_feats = a
        got, warn = upd.apply_update_rank12_rows_fleet(*a)
        want, pwarn = upd.apply_update_rank12_rows_fleet_plain(*a)
        for b in (b for b, f in enumerate(flags) if f):
            g, w = _state_fields(tree.index(got, b)), _state_fields(tree.index(want, b))
            e = max(float((g[k] - w[k]).abs().max()) for k in g) / max(
                float(w["cov"].abs().max()), 1.0)
            worst = max(worst, e)
            if not e <= 1e-4 or bool(warn[b]) != bool(pwarn[b]):
                fail(f"[fleet] K12 batched, instance {b} ({n_feats[b]} features): error "
                     f"{e:.3e} of max(|P|, 1)")
            k = n_feats[b]
            one, owarn = upd.apply_update_rank12_rows(tree.index(st, b), params, H12[b, :k],
                                                      r_blk[b, :k], include[b, :k], cols[b])
            single("K12", b, (*g.values(), warn[b]), (*_state_fields(one).values(), owarn))
    res["K12"] = (len(calls[::8]), worst)
    timed("K12", upd.apply_update_rank12_rows_fleet, calls, ("rank12_kernel",))

    calls = [a for a in rec.calls["predict_warp_points"] if a[0].dim() == 3]
    worst = 0.0
    for a in calls[::8]:
        (got, R), (want, pR) = camera.predict_warp_points(*a), camera.predict_warp_points_plain(*a)
        e_rot, e_pts = float((R - pR).abs().max()), float((got - want).abs().max())
        worst = max(worst, e_pts)
        if not (e_rot <= 4 * 2.0 ** -23 and e_pts <= 4 * PX_ULP):
            fail(f"[fleet] K7 prediction batched: rotation {e_rot:.3e}, points {e_pts:.3e} px")
        for b in range(a[0].shape[0]):
            single("K7 prediction", b, (got[b], R[b]),
                   camera.predict_warp_points(a[0][b], a[1][b], a[2][b], *a[3:]))
    res["K7 predict"] = (len(calls[::8]), worst)
    timed("K7 predict", camera.predict_warp_points, calls, ("predict_warp_kernel",))

    calls = [a for a in rec.calls["select_track"] if a[0].dim() == 3]
    for a in calls[::8]:
        got = gridops.select_track(*a)
        if not all(torch.equal(g, w) for g, w in zip(got, gridops.select_track_plain(*a))):
            fail("[fleet] K8 select_track batched differs from its batched plain version")
        for b in range(a[0].shape[0]):
            single("K8 select_track", b, [g[b] for g in got],
                   gridops.select_track(*(x[b] for x in a[:11]), *a[11:]))
    res["K8 select"] = (len(calls[::8]), 0.0)
    timed("K8 select", gridops.select_track, calls, ("select_track_kernel",))

    n_first = 0
    for name in ("rank_in_cell", "kept_order_stats", "compact_kept"):
        fn, plain = getattr(gridops, name), getattr(gridops, name + "_plain")
        for a in (a for a in rec.calls[name] if a[0].dim() == 2):
            n_first += 1
            got = fn(*a)
            if not all(torch.equal(g, w) for g, w in zip(got, plain(*a))):
                fail(f"[fleet] K8 {name} batched differs from its batched plain version")
            n_in = 2 if name == "compact_kept" else 4
            for b in range(a[0].shape[0]):
                single(f"K8 {name}", b, [g[b] for g in got],
                       fn(*(x[b] for x in a[:n_in]), *a[n_in:]))
    res["K8 first frame"] = (n_first, 0.0)
    print(f"[fleet] K11, K12, K7's prediction and K8 batched at B = {B}: (recorded launches "
          f"checked, largest error against the batched plain version) {res}; every instance "
          f"bit for bit its single launch; device us per batched launch {us}")
    return res, us


def _batched_bounds(rec):
    """The bound (us, what binds) of K11's, K12's, K7's prediction's and
    K8's selection's batched launches, the mean over a fleet run's recorded
    calls: each updating (pruning) instance's inputs read once, its outputs
    written once and its operations, counted as check_ekf_update,
    check_backend_kernels, check_camera and check_gridops count them for
    one instance, summed over the launch's instances."""
    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.utils import tree

    out = {}

    def mean(tag, items):  # [(bytes, operations)] a launch
        if items:
            bs = [bound(b, o) for b, o in items]
            out[tag] = (round(sum(b[0] for b in bs) / len(bs) * 1e3, 4), bs[-1][1])

    items = []
    for st, params, H, r, rows, flags, _ in rec.calls["apply_update_fleet"]:
        D, size = st.cov.shape[-1], st.cov.element_size()
        n_bytes = ops = 0.0
        for b in (b for b, f in enumerate(flags) if f):
            nz = float(rows[b] if rows[b] is not None else H.shape[1])
            qr_ops, m = 0.0, nz
            if upd.update_tier(H.shape[1], D, rows[b]) == "QR":
                qr_ops, m = 2 * nz * D * D, float(D)
            ops += (qr_ops + 2 * m * D * D + m * m * D + m ** 3 / 3 + 2 * m * m * D + 2 * m * D
                    + 2 * m * D * D + 3 * D * D + 40 * D)
            fields = nbytes(*_state_fields(tree.index(st, b)).values())
            n_bytes += (2 * D * D * size + (nz * (D + 1) + D + 1) * size
                        + 2 * (fields - D * D * size))
        items.append((n_bytes, ops))
    mean("K11", items)
    items = []
    for st, params, H12, r_blk, include, cols, flags, _, n_feats in \
            rec.calls["apply_update_rank12_rows_fleet"]:
        D, size = st.cov.shape[-1], st.cov.element_size()
        n_bytes = ops = 0.0
        for b in (b for b, f in enumerate(flags) if f):
            k = n_feats[b]
            n = 5 * int(include[b, :k].sum())
            ops += 2 * n * 90 + 3 * 12 ** 3 + 13 * 144 + 2 * D * 156 + 26 * D * D + 40 * D
            n_bytes += (2 * nbytes(*_state_fields(tree.index(st, b)).values())
                        + n * 13 * size + nbytes(include[b, :k], cols[b], params.obs_noise))
        items.append((n_bytes, ops))
    mean("K12", items)
    # K7's prediction: points, rate, dt, rotation and intrinsics in, the
    # points and R out; ~20 operations a point (the warp), ~150 an instance
    mean("K7 predict", [(nbytes(*a[:5]) + a[0].numel() * 4 + 36 * a[0].shape[0],
                         20 * a[0].shape[0] * a[0].shape[1] + 150 * a[0].shape[0])
                        for a in rec.calls["predict_warp_points"] if a[0].dim() == 3])
    items = []
    for a in (a for a in rec.calls["select_track"] if a[0].dim() == 3):
        B, F, C = a[0].shape[0], a[0].shape[1], a[5].shape[1]
        n = F + C
        items.append((sum(nbytes(x) for x in a[:11]) + B * (25 * F + 4),
                      B * 3 * (C * math.log2(C) + 2 * n * math.log2(n))))
    mean("K8 select", items)
    return out


def run_fleet_phase(config, frames, pb, wrappers, card):
    """[fleet]: B = FLEET_B decorrelated instances of the bench world
    (instance b from frame FLEET_STRIDE * b, FLEET_FRAMES frames each)
    through ``parallel.fleet.run_fleet``, counters at 0 and the batched
    kernels' calls recorded; each instance against ``run_sequence`` on its
    frames; the back-end's K14, K13, K9 and K10 at most once a stage on
    every step; the recorded batched launches of K2, K4+K6 and K5 bit for bit
    their batched plain version and their single launches, K14's, K13's,
    K9's and K10's within their bars of the batched plain version and bit
    for bit their single launches, K1's (temporal,
    stereo forward and backward, and the compact entry in a
    compact-configuration fleet run of two frames) bit for bit the single
    launches and within K1's bars of the plain version; a forced
    stereo-seed fallback on one instance; then fleet_bench's measurements at
    B = FLEET_SIZES."""
    import torch

    from uav_airvision_tpu_torch import fleet_bench
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.ops import fast, gridops, lk, pyramid
    from uav_airvision_tpu_torch.parallel import fleet
    from uav_airvision_tpu_torch.utils import tree

    t_phase = time.time()
    fe = config.frontend
    T, B = FLEET_FRAMES, FLEET_B
    bframes = fleet_bench.fleet_frames(frames, T, B, FLEET_STRIDE)
    _zero(wrappers)
    steps = []

    def counts(k, fe_out, o):  # the back-end's and K7's and K8's launch counts after each step
        steps.append(({n: sum(f.launches for f in fns)
                       for n, fns in fleet_bench.BACKEND.items()},
                      {n: sum(f.launches for f in fns) for n, fns in fleet_bench.BATCHED.items()
                       if n.startswith(("K7", "K8"))}))

    torch.cuda.synchronize()
    t0 = time.time()
    with FleetRecorder() as rec:
        _, out = fleet.run_fleet(config, bframes, pb.gyro_bias, pb.acc_mean, on_frame=counts)
    torch.cuda.synchronize()
    per_entry = _per_entry(wrappers)
    print(f"[fleet] B = {B} decorrelated (stride {FLEET_STRIDE}), {T} frames each: "
          f"{time.time() - t0:.2f} s (cold); launches {per_entry}")
    for name, n in per_entry.items():
        if n == 0:
            fail(f"[fleet] the fleet path never launched kernel {name}")
    batched = {k: sum(f.launches for f in fns) for k, fns in fleet_bench.BATCHED.items()}
    print(f"[fleet] the front-end's batched kernels' launches per step at B = {B}: "
          f"{ {k: round(n / T, 3) for k, n in batched.items()} }")
    _fleet_frontend_steps(steps)
    per_step = _fleet_backend_steps(steps, out)
    print(f"[fleet] the back-end's batched kernels at B = {B}: launches per step "
          f"{ {k: round(v, 3) for k, v in per_step.items()} } (K14 to K10 at most once a "
          f"stage, K11 and K12 at most once an update stage, on every step); K7's prediction "
          f"and K8's selection once a step, K8's first-frame entries once on the first")
    if not torch.isfinite(out.p).all() or int(out.active.sum()) < B * 20:
        fail(f"[fleet] {int(out.active.sum())} active instance-frames, finite "
             f"{bool(torch.isfinite(out.p).all())}")
    for b in range(B):
        _, want = vio.run_sequence(config, vio.VioFrame(*(x[:, b] for x in bframes)),
                                   pb.gyro_bias, pb.acc_mean)
        _fleet_vs_single("[fleet]", out, want, b)
    t_part = {"run and single runs": time.time() - t_phase}

    # the recorded batched launches (every 10th frame's), again
    def rows(pyrs):  # each camera's pyramids, one row an instance
        return [p.flat.view(p.batch, -1) for p in pyrs]

    for a in rec.calls["build_pyramid_pair"][::10]:
        _check_batched("[fleet] K2", rows(pyramid.build_pyramid_pair(*a)),
                       rows(pyramid.build_pyramid_pair_plain(*a)),
                       [[p.flat for p in pyramid.build_pyramid_pair(a[0][b], a[1][b], *a[2:])]
                        for b in range(B)])
    for a in rec.calls["detect_fast"][::10]:
        img, thr, pts, valid = a
        _check_batched("[fleet] K4+K6", fast.detect_fast(*a), fast.detect_fast_plain(*a),
                       [fast.detect_fast(img[b], thr, *((pts[b], valid[b]) if pts is not None
                                                         else ())) for b in range(B)])
    for a in rec.calls["dense_grid_topk"][::10]:
        _check_batched("[fleet] K5", gridops.dense_grid_topk(*a),
                       gridops.dense_grid_topk_plain(*a),
                       [gridops.dense_grid_topk(a[0][b], *a[1:]) for b in range(B)])
    t_part["K2, K4+K6, K5"] = time.time() - t_phase - sum(t_part.values())
    be = _check_backend_batched(rec)
    print(f"[fleet] K14, K13, K9, K10 batched: (recorded launches checked, largest error "
          f"against the batched plain version; K10: decision flips, each at its threshold) "
          f"{be}; every instance bit for bit its single launch")
    t_part["K14, K13, K9, K10"] = time.time() - t_phase - sum(t_part.values())
    _check_update_batched(rec, B)
    bounds = {B: _batched_bounds(rec)}
    t_part["K11, K12, K7, K8"] = time.time() - t_phase - sum(t_part.values())
    print(f"[fleet] K2, K4+K6, K5: {len(rec.calls['build_pyramid_pair'][::10])}, "
          f"{len(rec.calls['detect_fast'][::10])}, {len(rec.calls['dense_grid_topk'][::10])} "
          f"recorded batched launches checked")

    def check_lk(tag, calls, entry, kernel_name):
        shapes = {}
        for a in calls:
            shapes.setdefault((tuple(a[2].shape), a[9]), []).append(a)
        worst = 0.0
        for shape, group in sorted(shapes.items()):
            for a in group[::max(1, len(group) // 3)][:3]:
                pp, cp, p0, p1, v = a[:5]
                rest = dict(win=a[5], max_iter=a[6], eps=a[7], min_eig_threshold=a[8],
                            n_levels=a[9], max_iter_upper=a[10])
                kn, ks = entry(pp, cp, p0, p1, v, **rest)
                for b in range(p0.shape[0]):
                    on, os_ = entry(pp.instance(b), cp.instance(b), p0[b], p1[b], v[b], **rest)
                    if not (torch.equal(kn[b], on) and torch.equal(ks[b], os_)):
                        fail(f"{tag} {shape}: instance {b} differs from its single launch")
                pn, ps = lk.pyramidal_lk_plain(pp, cp, p0, p1, v, compact_windows=(
                    entry is lk.pyramidal_lk_compact), **rest)
                agree = float((ks == ps).float().mean())
                both = ks & ps
                err = float((kn[both] - pn[both]).abs().max()) if bool(both.any()) else 0.0
                worst = max(worst, err)
                if agree < 0.99 or err > 1e-3:
                    fail(f"{tag} {shape}: status agreement {agree:.4f}, max err {err:.2e} px")
            a = group[-1]
            _, us = _profile_calls(lambda: entry(*a[:5], win=a[5], max_iter=a[6], eps=a[7],
                                                 min_eig_threshold=a[8], n_levels=a[9],
                                                 max_iter_upper=a[10]), kernels=(kernel_name,))
            print(f"{tag} batched (B, F, 2) x levels {shape} ({len(group)} calls): "
                  f"{us:.1f} us on the device per launch")
        print(f"{tag} every instance bit for bit its single launch; within K1's bars of the "
              f"plain version (max err {worst:.3e} px)")

    check_lk("[fleet] K1", rec.calls["pyramidal_lk"], lk.pyramidal_lk, "lk_kernel")
    ccfg = variant_config(config, "compact")
    with FleetRecorder() as crec:
        fleet.run_fleet(ccfg, vio.VioFrame(*(x[:2] for x in bframes)), pb.gyro_bias,
                        pb.acc_mean)
    if not crec.calls["pyramidal_lk_compact"]:
        fail("[fleet] the compact configuration's fleet step made no compact LK call")
    check_lk("[fleet] K1 compact", crec.calls["pyramidal_lk_compact"], lk.pyramidal_lk_compact,
             "lk_compact_kernel")

    t_part["K1"] = time.time() - t_phase - sum(t_part.values())
    # a forced stereo-seed fallback on instance 1 (tests/test_fleet.py's
    # starvation: all but 3 feature slots invalidated)
    k0, n_after = FLEET_STARVE
    state, _ = fleet.run_fleet(config, vio.VioFrame(*(x[:k0] for x in bframes)), pb.gyro_bias,
                               pb.acc_mean)
    front = state.frontend
    keep = torch.where((torch.arange(B, device=front.valid.device) == 1)[:, None],
                       torch.arange(front.valid.shape[1], device=front.valid.device) < 3, True)
    starved = state._replace(frontend=front._replace(
        valid=front.valid & keep, ids=torch.where(keep, front.ids, -1),
        lifetime=torch.where(keep, front.lifetime, 0)))
    seeds, k1 = [], []

    def on_frame(k, fe_out, o):
        seeds.append(fe_out.n_seed.tolist())
        k1.append(lk.pyramidal_lk.launches)

    n0 = lk.pyramidal_lk.launches
    tail = vio.VioFrame(*(x[k0:k0 + n_after] for x in bframes))
    _, sout = fleet.run_fleet(config, tail, pb.gyro_bias, pb.acc_mean, state=starved,
                              on_frame=on_frame)
    per_frame = [b - a for a, b in zip([n0] + k1[:-1], k1)]
    print(f"[fleet] forced fallback after frame {k0}: seeds per instance {seeds[0]} "
          f"(min {fe.stereo_seed_min_tracked}); K1 launches per frame {per_frame}")
    fired = [b for b, n in enumerate(seeds[0]) if n < fe.stereo_seed_min_tracked]
    if fired != [1] or per_frame[0] != 5:
        fail(f"[fleet] the fallback fired on instances {fired}, K1 launches {per_frame} "
             f"(expected instance 1 alone: 1 temporal + 2 x 2 stereo)")
    for b in range(B):
        _, want = vio.run_sequence(config, vio.VioFrame(*(x[:, b] for x in tail)), pb.gyro_bias,
                                   pb.acc_mean, state=tree.index(starved, b))
        _fleet_vs_single("[fleet] fallback", sout, want, b, k0)

    t_part["fallback"] = time.time() - t_phase - sum(t_part.values())
    # scaling: fleet_bench's measurements at each B (the recorded calls
    # freed first: peak memory is the fleet's)
    del rec, crec, out, sout, state, starved, front, bframes, tail
    torch.cuda.empty_cache()
    res = {}
    for n in FLEET_SIZES:
        res[n] = r = fleet_bench.measure(config, fleet_bench.fleet_frames(
            frames, T, n, FLEET_STRIDE), pb, profile=True)
        print(f"[fleet] B = {n}: {r['instance_frames_per_s']:.2f} instance-frames/s aggregate "
              f"(warm, {r['seconds']:.3f} s for {T} steps), {r['host_syncs_per_step']:.2f} host "
              f"syncs/step, {r['cuda_launches_per_step']:.1f} CUDA launches/step, batched "
              f"kernels' launches/step {r['kernel_launches_per_step']} "
              f"{r['backend_launches_per_step']}, device us per launch "
              f"{ {k: round(v, 2) if v else v for k, v in r['kernel_device_us_per_launch'].items()} }, "
              f"per step "
              f"{ {k: round(v, 2) for k, v in r['kernel_device_us_per_step'].items()} }, "
              f"peak device memory {r['peak_device_bytes'] / 2 ** 20:.1f} MiB ({card})")
        if not r["finite"]:
            fail(f"[fleet] B = {n}: non-finite poses")
        if not r["host_syncs_per_step"] <= 6:
            fail(f"[fleet] B = {n}: {r['host_syncs_per_step']:.2f} host syncs per step (> 6)")
    # the four kernels' bounds at the widest B, from a recorded run of its own
    n = FLEET_SIZES[-1]
    with FleetRecorder() as rec_n:
        fleet.run_fleet(config, fleet_bench.fleet_frames(frames, T, n, FLEET_STRIDE),
                        pb.gyro_bias, pb.acc_mean)
    bounds[n] = _batched_bounds(rec_n)
    del rec_n
    print(f"[fleet] bound per batched launch of K11, K12, K7's prediction and K8's selection "
          f"(us, what binds; the mean over the run's launches) at B = {B} / {n}: {bounds}")
    lo, hi = res[FLEET_SIZES[0]], res[FLEET_SIZES[-1]]
    if lo["kernel_launches_per_step"] != hi["kernel_launches_per_step"]:
        fail(f"[fleet] the batched kernels' launches per step grow with B: "
             f"{lo['kernel_launches_per_step']} at B = {FLEET_SIZES[0]}, "
             f"{hi['kernel_launches_per_step']} at B = {FLEET_SIZES[-1]}")
    t_part["measure"] = time.time() - t_phase - sum(t_part.values())
    print(f"[fleet] phase {time.time() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in t_part.items()))
    return res


LONG_S = 60.0  # [long]: seconds of the easy preset (1,200 frames)
LONG_CHUNK_S = 10.0  # seconds a chunk (6 chunks)
LONG_SEED = 7
LONG_MIN_ACTIVE = 1100
LONG_SPLIT = 400  # frames run as two chunks and as one run_sequence call
LONG_RENDER_FRAMES = (0, 599, 1199)  # frames rendered on the card and on the host
# 1.25 x the JAX package's ATE rmse over the same 60 s rendered without cv2:
# 0.02148 m (tools/jax_long_bar.py 60 --preset easy --chunk 10 on the CPU,
# scripts/long_run.py's figure, rounded there to 5 digits; PERF.md)
LONG_ATE_BAR_M = 0.02685
# the back-end kernels with a float32 and a float64 instantiation: C entry
# stems, and the wrappers that reach them on the main path
LONG_F64_ENTRIES = ("propagate", "triangulate_rows", "feature_block", "gate", "rank12",
                    "ekf_update")
LONG_F64_CALLS = ("propagate", "triangulate_rows", "feature_block_rows", "gating_test_batch",
                  "apply_update_rank12_rows", "apply_update")


class LongObserver:
    """The kernels' observer in [long]: the levels of each frame's first K1
    call after K7's prediction (the temporal tracker's), and the latest two
    calls of each back-end wrapper in LONG_F64_CALLS."""

    def __init__(self):
        import collections

        self.temporal_levels = collections.Counter()
        self.calls = {name: collections.deque(maxlen=2) for name in LONG_F64_CALLS}
        self._predicted = False

    def __call__(self, name, args):
        args = _single_call(name, args)
        if name == "predict_warp_points":
            self._predicted = True
        elif name == "pyramidal_lk" and self._predicted:
            self.temporal_levels[args[9]] += 1
            self._predicted = False
        elif name in self.calls:
            self.calls[name].append(args)

    def __enter__(self):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = self
        return self

    def __exit__(self, *exc):
        from uav_airvision_tpu_torch import kernels

        kernels.observer = None


class EntryCounter:
    """Counts the C entry points launched (``kernels.launch`` by name)."""

    def __enter__(self):
        import collections

        from uav_airvision_tpu_torch import kernels

        self.counts = collections.Counter()
        self._launch = kernels.launch

        def launch(name, *args):
            self.counts[name] += 1
            self._launch(name, *args)

        kernels.launch = launch
        return self

    def __exit__(self, *exc):
        from uav_airvision_tpu_torch import kernels

        kernels.launch = self._launch


def check_long_renderer(world, fts, card):
    """[long, render]: frames LONG_RENDER_FRAMES and one inside a starve
    window rendered by simulation/render.py on the card and by
    ``world.render_frame`` on the host, each pair from one generator state;
    the renderer's bar (render.pixel_agreement) and the generator states
    equal afterwards.  Prints each route's ms a frame."""
    import numpy as np
    import torch

    from uav_airvision_tpu_torch.simulation import render

    cases = [(k, None) for k in LONG_RENDER_FRAMES]
    t_starve = fts[LONG_RENDER_FRAMES[1]]
    cases.append((LONG_RENDER_FRAMES[1], (t_starve - 0.5, t_starve + 0.5)))
    for k, starve in cases:
        t = fts[k]
        r_host, r_dev = np.random.default_rng(1000 + k), np.random.default_rng(1000 + k)
        want = world.render_frame(t, r_host, starve_window=starve)
        got = render.render_pair(world, t, r_dev, "cuda", starve_window=starve)
        ok, n_diff, max_diff, n_big = render.pixel_agreement(
            got, want, render.rect_border(world, t))
        same_rng = r_host.bit_generator.state == r_dev.bit_generator.state
        print(f"[long, render] frame {k} (t = {t:.2f} s{', starved' if starve else ''}): "
              f"{n_diff} pixels differ from the host's, by at most {max_diff}; {n_big} by more "
              f"than one off a border; generator states equal: {same_rng}")
        if not ok or not same_rng or got[0].device.type != "cuda":
            fail(f"[long, render] frame {k}{' starved' if starve else ''}: {n_diff} pixels "
                 f"differ (max {max_diff}, {n_big} past the bar), generator equal {same_rng}")
    rng = np.random.default_rng(3)
    ts = fts[:20]
    render.render_frames(world, ts[:2], rng, "cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.time()
    render.render_frames(world, ts, rng, "cuda")
    torch.cuda.synchronize()
    dev_ms = (time.time() - t0) * 1e3 / len(ts)
    t0 = time.time()
    for t in ts[:3]:
        world.render_frame(t, rng)
    host_ms = (time.time() - t0) * 1e3 / 3
    print(f"[long, render] {dev_ms:.2f} ms a stereo frame on the card (host noise draw and "
          f"upload included) against {host_ms:.1f} ms on the host ({card})")


def _long_checks(tag, result, outs, bar):
    """The run checks of a [long] run: active frames, finite poses, the
    covariance finite at every chunk, no reset, ATE rmse under ``bar``."""
    import numpy as np

    act = outs.active.numpy()
    p, q = outs.p.numpy(), outs.q.numpy()
    for row in result["chunks"]:
        print(f"{tag} frame {row['frame']:5d} t={row['t_s']:5.1f} s: pos_std "
              f"{row['pos_std_m']:.5f} m (max {row['max_pos_std_m']:.5f}), resets "
              f"{row['resets']}, sym_err {row['sym_err']:.3e}, cov finite {row['cov_finite']}")
    print(f"{tag} {int(act.sum())} active frames of {len(act)}; ATE rmse "
          f"{result['ate_rmse_m']:.5f} m (bar {bar:.5f}), RTE rmse {result['rte_rmse_m']:.5f} m; "
          f"{result['online_resets']} resets; filter {len(act) / result['filter_s']:.1f} "
          f"frames/s ({result['filter_s']:.1f} s), render {result['render_s']:.1f} s, wall "
          f"with rendering {result['wall_s']:.1f} s")
    if act.sum() < LONG_MIN_ACTIVE:
        fail(f"{tag} only {int(act.sum())} active frames (< {LONG_MIN_ACTIVE})")
    if not (np.isfinite(p[act]).all() and np.isfinite(q[act]).all()):
        fail(f"{tag} non-finite poses")
    if not all(row["cov_finite"] for row in result["chunks"]):
        fail(f"{tag} the covariance went non-finite")
    if result["online_resets"]:
        fail(f"{tag} {result['online_resets']} online resets on the easy preset")
    if not result["ate_rmse_m"] < bar:
        fail(f"{tag} ATE rmse {result['ate_rmse_m']:.5f} m is not under {bar:.5f} m")


def check_long_f64_calls(obs, card):
    """Each back-end kernel's float64 calls recorded in the float64 run
    against its float64 plain version: K14 within 1e-12 relative, K11's new
    state within 1e-10 of each field's largest entry, K12's P_new within
    1e-10 of max(|P|, 1) (its other fields 1e-4, [limits]' bar), K9 within
    1e-10 of each block's largest entry ([limits]), K13's initialized and
    init_fail identical and positions within 1e-3 of max(|p|, 1)
    ([limits]), K10's decisions identical but within 1e-4 of the
    threshold.  Returns {wrapper: the largest error}."""
    import torch

    from uav_airvision_tpu_torch.models.msckf import propagation
    from uav_airvision_tpu_torch.models.msckf import triangulation as tri
    from uav_airvision_tpu_torch.models.msckf import update as upd

    errs = {}
    for name, calls in obs.calls.items():
        if not calls:
            fail(f"[long, float64] no {name} call recorded")
            continue
        for a in calls:
            if name == "propagate":
                e = _prop_err(propagation.propagate(*a), propagation.propagate_plain(*a))
                ok = e <= 1e-12
            elif name == "apply_update":
                e = _state_err(upd.apply_update(*a)[0], upd.apply_update_plain(*a)[0])
                ok = e <= 1e-10
            elif name == "apply_update_rank12_rows":
                got = upd.apply_update_rank12_rows(*a)[0]
                want = upd.apply_update_rank12_rows_plain(*a)[0]
                e = float((got.cov - want.cov).abs().max()) / max(float(want.cov.abs().max()), 1.0)
                ok = e <= 1e-10 and _state_err(got, want) <= 1e-4
            elif name == "feature_block_rows":
                H, r, rows = upd.feature_block_rows(*a[:13], rm=a[13])
                pH, pr, prows = upd.feature_block_rows_plain(*a[:13], rm=a[13])
                sc = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
                e = max(float(((g - w).abs().flatten(1).amax(1) / sc).max())
                        for g, w in ((H, pH), (r, pr)))
                ok = e <= 1e-10 and torch.equal(rows, prows)
            elif name == "triangulate_rows":
                pos, init, failed = tri.triangulate_rows(*a)
                ppos, pinit, pfail = tri.triangulate_rows_plain(*a)
                new = init & ~a[5]
                d = (pos - ppos).abs().amax(1) / ppos.abs().amax(1).clamp(min=1.0)
                e = float(d[new].max()) if bool(new.any()) else 0.0
                ok = torch.equal(init, pinit) and torch.equal(failed, pfail) and e <= 1e-3
            else:  # gating_test_batch
                H, r, rows_true, cov, obs_noise, chi2, dof = a
                thresh = chi2[dof]
                near = (upd.gate_gamma_plain(H, r, cov, obs_noise) - thresh).abs() <= 1e-4 * thresh
                diff = (upd.gating_test_batch(*a) != upd.gating_test_batch_plain(*a)) & ~near
                e, ok = float(diff.sum()), not bool(diff.any())
            data = a[0] if isinstance(a[0], torch.Tensor) else a[0].cov  # a state's
            if name in ("feature_block_rows", "triangulate_rows"):
                data = a[2 if name == "triangulate_rows" else 4]  # the observations
            if data.dtype != torch.float64:
                fail(f"[long, float64] a {name} call on {data.dtype} data")
            errs[name] = max(errs.get(name, 0.0), e)
            if not ok:
                fail(f"[long, float64] {name}: error {e:.3e} against its float64 plain version")
    print(f"[long, float64] the back-end kernels' float64 calls against their float64 plain "
          f"versions: { {k: f'{v:.3e}' for k, v in errs.items()} } ({card})")
    return errs


def run_long_phase(wrappers, card):
    """[long]: LONG_S seconds of the easy preset through ``long_run.run``
    (long_horizon_config, chunks of LONG_CHUNK_S, rendered on the card),
    counters at 0 before it, in float32 and then in float64 on the same
    rendered frames; the renderer against the host's; the first LONG_SPLIT
    frames (two chunks) against one run_sequence call, bit for bit."""
    import dataclasses

    import torch

    from uav_airvision_tpu_torch import long_run
    from uav_airvision_tpu_torch.config import long_horizon_config
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.simulation import render

    t_phase = time.time()
    config = long_horizon_config()
    with render.without_opencv():  # the world long_run.run builds and renders
        world, pb, fts = long_run.build(config, LONG_S, "easy", LONG_SEED)
        check_long_renderer(world, fts, card)
    bar = LONG_ATE_BAR_M

    images = {}
    _zero(wrappers)
    rendered = dict(render.frames_rendered)
    with LongObserver() as obs:
        res32, out32 = long_run.run(config, LONG_S, "easy", LONG_CHUNK_S, LONG_SEED, "cuda",
                                    images=images, log=None)
    per_entry = _per_entry(wrappers)
    on_card = {route: n - rendered.get(route, 0) for route, n in render.frames_rendered.items()}
    print(f"[long] float32: {res32['frames']} frames in {len(res32['chunks'])} chunks, rendered "
          f"{on_card}; launches {per_entry}; the temporal K1 call's levels "
          f"{dict(obs.temporal_levels)}")
    if on_card.get("tensor", 0) != len(fts) or on_card.get("host", 0):
        fail(f"[long] frames rendered by route {on_card}: {len(fts)} on the card expected")
    for name, n in per_entry.items():
        if n == 0:
            fail(f"[long] the path never launched kernel {name}")
    if set(obs.temporal_levels) != {3} or sum(obs.temporal_levels.values()) < len(fts) - 1:
        fail(f"[long] the temporal K1 calls' levels {dict(obs.temporal_levels)}: 3 expected "
             f"on every frame after the first")
    _long_checks("[long]", res32, out32, bar)

    # two chunks against one call over the same frames
    c0 = torch.cat([images[k][0] for k in sorted(images) if k < LONG_SPLIT])
    c1 = torch.cat([images[k][1] for k in sorted(images) if k < LONG_SPLIT])
    _, one = vio.run_sequence(config, long_run.chunk_frames(pb, 0, LONG_SPLIT, c0, c1,
                                                            torch.device("cuda")),
                              pb.gyro_bias, pb.acc_mean)
    head = type(out32)(*(x[:LONG_SPLIT] for x in out32))
    diff = _same_bits(type(one)(*(x.cpu() for x in one)), head,
                      ("p", "q", "v", "active", "did_reset"))
    print(f"[long] the first {LONG_SPLIT} frames as {sum(k < LONG_SPLIT for k in images)} "
          f"chunks against one run_sequence call: "
          f"{'bit for bit equal' if not diff else 'DIFFERENT in ' + str(diff)}")
    if diff:
        fail(f"[long] the chunked run differs from one call in {diff}")

    # float64 on the same frames
    config64 = dataclasses.replace(config, dtype="float64")
    _zero(wrappers)
    with LongObserver() as obs64, EntryCounter() as entries:
        res64, out64 = long_run.run(config64, LONG_S, "easy", LONG_CHUNK_S, LONG_SEED, "cuda",
                                    images=images, log=None)
    per_entry = _per_entry(wrappers)
    f64 = {stem: (entries.counts[f"{stem}_f64"], entries.counts[f"{stem}_f32"])
           for stem in LONG_F64_ENTRIES}
    print(f"[long] float64: launches {per_entry}; (float64, float32) instantiations "
          f"launched {f64}")
    for name, n in per_entry.items():
        if n == 0:
            fail(f"[long, float64] the path never launched kernel {name}")
    for stem, (n64, n32) in f64.items():
        if n64 == 0 or n32:
            fail(f"[long, float64] {stem}: {n64} float64 and {n32} float32 launches")
    _long_checks("[long, float64]", res64, out64, bar)
    per_chunk = long_run.chunk_distance(res32["chunks"], out32, out64)
    print(f"[long] largest |p_float32 - p_float64| per chunk (m): "
          f"{[f'{d:.3e}' for d in per_chunk]}; ATE rmse float32 {res32['ate_rmse_m']:.5f} m, "
          f"float64 {res64['ate_rmse_m']:.5f} m")
    check_long_f64_calls(obs64, card)
    print(f"[long] phase {time.time() - t_phase:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        fatal("PyTorch is not installed")
    if not torch.cuda.is_available():
        fatal("torch.cuda.is_available() is False: this smoke test needs a GPU")
    t_start = time.time()
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
    from uav_airvision_tpu_torch.utils import profiling

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
    k2_0, k10_0 = pyramid.build_pyramid_pair.launches, update.gating_test_batch.launches
    with Recorder() as rec:
        state, _ = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    print(f"[main] warm run: {N_FRAMES} frames in {time.time() - t0:.2f} s; calls per shape "
          f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(rec.counts.items(), key=str)} }")
    k2_n = pyramid.build_pyramid_pair.launches - k2_0
    k10_calls = sum(n for k, n in rec.counts.items() if k[0] == "K10")
    k10_n = update.gating_test_batch.launches - k10_0
    print(f"[main] warm run: K2 {k2_n} launches for {N_FRAMES} frames, K10 {k10_n} launches "
          f"for {k10_calls} gate calls")
    if k2_n != N_FRAMES or k10_n != k10_calls:
        fail(f"K2 launched {k2_n} times for {N_FRAMES} frames, K10 {k10_n} times for "
             f"{k10_calls} gate calls: one launch each expected")
    params = make_params(config, dev)
    results["K14"] = check_propagate(rec, state.filter, params, frames, N_FRAMES // 2)
    check_lk_recorded(rec)
    check_fast_recorded(rec)
    results.update(check_backend_kernels(rec, config, params))
    results.update(check_ekf_update(rec))
    results.update(check_gridops(rec))
    results.update(check_camera(rec))

    # every entry point the main path launches (camera.distort_points runs
    # there only inside the fused stereo prologue, the homography warp only
    # inside the fused prediction; K8's first three entry points on the first
    # frame); P1 and K1's level entry run on the compact path only
    wrappers = {"K1": [lk.pyramidal_lk], "K2": [pyramid.build_pyramid_pair],
                "K4+K6": [fast.detect_fast], "K14": [propagation.propagate],
                "K13": [triangulation.triangulate_rows], "K9": [update.feature_block_rows],
                "K10": [update.gating_test_batch],
                "K12": [update.apply_update_rank12_rows], "K11": [update.apply_update],
                "K5": [gridops.dense_grid_topk],
                "K8": [*gridops.K8_WRAPPERS, gridops.select_track],
                "K7": [camera.undistort_distort_points, camera.undistort_points,
                       camera.predict_warp_points, camera.stereo_gate]}
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    profiling.reset()
    profiling.enable()
    syncs0 = device.host_syncs["sync"]
    torch.cuda.synchronize()
    t0 = time.time()
    state, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.time() - t0
    profiling.disable()
    per_entry = {f"{name} {fn.__name__}": fn.launches
                 for name, fns in wrappers.items() for fn in fns}
    launches = {name: sum(fn.launches for fn in fns) for name, fns in wrappers.items()}
    syncs = (device.host_syncs["sync"] - syncs0) / N_FRAMES
    print(f"[main] timed run: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.2f} "
          f"frames/s; {syncs:.2f} host syncs/frame; launches {per_entry}")
    print(f"[main] EKF updates per row tier: {k11_tiers(profiling.snapshot())}")
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
    print(f"[main] K2 {launches['K2'] / N_FRAMES:.2f} launches/frame, K10 "
          f"{launches['K10'] / N_FRAMES:.2f}; CUDA launches per frame over frames "
          f"{PROFILE_WINDOW}: {profile_launches(config, frames, pb):.1f}")

    sources = {"K1": ("lk.cu", "uav_airvision_tpu/ops/lk.py:341", "pyramidal_lk"),
               "K2": ("pyramid.cu", "uav_airvision_tpu/ops/pyramid.py:115",
                      "build_pyramid_pair"),
               "K4+K6": ("fast.cu", "uav_airvision_tpu/ops/fast.py:103", "fast_detect_masked"),
               "K14": ("propagate.cu", "uav_airvision_tpu/models/msckf/propagation.py:88",
                       "propagate"),
               "K13": ("triangulate.cu",
                       "uav_airvision_tpu/models/msckf/triangulation.py:159", "triangulate_rows"),
               "K9": ("feature_block.cu", "uav_airvision_tpu/models/msckf/update.py:103",
                      "feature_block_rows"),
               "K10": ("gate.cu", "uav_airvision_tpu/models/msckf/update.py:170",
                       "gating_test_batch"),
               "K12": ("rank12.cu", "uav_airvision_tpu/models/msckf/update.py:239",
                       "apply_update_rank12_rows"),
               "K11": ("ekf_update.cu", "uav_airvision_tpu/models/msckf/update.py:296",
                       "apply_update"),
               "K5": ("gridops.cu", "uav_airvision_tpu/ops/gridops.py:147", "dense_grid_topk"),
               "K8": ("gridops.cu", "uav_airvision_tpu/ops/gridops.py:58", "select_track + "
                      "rank_in_cell + kept_order_stats + compact_kept + smallest_k_indices + "
                      "stable_compact_indices"),
               "K7": ("camera.cu", "uav_airvision_tpu/ops/camera.py:99", "predict_warp_points "
                      "+ stereo_gate + undistort_distort_points + undistort_points")}
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

    # the two further configurations, each with every counter at 0 before it;
    # the compact LK's one launch (K1's compact entry) stands in P1's row
    every = {**wrappers, "P1": [lk.pyramidal_lk_compact]}
    t0 = time.time()
    compact_launches, p1 = run_compact(config, frames, pb, world, every,
                                       off_path={"K1 pyramidal_lk"})
    results.update(p1)
    t1 = time.time()
    run_exact(config, world, imu, fts, cam0, cam1, frames, pb, every,
              off_path={"P1 pyramidal_lk_compact", "K12 apply_update_rank12_rows"})
    t2 = time.time()
    check_limits_kernels(dev)
    run_limits(config, world, imu, fts, cam0, cam1, wrappers,
               off_path={"K12 apply_update_rank12_rows"})
    t3 = time.time()
    run_euroc(config, world, cam0, cam1, wrappers, card)
    t4 = time.time()
    run_fleet_phase(config, frames, pb, wrappers, card)
    t5 = time.time()
    run_long_phase(wrappers, card)
    print(f"[time] {time.time() - t_start:.1f} s in all; [compact] {t1 - t0:.1f} s, [exact] "
          f"{t2 - t1:.1f} s, [limits] {t3 - t2:.1f} s, [euroc] {t4 - t3:.1f} s, [fleet] "
          f"{t5 - t4:.1f} s, [long] {time.time() - t5:.1f} s")
    launches["P1"] = compact_launches["P1 pyramidal_lk_compact"]
    sources["P1"] = ("lk.cu", "scripts/exp_gather.py:82", "pyramidal_lk_compact")

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
