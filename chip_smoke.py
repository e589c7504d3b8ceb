"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: exits 1 unless CUDA is available; prints the card's name and
   power limit (nvidia-smi) and builds the kernels of
   ``uav_airvision_tpu_torch/csrc`` (nvcc, sm_90a).
2. Kernels against their plain PyTorch versions on the card, at main-path
   shapes, on a rendered 752x480 bench-world frame pair: K2 (pyramid) and
   K4+K6 (FAST + mask + NMS) exactly, K1 (LK; temporal 104 points x 2
   levels, stereo forward 204 x 2, backward 204 x level 0) status agreeing
   on >= 99% of points and agreeing points within 1e-3 px, K14 (propagation,
   11 IMU samples, a real covariance) within 1e-5 relative.  Median times by
   CUDA events, warm.
3. Main path: the bench world as bench.py renders it (euroc_config, seed 5,
   200 frames) through ``run_sequence`` on the card twice; the second run is
   timed, with every launch counter set to 0 just before it.  Checks: every
   kernel launched, finite poses, >= 150 active frames, ATE max (per-frame
   |p - groundtruth|, no alignment) under ATE_BAR_M.
   The first 40 frames also run through the port's plain PyTorch path on
   the host; poses must agree within 1e-4 m.
4. Prints the per-kernel JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.  Any failure exits nonzero.
"""

from __future__ import annotations

import json
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


def render_bench_world(n_frames: int):
    import numpy as np

    from uav_airvision_tpu.config import euroc_config
    from uav_airvision_tpu.simulation.world import StereoWorld
    from uav_airvision_tpu.streaming.prebatch import prebatch_imu

    config = euroc_config()
    world = StereoWorld(config)
    dur = n_frames / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(dur)
    fts = world.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    return config, world, pb, np.stack(cam0), np.stack(cam1)


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
    res["K2"] = (0.0,
                 cuda_ms(lambda: pyramid.build_pyramid_padded(cam0, fe.pyramid_levels)),
                 cuda_ms(lambda: pyramid.build_pyramid_padded_plain(cam0, fe.pyramid_levels)))
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
    res["K4+K6"] = (0.0, cuda_ms(lambda: fast.detect_fast(cam0, fe.fast_threshold, pts, valid)),
                    cuda_ms(lambda: fast.detect_fast_plain(cam0, fe.fast_threshold, pts, valid)))
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
    err_all, ms_all, plain_all = 0.0, 0.0, 0.0
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
    res["K1"] = (err_all, ms_all, plain_all)
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
    return abs_err, ms, pms


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
    from uav_airvision_tpu_torch.models.msckf import propagation
    from uav_airvision_tpu_torch.models.msckf.state import make_params
    from uav_airvision_tpu_torch.ops import fast, lk, pyramid

    dev = device.get_device("cuda")
    t0 = time.time()
    kernels.lib()
    print(f"[build] {kernels.build_info['path']} in {time.time() - t0:.1f} s "
          f"(cached: {kernels.build_info['cached']})")
    for line in kernels.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    t0 = time.time()
    config, world, pb, cam0, cam1 = render_bench_world(N_FRAMES)
    frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)
    print(f"[render] {N_FRAMES} bench-world frames in {time.time() - t0:.1f} s")

    results = check_kernels(config, frames, dev)

    # main path, warm run
    t0 = time.time()
    state, _ = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    print(f"[main] warm run: {N_FRAMES} frames in {time.time() - t0:.2f} s")
    results["K14"] = check_propagate(state.filter, make_params(config, dev), frames, 100)

    wrappers = {"K1": lk.pyramidal_lk, "K2": pyramid.build_pyramid_padded,
                "K4+K6": fast.detect_fast, "K14": propagation.propagate}
    for fn in wrappers.values():
        fn.launches = 0
    syncs0 = device.host_syncs["sync"]
    torch.cuda.synchronize()
    t0 = time.time()
    state, outs = vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    syncs = (device.host_syncs["sync"] - syncs0) / N_FRAMES
    print(f"[main] timed run: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.2f} "
          f"frames/s; {syncs:.2f} host syncs/frame; launches {launches}")
    for name, n in launches.items():
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

    sources = {"K1": ("uav_airvision_tpu_torch/csrc/lk.cu",
                      "uav_airvision_tpu/ops/lk.py:341", "pyramidal_lk"),
               "K2": ("uav_airvision_tpu_torch/csrc/pyramid.cu",
                      "uav_airvision_tpu/ops/pyramid.py:115", "build_pyramid_padded"),
               "K4+K6": ("uav_airvision_tpu_torch/csrc/fast.cu",
                         "uav_airvision_tpu/ops/fast.py:103", "fast_detect_masked"),
               "K14": ("uav_airvision_tpu_torch/csrc/propagate.cu",
                       "uav_airvision_tpu/models/msckf/propagation.py:88", "propagate")}
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

    if FAILURES:
        fatal(f"{len(FAILURES)} check(s) failed: " + "; ".join(FAILURES))
    print(json.dumps({"kernels": [
        {"name": f"{name} {sources[name][2]}", "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2]} for name in ("K1", "K2", "K4+K6", "K14")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
