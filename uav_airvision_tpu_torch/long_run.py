"""Long-horizon stability run of the PyTorch port: the counterpart of
scripts/long_run.py, on the card unless the caller asks for the CPU.

    python -m uav_airvision_tpu_torch.long_run [duration_s] [--preset easy] [--chunk 30]
                                               [--device cuda|cpu] [--dtype float32 [float64]]

A ``duration_s`` (600 by default) world of the preset (the layered,
photometric ``StereoWorld``, seed 7) runs through ``long_horizon_config()``
(``lk_temporal_levels=3``) as one continuous filter run, ``--chunk`` seconds of
frames at a time: each chunk is rendered on the run's device
(``simulation/render.py``; ``world.render_frame`` on the CPU), its frames
sliced from the prebatched IMU, and run through ``run_sequence`` with the
state of the chunk before.  After each chunk the covariance must be finite
(raises with the frame otherwise), and the position std
(``sqrt(max diag(cov)[12:15])``), the resets so far and ``max|cov - cov'|``
are printed.  At the end ATE and RTE over the active frames against the
world's ground truth.  The world is built and rendered as on a machine
without OpenCV, on every device (the device renderer does not implement
the simulator's OpenCV blur).  ``--dtype float64`` runs the filter in float64 (the
config's ``dtype``).  The report goes to
``reports/torch_long_run_<preset>_<duration>s[_float64].json``: the JAX
script's keys plus ``dtype``, ``device``, ``render_s``, ``filter_s`` and
``chunks`` (one row per chunk).  ``--dtype float32 float64`` runs both
on the same rendered frames (rendered once) and adds to each float64 chunk
row its largest distance from the float32 run's positions.  Without CUDA
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

FPS = 20  # the world's frame clock


def build(config, duration, preset="easy", seed=7):
    """(world, prebatched IMU, frame times) of scripts/long_run.py's world."""
    from .simulation.world import EUROC_MOTION_PRESETS, StereoWorld, Trajectory6DoF
    from .streaming.prebatch import prebatch_imu

    world = StereoWorld(config, seed=seed,
                        trajectory=Trajectory6DoF(**EUROC_MOTION_PRESETS[preset]),
                        scene="layered", photometric=True)
    imu_t, imu_w, imu_a = world.imu_stream(duration, seed=seed)
    fts = world.frame_times(duration)
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    return world, pb, fts


def chunk_frames(pb, k0, k1, cam0, cam1, device):
    """The VioFrame of frames [k0, k1) from the prebatched IMU and the
    chunk's image stacks (already on ``device``)."""
    from .models.vio import VioFrame

    def f32(x):
        return torch.as_tensor(np.asarray(x[k0:k1]), dtype=torch.float32, device=device)

    return VioFrame(timestamp=f32(pb.timestamps), cam0=cam0, cam1=cam1,
                    imu_t=f32(pb.imu_t), imu_w=f32(pb.imu_w), imu_a=f32(pb.imu_a),
                    imu_mask=torch.as_tensor(pb.imu_mask[k0:k1], device=device),
                    fe_mean_w=f32(pb.fe_mean_w), fe_dt=f32(pb.fe_dt),
                    active=torch.as_tensor(pb.active[k0:k1], device=device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chunks(config, world, pb, fts, rng, device, chunk_s=30.0, images=None, log=print):
    """The chunk loop over ``world``'s frames at times ``fts`` (``pb`` their
    prebatched IMU, ``rng`` the renderer's generator) on ``device``: each
    chunk rendered there, then ``run_sequence`` from the state of the chunk
    before.  Raises when the covariance is not finite after a chunk.
    Returns (state, outputs, rows, render_s, filter_s): ``outputs`` the
    StepOutput of every frame on the host, ``rows`` one dict per chunk.
    ``images``, if given, is a dict from a chunk's first frame to its (cam0,
    cam1) stacks: chunks found there are not rendered again, chunks rendered
    are put there (a second run over the same world and chunks, e.g. in the
    other dtype, reuses them).  ``log`` (None: silent) gets each chunk's
    line."""
    from .models.frontend.params import make_frontend_params
    from .models.msckf.state import make_params
    from .models.msckf.step import StepOutput
    from .models.vio import run_sequence
    from .simulation.render import render_frames

    T = len(fts)
    per = int(round(chunk_s * FPS))
    mparams = make_params(config, device)
    fparams = make_frontend_params(config, device)
    state = None
    outs, rows = [], []
    n_resets, max_pos_std = 0, 0.0
    render_s = filter_s = 0.0
    t_start = time.time()
    for k0 in range(0, T, per):
        k1 = min(k0 + per, T)
        t0 = time.time()
        if images is not None and k0 in images:
            cam0, cam1 = images[k0]
        else:
            cam0, cam1 = render_frames(world, fts[k0:k1], rng, device)
            if images is not None:
                images[k0] = (cam0, cam1)
        _sync(device)
        t1 = time.time()
        state, out = run_sequence(config, chunk_frames(pb, k0, k1, cam0, cam1, device),
                                  pb.gyro_bias, pb.acc_mean, fparams, mparams, state=state)
        out = StepOutput(*(x.cpu() for x in out))
        t2 = time.time()
        render_s += t1 - t0
        filter_s += t2 - t1
        outs.append(out)
        n_resets += int(out.did_reset[out.active].sum())
        cov = state.filter.cov
        if not bool(torch.isfinite(cov).all()):
            raise FloatingPointError(f"cov non-finite at frame {k1}")
        pos_std = float(torch.sqrt(torch.diagonal(cov)[12:15].max()))
        max_pos_std = max(max_pos_std, pos_std)
        sym_err = float((cov - cov.T).abs().max())
        rows.append(dict(frame=k1, t_s=float(fts[k1 - 1] - fts[0]), pos_std_m=pos_std,
                         max_pos_std_m=max_pos_std, resets=n_resets, sym_err=sym_err,
                         cov_finite=True))
        if log is not None:
            log(f"  [{k1:6d}/{T}] t={fts[k1 - 1] - fts[0]:6.1f}s pos_std={pos_std:.4f}m "
                f"max={max_pos_std:.4f} resets={n_resets} sym_err={sym_err:.2e} "
                f"({k1 / (time.time() - t_start):.0f} fps incl. render)", flush=True)
    outputs = StepOutput(*(torch.cat(xs) for xs in zip(*outs)))
    return state, outputs, rows, render_s, filter_s


def run(config, duration=600.0, preset="easy", chunk_s=30.0, seed=7, device="cuda",
        images=None, log=print):
    """scripts/long_run.py's run of the port, its world built and rendered
    as on a machine without OpenCV (``render.without_opencv``) on every
    device, as tools/jax_long_bar.py runs the JAX script.  Returns (result, outputs):
    ``result`` the report's dict (``result["chunks"]`` the per-chunk rows),
    ``outputs`` the StepOutput of every frame on the host; ``images`` and
    ``log`` as in ``run_chunks``."""
    from .device import get_device
    from .evaluation.metrics import ate, rte
    from .simulation.render import without_opencv

    device = get_device(device)
    with without_opencv():
        world, pb, fts = build(config, duration, preset, seed)
        T = len(fts)
        t_start = time.time()  # the loop's wall time, as the JAX script's
        if log is not None:
            log(f"[long_run] {preset} {duration:.0f}s = {T} frames, chunks of "
                f"{int(round(chunk_s * FPS))} frames ({config.dtype} on {device})", flush=True)
        _, outputs, rows, render_s, filter_s = run_chunks(
            config, world, pb, fts, np.random.default_rng(seed), device, chunk_s, images, log)
    p = outputs.p.numpy()
    act = outputs.active.numpy()
    ts_abs = pb.time_base + outputs.timestamp.numpy().astype(np.float64)
    gt_p = world.groundtruth(fts)
    a = ate(ts_abs[act], p[act], fts, gt_p)
    r = rte(ts_abs[act], p[act], fts, gt_p)
    result = {
        "preset": preset, "duration_s": duration, "frames": T, "poses": int(act.sum()),
        "ate_rmse_m": float(a["rmse"]), "rte_rmse_m": float(r["rmse"]),
        "path_len_m": float(np.sum(np.linalg.norm(np.diff(gt_p, axis=0), axis=1))),
        "online_resets": rows[-1]["resets"], "max_pos_std_m": rows[-1]["max_pos_std_m"],
        "wall_s": time.time() - t_start,
        "dtype": config.dtype,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "render_s": render_s, "filter_s": filter_s,
        "chunks": rows,
    }
    return result, outputs


def report_path(preset, duration, dtype):
    suffix = "_float64" if dtype == "float64" else ""
    return f"reports/torch_long_run_{preset}_{int(duration)}s{suffix}.json"


def chunk_distance(rows, a, b):
    """Per chunk (``rows``' frame ends), the largest |p_a - p_b| (m) over the
    frames active in both outputs."""
    act = (a.active & b.active).numpy()
    dp = np.linalg.norm(a.p.double().numpy() - b.p.double().numpy(), axis=1)
    out, k0 = [], 0
    for row in rows:
        sel = act[k0:row["frame"]]
        out.append(float(dp[k0:row["frame"]][sel].max()) if sel.any() else 0.0)
        k0 = row["frame"]
    return out


def main(argv=None):
    """The command line; returns {dtype: result}.  With both dtypes the
    frames are rendered once and the float64 report's chunk rows also hold
    ``dp_float32_m``, the chunk's largest distance from the float32 run's
    positions."""
    from .config import long_horizon_config

    ap = argparse.ArgumentParser(description="long-horizon stability run of the PyTorch port")
    ap.add_argument("duration", nargs="?", type=float, default=600.0, help="seconds")
    ap.add_argument("--preset", default="easy", help="easy, medium or difficult")
    ap.add_argument("--chunk", type=float, default=30.0, help="seconds a chunk")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", nargs="+", default=["float32"], choices=("float32", "float64"),
                    help="the filter's dtype; float32 float64 runs both on the same frames")
    args = ap.parse_args(argv)

    images = {} if len(args.dtype) > 1 else None
    results, outputs = {}, {}
    for dtype in args.dtype:
        config = dataclasses.replace(long_horizon_config(), dtype=dtype)
        results[dtype], outputs[dtype] = run(config, args.duration, args.preset, args.chunk, 7,
                                             args.device, images=images)
    if {"float32", "float64"} <= set(results):
        rows = results["float64"]["chunks"]
        for row, d in zip(rows, chunk_distance(rows, outputs["float64"], outputs["float32"])):
            row["dp_float32_m"] = d
            print(f"  [{row['frame']:6d}] largest |p_float64 - p_float32| {d:.3e} m")
    for dtype, result in results.items():
        out = report_path(args.preset, args.duration, dtype)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps({k: v for k, v in result.items() if k != "chunks"}))
    return results

if __name__ == "__main__":
    main()
