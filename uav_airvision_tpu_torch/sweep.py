"""Experiment sweep of the PyTorch port: the counterpart of the repository's
``run_sweep.py`` (which drives the JAX package), with its flags, its
``results/metrics_summary.csv`` schema and a ``--device`` (the card unless
the caller asks for the CPU).  Replaces the reference run.bat grid: 9 EuRoC
sequences x offsets {1,5,10,15,20,30,40} (reference run.bat:4-10).

    python -m uav_airvision_tpu_torch.sweep --root /data/euroc [--sequences MH_01_easy ...]
                                            [--offsets 1 5 10 ...] [--device cpu]
    python -m uav_airvision_tpu_torch.sweep --synthetic-suite [--duration 20]
    python -m uav_airvision_tpu_torch.sweep --long-stability

``--root`` runs every (sequence, offset) in batch mode and writes one row
each; a sequence longer than 60 s after its offset runs
``long_horizon_config()``, a shorter one ``euroc_config()``.  The plots
(``evaluation/plots.py``) are drawn only where matplotlib imports.
"""

from __future__ import annotations

import argparse
import os

SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]
OFFSETS = [1, 5, 10, 15, 20, 30, 40]
LONG_HORIZON_S = 60.0  # missions past this run the 3-level temporal LK
CHUNK_S = 30.0  # seconds of a synthetic sequence rendered and run at a time


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[plots] skipped: matplotlib is not installed")
        return False
    return True


def _run(config, frames, pb):
    """Run the sequence; (absolute timestamps, positions, quaternions,
    active mask, final state, outputs) on the host."""
    import numpy as np

    from .models.vio import run_sequence

    state, outs = run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    act = outs.active.cpu().numpy()
    ts_abs = pb.time_base + outs.timestamp.cpu().numpy().astype(np.float64)
    return ts_abs, outs.p.cpu().numpy(), outs.q.cpu().numpy(), act, state, outs


def _path_length(p):
    import numpy as np

    return float(np.sum(np.linalg.norm(np.diff(np.asarray(p, np.float64), axis=0), axis=1)))


def _row(name, a, r, path_len):
    perc = 100.0 * a["rmse"] / path_len if path_len > 0 else ""
    return dict(dataset=name, ate_rmse=a["rmse"], ate_mean=a["mean"], ate_std=a["std"],
                rte_rmse=r["rmse"], rte_mean=r["mean"], rte_std=r["std"], ate_perc=perc)


def _summary_plots(summary, name_suffix=""):
    """Repo-level bar charts of the (name, ATE %, RTE %) rows, each chart of
    the rows whose value is finite."""
    import math

    from .evaluation.plots import plot_summary

    for col, kind in ((1, "ATE"), (2, "RTE")):
        rows = [(s[0], s[col]) for s in summary if math.isfinite(s[col])]
        if rows:
            png = f"results/{kind.lower()}_summary{name_suffix}.png"
            plot_summary(png, [r[0] for r in rows], [r[1] for r in rows], kind)
            print(f"[plots] {png}")


def run_synthetic_suite(duration, csv_path, seeds=(7, 13), name_suffix="",
                        strict_easy_resets=False, long_horizon=None, device="cuda"):
    """EuRoC-proxy evaluation grid on the hardened simulator: 6-DoF
    EuRoC-matched motion presets x layered multi-depth scene x photometric
    degradation (simulation/world.py).  One row per (preset, seed) in the
    reference metrics_summary.csv schema.  Each sequence runs CHUNK_S
    seconds of frames at a time, rendered on ``device``
    (``long_run.run_chunks``: ``simulation/render.py``, ``world.render_frame``
    on the CPU), its state carried from chunk to chunk; the covariance must
    be finite after every chunk.  The worlds are built and rendered as on a
    machine without OpenCV (``render.without_opencv``), on every device."""
    import numpy as np

    from .config import euroc_config, long_horizon_config
    from .device import get_device
    from .evaluation.metrics import ate, rte, write_metrics_summary
    from .long_run import run_chunks
    from .simulation.render import without_opencv
    from .simulation.world import EUROC_MOTION_PRESETS, StereoWorld, Trajectory6DoF
    from .streaming.prebatch import prebatch_imu
    from .utils.trajectory import TrajectoryWriter

    device = get_device(device)
    plots = _have_matplotlib()
    if long_horizon is None:
        long_horizon = duration > LONG_HORIZON_S
    config = long_horizon_config() if long_horizon else euroc_config()
    rows, summary = [], []
    for preset, kw in EUROC_MOTION_PRESETS.items():
        for seed in seeds:
            name = f"SYN_{preset}_s{seed}{name_suffix}"
            with without_opencv():
                world = StereoWorld(config, seed=seed, trajectory=Trajectory6DoF(**kw),
                                    scene="layered", photometric=True)
                imu_t, imu_w, imu_a = world.imu_stream(duration, seed=seed)
                fts = world.frame_times(duration)
                pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                                  config.capacity.imu_init_msgs)
                _, outs, chunks, render_s, filter_s = run_chunks(
                    config, world, pb, fts, np.random.default_rng(seed), device, CHUNK_S,
                    log=None)
            act = outs.active.numpy()
            ts_abs = pb.time_base + outs.timestamp.numpy().astype(np.float64)
            p, q = outs.p.numpy(), outs.q.numpy()
            TrajectoryWriter(dataset_name=name, offset="0").write_batch(ts_abs, p, q, act)
            gt_p = world.groundtruth(fts)
            a = ate(ts_abs[act], p[act], fts, gt_p)
            r = rte(ts_abs[act], p[act], fts, gt_p)
            path_len = _path_length(gt_p)
            # peak body rate, so rows compare with EuRoC specs; long-run
            # stability: online resets fired (run_chunks raises on a
            # non-finite covariance at a chunk's end)
            wmax = float(np.max(np.linalg.norm(imu_w, axis=1)))
            n_resets = chunks[-1]["resets"]
            print(f"[{name}] ATE {a['rmse']:.4f}m RTE {r['rmse']:.4f}m "
                  f"path {path_len:.1f}m peak|w| {wmax:.2f} rad/s "
                  f"({int(act.sum())} poses, {n_resets} resets, max pos std "
                  f"{chunks[-1]['max_pos_std_m']:.4f}m, cov finite at {len(chunks)} chunks; "
                  f"render {render_s:.1f} s, filter {filter_s:.1f} s)", flush=True)
            if strict_easy_resets and preset == "easy" and n_resets:
                raise RuntimeError(f"{name}: {n_resets} online resets on the easy preset over "
                                   f"{duration:.0f}s (long-run stability regression)")
            rows.append(_row(name, a, r, path_len))
            if plots:
                from .evaluation.plots import per_sequence_artifacts

                seq_dir = os.path.join("results", name)
                per_sequence_artifacts(seq_dir, ts_abs[act], p[act], fts, gt_p)
                print(f"[plots] {seq_dir}/", flush=True)
            if path_len > 0:
                summary.append((name, 100.0 * a["rmse"] / path_len,
                                100.0 * r["rmse"] / path_len))
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    write_metrics_summary(csv_path, rows)
    print(f"[csv] {csv_path}")
    if plots:
        _summary_plots(summary, name_suffix)


def run_root(root, sequences, offsets, csv_path, device="cuda"):
    """Every (sequence, offset) of the EuRoC sequences under ``root`` in
    batch mode: trajectories to results/txts/, one metrics row each (when
    the sequence has ground truth), the per-sequence plots for the first
    offset."""
    import numpy as np

    from .config import euroc_config, long_horizon_config
    from .device import get_device
    from .evaluation.metrics import ate, rte, write_metrics_summary
    from .main import build_frames_from_euroc
    from .utils.trajectory import TrajectoryWriter

    device = get_device(device)
    plots = _have_matplotlib()
    rows, summary = [], []
    for seq in sequences:
        path = os.path.join(root, seq)
        if not os.path.isdir(path):
            print(f"[skip] {seq}: not found under {root}")
            continue
        for off in offsets:
            try:
                frames, pb, gt = build_frames_from_euroc(euroc_config(), path, off, device)
            except ValueError as e:  # no frame after the offset
                print(f"[skip] {seq} offset {off}: {e}")
                continue
            # the two configurations prebatch alike (same capacity)
            long_horizon = pb.timestamps[-1] > LONG_HORIZON_S
            config = long_horizon_config() if long_horizon else euroc_config()
            if pb.active.any():
                ts_abs, p, q, act, _, _ = _run(config, frames, pb)
            else:  # every frame precedes the IMU's initialisation: no pose to estimate
                print(f"[{seq} offset {off}] no frame after the IMU's initialisation")
                ts_abs, p, q, act = np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4)), \
                    np.zeros(0, bool)
            TrajectoryWriter(dataset_name=seq, offset=str(int(off))).write_batch(ts_abs, p, q, act)
            if gt is None:
                print(f"[{seq} offset {off}] no ground truth: trajectory only")
                continue
            a = ate(ts_abs[act], p[act], gt["timestamp"], gt["p"])
            r = rte(ts_abs[act], p[act], gt["timestamp"], gt["p"])
            # ate_perc: ATE RMSE as a percentage of the ground-truth path
            # length over the evaluated span (the reference publishes the
            # column but not its script: this definition is ours)
            path_len = _path_length(gt["p"])
            print(f"[{seq} offset {off}] ATE {a['rmse']:.4f} RTE {r['rmse']:.4f}"
                  f"{' (long horizon)' if long_horizon else ''}")
            # one row per (sequence, offset): the full grid, no best-of
            rows.append(_row(f"{seq}_offset{int(off)}", a, r, path_len))
            if path_len > 0:
                summary.append((f"{seq}_offset{int(off)}", 100.0 * a["rmse"] / path_len,
                                100.0 * r["rmse"] / path_len))
            # reference-style per-sequence plots (first offset only: the
            # reference publishes one artifact set per sequence)
            if plots and off == offsets[0]:
                from .evaluation.plots import per_sequence_artifacts

                per_sequence_artifacts(os.path.join("results", seq), ts_abs[act], p[act],
                                       gt["timestamp"], gt["p"])
    if rows:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        write_metrics_summary(csv_path, rows)
        print(f"[csv] {csv_path}")
        if plots:
            _summary_plots(summary)


def main(argv=None):
    ap = argparse.ArgumentParser(description="sweep of the PyTorch port over EuRoC sequences")
    ap.add_argument("--root", help="directory containing EuRoC sequences")
    ap.add_argument("--sequences", nargs="*", default=SEQUENCES)
    ap.add_argument("--offsets", nargs="*", type=float, default=OFFSETS)
    ap.add_argument("--csv", default="results/metrics_summary.csv")
    ap.add_argument("--synthetic-suite", action="store_true",
                    help="run the EuRoC-proxy grid (hardened simulator) instead of real "
                         "sequences")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="synthetic-suite sequence length in seconds")
    ap.add_argument("--long-stability", action="store_true",
                    help="EuRoC-length (180 s = MH_01 length) stability rows: one seed per "
                         "preset, requires a finite covariance and no online reset on easy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.long_stability:
        run_synthetic_suite(180.0, args.csv.replace(".csv", "_synthetic_180s.csv"),
                            seeds=(7,), name_suffix="_180s", strict_easy_resets=True,
                            device=args.device)
    elif args.synthetic_suite:
        run_synthetic_suite(args.duration, args.csv.replace(".csv", "_synthetic.csv"),
                            device=args.device)
    elif args.root:
        run_root(args.root, args.sequences, args.offsets, args.csv, args.device)
    else:
        ap.error("--root is required unless --synthetic-suite or --long-stability")


if __name__ == "__main__":
    main()
