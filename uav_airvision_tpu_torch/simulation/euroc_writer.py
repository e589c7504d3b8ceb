"""The PyTorch port's own copy of uav_airvision_tpu/simulation/euroc_writer.py:
same signature, directory layout and CSV text (tests/test_torch_euroc.py
holds the two equal), except that the images are written by a small PNG
encoder on the standard library (``encode_png``), so a machine without
OpenCV or PIL (the card's) writes its own sequences.

Write a StereoWorld rollout as a EuRoC-MAV-format dataset directory.

Produces the layout both this framework's readers and the original
NumPy/OpenCV reference consume (mav0/cam{0,1}/data/<ns>.png,
mav0/imu0/data.csv, mav0/state_groundtruth_estimate0/data.csv), enabling
apples-to-apples accuracy/throughput comparisons on identical input.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib

import numpy as np

from ..runtime.native import PNG_SIGNATURE
from .world import StereoWorld


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(img) -> bytes:
    """An (H, W) uint8 image as an 8-bit grayscale PNG: IHDR, every row with
    filter 0 (None), one IDAT deflated at zlib level 1 (OpenCV's default
    speed setting), IEND."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"encode_png takes an (H, W) image, got shape {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def imwrite(path, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_euroc_dataset(world: StereoWorld, out_dir: str, duration: float,
                        fps: int = 20, imu_rate: int = 200, seed: int = 0,
                        t0_ns: int = 1_500_000_000_000_000_000,
                        starve_window=None, imu_dropout=None):
    """Render ``duration`` seconds of the world into ``out_dir``.

    Returns (frame_times, imu_times) in world seconds."""
    mav = os.path.join(out_dir, "mav0")
    cam0_dir = os.path.join(mav, "cam0", "data")
    cam1_dir = os.path.join(mav, "cam1", "data")
    imu_dir = os.path.join(mav, "imu0")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    for d in (cam0_dir, cam1_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    def ns(t):
        return t0_ns + int(round(t * 1e9))

    # images
    fts = world.frame_times(duration, fps=fps)
    rng = np.random.default_rng(seed)
    for t in fts:
        c0, c1 = world.render_frame(t, rng, starve_window=starve_window)
        imwrite(os.path.join(cam0_dir, f"{ns(t)}.png"), c0)
        imwrite(os.path.join(cam1_dir, f"{ns(t)}.png"), c1)

    # imu csv
    imu_t, imu_w, imu_a = world.imu_stream(duration, rate=imu_rate, seed=seed,
                                           dropout_window=imu_dropout)
    with open(os.path.join(imu_dir, "data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["#timestamp [ns]", "w_RS_S_x", "w_RS_S_y", "w_RS_S_z",
                    "a_RS_S_x", "a_RS_S_y", "a_RS_S_z"])
        for i, t in enumerate(imu_t):
            w.writerow([ns(t), *imu_w[i], *imu_a[i]])

    # groundtruth csv (EuRoC column order: p, q(wxyz), v, bw, ba)
    with open(os.path.join(gt_dir, "data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["#timestamp", "p_x", "p_y", "p_z", "q_w", "q_x", "q_y",
                    "q_z", "v_x", "v_y", "v_z", "b_w_x", "b_w_y", "b_w_z",
                    "b_a_x", "b_a_y", "b_a_z"])
        for t in imu_t:
            p = world.traj.pos(t)
            R = world.traj.R_i_w(t)
            # R (imu->world) to Hamilton wxyz
            tr = np.trace(R)
            qw = np.sqrt(max(tr + 1.0, 0.0)) / 2.0
            if qw > 1e-6:
                qx = (R[2, 1] - R[1, 2]) / (4 * qw)
                qy = (R[0, 2] - R[2, 0]) / (4 * qw)
                qz = (R[1, 0] - R[0, 1]) / (4 * qw)
            else:
                qx = qy = qz = 0.0
                qw = 1.0
            v = world.traj.vel(t)
            w.writerow([ns(t), *p, qw, qx, qy, qz, *v, 0, 0, 0, 0, 0, 0])

    return fts, imu_t
