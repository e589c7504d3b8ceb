"""The PyTorch port's EuRoC dataset path against the JAX package on the CPU:
the PNG loader (``runtime/``) against OpenCV, its CSV parser against numpy,
the EuRoC writer and the batch loading against the JAX package's, the
command line's ``--path`` batch mode end to end, and the sweep's ``--root``
grid.

One 2 s sequence of the calibrated world at full width (752x480, 40 frames,
the first 20 waiting for the IMU's gravity initialisation) is written once by
the port's writer, recording the frames it renders, and read by the tests
below.
"""

import contextlib
import csv
import dataclasses
import io
import os
import re
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from uav_airvision_tpu import config as jconfig
from uav_airvision_tpu.simulation.euroc_writer import write_euroc_dataset as j_write
from uav_airvision_tpu.simulation.world import StereoWorld as JStereoWorld
from uav_airvision_tpu.streaming import dataset as jdataset
from uav_airvision_tpu.streaming import prebatch as jprebatch
from uav_airvision_tpu_torch import config as tconfig
from uav_airvision_tpu_torch import main as tmain
from uav_airvision_tpu_torch import sweep
from uav_airvision_tpu_torch.models import vio as tvio
from uav_airvision_tpu_torch.runtime import native
from uav_airvision_tpu_torch.simulation import euroc_writer as twriter
from uav_airvision_tpu_torch.simulation.world import StereoWorld as TStereoWorld
from uav_airvision_tpu_torch.streaming import dataset as tdataset
from uav_airvision_tpu_torch.streaming import prebatch as tprebatch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEQ = "SYN_EUROC"
DURATION = 2.0


class _RecordingWorld:
    """A world that keeps every frame pair it renders."""

    def __init__(self, world):
        self.world = world
        self.frames = []

    def __getattr__(self, name):
        return getattr(self.world, name)

    def render_frame(self, *args, **kwargs):
        pair = self.world.render_frame(*args, **kwargs)
        self.frames.append(pair)
        return pair


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """(sequence directory, rendered cam0 (T,H,W), cam1) of the port's writer."""
    root = tmp_path_factory.mktemp("euroc")
    world = _RecordingWorld(TStereoWorld(tconfig.euroc_config()))
    twriter.write_euroc_dataset(world, str(root / SEQ), DURATION)
    cam0, cam1 = (np.stack(c) for c in zip(*world.frames))
    return root / SEQ, cam0, cam1


@pytest.fixture(scope="module")
def cli_run(sequence, tmp_path_factory):
    """``main.py --path <dir> --offset 0 --eval --device cpu`` (the reference's
    command) run in a directory of its own: (its BatchRun, its standard
    output, the directory)."""
    cwd = tmp_path_factory.mktemp("cli")
    out, old = io.StringIO(), os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            run = tmain.main(["--path", str(sequence[0]), "--offset", "0", "--eval",
                              "--device", "cpu"])
    finally:
        os.chdir(old)
    return run, out.getvalue(), cwd


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_all_filters(img):
    """An 8-bit grayscale PNG whose row y uses filter type y % 5 (None, Sub,
    Up, Average, Paeth), so that a decoder meets all five."""
    x = img.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1, :]  # above
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]  # above left
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    ftype = np.arange(img.shape[0]) % 5
    pred = np.choose(ftype[:, None], preds)
    rows = np.concatenate([ftype[:, None], (x - pred) & 0xFF], axis=1).astype(np.uint8)
    h, w = img.shape
    return (native.PNG_SIGNATURE
            + twriter._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + twriter._chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
            + twriter._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(48, 64), (480, 752)], ids=["48x64", "480x752"])
def test_native_decode_equals_cv2(tmp_path, shape):
    """Seeded random images written by OpenCV (its own filter choice), by the
    port's writer (filter 0) and with every row filter decode, through the
    loader's multithreaded call and image by image, to the pixels OpenCV
    reads; a 16-bit image to its high bytes."""
    rng = np.random.default_rng(shape[0])
    imgs, paths = [], []
    for i in range(3):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if i == 2:  # smooth, so that the adaptive filters pick more than None
            img = (np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])) // 3 % 256
                   ).astype(np.uint8)
        for writer in ("cv2", "port", "filters"):
            p = tmp_path / f"{writer}{i}.png"
            if writer == "cv2":
                cv2.imwrite(str(p), img)
            elif writer == "port":
                twriter.imwrite(str(p), img)
            else:
                p.write_bytes(_png_all_filters(img))
            imgs.append(img)
            paths.append(str(p))
    got = native.decode_pngs(paths, *shape, threads=4)
    for img, path, g in zip(imgs, paths, got):
        want = cv2.imread(path, -1)
        np.testing.assert_array_equal(want, img, err_msg=path)
        np.testing.assert_array_equal(g, want, err_msg=path)
        np.testing.assert_array_equal(native.decode_png(path), want, err_msg=path)
    assert native.png_size(paths[0]) == shape
    img16 = rng.integers(0, 2 ** 16, shape, dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "b16.png"), img16)
    np.testing.assert_array_equal(native.decode_png(str(tmp_path / "b16.png")),
                                  (cv2.imread(str(tmp_path / "b16.png"), -1) >> 8).astype(np.uint8))


def _corrupt(tmp_path, kind):
    img = np.random.default_rng(1).integers(0, 256, (48, 64), dtype=np.uint8)
    good = twriter.encode_png(img)
    p = tmp_path / f"{kind}.png"
    if kind == "truncated":
        p.write_bytes(good[:len(good) // 2])
    elif kind == "bad_crc":
        b = bytearray(good)
        b[50] ^= 0xFF  # inside the IDAT chunk
        p.write_bytes(bytes(b))
    elif kind == "not_png":
        p.write_bytes(b"timestamp,x\n" * 10)
    elif kind == "color":
        cv2.imwrite(str(p), np.stack([img, img, img], -1))
    elif kind == "wrong_size":
        p.write_bytes(good)
    return p


@pytest.mark.parametrize("kind", ["missing", "truncated", "bad_crc", "not_png", "color",
                                  "wrong_size"])
def test_native_decode_raises_with_the_path(tmp_path, kind):
    p = _corrupt(tmp_path, kind)
    shape = (48, 65) if kind == "wrong_size" else (48, 64)
    ok = tmp_path / "ok.png"
    twriter.imwrite(str(ok), np.zeros(shape, np.uint8))
    with pytest.raises(IOError, match=re.escape(f"1 PNG decodes failed: {p}")):
        native.decode_pngs([str(ok), str(p)], *shape)
    if kind in ("missing", "not_png"):
        with pytest.raises(IOError, match=re.escape(str(p))):
            native.decode_png(str(p))


def test_parse_csv_matches_numpy(tmp_path):
    """tests/test_streaming.py's check of the JAX package's parser, on the port's."""
    p = tmp_path / "data.csv"
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(50, 6))
    ts = (1403636579758555392 + np.arange(50) * 5000000).astype(np.int64)
    with open(p, "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(50):
            f.write(",".join([str(ts[i])] + [f"{v:.9f}" for v in rows[i]]) + "\n")
    t, vals = native.parse_csv(str(p), 6)
    np.testing.assert_allclose(t, ts * 1e-9)
    np.testing.assert_allclose(vals, rows, atol=1e-9)
    with pytest.raises(IOError, match="csv parse failed"):
        native.parse_csv(str(tmp_path / "missing.csv"), 6)


def test_writer_equals_jax(tmp_path):
    """The port's writer (its own PNG encoder) and the JAX package's (OpenCV)
    give the same files, the same CSV text and the same decoded images."""
    kw = dict(duration=0.5, seed=3, starve_window=(0.2, 0.3))
    got = twriter.write_euroc_dataset(TStereoWorld(tconfig.euroc_config()),
                                      str(tmp_path / "port"), **kw)
    want = j_write(JStereoWorld(jconfig.euroc_config()), str(tmp_path / "jax"), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port, jax_ = tmp_path / "port" / "mav0", tmp_path / "jax" / "mav0"
    for csv_file in ("imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert (port / csv_file).read_text() == (jax_ / csv_file).read_text()
    for cam in ("cam0", "cam1"):
        names = sorted(p.name for p in (jax_ / cam / "data").iterdir())
        assert sorted(p.name for p in (port / cam / "data").iterdir()) == names
        assert len(names) == 10
        ours = native.decode_pngs([str(port / cam / "data" / n) for n in names], 480, 752)
        theirs = native.decode_pngs([str(jax_ / cam / "data" / n) for n in names], 480, 752)
        for n, o, t in zip(names, ours, theirs):
            want_img = cv2.imread(str(jax_ / cam / "data" / n), -1)
            np.testing.assert_array_equal(o, want_img, err_msg=n)
            np.testing.assert_array_equal(t, want_img, err_msg=n)


@pytest.mark.parametrize("offset", [0.0, 0.63])
def test_load_and_prebatch_equal_jax(sequence, offset):
    """load_euroc_arrays (the whole sequence in one decode call, and image by
    image) and prebatch_imu give the JAX package's arrays bit for bit on the
    same directory; the images are the ones the writer rendered."""
    path, cam0, cam1 = sequence
    got_ds, want_ds = tdataset.EuRoCDataset(str(path)), jdataset.EuRoCDataset(str(path))
    got_ds.set_starttime(offset=offset)
    want_ds.set_starttime(offset=offset)
    # the JAX package's per-image OpenCV route: its native route would build
    # a library inside the JAX package, racing tests/test_streaming.py's build
    want = jprebatch.load_euroc_arrays(want_ds, use_native=False)
    first = len(cam0) - len(want[0])
    assert first == int(np.ceil(offset * 20))
    np.testing.assert_array_equal(want[1], cam0[first:])
    np.testing.assert_array_equal(want[2], cam1[first:])
    for use_native in (True, False):
        got = tprebatch.load_euroc_arrays(got_ds, use_native=use_native)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    cap = tconfig.euroc_config().capacity
    tpb = tprebatch.prebatch_imu(*got[:1], *got[3:], cap.max_imu_per_frame, cap.imu_init_msgs)
    jpb = jprebatch.prebatch_imu(*want[:1], *want[3:], cap.max_imu_per_frame, cap.imu_init_msgs)
    for field in dataclasses.fields(jpb):
        np.testing.assert_array_equal(np.asarray(getattr(tpb, field.name)),
                                      np.asarray(getattr(jpb, field.name)), err_msg=field.name)


def test_cli_path_batch(sequence, cli_run):
    """The command line's trajectory file, its ATE under the JAX end-to-end
    bar (tests/test_e2e.py), and its poses bit for bit those of
    ``run_sequence`` on the frames the writer rendered."""
    _, cam0, cam1 = sequence
    run, stdout, cwd = cli_run
    traj = cwd / "results" / "txts" / f"output_{SEQ}_offset0.txt"
    assert run.trajectory == os.path.join("results", "txts", traj.name) and traj.exists()
    assert len(traj.read_text().splitlines()) >= 15
    rmse = float(stdout.split("[eval] ATE rmse=")[1].split("m")[0])
    assert np.isfinite(rmse) and rmse < 0.1 and rmse == pytest.approx(run.ate["rmse"], abs=1e-4)

    cfg = tconfig.euroc_config()
    frames = tvio.frames_from_prebatch(run.pb, cam0, cam1, "cpu")
    _, want = tvio.run_sequence(cfg, frames, run.pb.gyro_bias, run.pb.acc_mean)
    assert run.start_frame == 0 and int(want.active.sum()) >= 15
    for name in ("p", "q", "v", "active", "timestamp"):
        assert torch.equal(getattr(run.outputs, name), getattr(want, name)), name


def test_sweep_root_grid(sequence, cli_run, tmp_path, monkeypatch):
    """``python -m uav_airvision_tpu_torch.sweep --root`` over one sequence x
    offsets 0, 1 and 5 (ROADMAP fault 6: the JAX ``run_sweep.py --root``
    raises a NameError): tests/test_sweep.py's CSV schema, one row and one
    trajectory per (sequence, offset) that has frames, the offset-0
    trajectory the command line's, and the plots.  At offset 1 the 1 s left
    waits for the IMU's initialisation: no active pose, so no ATE; offset 5
    is past the sequence's end, and a missing sequence is skipped."""
    path, _, _ = sequence
    root = tmp_path / "root"
    shutil.copytree(path, root / SEQ)
    monkeypatch.chdir(tmp_path)
    sweep.main(["--root", str(root), "--sequences", SEQ, "MISSING", "--offsets", "0", "1", "5",
                "--device", "cpu"])
    with open(tmp_path / "results" / "metrics_summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["dataset"] for r in rows] == [f"{SEQ}_offset0", f"{SEQ}_offset1"]
    for col in ("dataset", "ate_rmse", "ate_mean", "ate_std", "rte_rmse", "rte_mean",
                "rte_std", "ate_perc"):
        assert col in rows[0], f"missing column {col}"
    assert np.isfinite(float(rows[0]["ate_rmse"])) and float(rows[0]["ate_rmse"]) < 0.1
    assert np.isnan(float(rows[1]["ate_rmse"]))
    txts = tmp_path / "results" / "txts"
    assert (txts / f"output_{SEQ}_offset1.txt").exists()
    assert not (txts / f"output_{SEQ}_offset5.txt").exists()
    name = f"output_{SEQ}_offset0.txt"
    assert (txts / name).read_bytes() == (cli_run[2] / "results" / "txts" / name).read_bytes()
    for png in ("trajectories.png", "ate_vs_path.png"):
        assert (tmp_path / "results" / SEQ / png).exists()
    assert (tmp_path / "results" / "ate_summary.png").exists()
