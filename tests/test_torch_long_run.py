"""The port's long-horizon run (uav_airvision_tpu_torch/long_run.py) against
the JAX package's chunk loop, on the CPU, in float32 (float64:
tests/test_torch_long_run_f64.py).

The JAX side is scripts/long_run.py's loop (lines 57-98): the easy preset's
layered photometric world (seed 7) rendered on the host a chunk at a time,
each chunk through ``run_sequence(..., state=state)``, the covariance read
after each chunk.  The configuration is test_torch_slice.py's (8 cameras,
IMU init over 40 messages) with ``lk_temporal_levels=3``, as
``long_horizon_config`` sets it; 24 frames in 3 chunks of 8.  cv2 is blocked,
as on a machine without OpenCV (the run itself builds its world inside
``render.without_opencv``).  Per frame the slice test's bars (p 1e-3 m, q
1e-4); per chunk resets equal, position std within 1e-3 relative and both
covariances finite (tests/torch_long_run_cases.py).
"""

import json
import sys

import pytest
import torch

from uav_airvision_tpu_torch import long_run
from tests.torch_long_run_cases import (JAX_KEYS, chunks_equal_one_call, check_against_jax,
                                        runs)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def no_cv2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        yield


@pytest.fixture(scope="module")
def runs_f32(no_cv2):
    return runs("float32")


def test_long_run_matches_jax_chunk_loop(runs_f32):
    """(a) The port's chunked run against JAX's chunk loop, per frame and
    per chunk."""
    _, result, outs, _, want, jchunks = runs_f32
    check_against_jax(result, outs, want, jchunks)
    assert result["dtype"] == "float32" and outs.p.dtype == torch.float32


def test_long_run_chunks_equal_one_call(runs_f32):
    """(b) The chunked run equals one run_sequence call over the same frames
    (the same rendered images), bit for bit: the state carries across
    chunks exactly."""
    tcfg, _, outs, images, _, _ = runs_f32
    chunks_equal_one_call(tcfg, outs, images)


def test_long_run_cli_report(no_cv2, tmp_path, monkeypatch):
    """(c) The CLI on the CPU writes reports/torch_long_run_easy_1s.json and
    its _float64 twin with the JAX script's keys and one row per chunk
    (1.2 s in chunks of 0.4 s, 4 frames after the IMU initialisation, both
    dtypes on frames rendered once; the float64 rows carry their distance
    from the float32 run); --device is cuda by default and raises without
    CUDA."""
    from uav_airvision_tpu_torch.simulation import render

    monkeypatch.chdir(tmp_path)
    host = render.frames_rendered["host"]
    results = long_run.main(["1.2", "--chunk", "0.4", "--device", "cpu",
                             "--dtype", "float32", "float64"])
    assert render.frames_rendered["host"] - host == 24
    rows = {"frame", "t_s", "pos_std_m", "max_pos_std_m", "resets", "sym_err", "cov_finite"}
    for dtype, suffix in (("float32", ""), ("float64", "_float64")):
        with open(tmp_path / "reports" / f"torch_long_run_easy_1s{suffix}.json") as f:
            report = json.load(f)
        for key in JAX_KEYS + ("dtype", "device", "render_s", "filter_s", "chunks"):
            assert key in report, key
        assert report["frames"] == 24 and report["device"] == "cpu"
        assert report["dtype"] == dtype and report["poses"] == results[dtype]["poses"] == 4
        assert [r["frame"] for r in report["chunks"]] == [8, 16, 24]
        for row in report["chunks"]:
            assert set(row) == (rows | {"dp_float32_m"} if dtype == "float64" else rows)
    dp = [r["dp_float32_m"] for r in results["float64"]["chunks"]]
    print(f"largest |p_float64 - p_float32| per chunk: {dp}")
    assert all(0 <= d < 1e-3 for d in dp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        long_run.main(["0.6", "--chunk", "0.2"])
    assert long_run.report_path("easy", 600.0, "float64") == \
        "reports/torch_long_run_easy_600s_float64.json"


def test_sweep_synthetic_suite_runs_in_chunks(no_cv2, tmp_path, monkeypatch):
    """The sweep's synthetic suite (and --long-stability, the same function)
    renders and runs each sequence a chunk at a time through
    ``long_run.run_chunks``: on the CPU every frame through
    ``world.render_frame``, one CSV row per preset."""
    from uav_airvision_tpu_torch import sweep
    from uav_airvision_tpu_torch.simulation import render

    monkeypatch.chdir(tmp_path)
    chunks = []
    real = long_run.run_chunks

    def spy(*args, **kw):
        out = real(*args, **kw)
        chunks.append(len(out[2]))
        return out

    monkeypatch.setattr(long_run, "run_chunks", spy)
    monkeypatch.setattr(sweep, "_have_matplotlib", lambda: False)  # no pose to plot
    monkeypatch.setattr(sweep, "CHUNK_S", 0.1)
    host = render.frames_rendered["host"]
    sweep.run_synthetic_suite(0.3, "results/suite.csv", seeds=(7,), device="cpu")
    assert chunks == [3, 3, 3]
    assert render.frames_rendered["host"] - host == 3 * 6
    with open(tmp_path / "results" / "suite.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
