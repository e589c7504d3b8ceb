"""The port's world renderer (simulation/render.py) against the host's
``StereoWorld.render_frame``, on the CPU.

``render_pair_tensor`` is the tensor version the card runs; here it runs on
CPU tensors and is held to ``render_frame`` (cv2 blocked, as on a machine
without OpenCV) with the renderer's bar: at most one pixel in 10,000 of a
camera's image differs, each by at most one grey level unless it lies on a
plane's rectangle border.  The generator's state after each frame must be
``render_frame``'s, so the next frame's noise is the host's too.
"""

import sys
import types

import numpy as np
import pytest
import torch

from uav_airvision_tpu_torch.config import euroc_config, long_horizon_config
from uav_airvision_tpu_torch.simulation import render
from uav_airvision_tpu_torch.simulation.world import (EUROC_MOTION_PRESETS, StereoWorld,
                                                      Trajectory6DoF)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
STARVE = (0.3, 0.6)


@pytest.fixture(scope="module")
def no_cv2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        yield


@pytest.fixture(scope="module")
def easy_world(no_cv2):
    """long_run.py's world: layered, photometric, the easy preset, seed 7."""
    return StereoWorld(long_horizon_config(), seed=7,
                       trajectory=Trajectory6DoF(**EUROC_MOTION_PRESETS["easy"]),
                       scene="layered", photometric=True)


def _same_state(a, b):
    return a.bit_generator.state == b.bit_generator.state


def _check(world, t, got, want):
    ok, n_diff, max_diff, n_big = render.pixel_agreement(got, want, render.rect_border(world, t))
    print(f"t={t}: {n_diff} pixels differ, by at most {max_diff}; {n_big} by more, off a border")
    assert got[0].dtype == torch.uint8 and got[0].shape == (world.H, world.W)
    assert ok


def test_render_matches_host_on_easy_world(easy_world):
    """Three frames in a row from one generator (the layered photometric
    easy world at 752x480), then a frame inside a starve window; the
    generator equal to the host's after each."""
    w = easy_world
    assert (w.W, w.H) == (752, 480)
    r_host, r_dev = np.random.default_rng(7), np.random.default_rng(7)
    for t in (0.0, 1.55, 37.35):
        want = w.render_frame(t, r_host)
        got = render.render_pair_tensor(w, t, r_dev, CPU)
        _check(w, t, got, want)
        assert _same_state(r_host, r_dev)
    t = 0.45
    want = w.render_frame(t, r_host, starve_window=STARVE)
    got = render.render_pair_tensor(w, t, r_dev, CPU, starve_window=STARVE)
    _check(w, t, got, want)
    assert _same_state(r_host, r_dev)
    # a frame past the window renders the scene again, on the same stream
    want = w.render_frame(0.65, r_host, starve_window=STARVE)
    got = render.render_pair_tensor(w, 0.65, r_dev, CPU, starve_window=STARVE)
    _check(w, 0.65, got, want)
    assert _same_state(r_host, r_dev)


def test_render_matches_host_on_plain_plane(no_cv2):
    """The single-plane, non-photometric world (the bench world), with the
    default per-time generator when none is passed."""
    w = StereoWorld(euroc_config())
    for t in (0.0, 4.2):
        rng_h, rng_d = np.random.default_rng(5), np.random.default_rng(5)
        _check(w, t, render.render_pair_tensor(w, t, rng_d, CPU), w.render_frame(t, rng_h))
        assert _same_state(rng_h, rng_d)
    _check(w, 2.0, render.render_pair_tensor(w, 2.0, None, CPU), w.render_frame(2.0))


def test_render_frames_chunk_and_routes(easy_world):
    """``render_frames`` on the CPU is ``render_frame`` frame by frame (the
    plain version), and the tensor version over the same chunk gives the
    same stacks; each route counts its frames."""
    w = easy_world
    ts = w.frame_times(0.15)
    before = dict(render.frames_rendered)
    c0, c1 = render.render_frames(w, ts, np.random.default_rng(3), CPU)
    assert c0.shape == (len(ts), w.H, w.W) and c0.dtype == torch.uint8
    rng = np.random.default_rng(3)
    for k, t in enumerate(ts):
        got = render.render_pair_tensor(w, t, rng, CPU)
        _check(w, t, got, (c0[k].numpy(), c1[k].numpy()))
    assert render.frames_rendered["host"] - before.get("host", 0) == len(ts)
    assert render.frames_rendered["tensor"] - before.get("tensor", 0) == len(ts)


def test_render_raises_where_cv2_imports():
    """Where cv2 imports, render_frame blurs a photometric world; the device
    renderer does not implement the blur and raises rather than draw
    another world (render_pair too, on any device but the CPU).  A world
    without the photometric model renders."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        photo = StereoWorld(euroc_config(), scene="layered", photometric=True)
        plain = StereoWorld(euroc_config())
        mp.setitem(sys.modules, "cv2", types.ModuleType("cv2"))
        with pytest.raises(RuntimeError, match="cv2"):
            render.render_pair_tensor(photo, 1.0, np.random.default_rng(0), CPU)
        with pytest.raises(RuntimeError, match="cv2"):
            render.render_pair(photo, 1.0, np.random.default_rng(0), torch.device("meta"))
        img0, _ = render.render_pair_tensor(plain, 1.0, np.random.default_rng(0), CPU)
        assert img0.shape == (plain.H, plain.W)


def test_pixel_agreement_bar():
    """The bar itself: one differing pixel in 10,000 of an image passes, one
    more fails; a difference of two grey levels fails unless on a border."""
    H, W = 100, 200  # 2 pixels of an image may differ
    a = np.full((H, W), 100, np.uint8)
    want = (a, a)
    b = a.copy()
    b[0, :2] += 1
    assert render.pixel_agreement((b, a), want)[0]
    b[0, 2] += 1
    assert not render.pixel_agreement((b, a), want)[0]
    c = a.copy()
    c[5, 5] += 2
    assert not render.pixel_agreement((a, c), want)[0]
    border = np.zeros((2, H, W), bool)
    border[1, 5, 5] = True
    assert render.pixel_agreement((a, c), want, border)[0]


def test_without_opencv_renders_where_cv2_imports():
    """``without_opencv()``: inside, ``import cv2`` fails, so a photometric
    world built and rendered there is the world without OpenCV, and the
    tensor renderer draws it as render_frame does; outside, cv2 is what it
    was."""
    stub = types.ModuleType("cv2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", stub)
        with render.without_opencv():
            with pytest.raises(ImportError):
                import cv2  # noqa: F401
            w = StereoWorld(euroc_config(), scene="layered", photometric=True)
            r_host, r_dev = np.random.default_rng(2), np.random.default_rng(2)
            _check(w, 3.0, render.render_pair_tensor(w, 3.0, r_dev, CPU),
                   w.render_frame(3.0, r_host))
        assert sys.modules["cv2"] is stub
