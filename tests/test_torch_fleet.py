"""The port's fleet path on the CPU: B instances over a leading axis.

(a) each batched plain version of K2, K4+K6, K5 and K1 equals its
single-instance plain version instance by instance; (b) ``run_fleet`` over
B = 3 decorrelated instances equals ``run_sequence`` on each instance's
frames, bit for bit, under each front-end configuration the fleet runs;
(c) an instance whose tracks are cut takes the stereo-seed fallback alone
and still equals its single run; (d) an instance inactive on the first
frames publishes the JAX package's skip row, and a state whose instances
differ in being initialized sends each down its own branch; (e) the
port's fleet step against the JAX package's ``make_fleet_step(cfg,
tiered=False)`` (``vmap(vio_step)``), each step from the same converted
JAX state.  Small sizes: 94x60 frames of the simulated world (the JAX
package's ``_tiny_config`` and the port's copy of it).
"""

import dataclasses
import os
import sys

import numpy as np
import jax
import pytest
import torch

from uav_airvision_tpu.models.vio import VioFrame as JVioFrame
from uav_airvision_tpu.parallel import fleet as jfleet
from uav_airvision_tpu.simulation.world import StereoWorld as JStereoWorld
from uav_airvision_tpu.streaming.prebatch import prebatch_imu as j_prebatch_imu
from uav_airvision_tpu_torch import convert
from uav_airvision_tpu_torch.config import Config as TConfig
from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models import vio
from uav_airvision_tpu_torch.models.frontend import pipeline
from uav_airvision_tpu_torch.ops import camera, fast, gridops, lk, pyramid
from uav_airvision_tpu_torch.parallel import fleet
from uav_airvision_tpu_torch.simulation.world import StereoWorld
from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu
from uav_airvision_tpu_torch.utils import tree
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _tiny_config  # noqa: E402

CPU = torch.device("cpu")
B = 3
STRIDE = 3  # instance b starts STRIDE * b frames into the stream
T = 10
T0 = 1.5  # the world's trajectory starts moving here; the IMU from 0


def tiny_config(**frontend):
    """The port's copy of the JAX package's 94x60 ``_tiny_config``, with an
    8-camera window and 40 IMU messages of gravity init (as
    tests/test_torch_slice.py's slice_config), so that within 10 frames
    every frame is active and the window prunes."""
    cfg = euroc_config()
    c = cfg.calib

    def scale(i):
        fx, fy, cx, cy = i
        return (fx * 94 / 752, fy * 60 / 480, cx * 94 / 752, cy * 60 / 480)

    calib = dataclasses.replace(c, cam0_intrinsics=scale(c.cam0_intrinsics),
                                cam1_intrinsics=scale(c.cam1_intrinsics),
                                cam0_resolution=(94, 60), cam1_resolution=(94, 60))
    cap = dataclasses.replace(cfg.capacity, max_features=32, max_map_features=64,
                              max_lost_per_frame=16, max_update_rows=256, max_prune_rows=256,
                              max_imu_per_frame=16, max_cam_states=8, imu_init_msgs=40)
    return dataclasses.replace(cfg, calib=calib, capacity=cap,
                               filter=dataclasses.replace(cfg.filter, max_cam_state_size=8),
                               frontend=dataclasses.replace(cfg.frontend, **frontend))


def render(cfg, n_frames, world=StereoWorld, prebatch=prebatch_imu):
    """(prebatch, cam0, cam1) of n_frames frames from T0 on."""
    w = world(cfg)
    dur = n_frames / 20.0
    imu_t, imu_w, imu_a = w.imu_stream(T0 + dur + 0.1)
    fts = T0 + w.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(w.render_frame(t, rng) for t in fts))
    pb = prebatch(fts, imu_t, imu_w, imu_a, cfg.capacity.max_imu_per_frame,
                  cfg.capacity.imu_init_msgs)
    return pb, np.stack(cam0), np.stack(cam1)


@pytest.fixture(scope="module")
def stream():
    cfg = tiny_config()
    pb, cam0, cam1 = render(cfg, T + STRIDE * (B - 1))
    return pb, vio.frames_from_prebatch(pb, cam0, cam1, CPU)


def fleet_frames(frames, n=T, stride=STRIDE, n_inst=B):
    idx = torch.arange(n)[:, None] + stride * torch.arange(n_inst)[None, :]
    return vio.VioFrame(*(x[idx] for x in frames))


def own_frames(frames, b, n=T, stride=STRIDE):
    return vio.VioFrame(*(x[stride * b:stride * b + n] for x in frames))


def assert_same_outputs(fleet_out, single_out, b):
    """Every StepOutput field of instance b equals the single run's."""
    for name, got, want in zip(single_out._fields, fleet_out, single_out):
        assert torch.equal(got[:, b], want), f"instance {b}: {name} differs"


# (a) ------------------------------------------------------------------------

def _images(rng, n, H=60, W=94):
    """Smoothed random textures, so FAST and LK find structure."""
    img = rng.integers(0, 256, (n, H + 4, W + 4)).astype(np.float32)
    img = sum(img[:, i:i + H, j:j + W] for i in range(5) for j in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return torch.as_tensor(img.astype(np.uint8))


@pytest.mark.parametrize("kernel", ["K2", "K4+K6", "K5", "K1", "K1 compact", "K7 prediction",
                                    "K8 select_track", "K8 first frame"])
def test_batched_plain_matches_single(kernel):
    """Each batched plain version (a leading instance axis) equals the
    single-instance plain version on each instance: K2, K4+K6 and K5
    exactly, K1 (both trackers) exactly too (a point's sums do not depend
    on the other points), K7's prediction exactly (its 3x3 products are
    elementwise sums), K8's selection and first-frame entries exactly."""
    rng = np.random.default_rng(13)
    if kernel.startswith(("K7", "K8")):
        return _batched_frontend_plain(rng, kernel)
    cam0, cam1 = _images(rng, B), _images(rng, B)
    if kernel == "K2":
        got = pyramid.build_pyramid_pair_plain(cam0, cam1, 3)
        assert got[0].batch == got[1].batch == B
        for b in range(B):
            want = pyramid.build_pyramid_pair_plain(cam0[b], cam1[b], 3)
            for g, w in zip(got, want):
                assert torch.equal(g.instance(b).flat, w.flat)
                assert all(torch.equal(lv[b], wl) for lv, wl in zip(g.levels, w.levels))
    elif kernel == "K4+K6":
        pts = torch.as_tensor(rng.uniform([0, 0], [94, 60], (B, 40, 2)), dtype=torch.float32)
        valid = torch.as_tensor(rng.uniform(size=(B, 40)) < 0.8)
        keep, score = fast.detect_fast_plain(cam0, 10, pts, valid)
        assert int(keep.sum()) > 0
        for b in range(B):
            k1, s1 = fast.detect_fast_plain(cam0[b], 10, pts[b], valid[b])
            assert torch.equal(keep[b], k1) and torch.equal(score[b], s1)
        keep, score = fast.detect_fast_plain(cam0, 10)
        for b in range(B):
            k1, s1 = fast.detect_fast_plain(cam0[b], 10)
            assert torch.equal(keep[b], k1) and torch.equal(score[b], s1)
    elif kernel == "K5":
        score = torch.as_tensor(rng.integers(-1, 6, (B, 60, 94)), dtype=torch.int32)
        for k in (5, 8, 40):
            got = gridops.dense_grid_topk_plain(score, 4, 5, k)
            for b in range(B):
                want = gridops.dense_grid_topk_plain(score[b], 4, 5, k)
                assert all(torch.equal(g[b], w) for g, w in zip(got, want))
    else:
        p0, p1 = (pyramid.build_pyramid_padded_plain(c, 3) for c in (cam0, cam1))
        pts = torch.as_tensor(rng.uniform([5, 5], [89, 55], (B, 30, 2)), dtype=torch.float32)
        valid = torch.as_tensor(rng.uniform(size=(B, 30)) < 0.9)
        compact = kernel == "K1 compact"
        for kw in (dict(n_levels=2, max_iter_upper=5), dict(n_levels=4), dict(n_levels=1)):
            got = lk.pyramidal_lk_plain(p0, p1, pts, pts + 1.5, valid, max_iter=10,
                                        compact_windows=compact, **kw)
            assert got[0].shape == (B, 30, 2) and got[1].shape == (B, 30)
            assert bool(got[1].any())
            for b in range(B):
                want = lk.pyramidal_lk_plain(p0.instance(b), p1.instance(b), pts[b],
                                             pts[b] + 1.5, valid[b], max_iter=10,
                                             compact_windows=compact, **kw)
                assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])
            if compact:
                des = torch.zeros((B, 30, kw["n_levels"], 2), dtype=torch.int32)
                lk.pyramidal_lk_compact(p0, p1, pts, pts + 1.5, valid, max_iter=10, des=des,
                                        **kw)
                for b in range(B):
                    one = torch.zeros((30, kw["n_levels"], 2), dtype=torch.int32)
                    lk.pyramidal_lk_compact(p0.instance(b), p1.instance(b), pts[b],
                                            pts[b] + 1.5, valid[b], max_iter=10, des=one, **kw)
                    assert torch.equal(des[b], one)


def _batched_frontend_plain(rng, kernel):
    """K7's prediction, K8's selection and K8's first-frame entries at the
    tiny configuration's sizes (32 slots, 20 cells x 8 candidates)."""
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
    from tests.torch_select_inputs import CASES, select_inputs

    cfg = tiny_config()
    W, H = cfg.calib.cam0_resolution
    if kernel == "K7 prediction":
        p = make_frontend_params(cfg, CPU)
        pts = torch.as_tensor(rng.uniform([1, 1], [W - 1, H - 1], (B, 32, 2)), dtype=torch.float32)
        w = torch.as_tensor(rng.normal(0, 1.0, (B, 3)), dtype=torch.float32)
        w[0] = 0.0
        dt = torch.as_tensor(rng.uniform(0.04, 0.06, B), dtype=torch.float32)
        got = camera.predict_warp_points_plain(pts, w, dt, p.R_cam0_imu, p.cam0_intrinsics)
        assert torch.equal(got[1][0], torch.eye(3))
        for b in range(B):
            want = camera.predict_warp_points_plain(pts[b], w[b], dt[b], p.R_cam0_imu,
                                                    p.cam0_intrinsics)
            assert all(torch.equal(g[b], x) for g, x in zip(got, want)), f"instance {b}"
    elif kernel == "K8 select_track":
        fe = cfg.frontend
        ins = [select_inputs(b, 32, fe.grid_num * fe.grid_max_feature_num, CASES[b],
                             grid=(fe.grid_row, fe.grid_col), size=(H, W)) for b in range(B)]
        statics = ins[0][1]
        arrays = [torch.stack([torch.as_tensor(a[k]) for a, _ in ins]) for k in range(11)]
        got = gridops.select_track_plain(*arrays, *statics)
        assert bool(got[4].any())
        for b in range(B):
            want = gridops.select_track_plain(*(x[b] for x in arrays), *statics)
            assert all(torch.equal(g[b], x) for g, x in zip(got, want)), f"instance {b}"
    else:
        n = cfg.frontend.grid_num * 8
        cell = torch.as_tensor(rng.integers(0, 20, (B, n)), dtype=torch.int32)
        pri = torch.as_tensor(rng.integers(0, 3, (B, n)), dtype=torch.float32)
        arr = torch.as_tensor(rng.integers(0, 6, (B, n)), dtype=torch.int32)
        valid = torch.as_tensor(rng.uniform(size=(B, n)) < 0.7)
        rank, perm = gridops.rank_in_cell_plain(cell, pri, arr, valid, 20)
        keep = valid & (rank < 3)
        got = ((rank, perm), gridops.kept_order_stats_plain(perm, keep, cell, valid, 20),
               gridops.compact_kept_plain(perm, keep, 32))
        for b in range(B):
            r1, p1 = gridops.rank_in_cell_plain(cell[b], pri[b], arr[b], valid[b], 20)
            want = ((r1, p1), gridops.kept_order_stats_plain(p1, keep[b], cell[b], valid[b], 20),
                    gridops.compact_kept_plain(p1, keep[b], 32))
            for g, w in zip(got, want):
                assert all(torch.equal(x[b], y) for x, y in zip(g, w)), f"instance {b}"


# (b) ------------------------------------------------------------------------

VARIANTS = {"default": {}, "compact": {"lk_compact_windows": True},
            "exact_adder_mask": {"exact_adder_mask": True}, "unseeded": {"stereo_seeded": False}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fleet_matches_single_per_instance(stream, variant):
    """run_fleet over B = 3 decorrelated instances (instance b starts 3 b
    frames in) equals run_sequence on each instance's frames, every output
    field bit for bit (tolerance 0), under each front-end configuration;
    the frames are active and the window prunes."""
    cfg = tiny_config(**VARIANTS[variant])
    pb, frames = stream
    state, out = fleet.run_fleet(cfg, fleet_frames(frames), pb.gyro_bias, pb.acc_mean)
    assert out.p.shape == (T, B, 3) and state.filter.cov.shape[0] == B
    assert state.frontend.prev_pyr.batch == B and bool(out.active.all())
    assert int((out.n_prune_feats > 0).sum()) >= B
    for b in range(B):
        _, want = vio.run_sequence(cfg, own_frames(frames, b), pb.gyro_bias, pb.acc_mean)
        assert_same_outputs(out, want, b)


# (c) ------------------------------------------------------------------------

KEEP = 3  # < stereo_seed_min_tracked


def starve(front, inst):
    """All but the first KEEP feature slots of instance ``inst`` invalidated
    (tests/test_fleet.py's starve_one)."""
    F = front.valid.shape[-1]
    keep = torch.arange(F) < KEEP
    sel = torch.arange(front.valid.shape[0]) == inst
    keep = torch.where(sel[:, None], keep[None, :], True)
    return front._replace(valid=front.valid & keep, ids=torch.where(keep, front.ids, -1),
                          lifetime=torch.where(keep, front.lifetime, 0))


def test_fleet_seed_fallback_fires_on_the_starved_instance_alone(stream, monkeypatch):
    """Instance 1 is starved after frame 1: at frame 2 it alone takes the
    unseeded stereo match (one call on its subset beside one seeded call on
    the others'), its seed count is under stereo_seed_min_tracked and the
    others' are not, and every instance equals its single run from the same
    state."""
    cfg = tiny_config()
    fe = cfg.frontend
    assert fe.stereo_seeded and fe.stereo_seed_fallback
    pb, frames = stream
    bframes = fleet_frames(frames, n=6)
    state, _ = fleet.run_fleet(cfg, vio.VioFrame(*(x[:2] for x in bframes)), pb.gyro_bias,
                               pb.acc_mean)
    starved = state._replace(frontend=starve(state.frontend, 1))

    calls, seeds = [], []
    real = pipeline.stereo_match

    def spy(pyr0, pyr1, pts, *args, **kwargs):
        calls.append((pyr0.batch, kwargs.get("init_cam1") is not None))
        return real(pyr0, pyr1, pts, *args, **kwargs)

    monkeypatch.setattr(pipeline, "stereo_match", spy)
    _, out = fleet.run_fleet(cfg, vio.VioFrame(*(x[2:] for x in bframes)), pb.gyro_bias,
                             pb.acc_mean, state=starved,
                             on_frame=lambda k, fe_out, o: seeds.append(fe_out.n_seed.tolist()))
    assert seeds[0][1] < fe.stereo_seed_min_tracked
    assert all(n >= fe.stereo_seed_min_tracked for b, n in enumerate(seeds[0]) if b != 1)
    assert sorted(calls[:2]) == [(1, False), (B - 1, True)]
    assert all(c == (B, True) for c in calls[2:])  # the next frames: no fallback
    monkeypatch.setattr(pipeline, "stereo_match", real)
    for b in range(B):
        one = tree.index(starved, b)
        _, want = vio.run_sequence(cfg, vio.VioFrame(*(x[2:6, b] for x in bframes)),
                                   pb.gyro_bias, pb.acc_mean, state=one)
        assert_same_outputs(out, want, b)


# (d) ------------------------------------------------------------------------

def test_fleet_mixed_activity_publishes_the_skip_row(stream):
    """Instance 1 is inactive on the first 4 frames (its back-end skips,
    the front-end runs), the others active: each instance equals its single
    run, and the inactive rows are the JAX package's skip row (step.py:
    1055-1083)."""
    cfg = tiny_config()
    pb, frames = stream
    bframes = fleet_frames(frames)
    active = bframes.active.clone()
    active[:4, 1] = False
    bframes = bframes._replace(active=active)
    _, out = fleet.run_fleet(cfg, bframes, pb.gyro_bias, pb.acc_mean)
    for b in range(B):
        _, want = vio.run_sequence(cfg, vio.VioFrame(*(x[:, b] for x in bframes)),
                                   pb.gyro_bias, pb.acc_mean)
        assert_same_outputs(out, want, b)
    skip = {"q": torch.tensor([0.0, 0.0, 0.0, 1.0]), "p": torch.zeros(3), "v": torch.zeros(3)}
    for k in range(4):
        assert not bool(out.active[k, 1]) and bool(out.active[k, 0])
        for name, want in skip.items():
            assert torch.equal(getattr(out, name)[k, 1], want)
        for name in ("warn_large_update", "did_reset", "n_features", "n_lost_overflow",
                     "n_update_rows", "n_prune_feats"):
            assert int(getattr(out, name)[k, 1]) == 0, name
        assert int(out.n_cams[k, 1]) == 0
        assert torch.equal(out.timestamp[k, 1], bframes.timestamp[k, 1])
    assert bool(out.active[4:, 1].all())


def test_fleet_mixed_initialization(stream):
    """A fleet state whose instances differ in being initialized (instance 2
    joins fresh beside two instances two frames in, stacked with
    ``utils.tree.stack``) sends each instance down its own branch: the
    first-frame branch on instance 2's subset, the tracked branch on the
    others', and every instance equals its single run from its state."""
    cfg = tiny_config()
    pb, frames = stream
    singles = []
    for b in range(B):
        st = vio.init_vio_state(cfg, pb.gyro_bias, pb.acc_mean, device="cpu")
        if b < 2:
            st, _ = vio.run_sequence(cfg, own_frames(frames, b, n=2), pb.gyro_bias, pb.acc_mean,
                                     state=st)
        singles.append(st)
    state = tree.stack(singles)
    assert state.frontend.prev_pyr.held == (True, True, False)
    cont = vio.VioFrame(*(torch.stack([x[STRIDE * b + (2 if b < 2 else 0):][:4]
                                       for b in range(B)], 1) for x in frames))
    _, out = fleet.run_fleet(cfg, cont, pb.gyro_bias, pb.acc_mean, state=state)
    for b in range(B):
        one = singles[b]._replace(filter=tree.index(state.filter, b))
        _, want = vio.run_sequence(cfg, vio.VioFrame(*(x[:, b] for x in cont)), pb.gyro_bias,
                                   pb.acc_mean, state=one)
        assert_same_outputs(out, want, b)


def test_fleet_entry_points():
    """fleet_config is the identity; init_fleet_state's slices are
    init_vio_state's; make_fleet_step's step equals run_fleet's first step."""
    cfg = tiny_config()
    assert fleet.fleet_config(cfg) is cfg
    gb = np.array([[0.01, 0.0, 0.0], [0.0, 0.02, 0.0]])
    am = np.array([[0.05, 0.02, 9.8], [0.0, 0.1, 9.7]])
    state = fleet.init_fleet_state(cfg, gb, am, 2, device="cpu")
    for b in range(2):
        want = vio.init_vio_state(cfg, gb[b], am[b], device="cpu")
        got = tree.index(state, b)
        assert got.frontend.prev_pyr is None and want.frontend.prev_pyr is None
        for g, w in zip(_leaves(got), _leaves(want)):
            assert torch.equal(g, w)


def _leaves(t):
    if isinstance(t, tuple):
        for x in t:
            yield from _leaves(x)
    elif isinstance(t, torch.Tensor):
        yield t


# (e) ------------------------------------------------------------------------

N_JAX = 3


@pytest.fixture(scope="module")
def jax_fleet_run():
    """JAX's make_fleet_step(tiered=False) over N_JAX frames of B = 2
    decorrelated instances at _tiny_config, compiled once; its states
    before each step and its outputs, as numpy."""
    cfg = _tiny_config()
    pb, cam0, cam1 = render(cfg, N_JAX + 2, world=JStereoWorld, prebatch=j_prebatch_imu)
    step = jfleet.make_fleet_step(cfg, tiered=False)
    n = 2
    state = jfleet.init_fleet_state(cfg, np.tile(pb.gyro_bias, (n, 1)),
                                    np.tile(pb.acc_mean, (n, 1)), n)
    f32 = np.float32
    idx = np.arange(N_JAX)[:, None] + 2 * np.arange(n)[None, :]
    frames = [JVioFrame(
        timestamp=pb.timestamps[i].astype(f32), cam0=cam0[i], cam1=cam1[i],
        imu_t=pb.imu_t[i].astype(f32), imu_w=pb.imu_w[i].astype(f32),
        imu_a=pb.imu_a[i].astype(f32), imu_mask=pb.imu_mask[i],
        fe_mean_w=pb.fe_mean_w[i].astype(f32), fe_dt=pb.fe_dt[i].astype(f32),
        active=pb.active[i]) for i in idx]
    states, outs = [], []
    for fr in frames:
        states.append(jax.tree.map(np.asarray, state))
        state, out = step(state, fr)
        outs.append(jax.tree.map(np.asarray, out))
    return cfg, frames, states, outs


def test_fleet_step_matches_jax_vmap(jax_fleet_run):
    """The port's make_fleet_step against JAX's make_fleet_step(cfg,
    tiered=False) on the same frames, each step from the same JAX state
    (converted with convert.fleet_state_to_torch: uninitialized at frame 0,
    then with each instance's previous cam0 image): the positions within
    1e-3 m and the attitudes within 1e-4 of JAX's, per frame and instance
    (tests/test_torch_slice.py's bars), and the map feature counts within
    one feature (an LK status on its threshold can flip)."""
    cfg, frames, states, outs = jax_fleet_run
    tcfg = TConfig.from_json(cfg.to_json())
    step = fleet.make_fleet_step(tcfg, device="cpu")
    for k, (fr, st, jout) in enumerate(zip(frames, states, outs)):
        prev = frames[k - 1].cam0 if k else np.zeros_like(fr.cam0)
        state = convert.fleet_state_to_torch(st, prev, tcfg, CPU)
        assert (state.frontend.prev_pyr is None) == (k == 0)
        tframe = vio.VioFrame(*(torch.as_tensor(np.asarray(x)) for x in fr))
        _, out = step(state, tframe)
        assert out.p.shape == (2, 3)
        np.testing.assert_array_equal(out.active.numpy(), jout.active)
        np.testing.assert_allclose(out.p.numpy(), jout.p, atol=1e-3, rtol=0)
        np.testing.assert_allclose(out.q.numpy(), jout.q, atol=1e-4, rtol=0)
        assert np.abs(out.n_features.numpy() - jout.n_features).max() <= 1, k
        assert (jout.n_features > 0).all()


def test_fleet_frontend_calls_per_step(stream, monkeypatch):
    """The fleet's front-end calls K7's prediction and K8's selection once a
    tracked step, and K8's first-frame entries once on the first step, each
    on all B instances at once (a leading axis of B)."""
    cfg = tiny_config()
    pb, frames = stream
    calls = []
    targets = ((pipeline, "predict_warp_points"), (pipeline, "select_track"),
               (gridops, "rank_in_cell"), (gridops, "kept_order_stats"),
               (gridops, "compact_kept"))
    for mod, name in targets:
        def spy(x, *args, _real=getattr(mod, name), _name=name):
            calls[-1].append((_name, x.shape[0]))
            return _real(x, *args)

        monkeypatch.setattr(mod, name, spy)
    calls.append([])
    fleet.run_fleet(cfg, fleet_frames(frames, n=4), pb.gyro_bias, pb.acc_mean,
                    on_frame=lambda k, fe_out, o: calls.append([]))
    first = sorted(calls[0])
    assert first == [("compact_kept", B), ("kept_order_stats", B), ("rank_in_cell", B)]
    for step_calls in calls[1:4]:
        assert sorted(step_calls) == [("predict_warp_points", B), ("select_track", B)]
