"""Which feature blocks reach the back-end's gate and update, on the CPU.

The bench world (StereoWorld, seed 5) from where its trajectory starts to
move, with the IMU initialised on 40 messages so that every frame is
active, through the port's ``run_sequence``: 50 frames, a 20-camera
window, so that both call sites of K9's row-indexed entry
``feature_block_rows`` run (the lost features' blocks and, once the window
is full, the camera prune's).  Each call's map rows ``sel`` carry padding
(``smallest_k_indices`` fills past the candidates), marked by ``proc``
false.  A block that observes its feature from one view is all
cancellation in float32; these tests show that such blocks only ever come
from the padding, which K9 writes as zeros.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models import vio
from uav_airvision_tpu_torch.models.msckf import step
from uav_airvision_tpu_torch.simulation.world import StereoWorld
from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES = 50
T0 = 1.5  # the bench world's trajectory starts moving here


@pytest.fixture(scope="module")
def recorded_calls():
    """[(prune?, views of each block over its slots, proc, H, r, rows)] of
    every ``feature_block_rows`` call of the run."""
    cfg = euroc_config()
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, imu_init_msgs=40))
    world = StereoWorld(cfg)
    dur = N_FRAMES / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(T0 + dur + 0.1)
    fts = T0 + world.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, cfg.capacity.max_imu_per_frame,
                      cfg.capacity.imu_init_msgs)
    frames = vio.frames_from_prebatch(pb, np.stack(cam0), np.stack(cam1), torch.device("cpu"))
    calls = []
    orig = step.feature_block_rows

    def record(*args, rm=None):
        obs_mask, sel, proc = args[5], args[7], args[8]
        views = (obs_mask[sel] if rm is None else obs_mask[sel][:, rm]).sum(1)
        out = orig(*args, rm=rm)
        calls.append((rm is not None, views, proc.clone(), *out))
        return out

    step.feature_block_rows = record
    try:
        vio.run_sequence(cfg, frames, pb.gyro_bias, pb.acc_mean)
    finally:
        step.feature_block_rows = orig
    return calls


def test_processed_blocks_have_two_views_or_more(recorded_calls):
    """Every block with ``proc`` true observes its feature from >= 3 views
    (a lost candidate needs 3 observations, step.py's ``cand``) or, in the
    prune, from exactly its two slots (``_two_view_features``); both call
    sites run."""
    lost = [c for c in recorded_calls if not c[0]]
    prune = [c for c in recorded_calls if c[0]]
    assert len(lost) >= 10 and len(prune) >= 10
    for _, views, proc, *_ in lost:
        assert bool(proc.any()) and int(views[proc].min()) >= 3
    for _, views, proc, *_ in prune:
        assert bool(proc.any()) and set(views[proc].tolist()) == {2}


def test_one_view_blocks_are_padding_and_zero(recorded_calls):
    """The one-view blocks of the run are padding entries (``proc`` false),
    and the entry writes every padding block as zeros with rows 0."""
    n_one = 0
    for _, views, proc, H, r, rows in recorded_calls:
        n_one += int((views == 1).sum())
        assert not bool(proc[views == 1].any())
        assert not bool(H[~proc].any()) and not bool(r[~proc].any())
        assert not bool(rows[~proc].any())
    assert n_one > 0
