"""The generator is deterministic from the seed and differs across seeds."""

import numpy as np
import pytest
import torch

from vio_benchmark.gen import traffic, world
from vio_bench_common import small_config, small_mix


SEED = 2 ** 31 + 11  # past 32 signed bits


def other_order(mix, seed):
    """A seed after ``seed`` that puts the instances in another order."""
    other = seed + 1
    while traffic.instance_order(mix, other) == traffic.instance_order(mix, seed):
        other += 1
    return other


@pytest.fixture(scope="module")
def three():
    conf, mix = small_config()["config"], small_mix(steps=24)
    return (traffic.generate(mix, conf, SEED, "cpu"), traffic.generate(mix, conf, SEED, "cpu"),
            traffic.generate(mix, conf, other_order(mix, SEED), "cpu"))


def test_same_seed_same_inputs(three):
    a, b, _ = three
    for k in traffic.FRAME_FIELDS:
        assert torch.equal(a.frames[k], b.frames[k]), k
    assert np.array_equal(a.gyro_bias, b.gyro_bias) and np.array_equal(a.acc_mean, b.acc_mean)


def test_other_seed_same_work_in_another_order(three):
    a, _, c = three
    assert a.labels != c.labels and sorted(a.labels) == sorted(c.labels)
    perm = [a.labels.index(lab) for lab in c.labels]  # c's instance i is a's perm[i]
    for k in traffic.FRAME_FIELDS:
        assert not torch.equal(a.frames[k], c.frames[k]) or k in ("timestamp", "imu_t", "imu_mask",
                                                                  "fe_dt", "active"), k
        assert torch.equal(a.frames[k][:, perm], c.frames[k]), k
    assert np.array_equal(a.groundtruth[:, perm], c.groundtruth)
    assert np.array_equal(a.gyro_bias[perm], c.gyro_bias)


def test_instances_take_noise_of_their_own(three):
    a = three[0]
    i, j = (a.labels.index(("difficult", o)) for o in (1.0, 40.0))
    assert not torch.equal(a.frames["imu_w"][:, i], a.frames["imu_w"][:, j])
    # the two instances start at rest over the same scene: only the noise tells them apart
    d = (a.frames["cam0"][0, i].float() - a.frames["cam0"][0, j].float()).abs()
    assert 0 < float(d.mean()) < 5


def test_shapes_and_activity(three):
    a = three[0]
    T, B = a.steps, a.batch
    assert (T, B) == (24, 2)
    assert a.frames["cam0"].shape == (T, B, 240, 376) and a.frames["cam0"].dtype == torch.uint8
    act = a.frames["active"]
    assert not act[:20].any() and act[20:].all()  # 200 IMU messages = the first second
    assert 60 < float(a.frames["cam0"].float().mean()) < 200


def test_trajectory_starts_at_rest_and_joins_smoothly():
    tr = world.OffsetTrajectory("difficult", 30.0)
    t = np.array([0.0, 1.0, 1.5])
    assert np.allclose(tr.pos(t), 0.0) and np.allclose(tr.R_i_w(t), np.eye(3))
    ts = np.arange(1.4, 3.0, 0.005)
    v = np.diff(tr.pos(ts), axis=0) / 0.005
    assert np.abs(np.diff(v, axis=0)).max() < 0.05  # no velocity step at the lead-in's end
    assert np.abs(tr.omega_body(np.array([1.0]))).max() == 0.0
    assert np.abs(tr.omega_body(np.array([4.0]))).max() > 0.1
