"""The plain reference held to the JAX package, the system's own reference.

``reference/vio_plain`` is a frozen copy of the port's plain versions, so a
fault in the port's host glue, indexing or algorithm that predates the copy
would sit on both sides of the output check.  This anchors the copy to the
JAX package's outputs, recorded once into
``reference/anchor/jax_tiny_fleet.npz`` (the JAX package's
``make_fleet_step(cfg, tiered=False)`` on the CPU, over the stream stored
beside them): its ``run_fleet`` on the same frames, from its own initial
state, has to give JAX's positions, attitudes, active flags, feature counts
and end covariance.  The stream: the JAX package's ``_tiny_config`` (94x60,
32 feature slots) with an 8-state window and 40 IMU messages of gravity
initialisation, its simulated world from 1.5 s on, B = 2 instances 4 frames
apart, 40 frames each, every one active (an 8-state window, so that within
10 frames the window prunes).  Recorded readings: positions within 1.5e-5 m of JAX's, attitudes
within 1.3e-6, feature counts equal, end covariance within 9.3e-5 of its
largest entry.  Planted in the copy, an observation noise 10% too large
reads 9.1e-4 m and 6.0e-2, an LK capped at 9 steps 3.3e-2 m.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vio_benchmark.reference.vio_plain.config import Config
from vio_benchmark.reference.vio_plain.models import vio
from vio_benchmark.reference.vio_plain.parallel import fleet

ANCHOR = Path(__file__).resolve().parents[1] / "reference" / "anchor" / "jax_tiny_fleet.npz"
T, B, STRIDE = 40, 2, 4


@pytest.fixture(scope="module")
def run():
    d = dict(np.load(ANCHOR))
    idx = np.arange(T)[:, None] + STRIDE * np.arange(B)[None, :]
    cfg = Config.from_json(str(d["config"]))
    frames = vio.VioFrame(*(torch.as_tensor(d["in_" + f][idx]) for f in vio.VioFrame._fields))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    try:
        state, out = fleet.run_fleet(cfg, frames, d["gyro_bias"], d["acc_mean"])
    finally:
        torch.set_num_threads(threads)
    return d, state, out


def test_positions_and_attitudes_match_jax(run):
    d, _, out = run
    assert np.array_equal(out.active.numpy(), d["jax_active"]) and d["jax_active"].all()
    gap = np.linalg.norm(out.p.numpy().astype(np.float64) - d["jax_p"], axis=-1)
    assert gap.max() <= 1e-4, gap.max(axis=1)
    assert np.abs(out.q.numpy() - d["jax_q"]).max() <= 1e-5


def test_feature_counts_and_covariance_match_jax(run):
    d, state, out = run
    np.testing.assert_array_equal(out.n_features.numpy(), d["jax_n_features"])
    cov, ref = state.filter.cov.double().numpy(), d["jax_cov"].astype(np.float64)
    for b in range(B):
        assert np.abs(cov[b] - ref[b]).max() <= 1e-3 * np.abs(ref[b]).max(), b
