"""The single back-end step where the update rows overrun their buffer.

The lost-feature pass admits blocks while their row prefix is at most the
reference's 1,500-row cap, and the stacked prune (``filter.prune_rank12 =
False``) places every gated 5-row block, so both can place rows past a
``max_update_rows`` / ``max_prune_rows`` buffer smaller than what they
admit.  The JAX package scatters those rows with ``mode="drop"``
(``uav_airvision_tpu/models/msckf/step.py:360-369``); the port's
``_stack_blocks`` sends them to its sentinel row, which is cut off.

Two cases, float64, each over a whole back-end sequence of the oracle
scenario:
- ``lost``: 120 landmarks lost at once after 4 observations (the scenario
  of ``test_lost_overflow_second_pass_matches_jax``): the first pass admits
  832 rows into a 200-row buffer;
- ``prune``: the stacked prune with a 64-row buffer: up to 18 two-view
  features of 5 rows each.
Each is held to JAX's ``backend_step`` on the same inputs (the bars of
``tests/test_torch_backend.py``'s sequences), and each frame of the single
step to ``backend_step_fleet`` at B = 1, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from tests.oracle.synthetic import make_scenario
from tests.test_torch_backend import compare_sequences, port_config, scenario_inputs
from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu.models.msckf import state as jstate
from uav_airvision_tpu.models.msckf import step as jstep
from uav_airvision_tpu_torch.models.msckf import state as tstate
from uav_airvision_tpu_torch.models.msckf import step as tstep
from uav_airvision_tpu_torch.utils import tree
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def lost_case():
    """Every feature lost at once after exactly 4 observations, 200 rows."""
    cfg = euroc_config(dtype="float64")
    base = make_scenario(euroc_config(), duration=4.0, n_landmarks=120, track_len=80, seed=11)
    kcut = len(base.frames) - 8
    k0 = kcut - 4
    sc = dataclasses.replace(base, frames=[(t, meas if k0 <= k < kcut else [])
                                           for k, (t, meas) in enumerate(base.frames)])
    cap = dataclasses.replace(cfg.capacity, max_update_rows=200)
    return dataclasses.replace(cfg, capacity=cap), sc


def prune_case():
    """The stacked camera prune into a 64-row buffer."""
    cfg = euroc_config(dtype="float64")
    cap = dataclasses.replace(cfg.capacity, max_prune_rows=64)
    filt = dataclasses.replace(cfg.filter, prune_rank12=False)
    return (dataclasses.replace(cfg, capacity=cap, filter=filt),
            make_scenario(euroc_config(), duration=4.0, seed=3))


def frame_input(f):
    return tstep.FrameInput(**{k: (v if k == "active" else torch.as_tensor(v))
                               for k, v in f.items()})


def fleet_of_one(fr):
    return tstep.FrameInput(*(x[None] for x in fr[:-1]), active=[fr.active])


def leaves(t, name=""):
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        for n, x in zip(t._fields, t):
            yield from leaves(x, f"{name}.{n}")
    elif isinstance(t, torch.Tensor):
        yield name, t


@pytest.mark.parametrize("case", ["lost", "prune"])
def test_rows_past_the_buffer_dropped_as_jax(case):
    """The single step runs where the rows overrun the buffer (the parent's
    ``_stack_blocks`` raised an index error there), drops them as JAX does
    (per-frame poses within 1e-6 m of JAX's ``backend_step``, the second
    pass's 1e-5 m in the lost case) and equals ``backend_step_fleet`` at
    B = 1 bit for bit, state and outputs, on every frame."""
    cfg, sc = lost_case() if case == "lost" else prune_case()
    tcfg = port_config(cfg)
    cap = tcfg.capacity
    frames = scenario_inputs(cfg, sc)
    params = tstate.make_params(tcfg, CPU)
    state = tstate.init_state(tcfg, params, sc.gyro_bias, sc.acc_mean)
    outs = []
    for k, f in enumerate(frames):
        fr = frame_input(f)
        new, out = tstep.backend_step(state, fr, params, tcfg)
        fst, fout = tstep.backend_step_fleet(tree.stack([state]), fleet_of_one(fr), params, tcfg)
        for name, got, want in zip(out._fields, fout, out):
            assert torch.equal(got[0], want.to(got.dtype)), f"frame {k}: output {name}"
        for (name, got), (_, want) in zip(leaves(tree.index(fst, 0)), leaves(new)):
            assert torch.equal(got, want), f"frame {k}: state{name}"
        state = new
        outs.append(out)
    if case == "lost":
        # the first pass admitted more rows than the buffer holds
        assert max(int(o.n_update_rows) for o in outs) > cap.max_update_rows
    else:
        # some prune placed more gated 5-row blocks than the buffer holds
        assert max(int(o.n_prune_feats) for o in outs) * 5 > cap.max_prune_rows
    jparams = jstate.make_params(cfg, dtype=jnp.float64)
    jax_step = jax.jit(functools.partial(jstep.backend_step, params=jparams, config=cfg))
    n_prune, n_lost = compare_sequences(cfg, sc, frames, outs, (jparams, jax_step),
                                        1e-5 if case == "lost" else 1e-6)
    assert (n_lost if case == "lost" else n_prune) > 0
