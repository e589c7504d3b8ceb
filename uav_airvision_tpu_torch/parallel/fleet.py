"""Fleet: B VIO instances on one card, over a leading instance axis.

Port of uav_airvision_tpu/parallel/fleet.py (``fleet_config`` :34,
``init_fleet_state`` :45, ``make_fleet_step`` :55, ``run_fleet`` :101).  The
JAX package scales over instances (concurrent UAVs, offset sweeps,
sequences) with ``vmap`` and shards the batch over a TPU mesh; here the B
instances share one card and one frame's host work: the front-end's image
kernels (K2, K4+K6, K5 and K1) launch once per frame for the whole batch
(``models/frontend/pipeline.py::frontend_step_fleet``), and the back-end
(``models/msckf/step.py::backend_step_fleet``) reads each decision to the
host once for the batch and launches K14, K13, K9 and K10 once a stage for
the instances that need it (K11 and K12 once per updating instance).  Each
instance's outputs are its single-instance outputs (``run_sequence`` on its
frames), bit for bit.

Not ported: ``place_fleet``, ``default_mesh`` and ``run_fleet``'s ``mesh``
and ``axis`` (they shard over a TPU mesh; this is one card), ``tiered`` and
``bucket`` (they choose a TPU layout and no result: the JAX package defines
every choice of them as equal to ``vmap(vio_step)``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..device import get_device, to_host
from ..models.frontend.params import make_frontend_params
from ..models.msckf.state import make_params
from ..models.msckf.step import StepOutput
from ..models.vio import VioFrame, VioState, init_vio_state, vio_step_fleet
from ..utils import tree
from ..utils.profiling import span


def fleet_config(config: Config) -> Config:
    """The identity, as in the JAX package: a fleet runs every option of the
    single-instance configuration, the stereo-seed fallback included."""
    return config


def init_fleet_state(config: Config, gyro_bias, acc_mean, n: int,
                     device="cuda") -> VioState:
    """Batched initial state: every leaf has a leading instance axis of ``n``,
    and instance b's slice is ``init_vio_state`` of ``gyro_bias[b]`` and
    ``acc_mean[b]`` ((n, 3) each; one (3,) is every instance's).  On the card
    unless the caller passes the CPU."""
    with span("fleet.init"):
        mparams = make_params(config, get_device(str(device)))
        gb = np.array(np.broadcast_to(np.asarray(gyro_bias, np.float64), (n, 3)))
        am = np.array(np.broadcast_to(np.asarray(acc_mean, np.float64), (n, 3)))
        return tree.stack([init_vio_state(config, gb[b], am[b], mparams) for b in range(n)])


def make_fleet_step(config: Config, device="cuda"):
    """``step(bstate, bframe) -> (bstate, StepOutput)`` over a leading
    instance axis (``vio_step_fleet``); each call reads ``bframe.active``
    back from the device once."""
    dev = get_device(device)
    fparams, mparams = make_frontend_params(config, dev), make_params(config, dev)

    def step(bstate: VioState, bframe: VioFrame):
        state, out, _ = vio_step_fleet(bstate, bframe, fparams, mparams, config,
                                       to_host(bframe.active, "fleet.active"))
        return state, out

    return step


def run_fleet(config: Config, frames: VioFrame, gyro_bias, acc_mean, state: VioState = None,
              on_frame=None):
    """Every frame of ``frames`` (each leaf (T, B, ...)) through the fleet
    step, the stacked state carried from frame to frame.  Returns (state,
    StepOutput with (T, B, ...) leaves).  The device is the frames' device;
    the ``active`` flags are read back once for the run.
    ``on_frame(k, fe_out, out)``, if given, sees each frame's batched
    FrontendOutput and StepOutput."""
    device = get_device(str(frames.cam0.device))
    fparams, mparams = make_frontend_params(config, device), make_params(config, device)
    n = frames.timestamp.shape[1]
    if state is None:
        state = init_fleet_state(config, gyro_bias, acc_mean, n, device)
    active = to_host(frames.active, "fleet.active")
    outs = []
    for k in range(frames.timestamp.shape[0]):
        frame = VioFrame(*(x[k] for x in frames))
        with span("fleet.step"):
            state, out, fe_out = vio_step_fleet(state, frame, fparams, mparams, config,
                                                active[k])
        if on_frame is not None:
            on_frame(k, fe_out, out)
        outs.append(out)
    return state, StepOutput(*(torch.stack(xs) for xs in zip(*outs)))
