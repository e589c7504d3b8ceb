"""The VIO model: front-end + MSCKF back-end per frame, and the sequence
runner.  Port of uav_airvision_tpu/models/vio.py (``init_vio_state``,
``vio_step``, ``vio_step_fleet``, ``run_sequence``); PyTorch runs eagerly, so
the sequence runner is a Python loop over frames with the same signature and
``StepOutput`` fields, stacked over time."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..device import get_device, to_host
from .frontend.params import FrontendParams, make_frontend_params
from .frontend.pipeline import (FrontendState, frontend_step, frontend_step_fleet,
                                init_frontend_state)
from .msckf.state import FilterState, MsckfParams, init_state, make_params
from .msckf.step import FrameInput, StepOutput, backend_step, backend_step_fleet


class VioState(NamedTuple):
    frontend: FrontendState
    filter: FilterState


class VioFrame(NamedTuple):
    """Sensor frames; every field has a leading time axis in ``run_sequence``."""

    timestamp: torch.Tensor  # ()
    cam0: torch.Tensor  # (H,W) uint8
    cam1: torch.Tensor  # (H,W) uint8
    imu_t: torch.Tensor  # (I,)
    imu_w: torch.Tensor  # (I,3)
    imu_a: torch.Tensor  # (I,3)
    imu_mask: torch.Tensor  # (I,)
    fe_mean_w: torch.Tensor  # (3,)
    fe_dt: torch.Tensor  # ()
    active: torch.Tensor  # () bool


def frames_from_prebatch(pb, cam0, cam1, device) -> VioFrame:
    """VioFrame (time-leading) from a ``PrebatchedSequence`` and (T,H,W)
    uint8 image stacks, as the JAX package's bench and CLI assemble it."""
    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return VioFrame(
        timestamp=f32(pb.timestamps),
        cam0=torch.as_tensor(np.asarray(cam0), device=device),
        cam1=torch.as_tensor(np.asarray(cam1), device=device),
        imu_t=f32(pb.imu_t), imu_w=f32(pb.imu_w), imu_a=f32(pb.imu_a),
        imu_mask=torch.as_tensor(np.asarray(pb.imu_mask), device=device),
        fe_mean_w=f32(pb.fe_mean_w), fe_dt=f32(pb.fe_dt),
        active=torch.as_tensor(np.asarray(pb.active), device=device))


def init_vio_state(config: Config, gyro_bias=None, acc_mean=None,
                   mparams: MsckfParams = None, device="cuda") -> VioState:
    """The initial state on ``mparams``' device when given, else on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = mparams.obs_noise.device if mparams is not None else get_device(device)
    mparams = mparams or make_params(config, device)
    return VioState(frontend=init_frontend_state(config, device),
                    filter=init_state(config, mparams, gyro_bias, acc_mean))


def vio_step(state: VioState, frame: VioFrame, fparams: FrontendParams,
             mparams: MsckfParams, config: Config, active: bool):
    """Full frame: images -> features -> filter update -> pose.  ``active``
    is ``frame.active`` as a host value.  Returns (state, StepOutput)."""
    state, out, _ = _vio_step(state, frame, fparams, mparams, config, active)
    return state, out


def _backend_frame(frame: VioFrame, fe_out, dtype, active) -> FrameInput:
    return FrameInput(
        timestamp=frame.timestamp.to(dtype), imu_t=frame.imu_t.to(dtype),
        imu_w=frame.imu_w.to(dtype), imu_a=frame.imu_a.to(dtype),
        imu_mask=frame.imu_mask, feat_ids=fe_out.ids, feat_uv=fe_out.uv.to(dtype),
        feat_mask=fe_out.mask, active=active)


def _vio_step(state: VioState, frame: VioFrame, fparams: FrontendParams,
              mparams: MsckfParams, config: Config, active: bool):
    fe_state, fe_out = frontend_step(state.frontend, frame.cam0, frame.cam1,
                                     frame.fe_mean_w, frame.fe_dt, fparams, config)
    filt, out = backend_step(state.filter, _backend_frame(frame, fe_out, state.filter.cov.dtype,
                                                          active), mparams, config)
    return VioState(frontend=fe_state, filter=filt), out, fe_out


def vio_step_fleet(bstate: VioState, bframe: VioFrame, fparams: FrontendParams,
                   mparams: MsckfParams, config: Config, active):
    """B instances' frames (every leaf with a leading instance axis; JAX's
    ``vio_step_fleet``, defined equal to ``vmap(vio_step)``): the batched
    front-end (``frontend_step_fleet``: K2, K4+K6, K5 and K1 launched once for
    the batch), then the batched back-end (``backend_step_fleet``: K14, K13,
    K9 and K10 launched once a stage for the batch).  ``active`` holds the B
    ``bframe.active`` flags as host values.  Returns (state, StepOutput with
    a leading instance axis, FrontendOutput); each instance's slice is its
    ``vio_step``."""
    fe_state, fe_out = frontend_step_fleet(bstate.frontend, bframe.cam0, bframe.cam1,
                                           bframe.fe_mean_w, bframe.fe_dt, fparams, config)
    filt, out = backend_step_fleet(bstate.filter, _backend_frame(
        bframe, fe_out, bstate.filter.cov.dtype, active), mparams, config)
    return VioState(frontend=fe_state, filter=filt), out, fe_out


def run_sequence(config: Config, frames: VioFrame, gyro_bias, acc_mean, fparams=None,
                 mparams=None, state: VioState = None, on_frame=None):
    """Run every frame of ``frames`` (leading time axis) through ``vio_step``.
    Returns (state, StepOutput with a leading time axis).  The device is the
    frames' device.  ``on_frame(k, fe_out, out)``, if given, sees each
    frame's FrontendOutput and StepOutput."""
    device = get_device(str(frames.cam0.device))
    mparams = mparams or make_params(config, device)
    fparams = fparams or make_frontend_params(config, device)
    if state is None:
        state = init_vio_state(config, gyro_bias, acc_mean, mparams)
    active = to_host(frames.active, "run.active")
    outs = []
    for k in range(frames.timestamp.shape[0]):
        frame = VioFrame(*(x[k] for x in frames))
        state, out, fe_out = _vio_step(state, frame, fparams, mparams, config,
                                       bool(active[k]))
        if on_frame is not None:
            on_frame(k, fe_out, out)
        outs.append(out)
    return state, StepOutput(*(torch.stack(xs) for xs in zip(*outs)))


def run_sequence_checkpointed(config: Config, frames: VioFrame, gyro_bias, acc_mean,
                              checkpoint_dir: str, every: int = 200, state: VioState = None):
    """``run_sequence`` with periodic snapshots (``utils/checkpoint.py``; the
    reference has no checkpoint/resume at all — SURVEY.md section 5).

    Runs the sequence in chunks of ``every`` frames, snapshotting the whole
    VioState tree after each chunk.  If ``checkpoint_dir`` already holds a
    snapshot at or before the sequence's end, execution resumes from the
    latest one and only the remaining frames run, giving the bits of an
    uninterrupted run: the state roundtrip is exact and the whole state is
    in the tree.

    Returns (state, outputs, start_frame): ``outputs`` covers frames
    [start_frame, n), the part run in this call (None if none was).
    """
    from ..utils import checkpoint as ckpt

    n = int(frames.timestamp.shape[0])
    device = get_device(str(frames.cam0.device))
    mparams = make_params(config, device)
    fparams = make_frontend_params(config, device)
    if state is None:
        state = init_vio_state(config, gyro_bias, acc_mean, mparams)
    start = 0
    latest = ckpt.latest_step(checkpoint_dir)
    if latest is not None and 0 < latest <= n:
        state, start = ckpt.restore_state(checkpoint_dir, state, latest)
    outs = []
    for k0 in range(start, n, every):
        k1 = min(k0 + every, n)
        chunk = VioFrame(*(x[k0:k1] for x in frames))
        state, out = run_sequence(config, chunk, gyro_bias, acc_mean, fparams, mparams, state)
        ckpt.save_state(checkpoint_dir, state, k1)
        outs.append(out)
    outputs = StepOutput(*(torch.cat(xs) for xs in zip(*outs))) if outs else None
    return state, outputs, start
