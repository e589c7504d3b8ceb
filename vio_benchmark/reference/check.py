"""The plain reference's side of the output check: steps of the frozen plain
path (``vio_plain``, a copy of the port's plain PyTorch versions) on the CPU.

``run_steps`` runs a fleet of sampled instances over their frames from the
reference's own initial state (the check of a sweep's start) and returns
what each step published and the state after the last step.  ``run_split``
follows the program over a later stretch from the program's state at its
start, handed over as plain data (``import_state``; the previous frame's
pyramid is built again here from that frame): the front-end on its own,
and the back-end on its own fed the features the program published, so
that a front-end decision the two sides take apart does not move the
filter's numbers.

The control (``control=True``) is the reference one precision step down:
``tf32()`` computes every float32 matrix product with its inputs rounded to
TF32 (10-bit mantissa, round to nearest even), as the card's tensor cores
take them when TF32 is on, and ``bf16_lk()`` holds the LK tracker's
templates, gradients and sampled windows in bfloat16 (the front-end has no
matrix product; its pyramids are whole grey levels, which bfloat16 holds
exactly).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import NamedTuple

import numpy as np
import torch

from .vio_plain.config import Config
from .vio_plain.models import vio
from .vio_plain.models.frontend import pipeline
from .vio_plain.models.frontend.params import make_frontend_params
from .vio_plain.models.msckf import state as mstate
from .vio_plain.models.msckf.state import make_params
from .vio_plain.models.msckf.step import backend_step_fleet
from .vio_plain.ops import lk, pyramid
from .vio_plain.parallel import fleet

class Features(NamedTuple):
    """What the back-end takes of a front-end's output."""

    ids: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor


_TYPES = {"VioState": vio.VioState, "FrontendState": pipeline.FrontendState,
          "FilterState": mstate.FilterState, "ImuState": mstate.ImuState,
          "CamWindow": mstate.CamWindow, "FeatureTable": mstate.FeatureTable}


def plain_config(config: dict) -> Config:
    return Config.from_json(json.dumps(config))


def import_state(d):
    """The reference's state from plain data: {"type", "fields"} for a
    named tuple, {"pyramid": {...}} for a pyramid, tensors as they are."""
    if isinstance(d, dict) and "type" in d:
        return _TYPES[d["type"]](*(import_state(x) for x in d["fields"]))
    if isinstance(d, dict) and "pyramid" in d:
        p = dict(d["pyramid"])
        return pyramid.Pyramid(p.pop("flat"), **p)
    if isinstance(d, list):
        return type(d)(import_state(x) for x in d)
    return d


def _round_tf32(x):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32).view(x.shape)


@contextlib.contextmanager
def tf32():
    """Inside, float32 matrix products (``@``, matmul, mm, bmm, einsum)
    round their inputs to TF32."""
    saved = [(torch.Tensor, "__matmul__"), (torch.Tensor, "__rmatmul__"),
             (torch.Tensor, "matmul"), (torch.Tensor, "mm"), (torch.Tensor, "bmm"),
             (torch, "matmul"), (torch, "mm"), (torch, "bmm"), (torch, "einsum")]
    originals = [(owner, name, getattr(owner, name)) for owner, name in saved]

    def rounded(fn):
        def call(*args, **kwargs):
            args = [[_round_tf32(a) for a in x] if isinstance(x, (list, tuple))
                    and not isinstance(x, torch.Size) else _round_tf32(x) for x in args]
            return fn(*args, **kwargs)
        return call

    try:
        for owner, name, fn in originals:
            setattr(owner, name, rounded(fn))
        yield
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def _round_bf16(x):
    return x.to(torch.bfloat16).to(x.dtype) if x.dtype == torch.float32 else x


@contextlib.contextmanager
def bf16_lk():
    """Inside, the LK tracker's templates and gradients (``lk._template``)
    and its bilinear samples (``lk._sample``) are rounded to bfloat16."""
    template, sample = lk._template, lk._sample

    def rounded_template(*args, **kwargs):
        I, ix, iy, c = template(*args, **kwargs)
        return _round_bf16(I), _round_bf16(ix), _round_bf16(iy), c

    def rounded_sample(*args, **kwargs):
        return _round_bf16(sample(*args, **kwargs))

    try:
        lk._template, lk._sample = rounded_template, rounded_sample
        yield
    finally:
        lk._template, lk._sample = template, sample


@contextlib.contextmanager
def lower_precision(control: bool):
    """The control's precision (``tf32()`` and ``bf16_lk()``), or none."""
    if not control:
        yield
        return
    with tf32(), bf16_lk():
        yield


def run_steps(config: dict, frames: dict, gyro_bias, acc_mean, control=False):
    """The reference over ``frames`` ({field: (T, n, ...) CPU tensor}) from
    its own initial state (from the instances' ``gyro_bias`` and
    ``acc_mean``).  Returns ({"ids", "uv", "mask", "p",
    "q", "active": (T, n, ...)}, {"p", "q", "cov": (n, ...)} after the last
    step)."""
    cfg = plain_config(config)
    vf = vio.VioFrame(*(frames[f] for f in vio.VioFrame._fields))
    steps = []

    def on_frame(k, fe, out):
        steps.append({"ids": fe.ids, "uv": fe.uv, "mask": fe.mask, "p": out.p, "q": out.q,
                      "active": out.active})

    with lower_precision(control):
        st, _ = fleet.run_fleet(cfg, vf, np.asarray(gyro_bias), np.asarray(acc_mean), on_frame=on_frame)
    pub = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return pub, {"p": st.filter.imu.p, "q": st.filter.imu.q, "cov": st.filter.cov}


def run_split(config: dict, prev: dict, frames: dict, published: dict, state, control=False):
    """The reference over a later stretch's ``frames`` ({field: (T, n, ...)
    CPU tensor}) from the program's ``state`` (plain data) at its start,
    whose previous frame is ``prev`` ({"cam0", "cam1": (n, H, W)}): the
    front-end from the program's front-end state, and the back-end from the
    program's filter state fed the program's ``published`` features
    ({"ids", "uv", "mask": (T, n, ...)}).  Returns ({"ids", "uv", "mask"}
    of the front-end, {"p", "q", "active"} of the back-end, each (T, n,
    ...), and {"p", "q", "cov"} of the back-end after the last step)."""
    cfg = plain_config(config)
    dev = torch.device("cpu")
    fparams, mparams = make_frontend_params(cfg, dev), make_params(cfg, dev)
    st = import_state(state)
    fe_state = st.frontend
    if fe_state.prev_pyr is not None:  # None while no instance is initialized
        pyr, _ = pyramid.build_pyramid_pair(prev["cam0"], prev["cam1"],
                                            cfg.frontend.pyramid_levels)
        fe_state = fe_state._replace(prev_pyr=dataclasses.replace(pyr,
                                                                  held=fe_state.prev_pyr.held))
    filt = st.filter
    vf = vio.VioFrame(*(frames[f] for f in vio.VioFrame._fields))
    active = vf.active.tolist()
    fe_steps, be_steps = [], []
    with lower_precision(control):
        for k in range(vf.timestamp.shape[0]):
            frame = vio.VioFrame(*(x[k] for x in vf))
            fe_state, fe_out = pipeline.frontend_step_fleet(
                fe_state, frame.cam0, frame.cam1, frame.fe_mean_w, frame.fe_dt, fparams, cfg)
            fe_steps.append({"ids": fe_out.ids, "uv": fe_out.uv, "mask": fe_out.mask})
            feats = Features(published["ids"][k], published["uv"][k], published["mask"][k])
            filt, out = backend_step_fleet(filt, vio._backend_frame(frame, feats, filt.cov.dtype,
                                                                    active[k]), mparams, cfg)
            be_steps.append({"p": out.p, "q": out.q, "active": out.active})
    fe = {k: torch.stack([s[k] for s in fe_steps]) for k in fe_steps[0]}
    be = {k: torch.stack([s[k] for s in be_steps]) for k in be_steps[0]}
    return fe, be, {"p": filt.imu.p, "q": filt.imu.q, "cov": filt.cov}
