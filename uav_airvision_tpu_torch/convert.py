"""Conversion between the JAX package's state/parameter trees (taken as
numpy arrays) and the port's tensors, so both packages can start from the
same state.

``to_torch`` maps a NamedTuple tree by class name onto the port's classes
(``FrontendParams``, ``MsckfParams``, ``FilterState`` and its parts) with
``np.array`` on every leaf, so it takes JAX arrays or numpy arrays alike
without importing JAX.  ``to_numpy``
maps the other way into the same port classes holding numpy arrays.

The JAX ``FrontendState.prev_rows`` (banded template rows of the previous
frame) has no counterpart: the port keeps the previous cam0 pyramid, so
``frontend_state_to_torch`` also takes the previous cam0 image, and
``fleet_state_to_torch`` (a JAX fleet state, every leaf with a leading
instance axis) each instance's.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .models.frontend.params import FrontendParams, stereo_geometry
from .models.frontend.pipeline import FrontendState
from .models.msckf.state import CamWindow, FeatureTable, FilterState, ImuState, MsckfParams
from .models.vio import VioState
from .ops.pyramid import build_pyramid_padded

PORT_TYPES = {cls.__name__: cls for cls in (
    FrontendParams, MsckfParams, FilterState, ImuState, CamWindow, FeatureTable)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device):
    """NamedTuple tree of arrays -> the port's NamedTuple tree of tensors.
    The JAX ``FrontendParams`` lacks the stereo geometry (``R0to1``, ``E``)
    that the port forms once: it is formed from the converted fields."""
    if _is_namedtuple(tree):
        cls = PORT_TYPES[type(tree).__name__]
        fields = {f: to_torch(getattr(tree, f), device) for f in cls._fields if hasattr(tree, f)}
        if cls is FrontendParams and "E" not in fields:
            fields["R0to1"], fields["E"] = stereo_geometry(
                fields["R_cam0_imu"], fields["R_cam1_imu"], fields["t_cam0_imu"],
                fields["t_cam1_imu"])
        return cls(**fields)
    return torch.as_tensor(np.array(tree), device=device)


def to_numpy(tree):
    """The port's NamedTuple tree of tensors -> the same classes of numpy arrays."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree.detach().cpu().numpy()


def frontend_state_to_torch(fs, prev_cam0, config: Config, device) -> FrontendState:
    """JAX ``FrontendState`` (arrays) + the previous frame's cam0 image ->
    the port's state, whose ``prev_pyr`` is that image's pyramid.  An
    uninitialized state gets no pyramid.  A fleet's state (leading instance
    axis) takes the (B, H, W) images and gets their batch of pyramids."""
    initialized = np.asarray(fs.initialized, bool)
    prev_pyr = None
    if initialized.any():
        img = torch.as_tensor(np.asarray(prev_cam0, np.uint8), device=device)
        prev_pyr = build_pyramid_padded(img, config.frontend.pyramid_levels)
        if not initialized.all():
            prev_pyr.held = tuple(bool(x) for x in initialized)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    return FrontendState(ids=t(fs.ids), lifetime=t(fs.lifetime), cam0=t(fs.cam0),
                         cam1=t(fs.cam1), valid=t(fs.valid), next_id=t(fs.next_id),
                         prev_pyr=prev_pyr, initialized=t(fs.initialized))


def fleet_state_to_torch(state, prev_cam0, config: Config, device) -> VioState:
    """JAX fleet ``VioState`` (arrays, every leaf with a leading instance
    axis) + each instance's previous cam0 image (B, H, W) -> the port's
    batched ``VioState``: ``prev_pyr`` is the batch of those images'
    pyramids, ``held`` where the instance is initialized (None where every
    instance is; no pyramid where none is)."""
    return VioState(frontend=frontend_state_to_torch(state.frontend, prev_cam0, config, device),
                    filter=to_torch(state.filter, device))
