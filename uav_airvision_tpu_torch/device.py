"""Device and precision setup for the PyTorch port.

The JAX package runs every matmul at HIGHEST precision
(uav_airvision_tpu/utils/precision.py, models/vio.py:153).  The torch
counterpart is to keep TF32 off for both matmuls and cuDNN convolutions, so a
float32 product on the card is a full float32 product.

``host_syncs`` counts the device-to-host reads the port makes on its main
path (every ``.item()``-style branch decision goes through ``to_host``), so a
run can report syncs per frame; the recorder (``utils/profiling.py``), when
on, also counts and times each read by its site.
"""

from __future__ import annotations

import collections

import torch

from .utils import profiling

host_syncs = collections.Counter()


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)`` after the precision setup.  The port runs on the
    card unless the caller asks for the CPU (the CPU tests pass ``"cpu"``);
    raises when a CUDA device is asked for and none is present (never falls
    back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    set_precision()
    return dev


def to_host(t: torch.Tensor, site: str):
    """Read a tensor back to Python (``.tolist()``): one host sync, counted.
    ``site`` names the read (``profiling.SYNC_SITES``): with the recorder on
    it runs under the span ``sync.<site>``, the host's wait for the device to
    drain, and counts ``sync.<site>``."""
    host_syncs["sync"] += 1
    if not profiling.RECORDER.on:
        return t.tolist()
    name = "sync." + site
    profiling.count(name)
    with profiling.span(name):
        return t.tolist()
