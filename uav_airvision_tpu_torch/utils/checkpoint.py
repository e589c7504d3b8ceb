"""Checkpoint / resume for the VIO state (the reference has none — SURVEY.md
section 5: its only artifact is the append-only trajectory file).  The
port's counterpart of uav_airvision_tpu/utils/checkpoint.py, with its names
and its ``step_%08d`` naming, on ``torch.save`` in place of orbax.

The whole filter + front-end state is one NamedTuple tree (``VioState``),
saved as one flat dict of tensors (copies) keyed by each leaf's dotted
path.  The front-end's previous pyramid (``FrontendState.prev_pyr``) is the
tree's one optional part: ``None`` until the first frame, then a
``Pyramid`` saved as its flat buffer and its four sizes.  ``models.vio.run_sequence_checkpointed``
snapshots every N frames and resumes mid-sequence after a failure (kill and
resume give the uninterrupted run's bits); the CLI exposes it as
``--checkpoint-dir`` / ``--checkpoint-every``.
"""

from __future__ import annotations

import os

import torch

from ..ops.pyramid import Pyramid, pyramid_size

_PYRAMID_SIZES = ("H0", "W0", "n_levels", "pad")


def _flatten(tree, prefix, out):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}{name}.", out)
    elif isinstance(tree, Pyramid):
        out[f"{prefix}flat"] = tree.flat.clone()
        for name in _PYRAMID_SIZES:
            out[f"{prefix}{name}"] = torch.tensor(getattr(tree, name), dtype=torch.int64)
    elif tree is not None:
        # a copy with storage of its own: on the card some leaves are views
        # of one buffer under several dtypes, which torch.save refuses
        out[prefix[:-1]] = tree.clone()
    return out


def _device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, Pyramid):
        return tree.flat.device
    if isinstance(tree, tuple):
        for x in tree:
            dev = _device(x)
            if dev is not None:
                return dev
    return None


def _pyramid_from(saved, prefix, template, path):
    """The pyramid saved under ``prefix``, held to the template's pyramid
    where it has one, else to the sizes saved beside it."""
    if f"{prefix}flat" not in saved:
        if template is not None:
            raise ValueError(f"{path}: the checkpoint has no pyramid at {prefix[:-1]}")
        return None
    sizes = {name: int(saved[f"{prefix}{name}"]) for name in _PYRAMID_SIZES}
    flat = saved[f"{prefix}flat"]
    want = (template.flat.shape, template.flat.dtype) if template is not None else (
        (pyramid_size(sizes["H0"], sizes["W0"], sizes["n_levels"], sizes["pad"]),),
        torch.float32)
    if (tuple(flat.shape), flat.dtype) != (tuple(want[0]), want[1]) or (
            template is not None and sizes != {n: getattr(template, n) for n in _PYRAMID_SIZES}):
        raise ValueError(f"{path}: the pyramid at {prefix[:-1]} does not match the template")
    return Pyramid(flat, **sizes)


def _unflatten(template, prefix, saved, path):
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, name), f"{prefix}{name}.", saved,
                                           path) for name in template._fields))
    if template is None or isinstance(template, Pyramid):
        return _pyramid_from(saved, prefix, template, path)
    key = prefix[:-1]
    if key not in saved:
        raise ValueError(f"{path}: the checkpoint has no {key}")
    x = saved[key]
    if tuple(x.shape) != tuple(template.shape) or x.dtype != template.dtype:
        raise ValueError(f"{path}: {key} is {x.dtype}{tuple(x.shape)}, the template "
                         f"{template.dtype}{tuple(template.shape)}")
    return x


def _step_path(directory, step):
    return os.path.join(directory, f"step_{step:08d}")


def save_state(directory, state, step: int):
    """Write ``state`` as snapshot ``step`` (a temporary file renamed into
    place, so a killed save leaves no partial snapshot)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = _step_path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_flatten(state, "", {}), tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory):
    if not os.path.isdir(directory):
        return None
    steps = [
        int(n.split("_")[1])
        for n in os.listdir(directory)
        if n.startswith("step_") and n.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_state(directory, template, step: int = None):
    """Restore into the structure of ``template`` (a state of the same
    configuration, e.g. ``init_vio_state``'s) on the template's device; every
    leaf's shape and dtype must match the template's.  Returns (state, step)."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = _step_path(directory, step)
    saved = torch.load(path, weights_only=True, map_location=_device(template))
    return _unflatten(template, "", saved, path), step
