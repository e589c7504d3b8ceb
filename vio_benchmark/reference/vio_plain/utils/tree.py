# Frozen copy of uav_airvision_tpu_torch/utils/tree.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""Trees with a leading instance axis: a fleet's state, frames and outputs.

NamedTuples nest, ``None`` stays ``None``, a tensor's first axis is the
instance, a ``Pyramid`` batch is one leaf (``Pyramid.instance``,
``Pyramid.select``, ``stack_pyramids``), and a host list (a frame's
``active`` flags) holds one value per instance.  ``split_run`` runs two branches on two subsets of the
instances, each once, and merges their outputs back into instance order:
the port's form of a per-instance ``lax.cond`` under ``vmap``, whose
decision is a host flag per instance.  ``map_leaves`` maps trees leaf by
leaf, ``one`` gives a single instance's tensors a fleet's axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pyramid import Pyramid, stack_pyramids


def _is_node(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def index(tree, b: int):
    """Instance ``b`` of every leaf (views, no copy)."""
    if _is_node(tree):
        return type(tree)(*(index(x, b) for x in tree))
    if isinstance(tree, Pyramid):
        return tree.instance(b)
    if isinstance(tree, (torch.Tensor, list)):
        return tree[b]
    return tree


def map_leaves(fn, *trees):
    """``fn`` leaf by leaf over trees of one structure (NamedTuples of
    tensors); a ``None`` leaf stays ``None``."""
    first = trees[0]
    if _is_node(first):
        return type(first)(*(map_leaves(fn, *xs) for xs in zip(*trees)))
    return None if first is None else fn(*trees)


def one(*xs):
    """Each tensor (or None) with a leading instance axis of one: a single
    instance's call as a fleet's of one."""
    return tuple(x[None] if x is not None else None for x in xs)


def stack(trees):
    """The instances' trees (of tensors, pyramids or None) as one batched
    tree (copies); instances without a pyramid get a placeholder in the
    batch and ``held`` False."""
    first = trees[0]
    if _is_node(first):
        return type(first)(*(stack(xs) for xs in zip(*trees)))
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    pyrs = [t for t in trees if t is not None]
    return stack_pyramids(trees, pyrs[0]) if pyrs else None


def take(tree, idx):
    """The instances ``idx`` (host ints, ascending) of every leaf: the leaf
    itself when ``idx`` is all of them."""
    if _is_node(tree):
        return type(tree)(*(take(x, idx) for x in tree))
    if isinstance(tree, Pyramid):
        return tree.select(idx)
    if isinstance(tree, torch.Tensor):
        if list(idx) == list(range(tree.shape[0])):
            return tree
        return tree[torch.as_tensor(idx, device=tree.device)]
    return tree


def _merge(a, b, inv):
    """Two subsets' leaves concatenated and put back in instance order by
    ``inv``; pyramids are dropped (the caller sets them)."""
    if _is_node(a):
        return type(a)(*(_merge(x, y, inv) for x, y in zip(a, b)))
    if isinstance(a, tuple):
        return tuple(_merge(x, y, inv) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b])[inv.to(a.device)]
    return None


def split_run(flags, run_true, run_false):
    """``run_true(idx)`` on the instances whose host flag is set and
    ``run_false(idx)`` on the others, each once on its subset (not at all on
    an empty one); their output trees (tuples of tensors) merged back into
    instance order."""
    on = [b for b, f in enumerate(flags) if f]
    off = [b for b, f in enumerate(flags) if not f]
    if not off:
        return run_true(on)
    if not on:
        return run_false(off)
    return _merge(run_true(on), run_false(off), torch.as_tensor(np.argsort(on + off)))
