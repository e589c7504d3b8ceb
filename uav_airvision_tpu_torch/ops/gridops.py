"""Grid bucketing, stable per-cell ranking and compaction, per-cell top-k.

Port of uav_airvision_tpu/ops/gridops.py.  Every function reproduces a
stable lexsort bit for bit.  On CUDA tensors ``dense_grid_topk`` (K5) and
``rank_in_cell``, ``kept_order_stats``, ``compact_kept``,
``smallest_k_indices`` and ``stable_compact_indices`` (K8) launch the kernels
of ``csrc/gridops.cu``; CPU tensors run the plain versions beside them
(``<name>_plain``): the pairwise (n, n) strict-order forms, and for the
top-k the first k of a stable descending sort, which orders ties by flat
index ascending exactly like the JAX package's repeated first-argmax passes.
"""

from __future__ import annotations

import math

import torch

from .. import kernels


def set_drop(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for first-axis indices in
    [0, len(x)], where len(x) drops: a scatter into one extra dump row, so no
    boolean indexing (and no host sync) is needed.  ``idx`` may be a tuple
    whose later entries index the following axes."""
    n = x.shape[0]
    ext = torch.cat([x, x[:1]])
    ext[idx if isinstance(idx, tuple) else (idx,)] = val
    return ext[:n]


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (plain version)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {t.device}")
    return True


def _flat(t: torch.Tensor, dtype, n: int, what: str) -> torch.Tensor:
    """A kernel operand: (n,) of exactly ``dtype`` (a cast could change the
    order the plain version compares in), contiguous."""
    if t.dtype != dtype or t.shape != (n,):
        raise ValueError(f"{what}: expected ({n},) {dtype}, got {tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def smallest_k_indices_plain(key: torch.Tensor, k: int) -> torch.Tensor:
    n = key.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    before = (key[:, None] < key[None, :]) | (
        (key[:, None] == key[None, :]) & (idx[:, None] < idx[None, :]))
    rank = before.sum(0, dtype=torch.int32)
    out = torch.zeros((k,), dtype=torch.int32, device=key.device)
    return set_drop(out, torch.clamp(rank, max=k).long(), idx)


def smallest_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest (key, index) pairs, ascending (a stable
    argsort's first k); slots past the key's length hold 0."""
    if not _on_cuda(key, "K8"):
        return smallest_k_indices_plain(key, k)
    kernels.observe("smallest_k_indices", (key, k))
    n = key.shape[0]
    key = _flat(key, torch.int32, n, "smallest_k_indices key")
    out = torch.empty((k,), dtype=torch.int32, device=key.device)
    kernels.launch("grid_smallest_k", kernels.ptr(key), n, int(k), kernels.ptr(out))
    smallest_k_indices.launches += 1
    return out


def stable_compact_indices_plain(mask: torch.Tensor, fill: int) -> torch.Tensor:
    n = mask.shape[0]
    m32 = mask.to(torch.int32)
    rank = torch.cumsum(m32, 0, dtype=torch.int32) - m32
    out = torch.full((n,), fill, dtype=torch.int32, device=mask.device)
    return set_drop(out, torch.where(mask, rank, n).long(),
                    torch.arange(n, dtype=torch.int32, device=mask.device))


def stable_compact_indices(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Indices where ``mask`` is True, ascending, padded with ``fill``."""
    if not _on_cuda(mask, "K8"):
        return stable_compact_indices_plain(mask, fill)
    kernels.observe("stable_compact_indices", (mask, fill))
    n = mask.shape[0]
    mask = _flat(mask, torch.bool, n, "stable_compact_indices mask")
    out = torch.empty((n,), dtype=torch.int32, device=mask.device)
    kernels.launch("grid_stable_compact", kernels.ptr(mask), n, int(fill), kernels.ptr(out))
    stable_compact_indices.launches += 1
    return out


def cell_of_points(pts, grid_row, grid_col, img_h, img_w):
    grid_h = int(math.ceil(img_h / grid_row))
    grid_w = int(math.ceil(img_w / grid_col))
    row = torch.floor(pts[..., 1] / grid_h).to(torch.int32)
    col = torch.floor(pts[..., 0] / grid_w).to(torch.int32)
    return row * grid_col + col


def rank_in_cell_plain(cell, primary_desc, arrival, valid, n_cells):
    n = cell.shape[0]
    bc = torch.where(valid, cell, n_cells)
    idx = torch.arange(n, dtype=torch.int32, device=cell.device)
    cj, ci = bc[:, None], bc[None, :]
    pj, pi = primary_desc[:, None], primary_desc[None, :]
    aj, ai = arrival[:, None], arrival[None, :]
    tie_pa = (pj == pi) & ((aj < ai) | ((aj == ai) & (idx[:, None] < idx[None, :])))
    in_cell_before = (pj > pi) | tie_pa
    same = cj == ci
    before = (cj < ci) | (same & in_cell_before)
    grank = before.sum(0, dtype=torch.int32)
    rank = (same & in_cell_before).sum(0, dtype=torch.int32)
    perm = torch.zeros((n,), dtype=torch.int32, device=cell.device)
    perm[grank.long()] = idx
    return rank, perm


def rank_in_cell(cell, primary_desc, arrival, valid, n_cells):
    """Stable per-cell rank under (cell asc, primary desc, arrival asc,
    index asc), invalid entries last.  Returns (rank, perm), int32.  The
    kernel takes int32 cells and arrivals and a float32 primary."""
    if not _on_cuda(cell, "K8"):
        return rank_in_cell_plain(cell, primary_desc, arrival, valid, n_cells)
    kernels.observe("rank_in_cell", (cell, primary_desc, arrival, valid, n_cells))
    n = cell.shape[0]
    cell = _flat(cell, torch.int32, n, "rank_in_cell cell")
    primary_desc = _flat(primary_desc, torch.float32, n, "rank_in_cell primary")
    arrival = _flat(arrival, torch.int32, n, "rank_in_cell arrival")
    valid = _flat(valid, torch.bool, n, "rank_in_cell valid")
    kernels.check_cuda(cell, primary_desc, arrival, valid)
    rank = torch.empty((n,), dtype=torch.int32, device=cell.device)
    perm = torch.empty((n,), dtype=torch.int32, device=cell.device)
    kernels.launch("grid_rank_in_cell", kernels.ptr(cell), kernels.ptr(primary_desc),
                   kernels.ptr(arrival), kernels.ptr(valid), n, int(n_cells),
                   kernels.ptr(rank), kernels.ptr(perm))
    rank_in_cell.launches += 1
    return rank, perm


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    n = perm.shape[0]
    pos = torch.zeros((n,), dtype=torch.int32, device=perm.device)
    pos[perm.long()] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return pos


def kept_order_stats_plain(perm, keep, cell, valid, n_cells):
    pos = _inverse(perm)
    before = pos[:, None] < pos[None, :]
    kept_before = keep[:, None] & before
    global_rank = kept_before.sum(0, dtype=torch.int32)
    big_cell = torch.where(valid, cell, n_cells)
    same = big_cell[:, None] == big_cell[None, :]
    cell_rank = (kept_before & same).sum(0, dtype=torch.int32)
    zero = torch.zeros_like(global_rank)
    return (torch.where(keep, global_rank, zero), torch.where(keep, cell_rank, zero),
            keep.sum(dtype=torch.int32))


def kept_order_stats(perm, keep, cell, valid, n_cells):
    """(global_rank, cell_rank, n_kept), int32, of the kept subset in
    ``perm`` order."""
    if not _on_cuda(perm, "K8"):
        return kept_order_stats_plain(perm, keep, cell, valid, n_cells)
    kernels.observe("kept_order_stats", (perm, keep, cell, valid, n_cells))
    n = perm.shape[0]
    perm = _flat(perm, torch.int32, n, "kept_order_stats perm")
    keep = _flat(keep, torch.bool, n, "kept_order_stats keep")
    cell = _flat(cell, torch.int32, n, "kept_order_stats cell")
    valid = _flat(valid, torch.bool, n, "kept_order_stats valid")
    kernels.check_cuda(perm, keep, cell, valid)
    out = torch.empty((2 * n + 1,), dtype=torch.int32, device=perm.device)
    kernels.launch("grid_kept_order_stats", kernels.ptr(perm), kernels.ptr(keep),
                   kernels.ptr(cell), kernels.ptr(valid), n, int(n_cells), kernels.ptr(out[:n]),
                   kernels.ptr(out[n:]), kernels.ptr(out[2 * n:]))
    kept_order_stats.launches += 1
    return out[:n], out[n:2 * n], out[2 * n]


def compact_kept_plain(perm, keep, n_slots):
    n = perm.shape[0]
    pos = _inverse(perm)
    kept_rank = (keep[:, None] & (pos[:, None] < pos[None, :])).sum(0, dtype=torch.int32)
    sel = torch.zeros((n_slots,), dtype=torch.int32, device=perm.device)
    target = torch.where(keep, torch.clamp(kept_rank, max=n_slots), n_slots).long()
    sel = set_drop(sel, target, torch.arange(n, dtype=torch.int32, device=perm.device))
    selm = torch.arange(n_slots, device=perm.device) < keep.sum(dtype=torch.int32)
    return sel, selm


def compact_kept(perm, keep, n_slots):
    """(sel (n_slots,) source indices, selm (n_slots,) bool) of the kept
    entries in ``perm`` order; requires n_kept <= n_slots."""
    if not _on_cuda(perm, "K8"):
        return compact_kept_plain(perm, keep, n_slots)
    kernels.observe("compact_kept", (perm, keep, n_slots))
    n = perm.shape[0]
    perm = _flat(perm, torch.int32, n, "compact_kept perm")
    keep = _flat(keep, torch.bool, n, "compact_kept keep")
    kernels.check_cuda(perm, keep)
    sel = torch.empty((n_slots,), dtype=torch.int32, device=perm.device)
    selm = torch.empty((n_slots,), dtype=torch.bool, device=perm.device)
    kernels.launch("grid_compact_kept", kernels.ptr(perm), kernels.ptr(keep), n, int(n_slots),
                   kernels.ptr(sel), kernels.ptr(selm))
    compact_kept.launches += 1
    return sel, selm


def _cell_shape(H, W, grid_row, grid_col):
    return int(math.ceil(H / grid_row)), int(math.ceil(W / grid_col))


def dense_grid_topk_plain(score: torch.Tensor, grid_row: int, grid_col: int, k: int):
    H, W = score.shape
    cell_h, cell_w = _cell_shape(H, W, grid_row, grid_col)
    ph, pw = cell_h * grid_row, cell_w * grid_col
    padded = torch.full((ph, pw), -1, dtype=score.dtype, device=score.device)
    padded[:H, :W] = score
    cells = (padded.reshape(grid_row, cell_h, grid_col, cell_w)
             .permute(0, 2, 1, 3).reshape(grid_row * grid_col, cell_h * cell_w))
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    cy, cx = idx // cell_w, idx % cell_w
    g = torch.arange(grid_row * grid_col, dtype=torch.int32, device=score.device)
    ys = (g // grid_col)[:, None] * cell_h + cy
    xs = (g % grid_col)[:, None] * cell_w + cx
    return ys, xs, vals


def dense_grid_topk(score: torch.Tensor, grid_row: int, grid_col: int, k: int):
    """Top-k pixels per grid cell of a dense (H, W) score map, ordered by
    (value desc, in-cell flat index asc).  Returns (ys, xs, vals), each
    (grid_row*grid_col, k); vals <= 0 are empty slots (cells pad with -1).
    The kernel takes an int32 map; its limits on k (K5) and on n (K8: one
    block, one thread per element) are ``kMaxK`` and ``kMaxN`` in
    ``csrc/gridops.cu``, and a call past them raises from the launch."""
    if not _on_cuda(score, "K5"):
        return dense_grid_topk_plain(score, grid_row, grid_col, k)
    kernels.observe("dense_grid_topk", (score, grid_row, grid_col, k))
    if score.dtype != torch.int32 or score.ndim != 2:
        raise ValueError(f"K5 takes a (H, W) int32 map, got {tuple(score.shape)} {score.dtype}")
    H, W = score.shape
    cell_h, cell_w = _cell_shape(H, W, grid_row, grid_col)
    score = score.contiguous()
    out = torch.empty((3, grid_row * grid_col, k), dtype=torch.int32, device=score.device)
    kernels.launch("grid_topk_i32", kernels.ptr(score), H, W, int(grid_row), int(grid_col),
                   cell_h, cell_w, int(k), kernels.ptr(out[0]), kernels.ptr(out[1]),
                   kernels.ptr(out[2]))
    dense_grid_topk.launches += 1
    return out[0], out[1], out[2]


K8_WRAPPERS = (rank_in_cell, kept_order_stats, compact_kept, smallest_k_indices,
               stable_compact_indices)
for _fn in (dense_grid_topk,) + K8_WRAPPERS:
    _fn.launches = 0
