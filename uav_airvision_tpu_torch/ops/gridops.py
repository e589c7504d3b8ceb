"""Grid bucketing, stable per-cell ranking and compaction, per-cell top-k.

Port of uav_airvision_tpu/ops/gridops.py.  Every function reproduces a
stable lexsort bit for bit: the pairwise (n, n) strict-order forms are kept
(n is a few hundred) and ``dense_grid_topk`` takes the first k of a stable
descending sort, which orders ties by flat index ascending exactly like the
JAX package's repeated first-argmax passes.
"""

from __future__ import annotations

import math

import torch


def set_drop(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for first-axis indices in
    [0, len(x)], where len(x) drops: a scatter into one extra dump row, so no
    boolean indexing (and no host sync) is needed.  ``idx`` may be a tuple
    whose later entries index the following axes."""
    n = x.shape[0]
    ext = torch.cat([x, x[:1]])
    ext[idx if isinstance(idx, tuple) else (idx,)] = val
    return ext[:n]


def smallest_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest (key, index) pairs, ascending (a stable
    argsort's first k); slots past the key's length hold 0."""
    n = key.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    before = (key[:, None] < key[None, :]) | (
        (key[:, None] == key[None, :]) & (idx[:, None] < idx[None, :]))
    rank = before.to(torch.int32).sum(0)
    out = torch.zeros((k,), dtype=torch.int32, device=key.device)
    return set_drop(out, torch.clamp(rank, max=k).long(), idx)


def stable_compact_indices(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Indices where ``mask`` is True, ascending, padded with ``fill``."""
    n = mask.shape[0]
    m32 = mask.to(torch.int32)
    rank = torch.cumsum(m32, 0, dtype=torch.int32) - m32
    out = torch.full((n,), fill, dtype=torch.int32, device=mask.device)
    return set_drop(out, torch.where(mask, rank, n).long(),
                    torch.arange(n, dtype=torch.int32, device=mask.device))


def cell_of_points(pts, grid_row, grid_col, img_h, img_w):
    grid_h = int(math.ceil(img_h / grid_row))
    grid_w = int(math.ceil(img_w / grid_col))
    row = torch.floor(pts[..., 1] / grid_h).to(torch.int32)
    col = torch.floor(pts[..., 0] / grid_w).to(torch.int32)
    return row * grid_col + col


def rank_in_cell(cell, primary_desc, arrival, valid, n_cells):
    """Stable per-cell rank under (cell asc, primary desc, arrival asc,
    index asc), invalid entries last.  Returns (rank, perm)."""
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
    grank = before.to(torch.int32).sum(0)
    rank = (same & in_cell_before).to(torch.int32).sum(0)
    perm = torch.zeros((n,), dtype=torch.int32, device=cell.device)
    perm[grank.long()] = idx
    return rank, perm


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    n = perm.shape[0]
    pos = torch.zeros((n,), dtype=torch.int32, device=perm.device)
    pos[perm.long()] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return pos


def kept_order_stats(perm, keep, cell, valid, n_cells):
    """(global_rank, cell_rank, n_kept) of the kept subset in ``perm`` order."""
    pos = _inverse(perm)
    before = pos[:, None] < pos[None, :]
    kept_before = keep[:, None] & before
    global_rank = kept_before.to(torch.int32).sum(0)
    big_cell = torch.where(valid, cell, n_cells)
    same = big_cell[:, None] == big_cell[None, :]
    cell_rank = (kept_before & same).to(torch.int32).sum(0)
    zero = torch.zeros_like(global_rank)
    return (torch.where(keep, global_rank, zero), torch.where(keep, cell_rank, zero),
            keep.to(torch.int32).sum())


def compact_kept(perm, keep, n_slots):
    """(sel (n_slots,) source indices, selm (n_slots,) bool) of the kept
    entries in ``perm`` order; requires n_kept <= n_slots."""
    n = perm.shape[0]
    pos = _inverse(perm)
    kept_rank = (keep[:, None] & (pos[:, None] < pos[None, :])).to(torch.int32).sum(0)
    sel = torch.zeros((n_slots,), dtype=torch.int32, device=perm.device)
    target = torch.where(keep, torch.clamp(kept_rank, max=n_slots), n_slots).long()
    sel = set_drop(sel, target, torch.arange(n, dtype=torch.int32, device=perm.device))
    selm = torch.arange(n_slots, device=perm.device) < keep.to(torch.int32).sum()
    return sel, selm


def dense_grid_topk(score: torch.Tensor, grid_row: int, grid_col: int, k: int):
    """Top-k pixels per grid cell of a dense (H, W) score map, ordered by
    (value desc, in-cell flat index asc).  Returns (ys, xs, vals), each
    (grid_row*grid_col, k); vals <= 0 are empty slots (cells pad with -1)."""
    H, W = score.shape
    cell_h = int(math.ceil(H / grid_row))
    cell_w = int(math.ceil(W / grid_col))
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
