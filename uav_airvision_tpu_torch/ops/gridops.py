"""Grid bucketing, stable per-cell ranking and compaction, per-cell top-k.

Port of uav_airvision_tpu/ops/gridops.py.  Every function reproduces a
stable lexsort bit for bit.  On CUDA tensors ``dense_grid_topk`` (K5) and
``rank_in_cell``, ``kept_order_stats``, ``compact_kept``,
``smallest_k_indices`` and ``stable_compact_indices`` (K8) launch the kernels
of ``csrc/gridops.cu``, as does ``select_track``, the front-end's whole
per-cell selection of a tracked frame (JAX models/frontend/pipeline.py:
388-440) in one K8 launch; CPU tensors run the plain versions beside them
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


def _drop_scatter(idx: torch.Tensor, val: torch.Tensor, n_out: int, fill: int):
    """(..., n_out) int32 holding ``fill`` and ``val`` scattered along the
    last axis at ``idx``, where an index of n_out drops (a dump column)."""
    out = torch.full(idx.shape[:-1] + (n_out + 1,), fill, dtype=torch.int32,
                     device=idx.device)
    return out.scatter(-1, idx, val.expand(idx.shape))[..., :n_out]


def _instances(x: torch.Tensor, dtype, what: str):
    """A K8 operand of one (n,) or S (S, n) instances: (flat contiguous, S, n)."""
    if x.dtype != dtype or x.dim() not in (1, 2):
        raise ValueError(f"{what}: expected (n,) or (S, n) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    S, n = (1, x.shape[0]) if x.dim() == 1 else x.shape
    return x.contiguous(), S, n


def smallest_k_indices_plain(key: torch.Tensor, k: int) -> torch.Tensor:
    n = key.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    a, b = key[..., :, None], key[..., None, :]
    before = (a < b) | ((a == b) & (idx[:, None] < idx[None, :]))
    rank = before.sum(-2, dtype=torch.int32)
    return _drop_scatter(torch.clamp(rank, max=k).long(), idx, k, 0)


def smallest_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest (key, index) pairs, ascending (a stable
    argsort's first k); slots past the key's length hold 0.  ``key`` (n,),
    or (S, n) for S instances at once (one launch, (S, k) out)."""
    if not _on_cuda(key, "K8"):
        return smallest_k_indices_plain(key, k)
    kernels.observe("smallest_k_indices", (key, k))
    key, S, n = _instances(key, torch.int32, "smallest_k_indices key")
    out = torch.empty(key.shape[:-1] + (k,), dtype=torch.int32, device=key.device)
    kernels.launch("grid_smallest_k", kernels.ptr(key), S, n, int(k), kernels.ptr(out))
    smallest_k_indices.launches += 1
    return out


def stable_compact_indices_plain(mask: torch.Tensor, fill: int) -> torch.Tensor:
    n = mask.shape[-1]
    m32 = mask.to(torch.int32)
    rank = torch.cumsum(m32, -1, dtype=torch.int32) - m32
    return _drop_scatter(torch.where(mask, rank, n).long(),
                         torch.arange(n, dtype=torch.int32, device=mask.device), n, fill)


def stable_compact_indices(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Indices where ``mask`` is True, ascending, padded with ``fill``;
    ``mask`` (n,), or (S, n) for S instances at once (one launch)."""
    if not _on_cuda(mask, "K8"):
        return stable_compact_indices_plain(mask, fill)
    kernels.observe("stable_compact_indices", (mask, fill))
    mask, S, n = _instances(mask, torch.bool, "stable_compact_indices mask")
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    kernels.launch("grid_stable_compact", kernels.ptr(mask), S, n, int(fill), kernels.ptr(out))
    stable_compact_indices.launches += 1
    return out


def cell_of_points(pts, grid_row, grid_col, img_h, img_w):
    grid_h = int(math.ceil(img_h / grid_row))
    grid_w = int(math.ceil(img_w / grid_col))
    # divide by tensors on the points' device: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which floors a few points
    # just below a cell edge into the other cell (the JAX package and K8's
    # select_track divide)
    h = torch.full((), grid_h, dtype=pts.dtype, device=pts.device)
    w = torch.full((), grid_w, dtype=pts.dtype, device=pts.device)
    row = torch.floor(pts[..., 1] / h).to(torch.int32)
    col = torch.floor(pts[..., 0] / w).to(torch.int32)
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


def select_track_plain(curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier,
                       acam1, next_id, grid_row, grid_col, H, W, grid_min, grid_max):
    i32 = torch.int32
    F, C = curr.shape[0], apts.shape[0]
    n_cells = grid_row * grid_col
    dev = curr.device
    tr_cell = cell_of_points(curr, grid_row, grid_col, H, W)
    tr_life = lifetime + 1
    acell = cell_of_points(apts, grid_row, grid_col, H, W)
    arank, aperm = rank_in_cell_plain(acell, ascore.to(torch.float32), aarrival, ainlier,
                                      n_cells)
    akeep = ainlier & (arank < grid_min)
    a_grank, a_crank, a_kept = kept_order_stats_plain(aperm, akeep, acell, ainlier, n_cells)
    aids = torch.where(akeep, next_id + a_grank, -1).to(i32)

    # combine tracked + new, prune per cell
    all_cell = torch.cat([tr_cell, acell])
    all_life = torch.cat([tr_life, torch.ones((C,), dtype=i32, device=dev)])
    all_valid = torch.cat([tracked, akeep])
    all_ids = torch.cat([ids, aids])
    all_cam0 = torch.cat([curr, apts])
    all_cam1 = torch.cat([cam1_curr, acam1])
    arrival = torch.cat([torch.arange(F, dtype=i32, device=dev), F + a_crank.to(i32)])

    cells = torch.arange(n_cells, device=dev)
    onehot = (all_cell[:, None] == cells[None, :]) & all_valid[:, None]
    overflow = onehot.to(i32).sum(0) > grid_max
    of_this = torch.where(all_valid, overflow[all_cell.clamp(0, n_cells - 1).long()], False)
    sort_life = torch.where(of_this, all_life, 0)
    prank, pperm = rank_in_cell_plain(all_cell, sort_life.to(torch.float32), arrival, all_valid,
                                      n_cells)
    keep = all_valid & (prank < grid_max)
    sel, selm = compact_kept_plain(pperm, keep, F)
    sel = sel.long()
    return (torch.where(selm, all_ids[sel], -1).to(i32),
            torch.where(selm, all_life[sel], 0).to(i32),
            torch.where(selm[:, None], all_cam0[sel], 0.0),
            torch.where(selm[:, None], all_cam1[sel], 0.0),
            selm,
            (next_id + a_kept).to(i32))


def select_track(curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier, acam1,
                 next_id, grid_row, grid_col, H, W, grid_min, grid_max):
    """The per-cell selection of a tracked frame: the stereo-matched
    candidates' best ``grid_min`` per cell become new features (ids from
    ``next_id`` in candidate order), the tracked features (``tracked``, with
    their ``ids`` and ``lifetime``) and the new ones are pruned to
    ``grid_max`` per cell (by lifetime in a cell that overflows), and the
    kept entries fill the F slots in prune order.  Returns the new (ids,
    lifetime, cam0, cam1, valid, next_id).  The kernel takes the F tracked
    and C candidate entries as the front-end makes them: float32 (F, 2) and
    (C, 2) points, int32 ids, lifetimes, scores and arrivals, bool flags and
    a 0-dim int32 ``next_id``."""
    args = (curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier, acam1,
            next_id, grid_row, grid_col, H, W, grid_min, grid_max)
    if not _on_cuda(curr, "K8"):
        return select_track_plain(*args)
    kernels.observe("select_track", args)
    F, C = curr.shape[0], apts.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for t, dtype, shape in ((curr, f32, (F, 2)), (cam1_curr, f32, (F, 2)), (tracked, b8, (F,)),
                            (ids, i32, (F,)), (lifetime, i32, (F,)), (apts, f32, (C, 2)),
                            (ascore, i32, (C,)), (aarrival, i32, (C,)), (ainlier, b8, (C,)),
                            (acam1, f32, (C, 2)), (next_id, i32, ())):
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"select_track: expected contiguous {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    # one allocation: the outputs (ids, lifetime, cam0, cam1, next_id,
    # valid), then the working arrays where they outgrow shared memory
    n_out = (24 * F + 4 + F + 15) // 16 * 16
    ws = 16 * (F + C) + 4 * (2 * C + grid_row * grid_col + F) + F + C  # gridops.cu select_bytes
    buf = torch.empty((n_out + ws if ws > kernels.SMEM_PER_BLOCK else n_out,),
                      dtype=torch.uint8, device=curr.device)
    base = buf.data_ptr()
    kernels.launch("grid_select_track_f32", curr.data_ptr(), cam1_curr.data_ptr(),
                   tracked.data_ptr(), ids.data_ptr(), lifetime.data_ptr(), F, apts.data_ptr(),
                   ascore.data_ptr(), aarrival.data_ptr(), ainlier.data_ptr(), acam1.data_ptr(), C,
                   next_id.data_ptr(), int(grid_row), int(grid_col), int(H), int(W),
                   int(grid_min), int(grid_max), base,
                   base + n_out if buf.shape[0] > n_out else None)
    select_track.launches += 1
    ints = buf[:24 * F + 4].view(i32)
    pts = ints[2 * F:6 * F].view(f32)
    return (ints[:F], ints[F:2 * F], pts[:2 * F].view(F, 2), pts[2 * F:].view(F, 2),
            buf[24 * F + 4:25 * F + 4].view(b8), ints[6 * F])


def _cell_shape(H, W, grid_row, grid_col):
    return int(math.ceil(H / grid_row)), int(math.ceil(W / grid_col))


def dense_grid_topk_plain(score: torch.Tensor, grid_row: int, grid_col: int, k: int):
    """Plain version of K5: ``score`` (H, W), or (B, H, W) of B maps."""
    lead, (H, W) = score.shape[:-2], score.shape[-2:]
    cell_h, cell_w = _cell_shape(H, W, grid_row, grid_col)
    ph, pw = cell_h * grid_row, cell_w * grid_col
    padded = torch.full((*lead, ph, pw), -1, dtype=score.dtype, device=score.device)
    padded[..., :H, :W] = score
    cells = (padded.reshape(*lead, grid_row, cell_h, grid_col, cell_w)
             .transpose(-3, -2).reshape(*lead, grid_row * grid_col, cell_h * cell_w))
    vals, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k].to(torch.int32)
    cy, cx = idx // cell_w, idx % cell_w
    g = torch.arange(grid_row * grid_col, dtype=torch.int32, device=score.device)
    ys = (g // grid_col)[:, None] * cell_h + cy
    xs = (g % grid_col)[:, None] * cell_w + cx
    return ys, xs, vals


def dense_grid_topk(score: torch.Tensor, grid_row: int, grid_col: int, k: int):
    """Top-k pixels per grid cell of a dense (H, W) score map, ordered by
    (value desc, in-cell flat index asc).  Returns (ys, xs, vals), each
    (grid_row*grid_col, k); vals <= 0 are empty slots (cells pad with -1).
    B maps (B, H, W) give (B, grid_row*grid_col, k) each, in one launch.
    The kernel takes an int32 map and any k up to the cell's pixel count."""
    if not _on_cuda(score, "K5"):
        return dense_grid_topk_plain(score, grid_row, grid_col, k)
    kernels.observe("dense_grid_topk", (score, grid_row, grid_col, k))
    out = _grid_topk_kernel(score, grid_row, grid_col, k)
    dense_grid_topk.launches += 1
    return out[0], out[1], out[2]


def _grid_topk_kernel(score, grid_row, grid_col, k, clocks=None):
    """K5's launch.  ``clocks``: an int64 (7,) tensor for the SM clock of the
    first cell's first block at its start and at the end of each of its
    phases."""
    if score.dtype != torch.int32 or score.ndim not in (2, 3):
        raise ValueError(f"K5 takes a (H, W) or (B, H, W) int32 map, got {tuple(score.shape)} "
                         f"{score.dtype}")
    B = score.shape[0] if score.ndim == 3 else 1
    H, W = score.shape[-2:]
    cell_h, cell_w = _cell_shape(H, W, grid_row, grid_col)
    score = score.contiguous()
    out = torch.empty((3, *score.shape[:-2], grid_row * grid_col, k), dtype=torch.int32,
                      device=score.device)
    kernels.launch("grid_topk_i32", kernels.ptr(score), B, H, W, int(grid_row), int(grid_col),
                   cell_h, cell_w, int(k), kernels.ptr(out[0]), kernels.ptr(out[1]),
                   kernels.ptr(out[2]), kernels.ptr(clocks) if clocks is not None else None)
    return out


K8_WRAPPERS = (rank_in_cell, kept_order_stats, compact_kept, smallest_k_indices,
               stable_compact_indices)
for _fn in (dense_grid_topk, select_track) + K8_WRAPPERS:
    _fn.launches = 0
