# Frozen copy of uav_airvision_tpu_torch/ops/gridops.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
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
Every K8 entry point (and its plain version) takes one instance's arrays
or a fleet's with a leading instance axis: one launch for the fleet, a
block an instance.
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


def _drop_scatter(idx: torch.Tensor, val: torch.Tensor, n_out: int, fill: int):
    """(..., n_out) int32 holding ``fill`` and ``val`` scattered along the
    last axis at ``idx``, where an index of n_out drops (a dump column)."""
    out = torch.full(idx.shape[:-1] + (n_out + 1,), fill, dtype=torch.int32,
                     device=idx.device)
    return out.scatter(-1, idx, val.expand(idx.shape))[..., :n_out]


def _k8_operands(what, fleet, *specs):
    """K8 operands of one instance or (``fleet``) of S instances along a
    leading axis: each (tensor, dtype, shape of one instance) of exactly
    that dtype (a cast could change the order the plain version compares
    in) and shape, contiguous (copied where it is not).  Returns the
    tensors and S."""
    S = specs[0][0].shape[0] if fleet else 1
    lead = (S,) if fleet else ()
    out = []
    for t, dtype, shape in specs:
        if t.dtype != dtype or t.shape != lead + shape:
            raise ValueError(f"{what}: expected {lead + shape} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        out.append(t.contiguous())
    kernels.check_cuda(*out)
    return out, S


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
    n = key.shape[-1]
    (key,), S = _k8_operands("smallest_k_indices key", key.dim() == 2, (key, torch.int32, (n,)))
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
    n = mask.shape[-1]
    (mask,), S = _k8_operands("stable_compact_indices mask", mask.dim() == 2,
                              (mask, torch.bool, (n,)))
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
    n = cell.shape[-1]
    bc = torch.where(valid, cell, n_cells)
    idx = torch.arange(n, dtype=torch.int32, device=cell.device)
    cj, ci = bc[..., :, None], bc[..., None, :]
    pj, pi = primary_desc[..., :, None], primary_desc[..., None, :]
    aj, ai = arrival[..., :, None], arrival[..., None, :]
    tie_pa = (pj == pi) & ((aj < ai) | ((aj == ai) & (idx[:, None] < idx[None, :])))
    in_cell_before = (pj > pi) | tie_pa
    same = cj == ci
    before = (cj < ci) | (same & in_cell_before)
    grank = before.sum(-2, dtype=torch.int32)
    rank = (same & in_cell_before).sum(-2, dtype=torch.int32)
    perm = torch.zeros_like(grank).scatter(-1, grank.long(), idx.expand_as(grank))
    return rank, perm


def rank_in_cell(cell, primary_desc, arrival, valid, n_cells):
    """Stable per-cell rank under (cell asc, primary desc, arrival asc,
    index asc), invalid entries last.  Returns (rank, perm), int32.  The
    kernel takes int32 cells and arrivals and a float32 primary, each (n,)
    or, for S instances at once (one launch, a block an instance), (S, n)."""
    if not _on_cuda(cell, "K8"):
        return rank_in_cell_plain(cell, primary_desc, arrival, valid, n_cells)
    kernels.observe("rank_in_cell", (cell, primary_desc, arrival, valid, n_cells))
    n = cell.shape[-1]
    (cell, primary_desc, arrival, valid), S = _k8_operands(
        "rank_in_cell", cell.dim() == 2, (cell, torch.int32, (n,)),
        (primary_desc, torch.float32, (n,)), (arrival, torch.int32, (n,)),
        (valid, torch.bool, (n,)))
    rank = torch.empty(cell.shape, dtype=torch.int32, device=cell.device)
    perm = torch.empty(cell.shape, dtype=torch.int32, device=cell.device)
    kernels.launch("grid_rank_in_cell", kernels.ptr(cell), kernels.ptr(primary_desc),
                   kernels.ptr(arrival), kernels.ptr(valid), S, n, int(n_cells),
                   kernels.ptr(rank), kernels.ptr(perm))
    rank_in_cell.launches += 1
    return rank, perm


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(perm.shape[-1], dtype=torch.int32, device=perm.device)
    return torch.zeros_like(perm).scatter(-1, perm.long(), idx.expand_as(perm))


def kept_order_stats_plain(perm, keep, cell, valid, n_cells):
    pos = _inverse(perm)
    before = pos[..., :, None] < pos[..., None, :]
    kept_before = keep[..., :, None] & before
    global_rank = kept_before.sum(-2, dtype=torch.int32)
    big_cell = torch.where(valid, cell, n_cells)
    same = big_cell[..., :, None] == big_cell[..., None, :]
    cell_rank = (kept_before & same).sum(-2, dtype=torch.int32)
    zero = torch.zeros_like(global_rank)
    return (torch.where(keep, global_rank, zero), torch.where(keep, cell_rank, zero),
            keep.sum(-1, dtype=torch.int32))


def kept_order_stats(perm, keep, cell, valid, n_cells):
    """(global_rank, cell_rank, n_kept), int32, of the kept subset in
    ``perm`` order; of (n,) entries, or of S instances' (S, n) at once (one
    launch, n_kept (S,))."""
    if not _on_cuda(perm, "K8"):
        return kept_order_stats_plain(perm, keep, cell, valid, n_cells)
    kernels.observe("kept_order_stats", (perm, keep, cell, valid, n_cells))
    n = perm.shape[-1]
    (perm, keep, cell, valid), S = _k8_operands(
        "kept_order_stats", perm.dim() == 2, (perm, torch.int32, (n,)), (keep, torch.bool, (n,)),
        (cell, torch.int32, (n,)), (valid, torch.bool, (n,)))
    out = torch.empty((2 * S * n + S,), dtype=torch.int32, device=perm.device)
    kernels.launch("grid_kept_order_stats", kernels.ptr(perm), kernels.ptr(keep),
                   kernels.ptr(cell), kernels.ptr(valid), S, n, int(n_cells),
                   kernels.ptr(out[:S * n]), kernels.ptr(out[S * n:]),
                   kernels.ptr(out[2 * S * n:]))
    kept_order_stats.launches += 1
    n_kept = out[2 * S * n:]
    return (out[:S * n].view(perm.shape), out[S * n:2 * S * n].view(perm.shape),
            n_kept if perm.dim() == 2 else n_kept[0])


def compact_kept_plain(perm, keep, n_slots):
    n = perm.shape[-1]
    pos = _inverse(perm)
    kept_rank = (keep[..., :, None] & (pos[..., :, None] < pos[..., None, :])).sum(
        -2, dtype=torch.int32)
    target = torch.where(keep, torch.clamp(kept_rank, max=n_slots), n_slots).long()
    sel = _drop_scatter(target, torch.arange(n, dtype=torch.int32, device=perm.device), n_slots, 0)
    selm = torch.arange(n_slots, device=perm.device) < keep.sum(-1, dtype=torch.int32,
                                                                 keepdim=True)
    return sel, selm


def compact_kept(perm, keep, n_slots):
    """(sel (n_slots,) source indices, selm (n_slots,) bool) of the kept
    entries in ``perm`` order, or (S, n_slots) each of S instances' (S, n)
    at once (one launch); requires n_kept <= n_slots."""
    if not _on_cuda(perm, "K8"):
        return compact_kept_plain(perm, keep, n_slots)
    kernels.observe("compact_kept", (perm, keep, n_slots))
    n = perm.shape[-1]
    (perm, keep), S = _k8_operands("compact_kept", perm.dim() == 2, (perm, torch.int32, (n,)),
                                   (keep, torch.bool, (n,)))
    sel = torch.empty(perm.shape[:-1] + (n_slots,), dtype=torch.int32, device=perm.device)
    selm = torch.empty(perm.shape[:-1] + (n_slots,), dtype=torch.bool, device=perm.device)
    kernels.launch("grid_compact_kept", kernels.ptr(perm), kernels.ptr(keep), S, n,
                   int(n_slots), kernels.ptr(sel), kernels.ptr(selm))
    compact_kept.launches += 1
    return sel, selm


def gather_rows(x, sel):
    """x (..., n, k) at sel (..., m): (..., m, k)."""
    return x.gather(-2, sel[..., None].expand(sel.shape + x.shape[-1:]))


def select_track_plain(curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier,
                       acam1, next_id, grid_row, grid_col, H, W, grid_min, grid_max):
    i32 = torch.int32
    F, C = curr.shape[-2], apts.shape[-2]
    lead = curr.shape[:-2]
    n_cells = grid_row * grid_col
    dev = curr.device
    tr_cell = cell_of_points(curr, grid_row, grid_col, H, W)
    tr_life = lifetime + 1
    acell = cell_of_points(apts, grid_row, grid_col, H, W)
    arank, aperm = rank_in_cell_plain(acell, ascore.to(torch.float32), aarrival, ainlier,
                                      n_cells)
    akeep = ainlier & (arank < grid_min)
    a_grank, a_crank, a_kept = kept_order_stats_plain(aperm, akeep, acell, ainlier, n_cells)
    aids = torch.where(akeep, next_id[..., None] + a_grank, -1).to(i32)

    # combine tracked + new, prune per cell
    all_cell = torch.cat([tr_cell, acell], -1)
    all_life = torch.cat([tr_life, torch.ones(lead + (C,), dtype=i32, device=dev)], -1)
    all_valid = torch.cat([tracked, akeep], -1)
    all_ids = torch.cat([ids, aids], -1)
    all_cam0 = torch.cat([curr, apts], -2)
    all_cam1 = torch.cat([cam1_curr, acam1], -2)
    arrival = torch.cat([torch.arange(F, dtype=i32, device=dev).expand(lead + (F,)),
                         F + a_crank.to(i32)], -1)

    cells = torch.arange(n_cells, device=dev)
    onehot = (all_cell[..., :, None] == cells) & all_valid[..., :, None]
    overflow = onehot.to(i32).sum(-2) > grid_max
    of_this = torch.where(all_valid, overflow.gather(-1, all_cell.clamp(0, n_cells - 1).long()),
                          False)
    sort_life = torch.where(of_this, all_life, 0)
    prank, pperm = rank_in_cell_plain(all_cell, sort_life.to(torch.float32), arrival, all_valid,
                                      n_cells)
    keep = all_valid & (prank < grid_max)
    sel, selm = compact_kept_plain(pperm, keep, F)
    sel = sel.long()
    return (torch.where(selm, all_ids.gather(-1, sel), -1).to(i32),
            torch.where(selm, all_life.gather(-1, sel), 0).to(i32),
            torch.where(selm[..., None], gather_rows(all_cam0, sel), 0.0),
            torch.where(selm[..., None], gather_rows(all_cam1, sel), 0.0),
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
    a 0-dim int32 ``next_id``; or a fleet's B instances of each (a leading
    axis, each instance contiguous, read at its instance stride), one
    launch for all (a block an instance), outputs with the leading axis."""
    args = (curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier, acam1,
            next_id, grid_row, grid_col, H, W, grid_min, grid_max)
    if not _on_cuda(curr, "K8"):
        return select_track_plain(*args)
    kernels.observe("select_track", args)
    fleet = curr.dim() == 3
    B = curr.shape[0] if fleet else 1
    lead = (B,) if fleet else ()
    F, C = curr.shape[-2], apts.shape[-2]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ins, strides = [], []
    for t, dtype, shape in ((curr, f32, (F, 2)), (cam1_curr, f32, (F, 2)), (tracked, b8, (F,)),
                            (ids, i32, (F,)), (lifetime, i32, (F,)), (apts, f32, (C, 2)),
                            (ascore, i32, (C,)), (aarrival, i32, (C,)), (ainlier, b8, (C,)),
                            (acam1, f32, (C, 2)), (next_id, i32, ())):
        if t.dtype != dtype or t.shape != lead + shape:
            raise ValueError(f"select_track: expected {lead + shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        t, st = kernels.per_instance(t, dtype, fleet)
        ins.append(t)
        strides.append(st)
    kernels.check_cuda(*(t[0] if fleet else t for t in ins))
    # one allocation: each instance's outputs (ids, lifetime, cam0, cam1,
    # next_id, valid) in a row, then its working arrays where they outgrow
    # shared memory
    n_out = (24 * F + 4 + F + 15) // 16 * 16
    ws = 16 * (F + C) + 4 * (2 * C + grid_row * grid_col + F) + F + C  # gridops.cu select_bytes
    ws = (ws + 15) // 16 * 16 if ws > kernels.SMEM_PER_BLOCK else 0
    buf = torch.empty((B * (n_out + ws),), dtype=torch.uint8, device=curr.device)
    base = buf.data_ptr()
    kernels.launch("grid_select_track_f32", *(t.data_ptr() for t in ins[:5]), F,
                   *(t.data_ptr() for t in ins[5:10]), C, ins[10].data_ptr(), int(grid_row),
                   int(grid_col), int(H), int(W), int(grid_min), int(grid_max), base,
                   base + B * n_out if ws else None, B,
                   kernels.int64s(strides + [n_out if fleet else 0, ws if fleet else 0]))
    select_track.launches += 1
    rows = buf[:B * n_out].view(B, n_out)
    ints = rows[:, :24 * F + 4].view(i32)
    pts = ints[:, 2 * F:6 * F].view(f32)
    out = (ints[:, :F], ints[:, F:2 * F], pts[:, :2 * F].unflatten(-1, (F, 2)),
           pts[:, 2 * F:].unflatten(-1, (F, 2)), rows[:, 24 * F + 4:25 * F + 4].view(b8),
           ints[:, 6 * F])
    return out if fleet else tuple(x[0] for x in out)


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
