"""Inputs of the front-end's per-cell selection (``gridops.select_track``),
made with numpy from a seed, shared by the CPU tests (against the JAX
package) and the card tests (kernel against its plain version).

Cases:
- ``ties``: scores, arrivals and lifetimes from small ranges, 80% of the
  tracked slots and 70% of the candidates valid;
- ``overflow``: half the tracked points in one cell, so that cell (and
  others) overflows and is pruned by lifetime;
- ``invalid``: no tracked slot and no candidate valid;
- ``full``: every slot tracked and the cells filled evenly, so the prune
  keeps min(F, cells x grid_max) entries (n_kept = F where F <= C).

Every case puts tracked points exactly on the cell edges and one float32
ulp either side of them; candidates sit on integer pixels, as FAST's do.
"""

import math

import numpy as np

CASES = ("ties", "overflow", "invalid", "full")


def select_inputs(seed, F, C, case, grid=(4, 5), size=(480, 752), grid_min=3):
    """(curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival,
    ainlier, acam1, next_id) as numpy arrays, then (grid_row, grid_col, H,
    W, grid_min, grid_max): ``select_track``'s arguments."""
    rng = np.random.default_rng(seed)
    gr, gc = grid
    H, W = size
    n_cells = gr * gc
    gmax = C // n_cells
    ch, cw = math.ceil(H / gr), math.ceil(W / gc)
    f32 = np.float32
    curr = rng.uniform([0, 0], [W - 1, H - 1], (F, 2)).astype(f32)
    if case == "overflow":
        curr[: F // 2] = rng.uniform([0, 0], [cw - 1, ch - 1], (F // 2, 2))
    if case == "full":
        cell = np.arange(F) % n_cells
        curr = np.stack([(cell % gc) * cw + rng.uniform(0, cw - 1, F),
                         (cell // gc) * ch + rng.uniform(0, ch - 1, F)], 1).astype(f32)
    # the cell edges, exactly and one ulp either side
    ys = np.concatenate([[f32(k * ch), np.nextafter(f32(k * ch), f32(0)),
                          np.nextafter(f32(k * ch), f32(H))] for k in range(1, gr)])
    xs = np.concatenate([[f32(k * cw), np.nextafter(f32(k * cw), f32(0)),
                          np.nextafter(f32(k * cw), f32(W))] for k in range(1, gc)])
    m = min(F // 2, len(ys), len(xs))
    curr[:m, 1], curr[m:2 * m, 0] = ys[:m], xs[:m]
    cam1_curr = (curr - rng.uniform(0, 30, (F, 1))).astype(f32)
    tracked = rng.uniform(size=F) < 0.8
    if case == "full":
        tracked[:] = True
    ids = rng.integers(0, 5000, F).astype(np.int32)
    lifetime = rng.integers(1, 4, F).astype(np.int32)
    ay, ax = rng.integers(0, H, C), rng.integers(0, W, C)
    apts = np.stack([ax, ay], 1).astype(f32)
    ascore = rng.integers(0, 4, C).astype(np.int32)
    aarrival = rng.integers(0, 5, C).astype(np.int32)
    ainlier = rng.uniform(size=C) < 0.7
    acam1 = (apts - rng.uniform(0, 30, (C, 1))).astype(f32)
    if case == "invalid":
        tracked[:] = False
        ainlier[:] = False
    next_id = np.array(rng.integers(0, 1000), np.int32)
    return ((curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier, acam1,
             next_id), (gr, gc, H, W, grid_min, gmax))
