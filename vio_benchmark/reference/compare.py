"""The numbers that decide ``correct``: the program's outputs against the
reference's, on the same frames.

Front-end (``compare_features``), over the features both publish, matched by
id, their gaps being the largest distance between the two sides' (u0, v0,
u1, v1) in pixels of cam0's focal length:

- ``gaps``: every matched feature's gap (the caller pools them over the
  checked stretches and takes quantiles: a single LK track that the two
  sides end apart, which rounding alone can cause, moves the largest gap and
  not the 90th percentile);
- ``feature_set_diff``: the features published by one side and not the
  other, as a share of those published by either.

Filter (``compare_filter``):

- ``pose_gap_m``: the largest distance between the two positions over the
  active instance-steps (inf where the two disagree on which are active);
- ``cov_gap_rel``: after the last step, the largest entry of the two
  covariances' difference over the reference's largest entry, the worst
  instance.
"""

from __future__ import annotations

import math

import torch


def compare_features(prog: dict, ref: dict, focal: float) -> dict:
    """``prog``/``ref`` {"ids", "uv", "mask": (T, n, ...)}."""
    T, n = prog["ids"].shape[:2]
    gaps, diff, either = [], 0, 0
    for t in range(T):
        for i in range(n):
            pa = {int(k): j for j, k in enumerate(prog["ids"][t, i]) if prog["mask"][t, i, j]}
            ra = {int(k): j for j, k in enumerate(ref["ids"][t, i]) if ref["mask"][t, i, j]}
            diff += len(pa.keys() ^ ra.keys())
            either += len(pa.keys() | ra.keys())
            for k in sorted(pa.keys() & ra.keys()):
                d = (prog["uv"][t, i, pa[k]].double() - ref["uv"][t, i, ra[k]].double()).abs().max()
                gaps.append(float(d) * focal if torch.isfinite(d) else math.inf)
    return {"gaps": gaps, "diff": diff, "either": either}


def compare_filter(prog: dict, ref: dict, prog_end: dict, ref_end: dict) -> dict:
    """``prog``/``ref`` {"p", "active": (T, n, ...)}, ``*_end`` {"cov": (n, D, D)}."""
    n = prog["p"].shape[1]
    act = prog["active"].bool()
    if not torch.equal(act, ref["active"].bool()):
        pose = math.inf
    else:
        d = (prog["p"].double() - ref["p"].double()).norm(dim=-1)
        pose = float(d[act].max()) if act.any() else 0.0
        if not math.isfinite(pose):
            pose = math.inf
    cov = 0.0
    for i in range(n):
        P, R = prog_end["cov"][i].double(), ref_end["cov"][i].double()
        e = float((P - R).abs().max()) / max(float(R.abs().max()), 1e-30)
        cov = max(cov, e if math.isfinite(e) else math.inf)
    return {"pose_gap_m": pose, "cov_gap_rel": cov}


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` (the nearest rank at or above it);
    inf for none."""
    if not values:
        return math.inf
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def feature_numbers(parts) -> dict:
    """The front-end's numbers pooled over the checked stretches' feature
    comparisons."""
    gaps = [g for p in parts for g in p["gaps"]]
    diff = sum(p["diff"] for p in parts)
    either = sum(p["either"] for p in parts)
    return {"feature_gap_p50_px": quantile(gaps, 0.5), "feature_gap_p90_px": quantile(gaps, 0.9),
            "feature_gap_p99_px": quantile(gaps, 0.99),
            "feature_gap_max_px": max(gaps) if gaps else math.inf,
            "feature_set_diff": diff / either if either else math.inf,
            "features_matched": len(gaps)}
