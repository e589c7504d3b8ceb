"""Trajectory evaluation: ATE with SE(3) (Umeyama) alignment.

Frozen copy of ``umeyama_alignment``, ``associate`` and ``ate`` from
uav_airvision_tpu_torch/evaluation/metrics.py at commit efd1109, unchanged
(the standard EuRoC evaluation protocol).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale=False):
    """Least-squares rigid alignment: find (s, R, t) with y ~ s R x + t.
    x, y: (N, 3)."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xc**2).sum() / len(x)
        s = float(np.trace(np.diag(d) @ S) / var)
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def associate(t_est, t_gt, max_dt=0.02):
    """Nearest-timestamp association.  Returns index pairs (est_idx, gt_idx)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    prev_closer = np.abs(t_gt[j - 1] - t_est) < np.abs(t_gt[j] - t_est)
    j = j - prev_closer.astype(int)
    ok = np.abs(t_gt[j] - t_est) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def ate(t_est, p_est, t_gt, p_gt, align=True):
    """Absolute trajectory error after optional SE(3) alignment."""
    ei, gi = associate(np.asarray(t_est), np.asarray(t_gt))
    pe = np.asarray(p_est)[ei]
    pg = np.asarray(p_gt)[gi]
    if len(pe) < 3:
        return dict(rmse=np.nan, mean=np.nan, std=np.nan, n=len(pe))
    if align:
        s, R, t = umeyama_alignment(pe, pg)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return dict(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        std=float(err.std()),
        n=int(len(err)),
    )
