"""The PyTorch port's own copy of uav_airvision_tpu/evaluation/metrics.py: same names, same
behaviour (tests/test_torch_standalone.py holds the two equal).

Trajectory evaluation: ATE / RTE with SE(3) (Umeyama) alignment.

The reference repo ships result CSVs/plots but not the evaluation scripts
(README references them; they are absent — SURVEY.md section 4).  This module
fills that gap: metrics match the standard EuRoC evaluation protocol and the
`metrics_summary.csv` schema (reference results/metrics_summary.csv).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

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


def rte(t_est, p_est, t_gt, p_gt, delta_s=1.0):
    """Relative trajectory error over delta_s-second segments."""
    ei, gi = associate(np.asarray(t_est), np.asarray(t_gt))
    te = np.asarray(t_est)[ei]
    pe = np.asarray(p_est)[ei]
    pg = np.asarray(p_gt)[gi]
    errs = []
    j = 0
    for i in range(len(te)):
        while j < len(te) and te[j] < te[i] + delta_s:
            j += 1
        if j >= len(te):
            break
        d_est = pe[j] - pe[i]
        d_gt = pg[j] - pg[i]
        errs.append(np.linalg.norm(d_est - d_gt))
    errs = np.asarray(errs)
    if len(errs) == 0:
        return dict(rmse=np.nan, mean=np.nan, std=np.nan, n=0)
    return dict(
        rmse=float(np.sqrt(np.mean(errs**2))),
        mean=float(errs.mean()),
        std=float(errs.std()),
        n=int(len(errs)),
    )


def write_metrics_summary(path, rows):
    """rows: list of dicts with keys matching the reference CSV schema:
    dataset, ate_rmse, ate_mean, ate_std, rte_rmse, rte_mean, rte_std, ate_perc."""
    fields = [
        "dataset", "ate_rmse", "ate_mean", "ate_std",
        "rte_rmse", "rte_mean", "rte_std", "ate_perc",
    ]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=fields)
        wr.writeheader()
        for r in rows:
            wr.writerow({k: r.get(k, "") for k in fields})


def load_trajectory_txt(path):
    """Read the output txt format: timestamp px py pz qx qy qz qw."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
