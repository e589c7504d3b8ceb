"""The PyTorch port's own copy of uav_airvision_tpu/evaluation/plots.py: same
functions, matplotlib imported inside them (the card's machine has none, and
nothing on the command line's path imports this module).

Published result-plot artifacts.

The reference ships per-sequence ``trajectories.png`` / ``ate_vs_path.png`` /
``rte_vs_path.png`` and repo-level ``ate_summary.png`` / ``rte_summary.png``
(reference results/MH_01_easy/, results/) but not the scripts that made them
(absent from its repo — SURVEY.md section 4).  This module regenerates the
same artifact set from our evaluation outputs; the error-vs-path percentage
is therefore OUR definition, documented on each function.

Matplotlib only, Agg backend (headless box); every function writes a PNG and
returns its path.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _path_progress(p_gt):
    """Cumulative ground-truth path length at each sample, (N,) meters."""
    seg = np.linalg.norm(np.diff(np.asarray(p_gt, np.float64), axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def plot_trajectories(png_path, p_gt, p_est):
    """Three projections (XY / XZ / YZ) of the aligned estimate over ground
    truth — the reference's ``trajectories.png`` panel layout (GT blue,
    estimate magenta)."""
    plt = _plt()
    p_gt = np.asarray(p_gt)
    p_est = np.asarray(p_est)
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    panes = [(0, 1, "X, m", "Y, m"), (0, 2, "X, m", "Z, m"), (1, 2, "Y, m", "Z, m")]
    for ax, (i, j, xl, yl) in zip(axes, panes):
        ax.plot(p_gt[:, i], p_gt[:, j], color="tab:blue", lw=1.0, label="GT")
        ax.plot(p_est[:, i], p_est[:, j], color="m", lw=1.0, label="ET")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.grid(True, alpha=0.6)
    axes[0].legend(loc="upper right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(png_path) or ".", exist_ok=True)
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    return png_path


def plot_error_vs_path(png_path, p_gt_assoc, err_m, kind="ATE"):
    """Per-sample error along the traveled path (reference's
    ``ate_vs_path.png`` / ``rte_vs_path.png``).

    x: cumulative ground-truth path length at each associated sample.
    y: per-sample error as a percentage of the TOTAL ground-truth path
    length (our definition — the reference's plotting script is absent
    from its repo, so the normalization is ours and stated here).
    """
    plt = _plt()
    s = _path_progress(p_gt_assoc)
    total = max(float(s[-1]), 1e-9)
    pct = 100.0 * np.asarray(err_m, np.float64) / total
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.plot(s, pct, color="red", lw=1.2, label=f"{kind} %")
    ax.axhline(pct.mean(), color="tab:blue", ls="--", lw=2,
               label=f"Mean {pct.mean():.2f}%")
    ax.set_xlabel("Path, m")
    ax.set_ylabel(f"{kind}, %")
    ax.grid(True, alpha=0.6)
    ax.legend(loc="upper right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(png_path) or ".", exist_ok=True)
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    return png_path


def plot_summary(png_path, names, pct, kind="ATE"):
    """Per-dataset percentage bar chart with mean/median rules — the
    reference's repo-level ``ate_summary.png`` / ``rte_summary.png``
    (labels in English here)."""
    plt = _plt()
    pct = np.asarray(pct, np.float64)
    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(names)), 6))
    x = np.arange(len(names))
    ax.bar(x, pct, width=0.55, color="#2d4a6b", edgecolor="black", lw=0.5)
    for xi, v in zip(x, pct):
        ax.annotate(f"{v:.1f}", (xi, v), ha="center", va="bottom", fontsize=9)
    ax.axhline(pct.mean(), color="red", ls="--", lw=1,
               label=f"Mean: {pct.mean():.2f}%")
    ax.axhline(np.median(pct), color="green", ls="-.", lw=1,
               label=f"Median: {np.median(pct):.2f}%")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel(f"{kind}, % of path length")
    ax.set_title(f"Absolute trajectory error ({kind})" if kind == "ATE"
                 else f"Relative trajectory error ({kind})")
    ax.legend(loc="upper right", fontsize=8)
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(png_path) or ".", exist_ok=True)
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    return png_path


def per_sequence_artifacts(out_dir, t_est, p_est, t_gt, p_gt):
    """Write the reference's per-sequence artifact triple into ``out_dir``:
    trajectories.png, ate_vs_path.png, rte_vs_path.png.  Returns the ATE
    sample errors' (assoc_gt_positions, err_m) for summary use."""
    from .metrics import associate, umeyama_alignment

    ie, ig = associate(np.asarray(t_est, np.float64), np.asarray(t_gt, np.float64))
    pe = np.asarray(p_est, np.float64)[ie]
    pg = np.asarray(p_gt, np.float64)[ig]
    s, R, t = umeyama_alignment(pe, pg)
    pe_al = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe_al - pg, axis=1)

    plot_trajectories(os.path.join(out_dir, "trajectories.png"), pg, pe_al)
    plot_error_vs_path(os.path.join(out_dir, "ate_vs_path.png"), pg, err, "ATE")

    # RTE: 1 s window drift per sample (matches metrics.rte's delta)
    dt = np.diff(np.asarray(t_gt, np.float64)[ig]).mean() if len(ig) > 1 else 0.05
    k = max(1, int(round(1.0 / max(dt, 1e-6))))
    if len(pe_al) > k:
        d_est = pe_al[k:] - pe_al[:-k]
        d_gt = pg[k:] - pg[:-k]
        rerr = np.linalg.norm(d_est - d_gt, axis=1)
        plot_error_vs_path(os.path.join(out_dir, "rte_vs_path.png"),
                           pg[:-k], rerr, "RTE")
    return pg, err
