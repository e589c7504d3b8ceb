"""Operations and bytes of the kernels whose roofline share the benchmark reports.

Counted from shapes, each input byte read once and each output byte written
once.  K2's and K11's arithmetic is frozen from chip_smoke.py
(``check_kernels``' K2 bound, ``_batched_bounds``' K11 bound) and K11's row
tiers from uav_airvision_tpu_torch/models/msckf/update.py (``update_tiers``,
``update_tier``) at commit efd1109.
"""

from __future__ import annotations

#: The CUDA kernels of each counted kernel, by their function names.
KERNELS = {"K2": ("pyramid_kernel", "level0_kernel", "level_kernel"),
           "K11": ("update_kernel",)}


def level_shapes(H: int, W: int, n_levels: int):
    """Unpadded (h, w) of pyramid levels 0..n_levels-1 (ceil halving)."""
    shapes = [(H, W)]
    for _ in range(n_levels - 1):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


def k2_work(n_inst: int, H: int, W: int, n_levels: int, pad: int):
    """(bytes, operations) of one K2 launch over both cameras of ``n_inst``
    instances: the 2 n_inst uint8 images read, every padded float32 level
    written, ~20 integer operations per pixel of each level past level 0
    (two separable 5-tap passes and the rounding)."""
    shapes = level_shapes(H, W, n_levels)
    out_floats = sum((h + 2 * pad) * (w + 2 * pad) for h, w in shapes)
    images = 2 * n_inst
    n_bytes = images * H * W + images * out_floats * 4
    ops = 20 * images * sum(h * w for h, w in shapes[1:])
    return n_bytes, ops


def update_tier(n_rows: int, D: int, rows_true) -> str:
    """The row tier K11 takes: "all", "T1", "T2" or "QR"."""
    T1, T2 = D + 7 - (D + 7) % 8, 2 * D
    if rows_true is None or n_rows <= T2:
        return "all"
    return "T1" if rows_true <= T1 else ("T2" if rows_true <= T2 else "QR")


def k11_work(D: int, elem: int, n_cams: int, n_rows: int, rows_true):
    """(bytes, operations) of one K11 launch: for each updating instance
    (``rows_true``, one entry each: its true row count, or None for the
    whole buffer of ``n_rows``), its covariance read and written, its rows
    of H and r read, the injected state's fields read and written; the
    update's products, the Cholesky solve and the injection (the QR tier
    first compresses its rows to D)."""
    n_bytes = ops = 0.0
    fields = 28 + 7 * n_cams  # q bg v ba p R_imu_cam0 t_cam0_imu + the window's q and p
    for rows in rows_true:
        nz = float(rows if rows is not None else n_rows)
        qr_ops, m = 0.0, nz
        if update_tier(n_rows, D, rows) == "QR":
            qr_ops, m = 2 * nz * D * D, float(D)
        ops += (qr_ops + 2 * m * D * D + m * m * D + m ** 3 / 3 + 2 * m * m * D + 2 * m * D
                + 2 * m * D * D + 3 * D * D + 40 * D)
        n_bytes += (2 * D * D * elem + (nz * (D + 1) + D + 1) * elem + 2 * fields * elem)
    return n_bytes, ops
