"""Published peaks of one NVIDIA H100 and the roofline bound of a piece of work.

Frozen from chip_smoke.py (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``,
``bound``) at commit efd1109: NVIDIA's data sheet for the SXM
part, dense rates, at its full 700 W power limit.  The card's own name and
power limit are read by ``nvidia-smi`` in the run (``card``) and printed
beside every roofline share.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # 80 GB HBM3
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound(n_bytes: float, ops: float):
    """(seconds, what binds): the least time the card could take for the
    work, bytes over the memory rate or operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"
