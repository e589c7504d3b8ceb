"""The PyTorch port's own copy of uav_airvision_tpu/utils/trajectory.py: same names, same
behaviour (tests/test_torch_standalone.py holds the two equal).

Trajectory txt writer — bit-compatible with the reference output format
(reference src/msckf.py:10-16,152-160): one line per processed frame,
``timestamp px py pz qx qy qz qw`` with 6/9 decimal places, appended to
``results/txts/output_<dataset>_offset<offset>.txt``.

The dataset name / offset can be passed explicitly; the reference's
environment-variable side channel (DATASET_NAME / TIME_OFFSET) is honored as
a fallback for drop-in compatibility.
"""

from __future__ import annotations

import os

import numpy as np


def output_filepath(dataset_name=None, offset=None, base="results/txts"):
    os.makedirs(base, exist_ok=True)
    name = dataset_name if dataset_name is not None else os.getenv("DATASET_NAME", "unknown")
    off = offset if offset is not None else os.getenv("TIME_OFFSET", "0")
    return os.path.join(base, f"output_{name}_offset{off}.txt")


def format_state_line(timestamp, position, orientation):
    p = np.asarray(position)
    q = np.asarray(orientation)
    return (
        f"{float(timestamp):.6f} "
        f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
        f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
    )


class TrajectoryWriter:
    def __init__(self, dataset_name=None, offset=None, base="results/txts",
                 path=None):
        self.path = path or output_filepath(dataset_name, offset, base)

    def append(self, timestamp, position, orientation):
        with open(self.path, "a") as f:
            f.write(format_state_line(timestamp, position, orientation))

    def write_batch(self, timestamps, positions, orientations, mask=None):
        with open(self.path, "a") as f:
            for i in range(len(timestamps)):
                if mask is not None and not mask[i]:
                    continue
                f.write(format_state_line(timestamps[i], positions[i], orientations[i]))
