"""The PyTorch port's own copy of uav_airvision_tpu/streaming/dataset.py: same
names, same behaviour (tests/test_torch_standalone.py holds the two equal),
except that ``ImageReader.read`` decodes with the port's PNG loader
(``runtime/native.py``), not OpenCV, and raises on a file it cannot decode.

EuRoC MAV dataset readers (host side, NumPy).

Same directory layout and message semantics as the reference readers
(reference src/streaming/dataset.py:12-220): ns->s timestamp scaling, sorted
png scan, start-time offsetting against max(imu start, stereo start).
Images are decoded lazily (grayscale, as recorded).
"""

from __future__ import annotations

import os
from collections import namedtuple
from dataclasses import dataclass

import numpy as np

from ..runtime import native

imu_msg = namedtuple("imu_msg", ["timestamp", "angular_velocity", "linear_acceleration"])
img_msg = namedtuple("img_msg", ["timestamp", "image"])
stereo_msg = namedtuple(
    "stereo_msg", ["timestamp", "cam0_image", "cam1_image", "cam0_msg", "cam1_msg"]
)
gt_msg = namedtuple("gt_msg", ["timestamp", "p", "q", "v", "bw", "ba"])


class GroundTruthReader:
    """state_groundtruth_estimate0/data.csv -> gt_msg stream."""

    def __init__(self, path, scaler=1e-9, starttime=-np.inf):
        self.path = path
        self.scaler = scaler
        self.starttime = starttime

    def set_starttime(self, t):
        self.starttime = t

    def load(self):
        data = np.loadtxt(self.path, delimiter=",", skiprows=1)
        t = data[:, 0] * self.scaler
        keep = t >= self.starttime
        return dict(
            timestamp=t[keep], p=data[keep, 1:4], q=data[keep, 4:8],
            v=data[keep, 8:11], bw=data[keep, 11:14], ba=data[keep, 14:17],
        )

    def __iter__(self):
        d = self.load()
        for i in range(len(d["timestamp"])):
            yield gt_msg(d["timestamp"][i], d["p"][i], d["q"][i], d["v"][i],
                         d["bw"][i], d["ba"][i])


class IMUDataReader:
    """imu0/data.csv -> imu_msg stream."""

    def __init__(self, path, scaler=1e-9, starttime=-np.inf):
        self.path = path
        self.scaler = scaler
        self.starttime = starttime
        self._cache = None

    def _data(self):
        if self._cache is None:
            self._cache = np.loadtxt(self.path, delimiter=",", skiprows=1)
        return self._cache

    def arrays(self):
        d = self._data()
        t = d[:, 0] * self.scaler
        keep = t >= self.starttime
        return t[keep], d[keep, 1:4], d[keep, 4:7]

    def start_time(self):
        return self._data()[0, 0] * self.scaler

    def set_starttime(self, t):
        self.starttime = t

    def __iter__(self):
        t, w, a = self.arrays()
        for i in range(len(t)):
            yield imu_msg(t[i], w[i], a[i])


class ImageReader:
    """cam{0,1}/data/*.png -> img_msg stream (lazy decode)."""

    def __init__(self, paths, timestamps, starttime=-np.inf):
        self.paths = paths
        self.timestamps = np.asarray(timestamps)
        self.starttime = starttime

    def set_starttime(self, t):
        self.starttime = t

    def start_time(self):
        return self.timestamps[0]

    def read(self, path):
        return native.decode_png(path)

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for p, t in zip(self.paths, self.timestamps):
            if t < self.starttime:
                continue
            yield img_msg(t, self.read(p))


class Stereo:
    def __init__(self, cam0: ImageReader, cam1: ImageReader):
        self.cam0 = cam0
        self.cam1 = cam1
        self.timestamps = cam0.timestamps

    def set_starttime(self, t):
        self.starttime = t
        self.cam0.set_starttime(t)
        self.cam1.set_starttime(t)

    def start_time(self):
        return self.cam0.start_time()

    @property
    def starttime(self):
        return self.cam0.starttime

    @starttime.setter
    def starttime(self, t):
        pass

    def __len__(self):
        return len(self.cam0)

    def __iter__(self):
        for l, r in zip(self.cam0, self.cam1):
            yield stereo_msg(l.timestamp, l.image, r.image, l, r)


def _list_imgs(directory):
    names = sorted(
        (n for n in os.listdir(directory) if n.endswith(".png")),
        key=lambda n: float(n[:-4]),
    )
    paths = [os.path.join(directory, n) for n in names]
    ts = [float(n[:-4]) * 1e-9 for n in names]
    return paths, ts


class EuRoCDataset:
    """Composite EuRoC reader (reference EuRoCDataset, dataset.py:189-220)."""

    def __init__(self, path):
        self.groundtruth = GroundTruthReader(
            os.path.join(path, "mav0", "state_groundtruth_estimate0", "data.csv")
        )
        self.imu = IMUDataReader(os.path.join(path, "mav0", "imu0", "data.csv"))
        self.cam0 = ImageReader(*_list_imgs(os.path.join(path, "mav0", "cam0", "data")))
        self.cam1 = ImageReader(*_list_imgs(os.path.join(path, "mav0", "cam1", "data")))
        self.stereo = Stereo(self.cam0, self.cam1)
        self.timestamps = self.cam0.timestamps
        self.starttime = max(self.imu.start_time(), self.stereo.start_time())
        self.set_starttime(0)

    def set_starttime(self, offset):
        t = self.starttime + offset
        self.groundtruth.set_starttime(t)
        self.imu.set_starttime(t)
        self.cam0.set_starttime(t)
        self.cam1.set_starttime(t)
        self.stereo.set_starttime(t)
