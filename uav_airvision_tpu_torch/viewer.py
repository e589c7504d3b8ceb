"""The PyTorch port's own copy of uav_airvision_tpu/viewer.py: same class, same
behaviour (tests/test_torch_tools.py runs its headless path).

Live visualization (host side) — image pane + 3-D trajectory/points view.

Functional equivalent of the reference viewer (reference src/viewer.py:16-111):
PyQt5/pyqtgraph main window with a camera-image pane, a GL 3-D pane drawing
the trajectory line and landmark scatter, thread-safe input queues drained by
a 30 Hz timer, an FPS status bar, and optional mp4 recording of the first
seconds.  All GUI deps are imported lazily and failures degrade to a headless
no-op so the compute path never requires Qt.
"""

from __future__ import annotations

import time
from queue import Queue

import numpy as np


class SimpleViewer:
    def __init__(self, record_path=None, record_seconds=50.0, refresh_hz=30.0):
        self.image_queue = Queue()
        self.pose_queue = Queue()
        self.point_queue = Queue()
        self._positions = []
        self._t0 = time.time()
        self._frames = 0
        self._record_path = record_path
        self._record_seconds = record_seconds
        self._writer = None
        self._gui = None
        try:
            self._init_gui(refresh_hz)
        except Exception as e:  # headless / no Qt
            self._gui_error = e

    # ------------------------------------------------------------------
    # thread-safe producers (reference viewer.py:45-57)
    # ------------------------------------------------------------------
    def update_image(self, image):
        self.image_queue.put(np.asarray(image))

    def update_pose(self, pose):
        """pose: Isometry-like with .R/.t (cam0 pose)."""
        self.pose_queue.put((np.asarray(pose.R), np.asarray(pose.t)))

    def update_points(self, points):
        self.point_queue.put(np.asarray(points))

    # ------------------------------------------------------------------
    def _init_gui(self, refresh_hz):
        from PyQt5 import QtCore, QtWidgets  # noqa: F401
        import pyqtgraph as pg
        import pyqtgraph.opengl as gl

        app = pg.mkQApp("uav-airvision-tpu")
        win = QtWidgets.QMainWindow()
        win.setWindowTitle("uav-airvision-tpu")
        central = QtWidgets.QWidget()
        layout = QtWidgets.QHBoxLayout(central)

        self._img_widget = pg.GraphicsLayoutWidget()
        vb = self._img_widget.addViewBox()
        vb.setAspectLocked(True)
        vb.invertY(True)
        self._img_item = pg.ImageItem()
        vb.addItem(self._img_item)
        layout.addWidget(self._img_widget)

        self._gl = gl.GLViewWidget()
        self._gl.setCameraPosition(distance=10)
        self._traj_item = gl.GLLinePlotItem(color=(1, 0, 0, 1), width=2)
        self._pts_item = gl.GLScatterPlotItem(color=(1, 1, 0, 1), size=3)
        self._gl.addItem(self._traj_item)
        self._gl.addItem(self._pts_item)
        layout.addWidget(self._gl)

        win.setCentralWidget(central)
        self._status = win.statusBar()
        win.resize(1200, 500)
        win.show()

        timer = QtCore.QTimer()
        timer.timeout.connect(self._update_gui)
        timer.start(int(1000 / refresh_hz))
        self._gui = dict(app=app, win=win, timer=timer)

    def _update_gui(self):
        import pyqtgraph as pg  # noqa: F401

        while not self.image_queue.empty():
            img = self.image_queue.get()
            self._img_item.setImage(img.T)
        while not self.pose_queue.empty():
            R, t = self.pose_queue.get()
            self._positions.append(t)
        while not self.point_queue.empty():
            pts = self.point_queue.get()
            self._pts_item.setData(pos=pts)
        if self._positions:
            self._traj_item.setData(pos=np.asarray(self._positions))
        self._frames += 1
        dt = time.time() - self._t0
        if dt > 0:
            self._status.showMessage(f"{self._frames / dt:.1f} fps")
        self._maybe_record()

    def _maybe_record(self):
        if self._record_path is None:
            return
        if time.time() - self._t0 > self._record_seconds:
            if self._writer is not None:
                self._writer.release()
                self._writer = None
            return
        try:
            import cv2

            pix = self._gui["win"].grab()
            qimg = pix.toImage()
            w, h = qimg.width(), qimg.height()
            ptr = qimg.bits()
            ptr.setsize(h * w * 4)
            arr = np.frombuffer(ptr, np.uint8).reshape(h, w, 4)[:, :, :3]
            if self._writer is None:
                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self._writer = cv2.VideoWriter(self._record_path, fourcc, 30, (w, h))
            self._writer.write(arr)
        except Exception:
            self._record_path = None

    # ------------------------------------------------------------------
    def replay(self, timestamps, positions):
        """Offline trajectory replay (batch mode --view)."""
        if self._gui is None:
            print(f"[viewer] headless ({getattr(self, '_gui_error', 'no GUI')}); "
                  f"{len(positions)} poses not shown")
            return
        for p in positions:
            self._positions.append(np.asarray(p))
        self._update_gui()
        self._gui["app"].exec_()
