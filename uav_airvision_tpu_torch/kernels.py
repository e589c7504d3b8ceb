"""Build-and-bind layer for the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file compiles with nvcc for ``sm_90a`` into an object,
all of them at once (one nvcc process per source), and the objects link
into ONE shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c csrc/<name>.cu -o build/torch_kernels/<hash>/<name>.o
    nvcc -shared -o build/torch_kernels/lib<hash>.so build/torch_kernels/<hash>/*.o

The library name carries a hash of the sources (headers included) and
flags, so an edit to any source rebuilds it.  The build runs at the first
kernel launch of a process (never at import: the CPU tests import every
module and this machine may have no nvcc).  ``-fmad=false`` keeps nvcc from
contracting a*b+c into FMAs, so a kernel rounds where its plain PyTorch
version does.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``launch`` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Dynamic shared memory a block may take on the H100 (its opt-in limit,
# 232,448 B) less 1 KB for the kernels' static shared memory: a wrapper
# allocates a device workspace where a kernel's tile needs more (the kernel
# itself checks against the device's own limit).
SMEM_PER_BLOCK = 232448 - 1024

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double
L = ctypes.c_longlong
# The state an EKF update injects into (msckf_common.cuh::InjectIn): the
# IMU's q, bg, v, ba, p, R_imu_cam0, t_cam0_imu, the window's q and p, N,
# count, and the too_large flag out.
INJECT = [P, P, P, P, P, P, P, P, P, I, P, P]
# C signatures: every entry point returns int (a cudaError_t).
SIGNATURES = {
    # img0, img1, n_cam, H, W, n_levels, pad, out, stream
    "pyramid_u8": [P, P, I, I, I, I, I, P, P],
    # img, H, W, thr, pts, pts_valid, n_pts, keep_out, score_out, clocks, stream
    "fast_detect_masked": [P, I, I, I, P, P, I, P, P, P, P],
    # prev_pyr, curr_pyr, H0, W0, prev_pts, init_pts, valid, F, n_levels,
    # max_iter, max_iter_upper, eps2, min_eig, out_pts, out_status, win, stream
    "pyramidal_lk": [P, P, I, I, P, P, P, I, I, I, I, F, F, P, P, I, P],
    # prev_pyr, H0, W0, prev_pts, pts_in, valid, windows, des, F, L, it_max,
    # eps2, min_eig, pts_out, des_next, out_status, win, stream
    "pyramidal_lk_level": [P, I, I, P, P, P, P, P, I, I, I, F, F, P, P, P, I, P],
    # prev_pyr, curr_pyr, H0, W0, prev_pts, init_pts, valid, F, n_levels,
    # max_iter, max_iter_upper, eps2, min_eig, out_pts, out_status, des_out,
    # clocks, win, stream
    "pyramidal_lk_compact": [P, P, I, I, P, P, P, I, I, I, I, F, F, P, P, P, P, I, P],
    # img, HP, WP, oy, ox, origin stride, F, n, out, stream
    "extract_windows": [P, I, I, P, P, I, I, I, P, P],
    # imu_t, imu_w, imu_a, imu_mask, I, q, p, v, bg, ba, q_null, p_null,
    # v_null, timestamp, gravity, sid, qc, cov_in, D, state_out, sid_out,
    # cov_out, work, clocks, stream
    "propagate_f32": [P, P, P, P, I, *[P] * 10, P, P, P, I, P, P, P, P, P, P],
    "propagate_f64": [P, P, P, P, I, *[P] * 10, P, P, P, I, P, P, P, P, P, P],
    # cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, active, B, huber_eps,
    # precision, damping, outer_max, inner_max, pos_out, ok_out, clocks, stream
    "triangulate_f32": [P, P, I, P, P, P, P, P, I, D, D, D, I, I, P, P, P, P],
    "triangulate_f64": [P, P, I, P, P, P, P, P, I, D, D, D, I, I, P, P, P, P],
    # cam_q, cam_p, N, obs, obs_mask, M, position, initialized, sel, sel_ok,
    # B, R_c0c1, t_c0c1, huber_eps, precision, damping, outer_max, inner_max,
    # motion_thr, position_out, initialized_out, init_fail_out, clocks, stream
    "triangulate_rows_f32": [P, P, I, P, P, I, P, P, P, P, I, P, P, D, D, D, I, I, D, P, P, P,
                             P, P],
    "triangulate_rows_f64": [P, P, I, P, P, I, P, P, P, P, I, P, P, D, D, D, I, I, D, P, P, P,
                             P, P],
    # cams_q, cams_p, cams_qn, cams_pn, rm, N, Nw, obs, obs_mask, p_w, sel,
    # proc, gravity, R_c0c1, t_c0c1, B, H_out, r_out, rows_out, clocks, stream
    "feature_block_f32": [P, P, P, P, P, I, I, P, P, P, P, P, P, P, P, I, P, P, P, P, P],
    "feature_block_f64": [P, P, P, P, P, I, I, P, P, P, P, P, P, P, P, I, P, P, P, P, P],
    # H, r, B, R, D, h_stride, r_stride, rows_true, dof, dof is int64, P,
    # obs_noise, table, n_table, out, flags, gamma, work, stream
    "gate_f32": [P, P, I, I, I, L, L, P, P, I, P, P, P, I, P, P, P, P, P],
    "gate_f64": [P, P, I, I, I, L, L, P, P, I, P, P, P, I, P, P, P, P, P],
    # P, D, B, n_feat, rows_per, B's feature and row strides, r, r's strides,
    # include, cols, obs_noise, out, *INJECT, clocks, stream
    "rank12_f32": [P, I, P, I, I, L, L, P, L, L, P, P, P, P, *INJECT, P, P],
    "rank12_f64": [P, I, P, I, I, L, L, P, L, L, P, P, P, P, *INJECT, P, P],
    # pts, n, intr, field stride, point stride, coef, field stride, point
    # stride, model, (R, new_intr,) out..., stream
    "camera_undistort": [P, I, P, I, I, P, I, I, I, P, P, P, P],
    "camera_distort": [P, I, P, I, I, P, I, I, I, P, P],
    "camera_undistort_distort": [P, I, P, I, I, P, I, I, I, P, P, P, P],
    # pts, n, intr, field stride, point stride, R, out, stream
    "camera_warp": [P, I, P, I, I, P, P, P],
    # pts, n, mean_ang_vel, dt, R_cam_imu, intr, out, stream
    "camera_predict_warp": [P, I, P, P, P, P, P, P],
    # cam0, p1, p0r, proj1, valid, st_fwd, n, intr, coef, model, E, fwd_bwd,
    # max_vdisp, thresh, h, w, inlier, stream
    "camera_stereo_gate": [P, P, P, P, P, P, I, P, P, I, P, F, F, F, I, I, P, P],
    # score, H, W, grid_row, grid_col, cell_h, cell_w, k, ys, xs, vals, clocks, stream
    "grid_topk_i32": [P, I, I, I, I, I, I, I, P, P, P, P, P],
    # cell, primary, arrival, valid, n, n_cells, rank, perm, stream
    "grid_rank_in_cell": [P, P, P, P, I, I, P, P, P],
    # perm, keep, cell, valid, n, n_cells, global_rank, cell_rank, n_kept, stream
    "grid_kept_order_stats": [P, P, P, P, I, I, P, P, P, P],
    # perm, keep, n, n_slots, sel, selm, stream
    "grid_compact_kept": [P, P, I, I, P, P, P],
    # key, n, k, out, stream
    "grid_smallest_k": [P, I, I, P, P],
    # mask, n, fill, out, stream
    "grid_stable_compact": [P, I, I, P, P],
    # curr, cam1_curr, tracked, ids, lifetime, F, apts, ascore, aarrival,
    # ainlier, acam1, C, next_id, grid_row, grid_col, H, W, grid_min,
    # grid_max, out, work, stream
    "grid_select_track_f32": [P, P, P, P, P, I, P, P, P, P, P, I, P, I, I, I, I, I, I, P, P, P],
    # P, D, H, r, m, qr, obs_noise, work, out, *INJECT, clocks, stream
    "ekf_update_f32": [P, I, P, P, I, I, P, P, P, *INJECT, P, P],
    "ekf_update_f64": [P, I, P, P, I, I, P, P, P, *INJECT, P, P],
}

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}

# An optional callable(name, args): the wrappers of the back-end, grid,
# camera, extract and LK-level kernels pass it the arguments of every call
# they launch on the card, and the back-end its motion-check decisions
# (chip_smoke.py records the main path's calls through it).
observer = None


def observe(name: str, args: tuple) -> None:
    if observer is not None:
        observer(name, args)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` if the hashed library is missing; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{tag}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    obj_dir = BUILD_DIR / f"{tag}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in _sources():
        if src.suffix == ".cu":
            obj = obj_dir / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for src, _, proc in procs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_info.update(path=str(lib_path), seconds=time.time() - t0,
                      cached=False, ptxas="".join(report))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library; the first caller builds it.  Safe to enter from
    several threads (the streaming orchestrator's image thread may be the
    first to launch): one builds, the others wait for it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib


def check_cuda(*tensors: torch.Tensor) -> None:
    """Kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


_entries: dict = {}


def launch(name: str, *args) -> None:
    """Call a C entry point on the current stream; raise on a launch error.
    Each entry point is looked up once; the stream is passed as its raw
    handle."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(lib(), name)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, for a ``void*`` argument."""
    return t.data_ptr()
