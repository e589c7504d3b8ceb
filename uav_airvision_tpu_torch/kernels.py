"""Build-and-bind layer for the hand-written CUDA kernels in ``csrc/``.

All ``csrc/*.cu`` files compile with nvcc for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/torch_kernels/lib<hash>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edit to any
source rebuilds it.  The build runs at the first kernel launch of a process
(never at import: the CPU tests import every module and this machine may have
no nvcc).  ``-fmad=false`` keeps nvcc from contracting a*b+c into FMAs, so a
kernel rounds where its plain PyTorch version does.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``launch`` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signatures: every entry point returns int (a cudaError_t).
SIGNATURES = {
    # src, src_stride, src_off, Hs, Ws, dst, Ho, Wo, pad, down, stream
    "pyr_level_u8": [P, I, I, I, I, P, I, I, I, I, P],
    "pyr_level_f32": [P, I, I, I, I, P, I, I, I, I, P],
    # img, H, W, thr, pts, pts_valid, n_pts, score_tmp, corner_tmp,
    # keep_out, score_out, stream
    "fast_detect_masked": [P, I, I, I, P, P, I, P, P, P, P, P],
    # prev_pyr, curr_pyr, H0, W0, prev_pts, init_pts, valid, F, n_levels,
    # max_iter, max_iter_upper, eps2, min_eig, out_pts, out_status, stream
    "pyramidal_lk": [P, P, I, I, P, P, P, I, I, I, I, F, F, P, P, P],
    # imu_t, imu_w, imu_a, imu_mask, I, state_in, qc, cov_in, D,
    # state_out, cov_out, stream
    "propagate_f32": [P, P, P, P, I, P, P, P, I, P, P, P],
    "propagate_f64": [P, P, P, P, I, P, P, P, I, P, P, P],
}

_lib = None
build_info: dict = {}


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
    lib_path = BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), seconds=time.time() - t0,
                      cached=False, ptxas=proc.stderr)
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
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


def launch(name: str, *args) -> None:
    """Call a C entry point on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
