"""ctypes bindings and build of the host data loader (``runtime/loader.cpp``):
multithreaded grayscale PNG decode and EuRoC CSV parse.  The port's copy of
uav_airvision_tpu/runtime/native.py, with the same two functions.

The source builds at its first use, never at import:

    g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -lz \
        -o build/torch_loader/libuavloader_<hash>.so

The library's name carries a hash of the source and the command, so an edit
rebuilds it; the build writes a temporary file and renames it, so processes
that build at once do not see each other's half-written library.  It links
zlib only: the card's machine has no libpng, OpenCV or PIL, and this is the
port's only PNG decoder.  A failed build or decode raises; nothing falls back
to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_loader"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIBS = ["-lz"]

# loader.cpp's per-image status codes
STATUS = {1: "cannot open the file", 2: "file truncated", 3: "not a PNG file",
          4: "malformed chunk or CRC mismatch",
          5: "unsupported PNG (not 8/16-bit grayscale, or interlaced)",
          6: "image size differs from the sequence's", 7: "corrupt image data (inflate)",
          8: "unknown row filter"}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}


def build() -> Path:
    """Compile ``loader.cpp`` if the hashed library is missing; return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    lib_path = BUILD_DIR / f"libuavloader_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.time()
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), *LIBS, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), seconds=time.time() - t0, cached=False)
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded library; the first caller builds it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                lib.uav_decode_pngs.restype = ctypes.c_int
                lib.uav_decode_pngs.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ]
                lib.uav_parse_csv.restype = ctypes.c_int64
                lib.uav_parse_csv.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int64,
                ]
                _lib = lib
    return _lib


def png_size(path):
    """(height, width) from a PNG's IHDR chunk (bytes 16-23, big-endian)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise IOError(f"not a PNG file: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def decode_pngs(paths, height, width, threads=None):
    """Decode grayscale PNGs into one (N, H, W) uint8 array, multithreaded.
    Raises IOError naming the files that failed."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, height, width), np.uint8)
    status = np.zeros(n, np.int32)
    encoded = [os.fsencode(p) for p in paths]
    blob = b"\0".join(encoded) + b"\0"
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum([len(e) + 1 for e in encoded[:-1]])
    threads = threads or min(os.cpu_count() or 4, 16)
    fails = lib.uav_decode_pngs(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if fails:
        bad = [f"{paths[i]} ({STATUS.get(int(status[i]), int(status[i]))})"
               for i in np.nonzero(status)[0][:3]]
        raise IOError(f"{fails} PNG decodes failed: {', '.join(bad)}")
    return out


def decode_png(path):
    """One grayscale PNG as an (H, W) uint8 array, its size read from IHDR."""
    return decode_pngs([path], *png_size(path), threads=1)[0]


def parse_csv(path, cols, scale=1e-9, max_rows=2_000_000):
    """Parse a EuRoC CSV into (timestamps, values[rows, cols])."""
    lib = get_lib()
    ts = np.empty(max_rows, np.float64)
    vals = np.empty((max_rows, cols), np.float64)
    n = lib.uav_parse_csv(
        os.fsencode(path), cols, scale,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows,
    )
    if n < 0:
        raise IOError(f"csv parse failed ({n}): {path}")
    return ts[:n].copy(), vals[:n].copy()
