"""The port's native IO: a PNG decoder, a threaded batch loader and a
trajectory parser in C++ (`slamio.cpp`, the port's own copy of the JAX
package's), bound with ctypes, plus an 8-bit grey PNG writer on stdlib
`zlib` (the renderer's export).

The library is built with `g++` at first use into the build directory of
`utils/cuda_build.py` (`_build/` beside the package unless a driver sets
another with `cuda_build.use_build_dir`), keyed by a hash of the source as
the CUDA kernels are, and linked against zlib. Nothing falls back to another
decoder: a failed build raises with the compiler's message, a failed decode
with the decoder's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from monocular_slam_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "slamio.cpp"
_lock = threading.Lock()
_lib = None

# slamio's return codes
_ERRORS = {
    -1: "not a PNG file",
    -2: "truncated chunk",
    -3: "short IHDR chunk",
    -4: "unsupported colour type (palette)",
    -5: "unsupported bit depth (not 8 or 16)",
    -6: "interlaced PNG (Adam7) unsupported",
    -7: "no IHDR or IDAT chunk",
    -8: "zlib inflate failed or image data has the wrong size",
    -9: "unknown scanline filter",
    -10: "image larger than the batch's first image",
    -100: "cannot read the file",
}

_F32P = ctypes.POINTER(ctypes.c_float)
_INTP = ctypes.POINTER(ctypes.c_int)


def build(force: bool = False) -> Path:
    """Compile `slamio.cpp` if its source changed (or with `force`);
    returns the library path. Raises with the compiler's output when g++
    fails."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    build_dir = cuda_build.BUILD_DIR
    out = build_dir / f"libslamio_{tag}.so"
    if out.exists() and not force:
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", str(tmp),
           "-lz", "-pthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.slamio_load_png_f32.restype = ctypes.c_int
        lib.slamio_load_png_f32.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int, _INTP, _INTP,
                                            ctypes.c_float]
        lib.slamio_png_size.restype = ctypes.c_int
        lib.slamio_png_size.argtypes = [ctypes.c_char_p, _INTP, _INTP]
        lib.slamio_load_batch_f32.restype = None
        lib.slamio_load_batch_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F32P,
                                              ctypes.c_int, _INTP, _INTP, ctypes.c_float,
                                              ctypes.c_int]
        lib.slamio_parse_trajectory.restype = ctypes.c_int
        lib.slamio_parse_trajectory.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                                ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (raises if it cannot be)."""
    return _load() is not None


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise IOError(f"PNG decode failed for {path}: {_ERRORS.get(rc, 'error')} ({rc})")


def _size(lib, path: str) -> tuple[int, int]:
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.slamio_png_size(path.encode(), ctypes.byref(w), ctypes.byref(h)), path)
    return w.value, h.value


def load_png_f32(path: str, scale16: float = 1.0 / 256.0) -> np.ndarray:
    """Decode a PNG to float32 grayscale (H, W): 8-bit values as they are
    (colour as 0.299 R + 0.587 G + 0.114 B), 16-bit values times `scale16`
    (1/5000 turns TUM depth into meters)."""
    lib = _load()
    w, h = _size(lib, path)
    out = np.empty(w * h, np.float32)
    wo, ho = ctypes.c_int(), ctypes.c_int()
    _check(lib.slamio_load_png_f32(path.encode(), out.ctypes.data_as(_F32P), w * h,
                                   ctypes.byref(wo), ctypes.byref(ho), ctypes.c_float(scale16)),
           path)
    return out.reshape(ho.value, wo.value)


def load_batch_f32(paths: list[str], scale16: float = 1.0 / 256.0,
                   n_threads: int = 0) -> list[np.ndarray]:
    """Decode several PNGs on `n_threads` threads (0: one per core) ->
    list of (H, W) float32 arrays. Sized by the first image."""
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    w, h = _size(lib, paths[0])
    cap = w * h
    out = np.empty((n, cap), np.float32)
    whs = np.zeros(2 * n, np.int32)
    rcs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.slamio_load_batch_f32(arr, n, out.ctypes.data_as(_F32P), cap, whs.ctypes.data_as(_INTP),
                              rcs.ctypes.data_as(_INTP), ctypes.c_float(scale16), n_threads)
    imgs = []
    for i in range(n):
        _check(int(rcs[i]), paths[i])
        wi, hi = whs[2 * i], whs[2 * i + 1]
        imgs.append(out[i, : wi * hi].reshape(hi, wi).copy())
    return imgs


def parse_trajectory(path: str, max_rows: int = 100000) -> np.ndarray:
    """Parse 'ts tx ty tz qx qy qz qw' rows -> (N, 8) float64."""
    lib = _load()
    out = np.empty((max_rows, 8), np.float64)
    n = lib.slamio_parse_trajectory(path.encode(),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
    if n < 0:
        raise IOError(f"cannot parse {path}")
    return out[:n].copy()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) image as an 8-bit grey PNG: no interlacing,
    filter 0 on every scanline, the IDAT stream from stdlib `zlib`."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png takes a uint8 (H, W) image, got {img.dtype} {img.shape}")
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
