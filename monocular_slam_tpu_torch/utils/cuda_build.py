"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` has a plain C interface. It is compiled at first
use with `nvcc` for `sm_90a` into a shared library under `_build/` beside
the package, keyed by a hash of the source, and loaded with `ctypes`.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def use_build_dir(path) -> Path:
    """Build and load every kernel, and the native decoder
    (`native/slamio.cpp`), under `path` from now on (a library this process
    has already loaded stays loaded); returns the directory used before."""
    global BUILD_DIR
    prev, BUILD_DIR = BUILD_DIR, Path(path)
    return prev


def nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, info: dict) -> Path:
    """Compile `csrc/<name>.cu` if its source changed; returns the library
    path. `info` receives path, seconds and the compiler's log."""
    src_path = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src_path.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        info.setdefault("path", str(out))
        info.setdefault("log", "already built")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src_path),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_path.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(path=str(out), seconds=time.perf_counter() - t0,
                log=(proc.stdout + proc.stderr).strip())
    return out


def load(name: str, info: dict, fn: str, argtypes: list) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed, with `fn`'s
    signature declared (every entry point returns a CUDA error code)."""
    lib = ctypes.CDLL(str(build(name, info)))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def current_stream() -> int:
    """The current CUDA stream of the current device, as the int ctypes
    passes (the wrappers check that their tensors lie on that device)."""
    import torch

    return torch.cuda.current_stream().cuda_stream
