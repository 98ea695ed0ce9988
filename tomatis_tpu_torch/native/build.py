"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds a kernel behind a plain C interface. It is
compiled with nvcc for sm_90a into ``native/build/lib<name>.so`` at first
use (a source-mtime check triggers a rebuild) and loaded with ctypes, the
same route as the reference's g++ builds (tomatis_tpu/native/build.py).
No PyTorch headers are compiled, so a build takes seconds. A failed build
raises: there is no fall-back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOCK = threading.Lock()
_CACHE: dict = {}
# nvcc's stderr of each build (-Xptxas -v: registers, shared memory, spills)
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("building the CUDA kernels needs nvcc (set CUDA_HOME "
                       "or put nvcc on PATH)")


def _compile(src: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # process-unique temp + atomic rename: a concurrent process must never
    # dlopen a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    BUILD_LOG[os.path.basename(src)] = proc.stderr
    os.replace(tmp, out)


def load_library(name: str) -> ctypes.CDLL:
    """Load lib<name>.so built from csrc/<name>.cu, compiling if stale."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            _compile(src, so)
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
