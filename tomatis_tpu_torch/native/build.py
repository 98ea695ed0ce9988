"""Build and load the port's native components.

Each ``csrc/<name>.cu`` holds a CUDA kernel behind a plain C interface,
compiled with nvcc for sm_90a; each ``csrc/<name>.cpp`` is host C++ (the
FLAC codec, the wire codec), compiled with the host C++ compiler (g++,
else nvcc in its place). Either goes into ``native/build/`` at first use
and is loaded with ctypes, the same route as the reference's g++
builds (tomatis_tpu/native/build.py). The library's file name carries a
short hash of its compile commands (compiler path and flags,
``-march=native`` included) and of the host (``platform.machine()`` and the
compiler's ``--version``), and a source newer than the library rebuilds it:
a library built with other flags, by another compiler or on another host
is rebuilt, never loaded.
No PyTorch headers are compiled, so a build takes seconds. A failed build
raises RuntimeError: a kernel has no fall-back; a codec's callers decide
(io/flac.py reads with the pure decoder, the processors write WAV,
io/wirecodec.py takes its numpy implementation).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
CXX_FLAGS = ["-std=c++17", "-O3", "-funroll-loops", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}     # one per library: two sources build in parallel
_CACHE: dict = {}
_VERSIONS: dict = {}       # compiler path -> its --version output
# the compiler's stderr of each build (nvcc -Xptxas -v: registers, shared
# memory, spills)
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


def _cxx_commands(src: str, tmp: str) -> list:
    """Command lines to try in order for a host C++ source. The library is
    built on the machine that runs it, so -march=native is safe; it is
    retried without for compilers that reject the flag."""
    gxx = shutil.which("g++")
    if gxx:
        base = [gxx, *CXX_FLAGS, src, "-o", tmp]
        return [base[:1] + ["-march=native"] + base[1:], base]
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        raise RuntimeError(
            "native build needs a C++ compiler but neither g++ nor nvcc was "
            "found. Install g++ (e.g. `apt install g++`) or stay on the "
            "pure fallbacks: FLAC decode degrades automatically; FLAC "
            "*encode* has no pure path — write .wav instead (the "
            "processors fall back to .wav on their own).") from None
    return [[nvcc, "-x", "c++", "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", src, "-o", tmp]]


def _commands(src: str, out: str) -> list:
    """Command lines that build `src` into `out`, to try in order."""
    if src.endswith(".cu"):
        return [[nvcc_path(), *NVCC_FLAGS, src, "-o", out]]
    return _cxx_commands(src, out)


def _compiler_version(compiler: str) -> str:
    if compiler not in _VERSIONS:
        proc = subprocess.run([compiler, "--version"], capture_output=True,
                              text=True)
        _VERSIONS[compiler] = proc.stdout.strip()
    return _VERSIONS[compiler]


def library_path(name: str, src: str) -> str:
    """native/build/lib<name>-<key>.so: the key hashes the compile
    commands without their file names, the machine type and the first
    compiler's --version."""
    cmds = _commands(src, "")
    flags = [[a for a in cmd if a not in (src, "")] for cmd in cmds]
    token = repr((flags, platform.machine(), _compiler_version(cmds[0][0])))
    key = hashlib.sha256(token.encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def _compile(src: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # process-unique temp + atomic rename: a concurrent process must never
    # dlopen a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    for cmd in _commands(src, tmp):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            break
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    BUILD_LOG[os.path.basename(src)] = proc.stderr
    os.replace(tmp, out)


def load_library(name: str) -> ctypes.CDLL:
    """Load the library built from csrc/<name>.cu or csrc/<name>.cpp,
    compiling if it is missing or older than its source."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        if not os.path.exists(src):
            src = os.path.join(CSRC_DIR, f"{name}.cpp")
            if os.environ.get("TOMATIS_NO_NATIVE"):
                # test/ops hook: behave exactly like a machine without a
                # C++ compiler (host components only; a CUDA kernel has no
                # fall-back to disable)
                raise RuntimeError(
                    "native components disabled by TOMATIS_NO_NATIVE")
        so = library_path(name, src)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            _compile(src, so)
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
