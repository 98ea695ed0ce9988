"""The benchmark's frozen FLAC codec (flac.cpp beside this file), built
with g++ into benchmark/_build/ and loaded with ctypes.

It encodes the benchmark's inputs and decodes the port's outputs for the
check, so neither changes when the program's own codec does. Nothing here
imports the program.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "flac.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIB: list = []


class _Info(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_int32), ("channels", ctypes.c_int32),
                ("bits_per_sample", ctypes.c_int32),
                ("total_samples", ctypes.c_int64)]


def compiler() -> str | None:
    return shutil.which("g++")


def library_path() -> str:
    """_build/libbenchflac-<key>.so, the key a hash of the source, the
    flags and the compiler's version: any change builds a new library."""
    gxx = compiler()
    if gxx is None:
        raise RuntimeError("the benchmark's FLAC codec needs g++")
    ver = subprocess.run([gxx, "--version"], capture_output=True,
                         text=True).stdout
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + repr((FLAGS, ver)).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbenchflac-{key}.so")


def lib() -> ctypes.CDLL:
    with _LOCK:
        if _LIB:
            return _LIB[0]
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([compiler(), *FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        L = ctypes.CDLL(so)
        L.tflac_open_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_Info)]
        L.tflac_open_read.restype = ctypes.c_void_p
        L.tflac_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_long]
        L.tflac_read.restype = ctypes.c_long
        L.tflac_close_read.argtypes = [ctypes.c_void_p]
        L.tflac_close_read.restype = None
        L.tflac_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
        L.tflac_open_write.restype = ctypes.c_void_p
        L.tflac_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_long]
        L.tflac_write.restype = None
        L.tflac_close_write.argtypes = [ctypes.c_void_p]
        L.tflac_close_write.restype = None
        L.tflac_encode_all.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_long, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        L.tflac_encode_all.restype = ctypes.c_int
        _LIB.append(L)
        return L


def _ints(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int32)
    if x.ndim != 2:
        raise ValueError(f"expected [n, channels] samples, got {x.shape}")
    return x


def encode(path: str, x: np.ndarray, sr: int, threads: int = 8) -> None:
    """Write int24 samples x [n, C] (int32 holding 24-bit values) as a
    PCM_24 FLAC file, the frames made on `threads` threads."""
    x = _ints(x)
    if lib().tflac_encode_all(str(path).encode(), x.ctypes.data, len(x), sr,
                              x.shape[1], 24, threads) != 0:
        raise OSError(f"cannot write {path}")


def encode_sequential(path: str, x: np.ndarray, sr: int,
                      block: int = 48000) -> None:
    """The same file written through the streaming encoder, block by
    block (the codec's own path; the tests hold encode() to it)."""
    x = _ints(x)
    L = lib()
    h = L.tflac_open_write(str(path).encode(), sr, x.shape[1], 24)
    if not h:
        raise OSError(f"cannot write {path}")
    try:
        for i in range(0, len(x), block):
            part = np.ascontiguousarray(x[i:i + block])
            L.tflac_write(h, part.ctypes.data, len(part))
    finally:
        L.tflac_close_write(h)


def decode(path: str) -> tuple:
    """(int32 samples [n, C], sample rate, bits per sample) of a FLAC
    file."""
    L = lib()
    info = _Info()
    h = L.tflac_open_read(str(path).encode(), ctypes.byref(info))
    if not h:
        raise OSError(f"cannot read {path} as FLAC")
    try:
        n, ch = int(info.total_samples), int(info.channels)
        out = np.empty((n, ch), np.int32)
        got = 0
        while got < n:
            r = L.tflac_read(h, out[got:].ctypes.data, n - got)
            if r <= 0:
                break
            got += r
    finally:
        L.tflac_close_read(h)
    if got != n:
        raise OSError(f"{path}: decoded {got} of {n} frames")
    return out, int(info.sample_rate), int(info.bits_per_sample)
