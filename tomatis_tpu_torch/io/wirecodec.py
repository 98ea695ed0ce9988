"""Host-side wire codec bindings (native C++ with numpy fallback), port of
tomatis_tpu/io/wirecodec.py. Imports no torch.

The wire format (see ops/wire.py) compresses PCM_24 audio
losslessly for the host<->device link. This module gives the wire batch
(parallel/batch.py) a fast host half:

    encode_f32(x [n, ch] float32) -> packed uint8 array, or None when the
        floats are not exactly PCM_24 (the batch then falls back to raw
        float32 transport so non-24-bit sources stay bit-exact).
    decode_pcm24(buf, n, ch) -> interleaved little-endian 3-byte PCM
        (exactly the engine's pcm24 payload layout).

Backed by csrc/wire.cpp via ctypes (built with g++ at first use); if the
native build is unavailable the numpy implementation from ops.wire takes
over (slower but identical bytes).
"""
from __future__ import annotations

import ctypes

import numpy as np

from tomatis_tpu_torch.ops import wire as _wire

_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            from tomatis_tpu_torch.native.build import load_library
            lib = load_library("wire")
            lib.twire_max_bytes.restype = ctypes.c_long
            lib.twire_max_bytes.argtypes = [ctypes.c_long, ctypes.c_int]
            lib.twire_encode_f32.restype = ctypes.c_long
            lib.twire_encode_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
            lib.twire_encode_i32.restype = ctypes.c_long
            lib.twire_encode_i32.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
            lib.twire_decode.restype = ctypes.c_int
            lib.twire_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int]
            lib.twire_decode_pcm24.restype = ctypes.c_int
            lib.twire_decode_pcm24.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int]
            _LIB = lib
        except (RuntimeError, OSError):
            # no compiler, a failed build or an unloadable library: the
            # numpy implementation takes over
            _LIB = None
    return _LIB


def available() -> bool:
    """True when the fast native half is loadable."""
    return _lib() is not None


def encode_f32(x: np.ndarray, rice: bool = True) -> np.ndarray | None:
    """float32 [n, ch] -> packed bytes, or None if not PCM_24-exact.

    rice=False emits the all-maxw TWC3 stream (see ops.wire.encode_np)
    so a rice-free device decoder can unpack it; the setting must match
    the consumer's.
    """
    x = np.ascontiguousarray(x, np.float32)
    n, ch = x.shape
    lib = _lib()
    if lib is not None:
        cap = lib.twire_max_bytes(n, ch)
        out = np.empty(cap, np.uint8)
        used = lib.twire_encode_f32(x.ctypes.data, n, ch, out.ctypes.data,
                                    cap, int(rice))
        if used == -1:
            return None
        if used < 0:
            raise RuntimeError(f"twire_encode_f32 failed: {used}")
        return out[:used]
    v = np.rint(x.astype(np.float64) * 8388608.0).astype(np.int64)
    if (v < -8388608).any() or (v > 8388607).any() \
            or not np.array_equal(
                (v.astype(np.float32) / np.float32(8388608.0)), x):
        return None
    return _wire.encode_np(v.astype(np.int32), rice=rice)


def encode_i32(v: np.ndarray, rice: bool = True) -> np.ndarray:
    """int32 PCM [n, ch] -> packed bytes."""
    v = np.ascontiguousarray(v, np.int32)
    n, ch = v.shape
    lib = _lib()
    if lib is not None:
        cap = lib.twire_max_bytes(n, ch)
        out = np.empty(cap, np.uint8)
        used = lib.twire_encode_i32(v.ctypes.data, n, ch, out.ctypes.data,
                                    cap, int(rice))
        if used < 0:
            raise RuntimeError(f"twire_encode_i32 failed: {used}")
        return out[:used]
    return _wire.encode_np(v, rice=rice)


def decode_i32(buf: np.ndarray, n: int, ch: int) -> np.ndarray:
    """packed bytes -> int32 PCM [n, ch]."""
    buf = np.ascontiguousarray(buf, np.uint8)
    lib = _lib()
    if lib is not None:
        out = np.empty((n, ch), np.int32)
        rc = lib.twire_decode(buf.ctypes.data, len(buf), out.ctypes.data,
                              n, ch)
        if rc:
            raise RuntimeError(f"twire_decode failed: {rc}")
        return out
    return _wire.decode_np(buf)


def decode_pcm24(buf: np.ndarray, n: int, ch: int) -> np.ndarray:
    """packed bytes -> interleaved LE 24-bit PCM bytes [n*ch*3]."""
    buf = np.ascontiguousarray(buf, np.uint8)
    lib = _lib()
    if lib is not None:
        out = np.empty(n * ch * 3, np.uint8)
        rc = lib.twire_decode_pcm24(buf.ctypes.data, len(buf),
                                    out.ctypes.data, n, ch)
        if rc:
            raise RuntimeError(f"twire_decode_pcm24 failed: {rc}")
        return out
    return _wire.le24_from_i32(_wire.decode_np(buf))
