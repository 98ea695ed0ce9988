"""FLAC reader/writer over the native C++ codec (csrc/flac.cpp), after
tomatis_tpu/io/flac.py; the writer makes a call's full blocks on several
threads and writes the same bytes.

Same float32 surface as io.wav: samples are normalized to [-1, 1) on read
and quantized with round-half-even + clip on write (PCM_16 / PCM_24
subtypes)."""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from tomatis_tpu_torch.native.build import load_library

BLOCK = 4096      # the encoder's block size (frames)


def _scale(bits: int) -> float:
    """Full-scale divisor 2^(bits-1) — any legal FLAC depth (4-32),
    including the 12/20-bit files some capture tools emit."""
    return float(1 << (bits - 1))


_SUBTYPE_BITS = {"PCM_16": 16, "PCM_24": 24}


class _FlacInfoC(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_int32),
                ("channels", ctypes.c_int32),
                ("bits_per_sample", ctypes.c_int32),
                ("total_samples", ctypes.c_int64)]


def _lib():
    lib = load_library("flac")
    lib.tflac_open_read.restype = ctypes.c_void_p
    lib.tflac_open_read.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(_FlacInfoC)]
    lib.tflac_read.restype = ctypes.c_long
    lib.tflac_read.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
    lib.tflac_seek.restype = ctypes.c_int
    lib.tflac_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.tflac_close_read.argtypes = [ctypes.c_void_p]
    lib.tflac_open_write.restype = ctypes.c_void_p
    lib.tflac_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.tflac_write.restype = ctypes.c_long
    lib.tflac_write.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
    lib.tflac_write_le24.restype = ctypes.c_long
    lib.tflac_write_le24.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_long]
    lib.tflac_close_write.argtypes = [ctypes.c_void_p]
    lib.tflac_encoder_threads.restype = ctypes.c_int
    lib.tflac_encoder_threads.argtypes = []
    lib.tflac_helpers_peak.restype = ctypes.c_int
    lib.tflac_helpers_peak.argtypes = [ctypes.c_int]
    return lib


def encoder_threads() -> int:
    """The helper threads the encoder may run at once over every open
    FlacWriter of the process: the CPUs of its affinity mask less one."""
    return _lib().tflac_encoder_threads()


def FlacReader(path):
    """Open a FLAC file for reading: native codec when buildable, else
    the pure-Python fallback decoder (io.flac_py) — same surface, so
    machines without g++ can still read FLAC (write falls back to WAV
    at the model layer, see models/standard.py). ValueError (the native
    codec declined the file — e.g. 32-bit streams, whose 33-bit side
    channel needs the pure decoder's arbitrary-width path) also falls
    back; if the file is genuinely corrupt the pure decoder's error
    propagates."""
    try:
        return _NativeFlacReader(path)
    except (RuntimeError, OSError, ValueError):
        from tomatis_tpu_torch.io.flac_py import PureFlacReader
        return PureFlacReader(path)


class _NativeFlacReader:
    def __init__(self, path):
        self._lib = _lib()
        info = _FlacInfoC()
        self._h = self._lib.tflac_open_read(str(path).encode(),
                                            ctypes.byref(info))
        if not self._h:
            raise ValueError(f"cannot open FLAC file: {path}")
        self.samplerate = info.sample_rate
        self.channels = info.channels
        self.bits = info.bits_per_sample
        self.frames = int(info.total_samples)
        self.subtype = f"PCM_{self.bits}"
        self._pos = 0

    def read(self, n_frames: int = -1) -> np.ndarray:
        if n_frames < 0:
            n_frames = max(0, self.frames - self._pos)
        buf = np.empty(n_frames * self.channels, np.int32)
        got = self._lib.tflac_read(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_frames)
        self._pos += got
        x = buf[:got * self.channels].astype(np.float32) / _scale(self.bits)
        return x.reshape(-1, self.channels)

    @property
    def int24_readable(self) -> bool:
        return self.bits <= 24

    def read_int24(self, n_frames: int = -1) -> np.ndarray:
        """Read as int32 samples at PCM_24 scale (float = v / 2^23) —
        exact for <=24-bit sources, skipping the float conversion."""
        if n_frames < 0:
            n_frames = max(0, self.frames - self._pos)
        buf = np.empty(n_frames * self.channels, np.int32)
        got = self._lib.tflac_read(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_frames)
        self._pos += got
        v = buf[:got * self.channels]
        if self.bits != 24:
            v = v << (24 - self.bits)
        return v.reshape(-1, self.channels)

    def seek(self, frame: int) -> int:
        frame = max(0, min(frame, self.frames))
        if self._lib.tflac_seek(self._h, frame) != 0:
            raise IOError("FLAC seek failed")
        self._pos = frame
        return frame

    def tell(self) -> int:
        return self._pos

    def close(self):
        if self._h:
            self._lib.tflac_close_read(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class FlacWriter:
    """A FLAC file written in pieces. The encoder carries a partial block
    across calls; a call that completes two or more blocks makes them on
    the calling thread and on helper threads (encoder_threads()), and the
    file's bytes are the one-thread encoder's.

    pooled_blocks and inline_blocks count, over every writer of the
    process, the blocks made on more than one thread and those made on the
    calling thread alone (a short call, a budget taken by other writers,
    the last partial block)."""
    pooled_blocks = 0
    inline_blocks = 0
    _count_lock = threading.Lock()

    def __init__(self, path, samplerate: int, channels: int,
                 subtype: str = "PCM_24"):
        if subtype not in _SUBTYPE_BITS:
            raise ValueError(f"unsupported FLAC subtype {subtype}")
        self._lib = _lib()
        self.samplerate = samplerate
        self.channels = channels
        self.subtype = subtype
        self.bits = _SUBTYPE_BITS[subtype]
        self._pend = 0        # frames of the encoder's partial block
        self._h = self._lib.tflac_open_write(str(path).encode(),
                                             samplerate, channels, self.bits)
        if not self._h:
            raise ValueError(f"cannot open FLAC file for write: {path}")

    def _count(self, n_frames: int, pooled: int):
        """Count the blocks that n_frames more frames completed, pooled of
        them made on more than one thread."""
        made, self._pend = divmod(self._pend + n_frames, BLOCK)
        self._count_blocks(made, pooled)

    @classmethod
    def _count_blocks(cls, made: int, pooled: int):
        with cls._count_lock:
            cls.pooled_blocks += pooled
            cls.inline_blocks += made - pooled

    def write(self, data: np.ndarray):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[1] != self.channels:
            raise ValueError("channel mismatch")
        s = _scale(self.bits)
        v = np.clip(np.rint(data * s), -s, s - 1).astype(np.int32)
        flat = np.ascontiguousarray(v.reshape(-1))
        pooled = self._lib.tflac_write(
            self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(data))
        self._count(len(data), pooled)

    def write_raw(self, raw):
        """Device-packed little-endian PCM_24 bytes (bytes-like or a uint8
        array), unpacked inside the encoder: no copy here."""
        if self.bits != 24:
            raise ValueError("write_raw requires PCM_24")
        b = raw if isinstance(raw, np.ndarray) else np.frombuffer(raw, np.uint8)
        b = np.ascontiguousarray(b, np.uint8).reshape(-1)
        n, rest = divmod(len(b), 3 * self.channels)
        if rest:
            raise ValueError(f"{len(b)} PCM_24 bytes are not whole frames of "
                             f"{self.channels} channels")
        pooled = self._lib.tflac_write_le24(self._h, b.ctypes.data, n)
        self._count(n, pooled)

    def close(self):
        if self._h:
            self._lib.tflac_close_write(self._h)
            self._h = None
            if self._pend:       # the last, partial block, made on close
                self._pend = 0
                self._count_blocks(1, 0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
