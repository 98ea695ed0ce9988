"""Rolling-window reader for the streaming driver (a copy of
tomatis_tpu/utils/rolling.py; the port imports nothing of the JAX package).

The stream is presented as an INFINITE zero-extended sample stream in
absolute coordinates: `left_pad` leading zeros, then the source's samples
(optionally scaled), then zeros forever. `window` returns fixed-shape
slices; `advance` consumes the source up to a coordinate and drops
everything before it — always filling BEFORE dropping, so advancing past
the buffered region can never silently skip unread source samples.
"""
from __future__ import annotations

import numpy as np


class RollingReader:
    """Zero-extended rolling window over an audio sample stream.

    read:     callable(n) -> [k, C] array (k may be < n; empty = EOF).
    channels: C.
    dtype:    buffer dtype (np.float32, or np.int32 for int24 paths).
    scale:    optional per-block multiplier applied to source samples
              (e.g. the adaptive processor's pre-attenuation) — zeros
              from padding are never scaled.
    block:    samples requested from `read` per call.
    left_pad: zeros prepended before the source's first sample.
    base:     absolute coordinate of the stream position the source is
              currently seeked to MINUS left_pad (i.e. of buf[0]).
    """

    def __init__(self, read, channels: int, dtype=np.float32, scale=None,
                 block: int = 65536, left_pad: int = 0, base: int = 0):
        self._read = read
        self.channels = int(channels)
        self.dtype = dtype
        self.scale = scale
        self.block = int(block)
        self.base = int(base)
        self.buf = np.zeros((int(left_pad), self.channels), dtype)
        self.drained = False

    def _fill_to(self, end: int) -> None:
        """Consume the source until the buffer covers [base, end) or EOF."""
        while self.base + len(self.buf) < end and not self.drained:
            blk = self._read(self.block)
            if len(blk) == 0:
                self.drained = True
                break
            blk = np.asarray(blk, self.dtype)
            if self.scale is not None:
                blk = blk * self.scale
            self.buf = np.concatenate([self.buf, blk], 0)

    def window(self, start: int, n: int) -> np.ndarray:
        """Fixed-shape [n, C] slice at absolute coords [start, start+n),
        zero-extended past EOF. start must be >= the current base
        (earlier samples have been dropped)."""
        if start < self.base:
            raise ValueError(f"window start {start} precedes the rolling "
                             f"base {self.base}")
        self._fill_to(start + n)
        rel = start - self.base
        sig = self.buf[rel:rel + n]
        if len(sig) < n:
            sig = np.concatenate(
                [sig, np.zeros((n - len(sig), self.channels), self.dtype)],
                0)
        return sig

    def advance(self, start: int) -> None:
        """Drop retained samples before `start`, consuming the source up
        to it first (fill-before-drop: a start beyond the buffered region
        must read the intervening source samples, not skip them)."""
        self._fill_to(start)
        drop = start - self.base
        if drop > 0:
            self.buf = self.buf[min(drop, len(self.buf)):]
            self.base = start
