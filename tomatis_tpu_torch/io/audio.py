"""Audio file I/O facade, port of tomatis_tpu/io/audio.py (WAV only).

API shape mirrors the subset of soundfile the processors use:
    info(path) -> Info(samplerate, channels, frames, format, subtype)
    read(path, frames=-1, start=0, dtype='float32', always_2d=True)
    write(path, data, samplerate, subtype='PCM_24')
    AudioFile(path, 'r'|'w', ...) -- streaming handle with .read/.write/.seek

FLAC is not yet ported: a .flac path raises ValueError rather than
writing some other container.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from tomatis_tpu_torch.io import wav as _wav


@dataclass
class Info:
    samplerate: int
    channels: int
    frames: int
    format: str
    subtype: str

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def _fmt_of(path) -> str:
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".wav", ".wave"):
        return "WAV"
    if ext == ".flac":
        raise ValueError(f"{path!r}: FLAC is not yet ported to the PyTorch "
                         "package (queued in ROADMAP.md); use a .wav path")
    raise ValueError(f"unsupported audio format: {path!r} (WAV supported)")


class AudioFile:
    """Streaming audio file handle (read or write mode)."""

    def __init__(self, path, mode: str = "r", samplerate: int | None = None,
                 channels: int | None = None, subtype: str = "PCM_24"):
        self.path = str(path)
        self.mode = mode
        self.format = _fmt_of(self.path)
        if mode == "r":
            self._h = _wav.WavReader(self.path)
            self.samplerate = self._h.samplerate
            self.channels = self._h.channels
            self.frames = self._h.frames
            self.subtype = self._h.subtype
        elif mode == "w":
            if samplerate is None or channels is None:
                raise ValueError("write mode requires samplerate and channels")
            self.samplerate = int(samplerate)
            self.channels = int(channels)
            self.subtype = subtype
            self._h = _wav.WavWriter(self.path, self.samplerate,
                                     self.channels, subtype)
            self.frames = 0
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- reading -----------------------------------------------------------
    def read(self, n_frames: int = -1, dtype: str = "float32",
             always_2d: bool = True) -> np.ndarray:
        x = self._h.read(n_frames)
        if dtype != "float32":
            x = x.astype(dtype)
        if not always_2d and x.shape[1] == 1:
            x = x[:, 0]
        return x

    def seek(self, frame: int) -> int:
        return self._h.seek(frame)

    def tell(self) -> int:
        return self._h.tell()

    # -- writing -----------------------------------------------------------
    def write(self, data: np.ndarray):
        self._h.write(data)
        data = np.asarray(data)
        self.frames += data.shape[0] if data.ndim > 1 else data.size

    @property
    def supports_raw(self) -> bool:
        return self.subtype == "PCM_24"

    def write_raw(self, raw):
        """Append pre-encoded sample bytes (PCM_24 writers only)."""
        self._h.write_raw(raw)
        self.frames += len(raw) // (3 * self.channels)

    def close(self):
        self._h.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def info(path) -> Info:
    with AudioFile(path, "r") as f:
        return Info(f.samplerate, f.channels, f.frames, f.format, f.subtype)


def read(path, frames: int = -1, start: int = 0, dtype: str = "float32",
         always_2d: bool = True):
    """Read (data, samplerate), like soundfile.read."""
    with AudioFile(path, "r") as f:
        if start:
            f.seek(start)
        x = f.read(frames, dtype=dtype, always_2d=always_2d)
        return x, f.samplerate


def write(path, data, samplerate: int, subtype: str = "PCM_24"):
    data = np.asarray(data)
    ch = data.shape[1] if data.ndim > 1 else 1
    with AudioFile(path, "w", samplerate=samplerate, channels=ch,
                   subtype=subtype) as f:
        f.write(data)
