"""Pure-Python WAV (RIFF) reader/writer, a copy of tomatis_tpu/io/wav.py.

Supports PCM 16/24/32-bit and IEEE float32, mono/stereo/N-channel,
streaming reads (arbitrary frame ranges) and streaming writes with header
fixup on close.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_SUBTYPE_FMT = {
    "PCM_16": (1, 16),
    "PCM_24": (1, 24),
    "PCM_32": (1, 32),
    "FLOAT": (3, 32),
}


@dataclass
class WavInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str
    data_offset: int
    bytes_per_frame: int


def _parse_header(f) -> WavInfo:
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data_offset = None
    data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt " and fmt is None:
            # first fmt wins, and cap the read: after a crashed writer's
            # csize=0 data header the walker steps through audio bytes,
            # where a stray b'fmt ' with a garbage size must not replace
            # the real format or trigger a multi-GB read
            take = min(csize, 1 << 16)
            fmt = f.read(take)
            f.seek(csize - take + (csize % 2), 1)
        elif cid == b"data" and data_offset is None:
            # first data chunk wins: a writer killed before header fixup
            # leaves csize=0, and the walker would then misread the audio
            # bytes as chunk headers — none of that may override this one
            data_offset = f.tell()
            data_size = csize
            if csize == 0:
                # crashed-writer marker: the audio bytes follow this
                # header and nothing in them parses as chunks — stop
                # instead of walking a possibly GB-sized region 8 bytes
                # at a time (zero bytes parse as csize=0 chunks)
                break
            f.seek(csize + (csize % 2), 1)
        else:
            f.seek(csize + (csize % 2), 1)
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError("short fmt chunk")
    (audio_fmt, channels, sr, _byte_rate, block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        if len(fmt) >= 40:
            audio_fmt = struct.unpack("<H", fmt[24:26])[0]
        else:
            raise ValueError("malformed extensible fmt chunk")
    if audio_fmt == 1:
        subtype = {16: "PCM_16", 24: "PCM_24", 32: "PCM_32"}.get(bits)
    elif audio_fmt == 3 and bits == 32:
        subtype = "FLOAT"
    else:
        subtype = None
    if subtype is None:
        raise ValueError(f"unsupported WAV format: fmt={audio_fmt} bits={bits}")
    bpf = block_align or channels * (bits // 8)
    # tolerate truncated files: trust actual size on disk
    end = f.seek(0, 2)
    avail = max(0, min(data_size, end - data_offset))
    return WavInfo(sr, channels, avail // bpf, subtype, data_offset, bpf)


def _decode(raw: bytes, subtype: str, channels: int) -> np.ndarray:
    if subtype == "PCM_16":
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif subtype == "PCM_32":
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif subtype == "FLOAT":
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif subtype == "PCM_24":
        from tomatis_tpu_torch.utils.pcm import i32_from_le24
        x = (i32_from_le24(np.frombuffer(raw, np.uint8))
             .astype(np.float32) / 8388608.0)
    else:
        raise ValueError(subtype)
    return x.reshape(-1, channels)


def _encode(data: np.ndarray, subtype: str) -> bytes:
    data = np.asarray(data, np.float32)
    if subtype == "FLOAT":
        return data.astype("<f4").tobytes()
    if subtype == "PCM_16":
        v = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
        return v.tobytes()
    if subtype == "PCM_32":
        # float64 before the clip: in float32 the +2147483647 bound
        # rounds up to 2^31, and astype(int32) then wraps +1.0 to -1.0
        v = np.clip(np.rint(data.astype(np.float64) * 2147483648.0),
                    -2147483648, 2147483647).astype("<i4")
        return v.tobytes()
    if subtype == "PCM_24":
        v = np.clip(np.rint(data * 8388608.0), -8388608, 8388607).astype(np.int32)
        flat = v.reshape(-1)
        out = np.empty((flat.size, 3), np.uint8)
        out[:, 0] = flat & 0xFF
        out[:, 1] = (flat >> 8) & 0xFF
        out[:, 2] = (flat >> 16) & 0xFF
        return out.tobytes()
    raise ValueError(subtype)


class WavReader:
    def __init__(self, path):
        self._f = open(path, "rb")
        self.info = _parse_header(self._f)
        self._pos = 0
        self._f.seek(self.info.data_offset)

    samplerate = property(lambda s: s.info.samplerate)
    channels = property(lambda s: s.info.channels)
    frames = property(lambda s: s.info.frames)
    subtype = property(lambda s: s.info.subtype)

    def seek(self, frame: int):
        frame = max(0, min(frame, self.info.frames))
        self._pos = frame
        self._f.seek(self.info.data_offset + frame * self.info.bytes_per_frame)
        return frame

    def tell(self) -> int:
        return self._pos

    def read(self, n_frames: int = -1) -> np.ndarray:
        if n_frames < 0:
            n_frames = self.info.frames - self._pos
        n_frames = max(0, min(n_frames, self.info.frames - self._pos))
        raw = self._f.read(n_frames * self.info.bytes_per_frame)
        got = len(raw) // self.info.bytes_per_frame
        raw = raw[: got * self.info.bytes_per_frame]
        self._pos += got
        return _decode(raw, self.info.subtype, self.info.channels)

    @property
    def int24_readable(self) -> bool:
        return self.info.subtype in ("PCM_16", "PCM_24")

    def read_int24(self, n_frames: int = -1) -> np.ndarray:
        """Read as int32 samples at PCM_24 scale (float = v / 2^23) —
        exact for 16/24-bit sources, skipping the float conversion."""
        if n_frames < 0:
            n_frames = self.info.frames - self._pos
        n_frames = max(0, min(n_frames, self.info.frames - self._pos))
        raw = self._f.read(n_frames * self.info.bytes_per_frame)
        got = len(raw) // self.info.bytes_per_frame
        raw = raw[: got * self.info.bytes_per_frame]
        self._pos += got
        st = self.info.subtype
        if st == "PCM_16":
            v = np.frombuffer(raw, "<i2").astype(np.int32) << 8
        elif st == "PCM_24":
            from tomatis_tpu_torch.utils.pcm import i32_from_le24
            v = i32_from_le24(np.frombuffer(raw, np.uint8))
        else:
            raise ValueError(f"int24 read unsupported for {st}")
        return v.reshape(-1, self.info.channels)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class WavWriter:
    def __init__(self, path, samplerate: int, channels: int, subtype: str = "PCM_24"):
        if subtype not in _SUBTYPE_FMT:
            raise ValueError(f"unsupported WAV subtype {subtype}")
        self.samplerate = samplerate
        self.channels = channels
        self.subtype = subtype
        self._f = open(path, "wb")
        self._data_bytes = 0
        self._write_header(0)

    @classmethod
    def reopen(cls, path, frames: int) -> "WavWriter":
        """Reopen an existing WAV for appending after truncating to
        `frames` sample frames (checkpoint/resume support).

        Trusts the bytes on disk, not the header's data size: a writer
        killed by SIGKILL never ran the close-time header fixup, so the
        header still says 0 frames while the audio bytes are all there."""
        with open(path, "rb") as f:
            info = _parse_header(f)
            end = f.seek(0, 2)
        if info.data_offset != 44:
            # close() rewrites the canonical 44-byte header at offset 0;
            # resuming a WAV with extra pre-data chunks (not one of ours)
            # would shift where readers think the samples start
            raise ValueError(
                f"cannot resume {path!r}: data chunk at offset "
                f"{info.data_offset}, not a WavWriter stage file")
        on_disk = max(0, end - info.data_offset) // info.bytes_per_frame
        if on_disk < frames:
            # the checkpoint promises more audio than the stage holds
            # (power loss can persist the renamed checkpoint but not the
            # buffered stage pages) — resuming would silently drop the
            # gap and shift everything after it
            raise ValueError(
                f"stage file holds {on_disk} frames but the checkpoint "
                f"expects {frames}; delete the checkpoint to restart")
        w = cls.__new__(cls)
        w.samplerate = info.samplerate
        w.channels = info.channels
        w.subtype = info.subtype
        keep = min(frames, on_disk) * info.bytes_per_frame
        w._f = open(path, "r+b")
        w._f.truncate(info.data_offset + keep)
        w._f.seek(info.data_offset + keep)
        w._data_bytes = keep
        return w

    def _write_header(self, data_size: int):
        fmt_code, bits = _SUBTYPE_FMT[self.subtype]
        bpf = self.channels * bits // 8
        self._f.write(struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + data_size, b"WAVE",
            b"fmt ", 16, fmt_code, self.channels, self.samplerate,
            self.samplerate * bpf, bpf, bits,
            b"data", data_size))

    def write(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[1] != self.channels:
            raise ValueError("channel mismatch")
        raw = _encode(data, self.subtype)
        self._f.write(raw)
        self._data_bytes += len(raw)

    def write_raw(self, raw):
        """Append already-encoded sample bytes (e.g. device-packed PCM_24)."""
        raw = bytes(raw) if not isinstance(raw, (bytes, bytearray)) else raw
        self._f.write(raw)
        self._data_bytes += len(raw)

    def flush(self):
        """Push buffered sample bytes to the OS (checkpointed writers
        need data bytes durable-ordered before their state file)."""
        self._f.flush()

    def close(self):
        if self._f.closed:
            return
        self._f.seek(0)
        self._write_header(self._data_bytes)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
