"""Cross-correlation alignment of two recordings, a copy of
tomatis_tpu/analysis/align.py over the port's io.audio (shared by the
calibrators, EQ analyzer and comparators — ref src/calibrate_to_baseline.py
:45-93, src/layer2_analyze_eq.py:17-52, src/compare_audio.py).

Power envelopes are downsampled to ~2 kHz (polyphase) and FFT-correlated:
a mid chunk of the reference recording against the full candidate.
Host numpy and scipy throughout: nothing here runs on the device.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve, resample_poly

from tomatis_tpu_torch.io import audio

EPS = 1e-12


def power_mono(x_lr: np.ndarray) -> np.ndarray:
    """[N, C] -> mono amplitude via power average (ref :6-9)."""
    p = np.mean(x_lr.astype(np.float32) ** 2, axis=1)
    return np.sqrt(p + EPS)


def rms_dbfs_mono(mono: np.ndarray) -> float:
    r = np.sqrt(np.mean(mono * mono) + EPS)
    return float(20 * np.log10(r + EPS))


def find_delay_by_corr(orig_path, base_path, sr: int = 48000,
                       ds_sr: int = 2000, chunk_sec: float = 25.0) -> int:
    """Global delay (samples) of orig relative to base (ref :45-93):
    correlate base's mid chunk envelope against orig's full envelope."""
    with audio.AudioFile(base_path, "r") as fb:
        if fb.samplerate != sr:
            raise ValueError(f"expected {sr} Hz, got {fb.samplerate}")
        n_base = fb.frames
        mid = int(0.5 * n_base)
        half = int(0.5 * chunk_sec * sr)
        s = max(0, mid - half)
        e = min(n_base, mid + half)
        fb.seek(s)
        mb = power_mono(fb.read(e - s))
    mb_ds = resample_poly(mb, ds_sr, sr).astype(np.float32)
    mb_ds = mb_ds - np.mean(mb_ds)

    with audio.AudioFile(orig_path, "r") as fo:
        if fo.samplerate != sr:
            raise ValueError(f"expected {sr} Hz, got {fo.samplerate}")
        chunks = []
        while True:
            x = fo.read(sr * 30)
            if len(x) == 0:
                break
            chunks.append(power_mono(x))
    mo = np.concatenate(chunks).astype(np.float32)
    mo_ds = resample_poly(mo, ds_sr, sr).astype(np.float32)
    mo_ds = mo_ds - np.mean(mo_ds)

    if len(mo_ds) < len(mb_ds):
        # mode='valid' silently commutes its arguments when the first is
        # shorter — argmax would then index into the wrong signal and the
        # delay would be meaningless
        raise ValueError(
            f"orig recording too short for alignment: "
            f"{len(mo_ds) / ds_sr:.1f}s of envelope vs the base's "
            f"{len(mb_ds) / ds_sr:.1f}s search chunk")
    corr = fftconvolve(mo_ds, mb_ds[::-1], mode="valid")
    k = int(np.argmax(corr))
    base_center = (s + (e - s) // 2) / sr
    orig_center = (k + len(mb_ds) // 2) / ds_sr
    return int(round((orig_center - base_center) * sr))


def read_aligned_overlap(orig_path, base_path, delay: int,
                         max_seconds: float, sr: int = 48000):
    """Read the aligned overlapping segment of both files
    (ref calibrate_to_baseline_v2.py:163-178). Returns (xo, xb)."""
    with audio.AudioFile(orig_path, "r") as fo, \
            audio.AudioFile(base_path, "r") as fb:
        base_start = max(0, -delay)
        orig_start = max(0, delay)
        avail = min(fb.frames - base_start, fo.frames - orig_start,
                    int(max_seconds * sr))
        if avail <= 0:
            raise ValueError("no usable aligned overlap")
        fb.seek(base_start)
        fo.seek(orig_start)
        xb = fb.read(avail)
        xo = fo.read(avail)
    return xo, xb
