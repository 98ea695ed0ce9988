"""Batched spectral statistics shared by the EQ analyzer and comparators,
PyTorch port of tomatis_tpu/analysis/spectra.py
(ref src/layer2_analyze_eq.py:54-88, src/compare_audio.py:12-29).

All per-frame FFT loops of the reference run as one device op over the
framed mono-power signal: framing, rFFT and power on the device
(torch.fft.rfft), the median on the host (np.median averages the two
middle values of an even count; torch.median does not).
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.analysis.align import EPS, power_mono
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device


def _mono_frames(mono, n_fft: int, hop: int, n_frames: int, dev):
    """Host mono signal -> (frames [F, n_fft], window [n_fft]) on dev."""
    t = torch.from_numpy(np.ascontiguousarray(mono, np.float32)).to(dev)
    win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(dev)
    return stft.frame_signal(t[:, None], n_fft, hop, n_frames)[:, 0, :], win


def _frame_logpower(mono, n_fft: int, hop: int, n_frames: int,
                    device="cuda"):
    """(levels [F] dBFS, log-power spectra [F, bins] dB) as tensors."""
    fr, win = _mono_frames(mono, n_fft, hop, n_frames,
                           resolve_device(device))
    r = torch.sqrt(torch.mean(torch.square(fr), dim=-1) + EPS)
    levels = 20.0 * torch.log10(r + EPS)
    X = torch.fft.rfft(fr * win)
    P = (X.real * X.real + X.imag * X.imag).to(torch.float32)
    return levels, 10.0 * torch.log10(P + EPS)


def logpower_median(x_lr: np.ndarray, sr: int, n_fft: int, hop: int,
                    music_dbfs: float, device="cuda"):
    """Median log-power spectrum over music frames (level > music_dbfs),
    computed on the power-mono signal (ref layer2_analyze_eq.py:54-88).
    Returns (freqs, median_db [bins], used_frames)."""
    mono = power_mono(x_lr)
    n_frames = 1 + (len(mono) - n_fft) // hop
    if n_frames <= 10:
        raise ValueError("segment too short for stable spectral statistics")
    levels, logp = _frame_logpower(mono, n_fft, hop, n_frames, device)
    used_t = levels > music_dbfs
    n_used = int(used_t.sum())
    if n_used < 50:
        raise ValueError(f"too few music frames ({n_used}); lower music_dbfs")
    # only the music frames cross to the host, where the median runs
    med = np.median(logp[used_t].cpu().numpy(), axis=0).astype(np.float32)
    freqs = stft.rfft_freqs(n_fft, sr)
    return freqs, med, n_used


def _frame_mag_mean(mono, n_fft: int, hop: int, n_frames: int,
                    device="cuda"):
    fr, win = _mono_frames(mono, n_fft, hop, n_frames,
                           resolve_device(device))
    return torch.mean(torch.abs(torch.fft.rfft(fr * win)), dim=0)


def mag_avg(mono: np.ndarray, n_fft: int = 4096, hop: int = 2048,
            device="cuda"):
    """Mean magnitude spectrum over all frames (ref compare_audio.py:12-24)."""
    n_frames = 1 + (len(mono) - n_fft) // hop
    return _frame_mag_mean(mono, n_fft, hop, n_frames,
                           device).cpu().numpy()


def band_energy(mag: np.ndarray, freqs: np.ndarray, f1: float, f2: float):
    m = (freqs >= f1) & (freqs < f2)
    return float(np.mean(np.asarray(mag)[m] ** 2) + EPS)


def anchored_delta(delta: np.ndarray, freqs: np.ndarray, anchor_lo: float,
                   anchor_hi: float, clamp_db: float):
    """Remove the anchor-band median and clamp (ref layer2_analyze_eq.py
    :137-144). Returns (delta0, anchor)."""
    mask = (freqs >= anchor_lo) & (freqs <= anchor_hi)
    anchor = float(np.median(delta[mask]))
    return np.clip(delta - anchor, -clamp_db, clamp_db).astype(np.float32), \
        anchor
