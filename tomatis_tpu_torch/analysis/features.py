"""Frame features + clustering for calibration, PyTorch port of
tomatis_tpu/analysis/features.py (ref src/calibrate_to_baseline.py:6-43,
src/calibrate_to_baseline_v2.py).

The per-frame loop of the reference (level + band-tilt per frame) is one
batched device op here: all frames -> rFFT -> band energies in one shot.
The clustering helpers are host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.analysis.align import EPS
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device


def _frame_features(xo, xb, n_fft: int, hop: int, n_frames: int, sr: int,
                    lo, hi):
    """xo, xb [N, C] tensors on one device -> (orig level, base level,
    base tilt), each [F]."""
    dev = xb.device
    win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(dev)
    freqs = torch.from_numpy(stft.rfft_freqs(n_fft, sr)).to(dev)

    def mono_frames(x):
        fr = stft.frame_signal(x, n_fft, hop, n_frames)   # [F, C, n_fft]
        return torch.sqrt(torch.mean(torch.square(fr), dim=1) + EPS)

    def level(m):
        r = torch.sqrt(torch.mean(torch.square(m), dim=-1) + EPS)
        return 20.0 * torch.log10(r + EPS)

    mo = mono_frames(xo)
    mb = mono_frames(xb)
    X = torch.fft.rfft(mb * win)                          # [F, bins]
    P = (X.real * X.real + X.imag * X.imag).to(torch.float32)
    lo_m = (freqs >= lo[0]) & (freqs < lo[1])
    hi_m = (freqs >= hi[0]) & (freqs < hi[1])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    e_lo = torch.sum(torch.where(lo_m, P, zero), dim=-1) + EPS
    e_hi = torch.sum(torch.where(hi_m, P, zero), dim=-1) + EPS
    tilt = 10.0 * torch.log10(e_hi / e_lo + EPS)
    return level(mo), level(mb), tilt


def frame_features(xo: np.ndarray, xb: np.ndarray, sr: int, n_fft: int,
                   hop: int, lo=(200, 1000), hi=(2000, 8000),
                   device="cuda"):
    """Per-frame (orig level, base level, base band tilt), batched.
    Frames start at 0, hop, ... while start + n_fft <= len."""
    dev = resolve_device(device)
    avail = min(len(xo), len(xb))
    n_frames = 1 + (avail - n_fft) // hop
    xo_t = torch.from_numpy(np.ascontiguousarray(xo[:avail],
                                                 np.float32)).to(dev)
    xb_t = torch.from_numpy(np.ascontiguousarray(xb[:avail],
                                                 np.float32)).to(dev)
    ol, bl, tl = _frame_features(xo_t, xb_t, n_fft, hop, n_frames, sr,
                                 tuple(lo), tuple(hi))
    starts = (np.arange(n_frames) * hop).astype(np.int64)
    return ol.cpu().numpy(), bl.cpu().numpy(), tl.cpu().numpy(), starts


def kmeans2_1d(x: np.ndarray, iters: int = 20):
    """Tiny 1-D 2-means (ref calibrate_to_baseline.py:31-43)."""
    m1, m2 = np.percentile(x, [30, 70]).astype(float)
    for _ in range(iters):
        d1 = np.abs(x - m1)
        d2 = np.abs(x - m2)
        c1 = x[d1 <= d2]
        c2 = x[d1 > d2]
        if len(c1) > 0:
            m1 = float(np.mean(c1))
        if len(c2) > 0:
            m2 = float(np.mean(c2))
    lab = (np.abs(x - m2) < np.abs(x - m1)).astype(np.int32)
    return lab, m1, m2


def tilt_to_states(tilts: np.ndarray) -> np.ndarray:
    """Cluster tilt into C1/C2; higher tilt => C2 (brighter)."""
    lab, m1, m2 = kmeans2_1d(tilts)
    mean0 = float(np.mean(tilts[lab == 0])) if np.any(lab == 0) else -1e9
    mean1 = float(np.mean(tilts[lab == 1])) if np.any(lab == 1) else -1e9
    hot = 1 if mean1 > mean0 else 0
    return np.where(lab == hot, 2, 1).astype(np.int32)


def debounce_state(state: np.ndarray, min_run: int = 3) -> np.ndarray:
    """Absorb runs shorter than min_run into the left neighbor
    (ref calibrate_to_baseline_v2.py:111-128)."""
    s = state.copy()
    n = len(s)
    i = 0
    while i < n:
        j = i + 1
        while j < n and s[j] == s[i]:
            j += 1
        if j - i < min_run:
            left = s[i - 1] if i > 0 else (s[j] if j < n else s[i])
            s[i:j] = left
        i = j
    return s
