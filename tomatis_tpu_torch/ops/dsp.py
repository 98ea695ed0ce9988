"""Core DSP primitives, PyTorch port of tomatis_tpu/ops/dsp.py.

Plain functions on float32 tensors with the reference's numerical
semantics (same EPS idioms, same plateau construction). Python-float
constants never promote a tensor: every result stays float32.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12
PEAK_LIMIT = 0.999


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def db_to_lin(db) -> torch.Tensor:
    """dB -> linear amplitude gain, float32."""
    return torch.pow(_f32(10.0), _f32(db) / 20.0)


def lin_to_db(lin, eps: float = EPS) -> torch.Tensor:
    """Linear amplitude -> dB with the reference's epsilon guard."""
    return 20.0 * torch.log10(_f32(lin) + eps)


def power_mono(frame: torch.Tensor) -> torch.Tensor:
    """[..., n, ch] -> [..., n] mono by power average (not (L+R)/2)."""
    return torch.sqrt(torch.mean(torch.square(frame), dim=-1))


def rms_dbfs(x_mono: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """RMS level in dBFS over the last axis, double-epsilon idiom:
    r = sqrt(mean(x^2) + EPS);  level = 20*log10(r + EPS)."""
    r = torch.sqrt(torch.mean(torch.square(x_mono), dim=-1) + eps)
    return 20.0 * torch.log10(r + eps)


def frame_levels_dbfs(frames: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-frame RMS dBFS of multichannel frames [..., n, ch]; the same
    scalar as rms_dbfs(power_mono(frames)), fused."""
    m = torch.mean(torch.square(frames), dim=(-2, -1)) + eps
    return 20.0 * torch.log10(torch.sqrt(m) + eps)


def gate_ui_to_dbfs(gate_ui, gate_scale: float = 1.0,
                    gate_offset: float = -100.0):
    """Linear UI->dBFS gate mapping: T = scale*ui + offset."""
    return gate_scale * gate_ui + gate_offset


def gate_ui_to_dbfs_log_percent(gate_ui, dynamic_range: float = 80.0):
    """Log-percent UI->dBFS gate mapping: T = -DR + DR*ui/100."""
    return -dynamic_range + dynamic_range * gate_ui / 100.0


def build_tilt_gain_db(freqs, fc, slope_db_per_oct, low_gain_db,
                       high_gain_db):
    """Tilt gain curve in dB with a 0 dB pivot at fc.

    Each side ramps from 0 dB at fc toward its plateau and clamps there:
        x = log2(max(f,1)/fc)
        low  side (x<0): g = sign(g_lo) * min(slope*|x|, |g_lo|)
        high side (x>0): g = sign(g_hi) * min(slope* x , |g_hi|)
    Bins with x == 0 keep g = 0. No single clip(low, high): it breaks when
    low_db > high_db.

    A numpy ``freqs`` takes the numpy branch, so the host builds the C1/C2
    tables exactly as the reference does; a tensor stays a tensor. The
    result is float32 either way.
    """
    if isinstance(freqs, torch.Tensor):
        f = torch.clamp(freqs.to(torch.float32), min=1.0)
        x = torch.log2(f / fc)
        zero = torch.zeros_like(x)
        g_low = float(np.sign(low_gain_db)) * torch.minimum(
            slope_db_per_oct * torch.clamp(-x, min=0.0),
            _f32(abs(low_gain_db)))
        g_hi = float(np.sign(high_gain_db)) * torch.minimum(
            slope_db_per_oct * torch.clamp(x, min=0.0),
            _f32(abs(high_gain_db)))
        return torch.where(x < 0, g_low, torch.where(x > 0, g_hi, zero))
    f = np.maximum(np.asarray(freqs, dtype=np.float32), 1.0)
    x = np.log2(f / fc).astype(np.float32)
    d_low = slope_db_per_oct * np.maximum(0.0, -x)
    g_low = np.sign(low_gain_db) * np.minimum(d_low, abs(low_gain_db))
    d_hi = slope_db_per_oct * np.maximum(0.0, x)
    g_hi = np.sign(high_gain_db) * np.minimum(d_hi, abs(high_gain_db))
    g = np.where(x < 0, g_low, np.where(x > 0, g_hi, 0.0))
    return g.astype(np.float32)


def tilt_platform_freqs(fc, slope, low_gain_db, high_gain_db):
    """Plateau start frequencies:
    f_lo = fc * 2^(-|G_lo|/slope),  f_hi = fc * 2^(|G_hi|/slope)."""
    f_lo = fc * 2.0 ** (-abs(low_gain_db) / slope)
    f_hi = fc * 2.0 ** (abs(high_gain_db) / slope)
    return f_lo, f_hi
