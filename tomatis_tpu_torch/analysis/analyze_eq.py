"""Layer-2 static EQ analyzer, PyTorch port of
tomatis_tpu/analysis/analyze_eq.py (capability parity with
ref src/layer2_analyze_eq.py): derive the base-minus-target EQ curve from
median log-power spectra over music frames, anchored to 0 in the mid band,
clamped and Savitzky-Golay smoothed -> layer2_eq_curve.csv (+ PNG)."""
from __future__ import annotations

import numpy as np
from scipy.signal import savgol_filter

from tomatis_tpu_torch.analysis.align import (find_delay_by_corr,
                                              read_aligned_overlap)
from tomatis_tpu_torch.analysis.spectra import (anchored_delta,
                                                logpower_median)
from tomatis_tpu_torch.utils.device import resolve_device


def analyze_eq(base_path, target_path, sr: int = 48000,
               max_minutes: float = 6.0, n_fft: int = 8192, hop: int = 4096,
               music_dbfs: float = -65.0, anchor_lo: float = 300.0,
               anchor_hi: float = 3000.0, clamp_db: float = 12.0,
               smooth_bins: int = 71, out_csv="layer2_eq_curve.csv",
               out_png="layer2_eq_curve.png", device="cuda") -> dict:
    dev = resolve_device(device)
    delay = find_delay_by_corr(target_path, base_path, sr=sr)
    xt, xb = read_aligned_overlap(target_path, base_path, delay,
                                  max_minutes * 60, sr)
    freqs, med_b, used_b = logpower_median(xb, sr, n_fft, hop, music_dbfs,
                                           device=dev)
    _, med_t, used_t = logpower_median(xt, sr, n_fft, hop, music_dbfs,
                                       device=dev)

    delta = (med_b - med_t).astype(np.float32)
    delta0, anchor = anchored_delta(delta, freqs, anchor_lo, anchor_hi,
                                    clamp_db)

    w = int(smooth_bins) | 1
    w = max(11, w)
    if w >= len(delta0):
        w = len(delta0) - 1 if (len(delta0) - 1) % 2 == 1 else len(delta0) - 2
    delta_s = savgol_filter(delta0, window_length=w,
                            polyorder=3).astype(np.float32)

    if out_csv:
        out = np.stack([freqs, delta0, delta_s], axis=1)
        np.savetxt(out_csv, out, delimiter=",",
                   header="freq_hz,delta_db_raw,delta_db_smooth", comments="")
    if out_png:
        _plot(out_png, freqs, delta0, delta_s, clamp_db, sr)
    return dict(delay_samples=delay, anchor_db=anchor,
                used_frames_base=used_b, used_frames_target=used_t,
                freqs=freqs, delta_raw=delta0, delta_smooth=delta_s,
                out_csv=out_csv)


def _plot(path, freqs, delta0, delta_s, clamp, sr):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(12, 6))
    plt.plot(freqs, delta0, label="raw (anchored, clamped)")
    plt.plot(freqs, delta_s, label="smooth")
    plt.xscale("log")
    plt.xlim(20, sr / 2)
    plt.ylim(-clamp - 1, clamp + 1)
    plt.grid(True, which="both", ls="--", alpha=0.4)
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Delta (dB)  [base - target]")
    plt.title("Layer2 EQ Curve (Static)")
    plt.legend()
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
