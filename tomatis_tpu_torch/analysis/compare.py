"""Pairwise comparator, PyTorch port of tomatis_tpu/analysis/compare.py
(capability parity with ref src/compare_audio.py):
align, anchor-gain the candidate, per-band spectral deltas, residual SNR,
diff_spectrum.csv for the layer-2b residual appliers. The three mean
magnitude spectra run on the device (analysis.spectra.mag_avg); the
alignment and the band statistics are host numpy."""
from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve, resample_poly

from tomatis_tpu_torch.analysis.align import EPS, power_mono, rms_dbfs_mono
from tomatis_tpu_torch.analysis.spectra import band_energy, mag_avg
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device

BANDS = [(200, 1000), (1000, 3000), (3000, 8000), (8000, 16000)]


def find_delay_full(base_mono: np.ndarray, cand_mono: np.ndarray, sr: int,
                    ds_sr: int = 2000) -> int:
    """Full-mode envelope correlation (ref compare_audio.py:28-40):
    returns delay in samples (cand - base)."""
    b = resample_poly(base_mono - base_mono.mean(), ds_sr,
                      sr).astype(np.float32)
    c = resample_poly(cand_mono - cand_mono.mean(), ds_sr,
                      sr).astype(np.float32)
    corr = fftconvolve(c, b[::-1], mode="full")
    k = int(np.argmax(corr))
    shift_ds = k - (len(b) - 1)
    return int(round(shift_ds * (sr / ds_sr)))


def align_pair(base_lr, cand_lr, delay: int):
    """Drop heads per delay sign; crop to common length (ref :42-49)."""
    if delay > 0:
        cand_lr = cand_lr[delay:]
    elif delay < 0:
        base_lr = base_lr[-delay:]
    n = min(len(base_lr), len(cand_lr))
    return base_lr[:n], cand_lr[:n]


def compare_audio(base_path, cand_path, sr: int = 48000, n_fft: int = 4096,
                  hop: int = 2048, out_csv="diff_spectrum.csv",
                  device="cuda") -> dict:
    dev = resolve_device(device)
    b_lr, sr1 = audio.read(base_path)
    c_lr, sr2 = audio.read(cand_path)
    if sr1 != sr or sr2 != sr:
        raise ValueError(f"expected {sr} Hz, got {sr1}/{sr2}")
    if b_lr.shape[1] != 2 or c_lr.shape[1] != 2:
        raise ValueError("stereo required")

    delay = find_delay_full(power_mono(b_lr), power_mono(c_lr), sr)
    b_lr2, c_lr2 = align_pair(b_lr, c_lr, delay)
    b2 = power_mono(b_lr2)

    freqs = stft.rfft_freqs(n_fft, sr)
    b_mag = mag_avg(b2, n_fft, hop, device=dev)
    c_mag = mag_avg(power_mono(c_lr2), n_fft, hop, device=dev)

    # level anchor on 300-3000 Hz band energy (ref :71-82)
    gain_lin = float(np.sqrt(band_energy(b_mag, freqs, 300, 3000)
                             / band_energy(c_mag, freqs, 300, 3000)))
    gain_db = 20 * np.log10(gain_lin + EPS)
    c_lr2s = c_lr2 * np.float32(gain_lin)

    c_mag2 = mag_avg(power_mono(c_lr2s), n_fft, hop, device=dev)
    diff_db = 20 * np.log10((b_mag + EPS) / (c_mag2 + EPS))

    bands = {}
    for f1, f2 in BANDS:
        m = (freqs >= f1) & (freqs < f2)
        bands[f"{f1}-{f2}"] = dict(mean=float(diff_db[m].mean()),
                                   std=float(diff_db[m].std()))

    res = b_lr2 - c_lr2s
    snr = rms_dbfs_mono(b2) - rms_dbfs_mono(power_mono(res))

    if out_csv:
        out = np.stack([freqs, diff_db], axis=1)
        np.savetxt(out_csv, out, delimiter=",",
                   header="freq_hz,delta_db_base_minus_cand", comments="")
    return dict(delay_samples=delay, anchor_gain_db=float(gain_db),
                anchor_gain_lin=gain_lin, bands=bands, snr_db=float(snr),
                freqs=freqs, diff_db=diff_db, out_csv=out_csv)
