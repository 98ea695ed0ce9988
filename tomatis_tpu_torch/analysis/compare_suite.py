"""Comparison/report suite, PyTorch port of
tomatis_tpu/analysis/compare_suite.py (capability parity with
ref src/compare_to_baseline.py, src/compare_three.py,
src/compare_diff_spectrum.py, src/plot_diff_spectrum.py).

Each tool keeps its reference quirks (mean-of-log vs Welch window-power
normalization vs RMS-gated mean power; anchored deltas; per-tool CSV
schemas). The per-frame FFT accumulations run as batched device ops:
framing, levels, rFFT power and the frame means (in float64, as the
reference's host numpy takes them) on the device, so only [bins] vectors
come back. Alignment, band statistics, envelopes and the log-grid
resampling are host numpy. Plots are drawn when matplotlib imports; where
it does not, no PNG is written, as in the reference.
"""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from tomatis_tpu_torch.analysis.align import (EPS, find_delay_by_corr,
                                              power_mono,
                                              read_aligned_overlap)
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device


def smooth_ma(y: np.ndarray, win: int = 31) -> np.ndarray:
    if win <= 1:
        return np.asarray(y).copy()
    win = int(win) | 1
    pad = win // 2
    yp = np.pad(y, (pad, pad), mode="edge")
    return np.convolve(yp, np.ones(win) / win, mode="valid").astype(y.dtype)


def band_mean(freqs, y, f1, f2) -> float:
    m = (freqs >= f1) & (freqs < f2)
    return float(np.mean(np.asarray(y)[m])) if np.any(m) else float("nan")


# ---------------------------------------------------------------------------
# batched spectral accumulators
# ---------------------------------------------------------------------------

def _frame_power(mono, n_fft: int, hop: int, n_frames: int, periodic: bool,
                 dev):
    """(levels [F] dBFS, rFFT power [F, bins]) of a host mono signal, on
    dev. The window is the periodic Hann when `periodic`, else the
    symmetric one."""
    t = torch.from_numpy(np.ascontiguousarray(mono, np.float32)).to(dev)
    win = torch.from_numpy(stft.hann_periodic(n_fft) if periodic
                           else stft.hann_symmetric(n_fft)).to(dev)
    fr = stft.frame_signal(t[:, None], n_fft, hop, n_frames)[:, 0, :]
    lv = 20.0 * torch.log10(torch.sqrt(torch.mean(torch.square(fr), dim=-1)
                                       + EPS) + EPS)
    X = torch.fft.rfft(fr * win)
    return lv, (X.real * X.real + X.imag * X.imag).to(torch.float32)


def mean_of_log_spectrum(mono: np.ndarray, sr: int, n_fft: int, hop: int,
                         device="cuda"):
    """Average of per-frame 10log10 power (ref compare_to_baseline.py
    :104-121)."""
    n_frames = 1 + (len(mono) - n_fft) // hop
    if n_frames < 1:
        raise ValueError("segment too short")
    _, P = _frame_power(mono, n_fft, hop, n_frames, False,
                        resolve_device(device))
    logs = 10.0 * torch.log10(P.to(torch.float64) + EPS)
    freqs = stft.rfft_freqs(n_fft, sr).astype(np.float32)
    return freqs, logs.mean(dim=0).cpu().numpy().astype(np.float32)


def welch_spectrum_db(x_lr: np.ndarray, sr: int, n_fft: int = 8192,
                      hop: int = 4096, device="cuda"):
    """Welch-style window-power-normalized mean power spectrum with the
    PERIODIC hann (ref compare_three.py:102-127)."""
    mono = power_mono(x_lr).astype(np.float32)
    n_frames = 1 + (len(mono) - n_fft) // hop
    freqs = stft.rfft_freqs(n_fft, sr)
    if n_frames < 1:
        return freqs, np.full(len(freqs), -120.0, np.float32)
    _, P = _frame_power(mono, n_fft, hop, n_frames, True,
                        resolve_device(device))
    win = stft.hann_periodic(n_fft)
    win_pow = float(np.sum(win * win) + EPS)
    acc = P.to(torch.float64).mean(dim=0).cpu().numpy() / win_pow
    return freqs, (10.0 * np.log10(acc + EPS)).astype(np.float32)


def gated_mean_power(x_lr: np.ndarray, sr: int, n_fft: int, hop: int,
                     rms_gate_dbfs: float = -80.0, device="cuda"):
    """Mean power spectrum over frames above an RMS gate
    (ref compare_diff_spectrum.py:79-119)."""
    mono = power_mono(x_lr).astype(np.float32)
    n_frames = 1 + (len(mono) - n_fft) // hop
    if n_frames < 1:
        raise ValueError("segment too short")
    lv, P = _frame_power(mono, n_fft, hop, n_frames, False,
                         resolve_device(device))
    used = lv >= rms_gate_dbfs
    n_used = int(used.sum())
    if not n_used:
        raise RuntimeError("no frames pass rms_gate_dbfs; lower the gate")
    freqs = stft.rfft_freqs(n_fft, sr).astype(np.float64)
    return (freqs, P[used].to(torch.float64).mean(dim=0).cpu().numpy(),
            n_used)


def rms_envelope_dbfs(x_lr: np.ndarray, sr: int, win_ms: float = 50,
                      hop_ms: float = 25):
    """Frame RMS dBFS envelope of the power-mono signal
    (ref compare_to_baseline.py:188-202)."""
    mono = power_mono(x_lr)
    win = max(int(sr * win_ms / 1000.0), 256)
    hop = max(int(sr * hop_ms / 1000.0), 128)
    n_frames = max(0, 1 + (len(mono) - win) // hop)
    t = np.arange(n_frames) * hop / sr
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    fr = mono[idx]
    y = 20 * np.log10(np.sqrt(np.mean(fr * fr, axis=1) + EPS) + EPS)
    return t.astype(np.float32), y.astype(np.float32)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib
    does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


# ---------------------------------------------------------------------------
# compare_to_baseline (multi-candidate)
# ---------------------------------------------------------------------------

BANDS6 = [("20-80", 20, 80), ("80-200", 80, 200), ("200-1k", 200, 1000),
          ("1k-3k", 1000, 3000), ("3k-8k", 3000, 8000),
          ("8k-16k", 8000, 16000)]


def compare_to_baseline(baseline, candidates, outdir, sr: int = 48000,
                        n_fft: int = 4096, hop: int = 2048,
                        max_minutes: float = 8.0, device="cuda") -> list:
    """Per-candidate aligned comparison -> diff_<name>.csv, summary.txt,
    delta_overlay.png, env_rms_dbfs.png (ref compare_to_baseline.py)."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    results = []
    for cand in candidates:
        delay = find_delay_by_corr(cand, baseline, sr=sr)
        xc_seg, xb_seg = read_aligned_overlap(cand, baseline, delay,
                                              max_minutes * 60, sr)
        mb = power_mono(xb_seg)
        mc = power_mono(xc_seg)
        rb = np.sqrt(np.mean(mb * mb) + EPS)
        rc = np.sqrt(np.mean(mc * mc) + EPS)
        gain_db = float(20 * np.log10((rb + EPS) / (rc + EPS)))

        freqs, sb = mean_of_log_spectrum(mb, sr, n_fft, hop, dev)
        _, sc = mean_of_log_spectrum(mc, sr, n_fft, hop, dev)
        d_raw = (sb - sc).astype(np.float32)
        anchor = band_mean(freqs, d_raw, 300.0, 3000.0)
        d_anch = (d_raw - anchor).astype(np.float32)
        d_smooth = smooth_ma(d_anch, 31)
        stats = {name: band_mean(freqs, d_smooth, lo, hi)
                 for name, lo, hi in BANDS6}
        music_err = float(np.nanmean([abs(stats["200-1k"]),
                                      abs(stats["1k-3k"]),
                                      abs(stats["3k-8k"])]))
        noise_delta = stats["8k-16k"]
        g = 10.0 ** (gain_db / 20.0)
        resid = mb - mc * g
        snr = float(10 * np.log10((np.sum(mb * mb) + EPS)
                                  / (np.sum(resid * resid) + EPS)))
        name = os.path.splitext(os.path.basename(str(cand)))[0]
        np.savetxt(os.path.join(outdir, f"diff_{name}.csv"),
                   np.column_stack([freqs, d_raw, d_anch, d_smooth]),
                   delimiter=",",
                   header="freq_hz,delta_raw_db,delta_anchored_db,"
                          "delta_smooth_db", comments="")
        results.append(dict(name=name, path=str(cand), delay=delay,
                            gain_db=gain_db, anchor_db=anchor, snr=snr,
                            stats=stats, music_err=music_err,
                            noise_delta=noise_delta, freqs=freqs,
                            delta_smooth=d_smooth, xb_seg=xb_seg,
                            xc_seg=xc_seg))

    with open(os.path.join(outdir, "summary.txt"), "w",
              encoding="utf-8") as f:
        f.write(f"Baseline: {baseline}\n")
        f.write(f"Max minutes analyzed: {max_minutes}\n")
        f.write("=" * 80 + "\n\n")
        for r in results:
            f.write(f"[{r['name']}]\n")
            f.write(f"  file: {r['path']}\n")
            f.write(f"  align delay (cand - base): {r['delay']} samples "
                    f"({r['delay'] / sr * 1000:.2f} ms)\n")
            f.write(f"  rms gain_db (base/cand): {r['gain_db']:.2f} dB\n")
            f.write(f"  anchor(300-3k) removed: {r['anchor_db']:.2f} dB\n")
            f.write(f"  time SNR (ref): {r['snr']:.2f} dB\n")
            f.write("  band delta (dB, baseline - candidate, "
                    "anchored+smooth):\n")
            for k, _, _ in BANDS6:
                f.write(f"    {k:>7}: {r['stats'][k]:+6.2f}\n")
            f.write(f"  music_err (200-8k abs avg): {r['music_err']:.2f} dB\n")
            f.write(f"  noise_delta (8k-16k): {r['noise_delta']:+.2f} dB\n\n")

    plt = _pyplot()
    if plt is not None:
        plt.figure(figsize=(12, 5))
        for r in results:
            plt.semilogx(r["freqs"], r["delta_smooth"], label=r["name"])
        plt.axhline(0.0, linewidth=1)
        plt.title("Candidate vs Baseline (Delta = base - cand, "
                  "anchored@300-3k, smooth)")
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Delta dB (base - candidate)")
        plt.grid(True, which="both", ls="--", alpha=0.4)
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(outdir, "delta_overlay.png"), dpi=160)
        plt.close()

        plt.figure(figsize=(12, 6))
        tb, eb = rms_envelope_dbfs(results[0]["xb_seg"], sr)
        plt.plot(tb, eb, label="baseline")
        for r in results:
            tc, ec = rms_envelope_dbfs(r["xc_seg"], sr)
            plt.plot(tc, ec, label=r["name"], alpha=0.8)
        plt.title("RMS dBFS Envelope (aligned overlap)")
        plt.xlabel("Time (s)")
        plt.ylabel("RMS dBFS")
        plt.grid(True, ls="--", alpha=0.4)
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(outdir, "env_rms_dbfs.png"), dpi=160)
        plt.close()
    for r in results:
        r.pop("xb_seg")
        r.pop("xc_seg")
    return results


# ---------------------------------------------------------------------------
# compare_three (Welch spectra, envelope overlay)
# ---------------------------------------------------------------------------

def compare_three(base, candidates, sr: int = 48000, ds_sr: int = 2000,
                  plot_sec: float = 500.0, max_sec_spec: float = 600.0,
                  n_fft: int = 8192, hop: int = 4096, smooth_win: int = 31,
                  out_prefix: str = "cmp", device="cuda") -> list:
    """Welch-spectrum deltas + envelope overlays for multiple candidates
    (ref compare_three.py:146-267)."""
    dev = resolve_device(device)
    results = []
    plt = _pyplot()
    if plt is not None:
        fig_env = plt.figure(figsize=(14, 6))
        fig_dlt = plt.figure(figsize=(14, 6))
        delay0 = find_delay_by_corr(candidates[0], base, sr=sr, ds_sr=ds_sr)
        xc0, xb0 = read_aligned_overlap(candidates[0], base, delay0,
                                        plot_sec, sr)
        env_b, _ = rms_envelope_dbfs(xb0, sr)
        t = np.arange(len(env_b)) * 0.025
        plt.figure(fig_env.number)
        plt.plot(t, env_b, label="baseline")

    for cand in candidates:
        delay = find_delay_by_corr(cand, base, sr=sr, ds_sr=ds_sr)
        xc_s, xb_s = read_aligned_overlap(cand, base, delay, max_sec_spec, sr)
        freqs, sb = welch_spectrum_db(xb_s, sr, n_fft, hop, dev)
        _, sc = welch_spectrum_db(xc_s, sr, n_fft, hop, dev)
        delta = (sb - sc).astype(np.float32)
        anchor = band_mean(freqs, delta, 300, 3000)
        delta_a = (delta - anchor).astype(np.float32)
        delta_s = smooth_ma(delta_a, smooth_win)
        name = os.path.basename(str(cand))
        res = dict(cand=str(cand), delay_samples=delay,
                   delay_ms=delay / sr * 1000.0, anchor_300_3k_db=anchor,
                   band_200_1k_db=band_mean(freqs, delta_a, 200, 1000),
                   band_1k_3k_db=band_mean(freqs, delta_a, 1000, 3000),
                   band_3k_8k_db=band_mean(freqs, delta_a, 3000, 8000),
                   band_8k_16k_db=band_mean(freqs, delta_a, 8000, 16000))
        results.append(res)
        np.savetxt(f"{out_prefix}_diff_{name}.csv",
                   np.stack([freqs, delta_a, delta_s], axis=1),
                   delimiter=",",
                   header="freq_hz,delta_db_anchored,delta_db_smooth",
                   comments="")
        if plt is not None:
            xc_p, _ = read_aligned_overlap(cand, base, delay, plot_sec, sr)
            env_c, _ = rms_envelope_dbfs(xc_p, sr)
            plt.figure(fig_env.number)
            plt.plot(np.arange(len(env_c)) * 0.025, env_c, label=name,
                     alpha=0.8)
            plt.figure(fig_dlt.number)
            plt.semilogx(freqs[1:], delta_s[1:], label=name)

    if plt is not None:
        plt.figure(fig_env.number)
        plt.xlabel("Time (s)")
        plt.ylabel("RMS dBFS")
        plt.legend()
        plt.grid(True, ls="--", alpha=0.4)
        plt.tight_layout()
        plt.savefig(f"{out_prefix}_envelopes.png", dpi=150)
        plt.figure(fig_dlt.number)
        plt.axhline(0, linewidth=1)
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Delta dB (base - cand)")
        plt.legend()
        plt.grid(True, which="both", ls="--", alpha=0.4)
        plt.tight_layout()
        plt.savefig(f"{out_prefix}_delta.png", dpi=150)
        plt.close("all")
    return results


# ---------------------------------------------------------------------------
# compare_diff_spectrum (log-grid) + plot_diff_spectrum
# ---------------------------------------------------------------------------

def compare_diff_spectrum(base, cand, sr: int = 48000, n_fft: int = 8192,
                          hop: int = 4096, max_minutes: float = 10.0,
                          rms_gate_dbfs: float = -80.0,
                          anchor=(300.0, 3000.0), clamp=(-12.0, 12.0),
                          smooth_win: int = 31, log_grid_n: int = 512,
                          out_csv="diff_spectrum.csv",
                          out_png="diff_vs_baseline.png",
                          device="cuda") -> dict:
    """RMS-gated mean power spectra, anchored + clamped delta resampled to
    a log-f grid with moving-average smoothing
    (ref compare_diff_spectrum.py:131-230)."""
    dev = resolve_device(device)
    delay = find_delay_by_corr(cand, base, sr=sr)
    xc, xb = read_aligned_overlap(cand, base, delay, max_minutes * 60, sr)
    freqs, p_base, used_b = gated_mean_power(xb, sr, n_fft, hop,
                                             rms_gate_dbfs, dev)
    _, p_cand, used_c = gated_mean_power(xc, sr, n_fft, hop, rms_gate_dbfs,
                                         dev)
    delta_db = (10 * np.log10(p_base + EPS)
                - 10 * np.log10(p_cand + EPS))
    am = (freqs >= anchor[0]) & (freqs <= anchor[1])
    anchor_db = float(np.mean(delta_db[am])) if np.any(am) else 0.0
    delta_db = np.clip(delta_db - anchor_db, clamp[0], clamp[1])

    fmin = max(20.0, float(freqs[1]))
    fmax = float(freqs[-1])
    flog = np.logspace(np.log10(fmin), np.log10(fmax), log_grid_n)
    delta_log = np.interp(flog, freqs, delta_db)
    delta_smooth = smooth_ma(delta_log, smooth_win)

    if out_csv:
        np.savetxt(out_csv, np.stack([flog, delta_log, delta_smooth], 1),
                   delimiter=",",
                   header="freq_hz,delta_db_raw,delta_db_smooth",
                   comments="")
    plt = _pyplot() if out_png else None
    if plt is not None:
        plt.figure(figsize=(16, 7))
        plt.semilogx(flog, delta_log, label="raw")
        plt.semilogx(flog, delta_smooth,
                     label=f"smooth (win={smooth_win})")
        plt.axhline(0.0, linewidth=1.0)
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Delta dB (base - candidate)")
        plt.grid(True, which="both", ls="--", alpha=0.35)
        plt.legend()
        plt.tight_layout()
        plt.savefig(out_png, dpi=150)
        plt.close()
    return dict(delay_samples=delay, anchor_db=anchor_db,
                used_frames=(used_b, used_c), freqs=flog,
                delta_raw=delta_log, delta_smooth=delta_smooth)


def _read_columns(in_csv) -> dict:
    """A CSV's columns by header name, each a list of its cells."""
    with open(in_csv, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    return {name: [r[j] if j < len(r) else "" for r in body]
            for j, name in enumerate(header)}


def _floats(cells) -> np.ndarray:
    """Cells as floats, an empty one NaN (as pandas.read_csv reads it)."""
    return np.array([float(c) if c.strip() else np.nan for c in cells],
                    float)


def plot_diff_spectrum(in_csv, out_png=None, title="Diff Spectrum "
                       "(base - candidate)", smooth_win: int = 31,
                       xlim=(20, 20000)) -> dict:
    """Plot any diff CSV with tolerant column names
    (ref plot_diff_spectrum.py:13-110)."""
    cols = _read_columns(in_csv)

    def pick(cands):
        for c in cols:
            if c.lower().strip() in cands:
                return c
        return None

    f_col = pick({"freq_hz", "freq", "hz", "f"})
    d_col = pick({"delta_db_smooth", "delta_db", "delta_db_raw",
                  "delta_db_base_minus_cand", "db", "delta"})
    if f_col is None or d_col is None:
        raise ValueError(f"unexpected columns: {list(cols)}")
    freq = _floats(cols[f_col])
    delta = _floats(cols[d_col])
    # log-f smoothing
    order = np.argsort(freq)
    freq, delta = freq[order], delta[order]
    lf = np.log10(np.maximum(freq, 1.0))
    grid = np.linspace(lf.min(), lf.max(), len(lf))
    dg = np.interp(grid, lf, delta)
    ds = smooth_ma(dg, smooth_win)
    delta_s = np.interp(lf, grid, ds)
    bands = {f"{lo}-{hi}": band_mean(freq, delta, lo, hi)
             for lo, hi in [(200, 1000), (1000, 3000), (3000, 8000),
                            (8000, 16000)]}
    out_png = out_png or str(in_csv).rsplit(".", 1)[0] + ".png"
    plt = _pyplot()
    if plt is None:
        return dict(bands=bands, out_png=None)
    plt.figure(figsize=(14, 6))
    plt.semilogx(freq, delta, alpha=0.5, label="raw")
    plt.semilogx(freq, delta_s, label=f"smooth (win={smooth_win})")
    plt.axhline(0, linewidth=1)
    plt.xlim(*xlim)
    plt.title(title)
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Delta dB")
    plt.grid(True, which="both", ls="--", alpha=0.4)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_png, dpi=150)
    plt.close()
    return dict(bands=bands, out_png=out_png)
