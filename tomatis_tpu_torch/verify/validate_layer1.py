"""Layer-1 validator, PyTorch port of tomatis_tpu/verify/validate_layer1.py
(capability parity with ref src/validate_layer1.py): a four-part PASS/FAIL
audit of a processed file against its input and state CSV.

A. engineering: sr/ch/sample-count equality, peak < 0.98 (ref :62-88)
B. independent gate recomputation vs the CSV: mismatch < 1%, level
   agreement < 0.1 dB (ref :110-193,481-513); the validator's state
   machine only advances on in-range frames (ref :137-159)
C. gate statistics: C2 ratio in [5%, 95%], short-run (<=3) ratio < 30%
D. conditional spectrum: median per-bin |Y|/|X| over stable frames vs the
   theoretical tilt curves, RMSE < 1.5 dB per band (ref :245-398,547-598)

On the device: the input's frame levels (ops.stft.frame_levels_chunk over
one uploaded signal), the gate recomputation (ops.gate.gate_updelay) and
the per-frame |rfft| ratios, whose frames are gathered on the device from
the two uploaded signals. On the host: the stable-frame selection, the
statistics, the CSV, and the per-bin medians (np.median averages the two
middle values of an even count, torch.median does not, and
torch.quantile refuses more than 2^24 elements).
"""
from __future__ import annotations

import csv
import time

import numpy as np
import torch

from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import dsp, gate as gate_ops, stft
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.utils.stateio import read_state_csv


def check_engineering(in_path, out_path, y: np.ndarray | None = None) -> dict:
    """y: pre-decoded output audio, so callers that also analyze the
    output (validate, verify-15db) decode the file once."""
    a = audio.info(in_path)
    b = audio.info(out_path)
    if y is None:
        y, _ = audio.read(out_path)
    peak = float(np.max(np.abs(y))) if y.size else 0.0
    return dict(
        sr_in=a.samplerate, sr_out=b.samplerate,
        sr_match=a.samplerate == b.samplerate,
        ch_in=a.channels, ch_out=b.channels,
        ch_match=a.channels == b.channels,
        frames_in=a.frames, frames_out=b.frames,
        frames_match=a.frames == b.frames,
        frames_diff=b.frames - a.frames,
        peak=peak, peak_safe=peak < 0.98)


def padded_signal(x: np.ndarray, n_fft: int, dev, total=None):
    """Host [N, C] -> [total + n_fft//2*2, C] float32 on dev: half a window
    of zeros at both ends, cut or zero-filled to `total` samples first
    (default N)."""
    pad = n_fft // 2
    total = len(x) if total is None else total
    t = torch.from_numpy(np.ascontiguousarray(x[:total], np.float32)).to(dev)
    return torch.nn.functional.pad(t, (0, 0, pad, pad + total - len(t)))


def _inrange_frame_levels(x: np.ndarray, n_fft: int, hop: int,
                          chunk: int = 4096, device="cuda") -> np.ndarray:
    """Levels of frames whose start lies in [0, total) after half-window
    padding (the validator/adaptive frame convention): one upload, then
    `chunk` frames at a time on the device."""
    dev = resolve_device(device)
    total = len(x)
    pad = n_fft // 2
    k0 = -(-pad // hop)
    k1 = min((total + 2 * pad - n_fft) // hop, (total + pad - 1) // hop)
    F = max(0, k1 - k0 + 1)
    if F == 0:
        return np.zeros(0, np.float32)
    xp = padded_signal(x, n_fft, dev)
    out = []
    for f0 in range(0, F, chunk):
        nf = min(chunk, F - f0)
        s = (k0 + f0) * hop
        out.append(stft.frame_levels_chunk(xp[s:s + (nf - 1) * hop + n_fft],
                                           n_fft, hop, nf))
    return torch.cat(out).cpu().numpy()


def simulate_gate(x: np.ndarray, sr: int, n_fft: int, hop: int,
                  threshold_dbfs: float, hyst_db: float, up_delay_ms: float,
                  device="cuda"):
    """Independent gate recomputation over in-range frames (ref :110-163).
    Returns (states ['C1'/'C2'], levels)."""
    dev = resolve_device(device)
    levels = _inrange_frame_levels(x, n_fft, hop, device=dev)
    if len(levels) == 0:
        return [], levels
    ton = threshold_dbfs + hyst_db / 2.0
    toff = threshold_dbfs - hyst_db / 2.0
    delay = gate_ops.updelay_frames(int(up_delay_ms * sr / 1000.0), hop)
    states, _ = gate_ops.gate_updelay(torch.from_numpy(levels).to(dev), ton,
                                      toff, delay)
    return ["C1" if s == 1 else "C2" for s in states.cpu().tolist()], levels


def compare_gate_states(csv_states, sim_states, sim_levels, csv_levels):
    """CSV vs recomputed states (ref :166-193)."""
    n = min(len(csv_states), len(sim_states))
    cs = np.asarray(csv_states[:n])
    ss = np.asarray(sim_states[:n])
    ld = np.abs(np.asarray(csv_levels[:n]) - np.asarray(sim_levels[:n]))
    mismatch = int(np.sum(cs != ss))
    # switch counts over the same common prefix the per-frame comparison
    # uses
    csv_sw = int(np.sum(cs[1:] != cs[:-1]))
    sim_sw = int(np.sum(ss[1:] != ss[:-1]))
    return dict(
        total_frames=n,
        mismatch_count=mismatch,
        mismatch_rate=mismatch / n if n else 0.0,
        csv_switches=csv_sw, sim_switches=sim_sw,
        switch_diff=abs(csv_sw - sim_sw),
        level_max_diff=float(ld.max()) if n else 0.0,
        level_mean_diff=float(ld.mean()) if n else 0.0)


def analyze_gate_stats(states) -> dict:
    """C2 ratio / switches / run lengths / jitter (ref :200-238)."""
    states = np.asarray(states)
    n = len(states)
    if n == 0:
        return {}
    c2 = int(np.sum(states == "C2"))
    sw = np.flatnonzero(states[1:] != states[:-1])
    run_ends = np.r_[sw, n - 1]
    run_starts = np.r_[0, sw + 1]
    runs = run_ends - run_starts + 1
    short = int(np.sum(runs <= 3))
    return dict(
        total_frames=n, c2_count=c2, c2_ratio=c2 / n,
        switch_count=len(sw), run_count=len(runs),
        run_min=int(runs.min()), run_max=int(runs.max()),
        run_median=float(np.median(runs)),
        short_runs=short, short_run_ratio=short / len(runs))


def find_stable_frames(states, margin: int = 2):
    """Frames whose +-margin window has a constant state (ref :245-258)."""
    s = np.asarray(states)
    n = len(s)
    if n < 2 * margin + 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    w = 2 * margin + 1
    ones = np.ones(w, np.int64)
    c1_ok = np.convolve((s == "C1").astype(np.int64), ones, "valid") == w
    c2_ok = np.convolve((s == "C2").astype(np.int64), ones, "valid") == w
    idx = np.arange(margin, n - margin)
    return idx[c1_ok], idx[c2_ok]


def gather_frames(xp: torch.Tensor, starts: np.ndarray,
                  n_fft: int) -> torch.Tensor:
    """Frames [B, n_fft, C] of a device signal at host start indices."""
    s = torch.from_numpy(np.asarray(starts, np.int64)).to(xp.device)
    return xp[s[:, None] + torch.arange(n_fft, device=xp.device)[None, :]]


def channel_mean_ratios(fx: torch.Tensor, fy: torch.Tensor,
                        win: torch.Tensor) -> torch.Tensor:
    """Per-frame channel-mean |Y| / max(channel-mean |X|, 1e-10), [B, bins]
    from frames [B, n_fft, C]."""
    X = torch.mean(torch.abs(torch.fft.rfft(fx.transpose(1, 2) * win)),
                   dim=1)
    Y = torch.mean(torch.abs(torch.fft.rfft(fy.transpose(1, 2) * win)),
                   dim=1)
    return Y / torch.clamp(X, min=1e-10)


def median_db(ratios: list, nbins: int):
    """Per-bin median of the stacked ratio rows, in dB, on the host;
    (zeros, 0) when there is no row."""
    allr = (torch.cat(ratios).cpu().numpy() if ratios
            else np.zeros((0, nbins), np.float32))
    if len(allr) == 0:
        return np.zeros(nbins), 0
    return 20.0 * np.log10(np.median(allr, axis=0) + dsp.EPS), len(allr)


def conditional_spectrum(x, y, sr, states, n_fft, hop,
                         level_threshold: float = -60.0, margin: int = 2,
                         batch: int = 512, device="cuda"):
    """Median per-bin |Y|/|X| over stable high-level frames, per state
    (ref :261-398). Returns (freqs, c1_db, c2_db, n_c1, n_c2)."""
    dev = resolve_device(device)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    pad = n_fft // 2
    total = len(x)
    xp = padded_signal(x, n_fft, dev)
    yp = padded_signal(y, n_fft, dev, total)
    win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(dev)
    c1_idx, c2_idx = find_stable_frames(states, margin)
    freqs = stft.rfft_freqs(n_fft, sr)
    # frame i of the level/gate framing starts at original coord
    # i*hop + off; off == 0 whenever hop divides pad (every default)
    off = -(-pad // hop) * hop - pad

    def collect(idx):
        idx = idx[(idx * hop + off >= 0) & (idx * hop + off + n_fft <= total)]
        keep = []
        for b0 in range(0, len(idx), batch):
            starts = idx[b0:b0 + batch] * hop + off + pad
            fx = gather_frames(xp, starts, n_fft)
            r = channel_mean_ratios(fx, gather_frames(yp, starts, n_fft), win)
            keep.append(r[dsp.frame_levels_dbfs(fx) >= level_threshold])
        return median_db(keep, len(freqs))

    c1_db, n1 = collect(c1_idx)
    c2_db, n2 = collect(c2_idx)
    return freqs, c1_db, c2_db, n1, n2


def spectrum_rmse(measured_db, theory_db, freqs, f_low, f_high) -> float:
    mask = (freqs >= f_low) & (freqs <= f_high)
    if not np.any(mask):
        return 0.0
    d = np.asarray(measured_db)[mask] - np.asarray(theory_db)[mask]
    return float(np.sqrt(np.mean(d ** 2)))


BANDS = [("low", 100, 800), ("mid", 800, 1200), ("high", 2000, 8000)]


def write_spectrum_csv(path, freqs, c1_db, c1_th, c2_db, c2_th):
    """The 5-column conditional-spectrum CSV (ref :645-653)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["freq_hz", "c1_measured_db", "c1_theory_db",
                    "c2_measured_db", "c2_theory_db"])
        for i, fr in enumerate(freqs):
            w.writerow([f"{fr:.2f}", f"{c1_db[i]:.4f}", f"{c1_th[i]:.4f}",
                        f"{c2_db[i]:.4f}", f"{c2_th[i]:.4f}"])


def validate(in_path, out_path, state_csv, gate_ui=50.0, gate_scale=1.0,
             gate_offset=-61.08, hyst_db=1.0, up_delay_ms=0.0,
             fc=1000.0, slope=12.0, c1_low=5.0, c1_high=-5.0,
             c2_low=-5.0, c2_high=5.0, n_fft=4096, hop=2048,
             out_csv="layer1_spectrum_check.csv",
             out_png="layer1_spectrum_check.png", device="cuda") -> dict:
    """Full A-D audit; returns the results dict with results['pass'] and
    results['timings'] (decode, gate recomputation, conditional spectrum,
    artifacts; seconds)."""
    dev = resolve_device(device)
    threshold = gate_scale * gate_ui + gate_offset
    results = {"pass": True, "checks": {}, "threshold_dbfs": threshold}
    t0 = time.perf_counter()
    y, _ = audio.read(out_path)   # decoded once, reused by every check
    x, sr = audio.read(in_path)
    t1 = time.perf_counter()

    eng = check_engineering(in_path, out_path, y=y)
    results["checks"]["engineering"] = eng
    if not (eng["sr_match"] and eng["ch_match"] and eng["frames_match"]
            and eng["peak_safe"]):
        results["pass"] = False

    csvd = read_state_csv(state_csv)
    csv_states = list(csvd["state"])
    sim_states, sim_levels = simulate_gate(
        x, sr, n_fft, hop, threshold, hyst_db, up_delay_ms, device=dev)
    cmp = compare_gate_states(csv_states, sim_states, sim_levels,
                              csvd["level_dbfs"])
    cmp["pass"] = cmp["mismatch_rate"] < 0.01 and cmp["level_max_diff"] < 0.1
    results["checks"]["gate"] = cmp
    if not cmp["pass"]:
        results["pass"] = False

    stats = analyze_gate_stats(csv_states)
    stats["c2_ratio_ok"] = 0.05 <= stats.get("c2_ratio", 0) <= 0.95
    stats["jitter_ok"] = stats.get("short_run_ratio", 0) < 0.30
    results["checks"]["gate_stats"] = stats  # WARN-only in the reference
    t2 = time.perf_counter()

    freqs, c1_db, c2_db, n1, n2 = conditional_spectrum(
        x, y, sr, csv_states, n_fft, hop, device=dev)
    c1_theory = dsp.build_tilt_gain_db(freqs, fc, slope, c1_low, c1_high)
    c2_theory = dsp.build_tilt_gain_db(freqs, fc, slope, c2_low, c2_high)
    c1_rmse = [spectrum_rmse(c1_db, c1_theory, freqs, lo, hi)
               for _, lo, hi in BANDS]
    c2_rmse = [spectrum_rmse(c2_db, c2_theory, freqs, lo, hi)
               for _, lo, hi in BANDS]
    spectrum_ok = max(c1_rmse + c2_rmse) < 1.5
    results["checks"]["spectrum"] = dict(
        c1_rmse=c1_rmse, c2_rmse=c2_rmse, c1_frames=n1, c2_frames=n2,
        **{"pass": spectrum_ok})
    if not spectrum_ok:
        results["pass"] = False
    t3 = time.perf_counter()

    if out_csv:
        write_spectrum_csv(out_csv, freqs, c1_db, c1_theory, c2_db,
                           c2_theory)
    if out_png:
        _plot(out_png, freqs, c1_db, c1_theory, c2_db, c2_theory,
              n1, n2, fc)
    results["timings"] = dict(decode_s=t1 - t0, gate_s=t2 - t1,
                              spectrum_s=t3 - t2,
                              artifacts_s=time.perf_counter() - t3)
    return results


def _plot(path, freqs, c1_db, c1_th, c2_db, c2_th, n1, n2, fc):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(2, 1, figsize=(12, 8))
    for ax, meas, th, color, name, n in [
            (axes[0], c1_db, c1_th, "b", "C1", n1),
            (axes[1], c2_db, c2_th, "r", "C2", n2)]:
        ax.semilogx(freqs, meas, color + "-", label=f"{name} measured",
                    alpha=0.7)
        ax.semilogx(freqs, th, color + "--", label=f"{name} theory",
                    linewidth=2)
        ax.axhline(0, color="gray", linestyle=":")
        ax.axvline(fc, color="red", linestyle=":", label=f"fc={fc}Hz")
        ax.set_xlim(20, 20000)
        ax.set_ylim(-10, 10)
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Gain (dB)")
        ax.set_title(f"{name} Spectrum (n={n})")
        ax.legend()
        ax.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)
