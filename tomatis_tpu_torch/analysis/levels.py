"""Level analyzers & report mergers, PyTorch port of
tomatis_tpu/analysis/levels.py (capability parity with
ref src/analyze_dbfs_simple.py, src/analyze_dbfs.py,
src/analyze_gate_threshold.py, src/analyze_stereo_state.py,
src/merge_state_volume.py, src/inspect_tomatis_d.py,
src/inspect_transition.py).

Host numpy and scipy, as in the reference, but for analyze_stereo_state's
min-hold gate: its threshold search and final states run the port's
ops.gate.gate_minhold on `device`, with each channel's levels uploaded
once per search. The dBFS-track CSVs are read with the csv module."""
from __future__ import annotations

import csv

import numpy as np
import torch

from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import gate as gate_ops
from tomatis_tpu_torch.utils.device import resolve_device

EPS = 1e-12


def _rms_dbfs(x) -> float:
    return float(20 * np.log10(np.sqrt(np.mean(np.square(x)) + EPS) + EPS))


def frame_levels_1d(x: np.ndarray, frame: int, hop: int,
                    blk: int = 8192) -> np.ndarray:
    """Per-frame RMS dBFS of a 1-D signal, vectorized in blocks of `blk`
    frames — an hour-long file at the 4096/2048 defaults would otherwise
    materialize a ~1.4 GB [n_frames, frame] index matrix at once (the
    same bound _per_channel_inrange_levels applies below)."""
    n = (len(x) - frame) // hop + 1
    if n <= 0:
        return np.zeros(0, np.float32)
    out = np.empty(n, np.float32)
    win_idx = np.arange(frame)[None, :]
    for i in range(0, n, blk):
        m = min(blk, n - i)
        idx = (np.arange(i, i + m)[:, None] * hop) + win_idx
        fr = x[idx]
        r = np.sqrt(np.mean(fr * fr, axis=1) + EPS)
        out[i:i + m] = 20 * np.log10(r + EPS)
    return out


# ---------------------------------------------------------------------------
# analyze_dbfs_simple (ref :24-95)
# ---------------------------------------------------------------------------

def dbfs_distribution(in_path, n_fft: int = 4096, hop: int = 2048) -> dict:
    """Percentiles of per-frame RMS dBFS of the (waveform-)mono mix plus
    suggested gate_ui values for 30/50/70% C2."""
    x, sr = audio.read(in_path)
    mono = x.mean(axis=1)
    levels = frame_levels_1d(mono.astype(np.float32), n_fft, hop)
    p = {q: float(np.percentile(levels, q)) for q in (1, 10, 30, 50, 70,
                                                      90, 99)}
    gate_offset = -100.0
    return dict(
        sr=sr, n_frames=len(levels), percentiles=p,
        dynamic_range=p[99] - p[1],
        suggestions={f"p{q}": dict(threshold_dbfs=p[q],
                                   gate_ui=p[q] - gate_offset)
                     for q in (30, 50, 70)})


# ---------------------------------------------------------------------------
# analyze_dbfs (ref src/analyze_dbfs.py, parameterized paths)
# ---------------------------------------------------------------------------

def compare_dbfs_tracks(input_path, candidate_paths: dict, sr_target=None,
                        frame_ms: float = 20.0, hop_ms: float = 10.0,
                        max_lag_s: float = 2.0, out_prefix=None) -> dict:
    """Input vs N candidate recordings: resample to a common rate, xcorr
    align, RMS normalize, frame dBFS tracks -> CSVs (+ plots)."""
    from scipy.signal import correlate, resample_poly

    def to_mono(a):
        return a.mean(axis=1) if a.ndim > 1 else a

    xin, sr_in = audio.read(input_path)
    xin = to_mono(xin).astype(np.float32)
    target_sr = sr_target or sr_in
    results = {}
    for name, path in candidate_paths.items():
        xc, sr_c = audio.read(path)
        xc = to_mono(xc).astype(np.float32)
        if sr_c != target_sr:
            xc = resample_poly(xc, target_sr, sr_c).astype(np.float32)
        # full-rate full-mode correlation replicates the reference's
        # align_by_xcorr estimator exactly (ref analyze_dbfs.py:29-41);
        # scipy picks the FFT path, but hour-scale inputs still allocate
        # multi-GB intermediates — use analysis/align.find_delay_by_corr
        # (2 kHz power envelopes) when reference-exact lags aren't needed
        max_lag = int(max_lag_s * target_sr)
        corr = correlate(xc, xin, mode="full")
        lags = np.arange(-len(xin) + 1, len(xc))
        m = (lags >= -max_lag) & (lags <= max_lag)
        lag = int(lags[m][np.argmax(corr[m])])
        a, b = xin, xc
        if lag > 0:
            b = b[lag:]
            a = a[:len(b)]
        elif lag < 0:
            a = a[-lag:]
            b = b[:len(a)]
        n = min(len(a), len(b))
        a, b = a[:n], b[:n]
        base_rms = np.sqrt(np.mean(a ** 2) + EPS)
        r = np.sqrt(np.mean(b ** 2) + EPS)
        if r >= EPS:
            b = b * (base_rms / r)
        frame = int(target_sr * frame_ms / 1000)
        hop = int(target_sr * hop_ms / 1000)
        ts = np.arange((n - frame) // hop + 1) * hop / target_sr
        din = frame_levels_1d(a, frame, hop)
        dout = frame_levels_1d(b, frame, hop)
        results[name] = dict(lag=lag, t=ts, in_dbfs=din, out_dbfs=dout)
        if out_prefix:
            with open(f"{out_prefix}_{name}.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["t", "in_dbfs", f"{name}_dbfs"])
                for t, di, do in zip(ts, din, dout):
                    w.writerow([f"{t:.3f}", f"{di:.3f}", f"{do:.3f}"])
    return results


# ---------------------------------------------------------------------------
# analyze_gate_threshold (ref :10-83)
# ---------------------------------------------------------------------------

def gate_threshold_from_tracks(t, in_dbfs, out_dbfs,
                               diff_threshold: float = 3.0) -> dict | None:
    """Detect gate switch points as |d(out)| > threshold; report the input
    level statistics at switches (the -24.3 dBFS device estimate came from
    this, docs/最终校准报告.md:10-13)."""
    out_dbfs = np.asarray(out_dbfs, float)
    in_dbfs = np.asarray(in_dbfs, float)
    t = np.asarray(t, float)
    d = np.abs(np.diff(out_dbfs, prepend=out_dbfs[:1]))
    sel = d > diff_threshold
    if not sel.any():
        return None
    lv = in_dbfs[sel]
    return dict(
        n_switches=int(sel.sum()),
        mean=float(lv.mean()), median=float(np.median(lv)),
        std=float(lv.std()),
        min=float(lv.min()), max=float(lv.max()),
        times=t[sel], levels=lv)


def read_track_csv(csv_path) -> dict:
    """A dBFS-track CSV as {column: [str values]}, in header order."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"empty CSV: {csv_path}")
    header, body = rows[0], rows[1:]
    return {c: [r[i] for r in body] for i, c in enumerate(header)}


def track_output_column(columns, csv_path) -> str:
    """Tolerant output-column matching (ref :20-27): a column naming the
    output, else any *_dbfs track that is not the input (the CSVs that
    compare_dbfs_tracks emits are named <candidate>_dbfs)."""
    named = [c for c in columns
             if "out" in c or "matlab" in c or "tomatis" in c]
    other = [c for c in columns if c.endswith("_dbfs") and c != "in_dbfs"]
    if not named and not other:
        raise ValueError(f"no output level column found in {csv_path}; "
                         f"columns: {list(columns)}")
    return (named or other)[0]


def gate_threshold_from_csv(csv_path, diff_threshold: float = 3.0):
    """CSV variant of gate_threshold_from_tracks."""
    cols = read_track_csv(csv_path)
    out_col = track_output_column(list(cols), csv_path)
    res = gate_threshold_from_tracks(
        np.asarray(cols["t"], float), np.asarray(cols["in_dbfs"], float),
        np.asarray(cols[out_col], float), diff_threshold)
    if res is None:            # no switch points: the CLI prints the
        return None            # friendly message, not a TypeError
    res["out_col"] = out_col   # so callers (the CLI plot) track the SAME
    #                            column the analysis used
    return res


# ---------------------------------------------------------------------------
# analyze_stereo_state (ref :25-159) + merge_state_volume (ref :28-113)
# ---------------------------------------------------------------------------

def format_time(seconds: float) -> str:
    m = int(seconds // 60)
    s = seconds % 60
    return f"{m}:{s:05.2f}"


def _per_channel_inrange_levels(x: np.ndarray, n_fft: int, hop: int):
    """Per-channel levels of in-range frames + start times."""
    total, ch = x.shape
    pad = n_fft // 2
    xp = np.concatenate([np.zeros((pad, ch), np.float32), x,
                         np.zeros((pad, ch), np.float32)])
    starts = []
    k = 0
    while k * hop + n_fft <= len(xp):
        orig = k * hop - pad
        if 0 <= orig < total:
            starts.append(k * hop)
        k += 1
    starts = np.asarray(starts)
    levels = np.empty((len(starts), ch), np.float32)
    win_idx = np.arange(n_fft)[None, :]
    blk = 8192   # bound the materialized frame matrix (an hour-long file
    #              would otherwise allocate ~1.4 GB per channel)
    for c in range(ch):
        col = xp[:, c]
        for i in range(0, len(starts), blk):
            sb = starts[i:i + blk]
            fr = col[sb[:, None] + win_idx]
            r = np.sqrt(np.mean(fr * fr, axis=1) + EPS)
            levels[i:i + len(sb), c] = 20 * np.log10(r + EPS)
    return levels, starts  # starts are in padded coordinates


def _minhold_threshold(levels, target_c2, hyst_db, min_hold_frames,
                       device="cuda"):
    """Binary-search a min-hold gate threshold (ref analyze_stereo_state
    :52-76) with the parallel-scan gate on `device`."""
    valid = levels[levels > -70]
    if len(valid) == 0:
        return float(np.median(levels))
    t_low = float(np.percentile(valid, 5))
    t_high = float(np.percentile(valid, 95))
    best_t = float(np.median(valid))
    lv = torch.from_numpy(np.asarray(levels, np.float32)).to(
        resolve_device(device))
    for _ in range(30):
        t_mid = (t_low + t_high) / 2
        states, _ = gate_ops.gate_minhold(
            lv, t_mid + hyst_db / 2, t_mid - hyst_db / 2,
            max(1, int(min_hold_frames)))
        r = int((states == gate_ops.C2).sum()) / len(levels)
        if abs(r - target_c2) < 0.01:
            return t_mid
        if r < target_c2:
            t_high = t_mid
        else:
            t_low = t_mid
        # unconditional overwrite (NOT best-seen tracking): replicates
        # ref analyze_stereo_state.py:60-76 exactly — unlike the
        # adaptive processor, whose own reference does track best
        # (src/process_tomatis_adaptive.py:124-154)
        best_t = t_mid
    return best_t


def analyze_stereo_state(in_path, out_csv, target_c2: float = 0.5,
                         hyst_db: float = 3.0, min_hold_ms: float = 250.0,
                         n_fft: int = 4096, hop: int = 2048,
                         device="cuda") -> dict:
    """Independent per-channel threshold search + min-hold gate simulation,
    bilingual CSV (the column names are a compatibility surface)."""
    dev = resolve_device(device)
    x, sr = audio.read(in_path)
    if x.shape[1] < 2:
        raise ValueError("stereo input required")
    min_hold = max(1, int(np.ceil(min_hold_ms / (hop / sr * 1000.0))))
    levels, start_samples = _per_channel_inrange_levels(x, n_fft, hop)
    # times are original-coordinate frame starts (ref :108)
    times = (np.asarray(start_samples) - n_fft // 2) / sr
    res = {}
    states_per_ch = []
    for c, name in [(0, "left"), (1, "right")]:
        t_opt = _minhold_threshold(levels[:, c], target_c2, hyst_db, min_hold,
                                   dev)
        st, _ = gate_ops.gate_minhold(
            torch.from_numpy(np.ascontiguousarray(levels[:, c])).to(dev),
            t_opt + hyst_db / 2, t_opt - hyst_db / 2, min_hold)
        st = st.cpu().numpy()
        states_per_ch.append(st)
        res[name] = dict(threshold=t_opt,
                         c2_ratio=float(np.mean(st == 2)))
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Frame", "音频秒数(秒)", "音频时间(分:秒)",
                    "Left_dBFS", "Left_Channel", "Right_dBFS",
                    "Right_Channel"])
        for i in range(len(levels)):
            t = times[i]
            w.writerow([i + 1, f"{t:.3f}", format_time(t),
                        f"{levels[i, 0]:.2f}",
                        "C1" if states_per_ch[0][i] == 1 else "C2",
                        f"{levels[i, 1]:.2f}",
                        "C1" if states_per_ch[1][i] == 1 else "C2"])
    res["n_frames"] = len(levels)
    res["out_csv"] = str(out_csv)
    return res


def merge_state_volume(state_csv, audio_path, out_csv, n_fft: int = 4096,
                       hop: int = 2048) -> dict:
    """Join a state CSV with per-channel dBFS of the processed audio
    (ref src/merge_state_volume.py:28-109)."""
    states = []
    with open(state_csv, "r", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            states.append(row["state"])
    x, sr = audio.read(audio_path)
    levels, _ = _per_channel_inrange_levels(x, n_fft, hop)
    ch = x.shape[1]
    frame_sec = hop / sr
    n = min(len(states), len(levels))
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        if ch > 1:
            w.writerow(["Frame", "音频秒数(秒)", "音频时间(分:秒)",
                        "Left_dBFS", "Left_Channel", "Right_dBFS",
                        "Right_Channel"])
            for i in range(n):
                t = (i + 1) * frame_sec
                w.writerow([i + 1, f"{t:.3f}", format_time(t),
                            f"{levels[i, 0]:.2f}", states[i],
                            f"{levels[i, 1]:.2f}", states[i]])
        else:
            w.writerow(["Frame", "音频秒数(秒)", "音频时间(分:秒)",
                        "dBFS", "Channel"])
            for i in range(n):
                t = (i + 1) * frame_sec
                w.writerow([i + 1, f"{t:.3f}", format_time(t),
                            f"{levels[i, 0]:.2f}", states[i]])
    return dict(n_rows=n, channels=ch, out_csv=str(out_csv))


# ---------------------------------------------------------------------------
# inspect_tomatis_d / inspect_transition (ref)
# ---------------------------------------------------------------------------

def amplitude_profile(in_path, chunk_sec: float = 0.5, out_png=None) -> dict:
    """0.5 s-chunk dBFS profile (ref src/inspect_tomatis_d.py:14-68)."""
    x, sr = audio.read(in_path)
    mono = np.sqrt(np.mean(np.square(x), axis=1))
    chunk = int(chunk_sec * sr)
    n = -(-len(mono) // chunk)
    times = np.arange(n) * chunk_sec
    levels = np.array([_rms_dbfs(mono[i * chunk:(i + 1) * chunk])
                       for i in range(n)], np.float32)
    if out_png:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure(figsize=(15, 6))
            plt.plot(times, levels)
            plt.axhline(-60, color="r", linestyle="--",
                        label="Silence (-60dB)")
            plt.axhline(-40, color="orange", linestyle="--",
                        label="Low (-40dB)")
            plt.xlabel("Time (s)")
            plt.ylabel("RMS Level (dBFS)")
            plt.grid(True)
            plt.legend()
            plt.savefig(out_png)
            plt.close()
        except ImportError:
            pass
    return dict(sr=sr, times=times, levels=levels, out_png=out_png)


def transition_profile(in_path, start_sec: float = 10.0,
                       end_sec: float = 20.0,
                       chunk_sec: float = 0.1) -> dict:
    """100 ms dBFS table of a window (ref src/inspect_transition.py:5-30)."""
    meta = audio.info(in_path)
    sr = meta.samplerate
    x, _ = audio.read(in_path, frames=int((end_sec - start_sec) * sr),
                      start=int(start_sec * sr))
    mono = np.sqrt(np.mean(np.square(x), axis=1))
    chunk = int(chunk_sec * sr)
    n = len(mono) // chunk
    times = start_sec + np.arange(n) * chunk_sec
    levels = np.array([
        20 * np.log10(np.sqrt(np.mean(mono[i * chunk:(i + 1) * chunk] ** 2)
                              + EPS) + EPS) for i in range(n)], np.float32)
    return dict(sr=sr, times=times, levels=levels)
