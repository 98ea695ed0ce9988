"""Audio repair utilities: declicker and head trimmer, a copy of
tomatis_tpu/models/repair.py over the port's io.audio (capability parity
with ref src/declick_inpaint.py and src/cut_tomatis_d.py).

The declick detector is vectorized end to end (first differences, MAD
sigma, run merging, linear inpaint via per-segment interpolation): no
per-click Python loops beyond the segment list itself. Host numpy
throughout: nothing here runs on the device.
"""
from __future__ import annotations

import numpy as np

from tomatis_tpu_torch.io import audio

EPS = 1e-12


def mad_sigma(x: np.ndarray) -> float:
    """Robust scale estimate: MAD -> sigma (ref declick_inpaint.py:7-11)."""
    med = np.median(x)
    return float((np.median(np.abs(x - med)) + EPS) / 0.6745)


def merge_runs(mask: np.ndarray, gap: int = 0) -> np.ndarray:
    """True-mask -> [start, end) segments, merging runs closer than `gap`
    (ref declick_inpaint.py:13-24)."""
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return np.zeros((0, 2), np.int64)
    cut = np.where(np.diff(idx) > (1 + gap))[0]
    starts = np.r_[idx[0], idx[cut + 1]]
    ends = np.r_[idx[cut] + 1, idx[-1] + 1]
    return np.stack([starts, ends], axis=1).astype(np.int64)


def inpaint_linear(x: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Linear-interpolation inpaint per segment/channel
    (ref declick_inpaint.py:26-46)."""
    y = x.copy()
    n = len(y)
    for s, e in segs:
        s0 = max(0, int(s) - 1)
        e0 = min(n - 1, int(e))
        if s0 >= e0:
            continue
        t = np.linspace(0.0, 1.0, e0 - s0 + 1, dtype=np.float32)[:, None]
        interp = (1 - t) * y[s0] + t * y[e0]
        y[s:e] = interp[(s - s0):(e - s0)]
    return y


def detect_clicks(x: np.ndarray, sr: int, k: float = 12.0,
                  pad_ms: float = 1.5, merge_gap_ms: float = 0.5,
                  max_fix_ms: float = 8.0):
    """Click detection on per-sample first differences. Returns
    (segments [m, 2], stats dict)."""
    n = len(x)
    dmax = np.max(np.abs(np.diff(x, axis=0)), axis=1)
    sigma = mad_sigma(dmax)
    thr = k * sigma
    hit = dmax > thr
    stats = dict(sigma=sigma, threshold=thr, hits=int(hit.sum()))
    if not hit.any():
        return np.zeros((0, 2), np.int64), stats
    pad = int(round(pad_ms * sr / 1000.0))
    gap = int(round(merge_gap_ms * sr / 1000.0))
    max_fix = int(round(max_fix_ms * sr / 1000.0))
    # window [i-pad, i+1+pad) around diff index i, replicating the
    # reference exactly (ref :82-87), including its quirk that at pad=0
    # the window covers only sample i even though the click touches i
    # and i+1 (the default 1.5 ms pad masks this in practice)
    mask = np.zeros(n, bool)
    starts = np.maximum(0, np.flatnonzero(hit) - pad)
    ends = np.minimum(n, np.flatnonzero(hit) + 1 + pad)
    for s, e in zip(starts, ends):
        mask[s:e] = True
    segs = merge_runs(mask, gap=gap)
    stats["raw_segments"] = len(segs)
    segs = segs[(segs[:, 1] - segs[:, 0]) <= max_fix]
    stats["kept_segments"] = len(segs)
    return segs, stats


def declick(in_path, out_path, k: float = 12.0, pad_ms: float = 1.5,
            merge_gap_ms: float = 0.5, max_fix_ms: float = 8.0,
            report_csv=None) -> dict:
    """Full declick pipeline (ref declick_inpaint.py:48-111)."""
    x, sr = audio.read(in_path)
    segs, stats = detect_clicks(x, sr, k, pad_ms, merge_gap_ms, max_fix_ms)
    y = inpaint_linear(x, segs) if len(segs) else x
    audio.write(str(out_path), y, sr, subtype="PCM_24")
    if report_csv:
        import csv
        with open(report_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["start_sample", "end_sample", "start_sec", "end_sec",
                        "len_samples"])
            for s, e in segs:
                w.writerow([int(s), int(e), s / sr, e / sr, int(e - s)])
    stats.update(sr=sr, out_path=str(out_path))
    return stats


def cut_head(in_path, out_path, cut_seconds: float = 16.0) -> dict:
    """Trim the first N seconds (ref src/cut_tomatis_d.py:9-38)."""
    x, sr = audio.read(in_path)
    cut = int(cut_seconds * sr)
    y = x[cut:]
    audio.write(str(out_path), y, sr, subtype="PCM_24")
    return dict(sr=sr, cut_samples=cut, n_out=len(y), out_path=str(out_path))
