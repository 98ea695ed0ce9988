"""Plain reference of the audited job's two verifiers, the Layer-1
validator and the +-15 dB verifier, written from the upstream scripts
(xyjk0511/tomatis-audio-processor, src/validate_layer1.py:62-398 and
src/verify_tomatis_15db.py:66-464), in float64 NumPy and PyTorch on the
CPU. It imports nothing of the program and nothing of JAX. It is the
module of the cell's own numbers (reference/__init__.py): NUMBERS,
numbers() and outputs().

Both tools read the processed output y against its input x, with the
settings that `process` writes into its params sidecar (the resolved
threshold T; hysteresis, up-delay, the tilt curves, n_fft, hop), the
rest at the tools' upstream defaults:
  A. engineering: rates, channels and lengths equal, the output's peak
     under 0.98; the verifier adds the peak in dBFS and the DC offset
     (its mean, under 0.001);
  B. the gate recomputed: the input padded by n_fft/2 zeros at both ends
     and framed at hop, the frames whose start lies in the file and whose
     end lies in the padded signal; a frame's level is 20 log10(sqrt(
     mean of its squares over samples and channels + EPS) + EPS); the
     hysteresis gate (on at T + hyst/2, off at T - hyst/2) with its
     up-switch delay in samples runs over these frames alone (validate
     :110-163). The validator compares it with the state CSV over their
     common frames (mismatches, switches, level gaps; pass under 1% and
     0.1 dB); both take the statistics of a state sequence (C2 share,
     switches, runs, runs of 3 frames or fewer), the verifier of its own
     recomputed gate, the validator of the CSV's;
  C. the conditional spectrum: the frames whose +-2 neighbours share
     their state (the validator's states are the CSV's, the verifier's
     its own) and that lie whole in the file; per frame the channel mean
     of |rfft(frame * hann)| of each signal (np.hanning), the ratio
     |Y| / max(|X|, 1e-10); frames whose input level is under -60 dBFS
     dropped; per bin the median (of an even count the mean of the two
     middle values) in dB, 20 log10(m + EPS). The validator's RMSE
     against the theory curve over 100-800, 800-1200 and 2000-8000 Hz
     (pass under 1.5 dB); the verifier's over 100-8000 Hz, the fc error
     (|mean| over 900-1100 Hz, under 0.5), the low (100-350 Hz) and high
     (3000-8000 Hz) platform means and their errors against +-|c1_low|
     (under 3);
  D. (the verifier) the Tilt Index per frame, frames at i*hop in the
     file as in C: 10 log10(E_hi / E_lo + EPS), E the channel-mean
     |rfft|^2 summed over 2000-8000 and 200-1000 Hz (both ends in);
     frames with E_lo <= EPS dropped; mean, population standard
     deviation, median, min and max of the input's, the output's, and
     the output's in C1 and in C2; the effect is C2's mean less C1's
     (WARN under 5 dB).
The two spectrum CSVs print the frequency %.2f and each column %.4f; the
verifier's report is upstream's layout (verify_tomatis_15db.py:514-799).

Where this departs from upstream:
  - the arithmetic is float64 (upstream's is numpy float32 and float64 by
    promotion); quantise, one of reference.precision's roundings, is put
    after each stage;
  - the validator's conditional spectrum takes its states from the
    configuration's reference render (ref["states"] at the CSV's rows),
    which the check already holds the CSV to (state_frames 0), and the
    CSV's own state on a frame the render marks `masked` (a decision
    within rounding of a threshold, where either is right);
  - a gate decision on a level within AMBIGUOUS_DB of the on or the off
    threshold is a matter of rounding: the gate is run again with each
    such decision taken the other way, and of these the one whose counts
    are nearest the answer's stands (its states then make the verifier's
    spectrum and Tilt Index).
"""
from __future__ import annotations

import csv
import json
import math
import os

import numpy as np
import torch

from reference.precision import identity
from reference.tomatis_ref import (AMBIGUOUS_DB, EPS, FULL_SCALE, gate,
                                   threshold_dbfs, tilt_gain_db)

RATIO_FLOOR = 1e-10
LEVEL_KEEP_DBFS = -60.0
MARGIN = 2
BLOCK_FRAMES = 512
BANDS = (("low", 100, 800), ("mid", 800, 1200), ("high", 2000, 8000))
CSV_HEADER = ["freq_hz", "c1_measured_db", "c1_theory_db", "c2_measured_db",
              "c2_theory_db"]
TOOLS = ("validate", "verify15")

NUMBERS = {
    "verify_gate_frames": "the largest gap of the two tools' gate counts "
    "and run statistics, in frames (a share times its count)",
    "verify_spectrum_db": "the largest per-bin gap of the measured columns "
    "of the two conditional-spectrum CSVs, dB",
    "verify_metrics_db": "the largest gap of the band RMSEs, fc errors, "
    "platforms, level gaps and means and theory columns, dB (the DC "
    "offset as its linear gap)",
    "verify_tilt_db": "the largest gap of the Tilt Index statistics and "
    "its effect, dB",
    "verify_verdicts": "PASS/FAIL and ok flags, exact values (rates, "
    "lengths, peak, threshold) and report lines that differ, a count",
}

# how the results' keys are compared (_gaps)
FRAMES = {"total_frames", "mismatch_count", "csv_switches", "sim_switches",
          "switch_diff", "c2_count", "switch_count", "run_count", "run_min",
          "run_max", "run_median", "short_runs", "c1_frames", "c2_frames"}
PER = {"mismatch_rate": "total_frames", "c2_ratio": "total_frames",
       "short_run_ratio": "run_count", "switches_per_min": "duration_min"}
EXACT = {"sr_in", "sr_out", "ch_in", "ch_out", "frames_in", "frames_out",
         "frames_diff", "peak", "duration_min", "threshold_dbfs",
         "platform_freqs"}
DB = {"c1_rmse", "c2_rmse", "c1_fc_error", "c2_fc_error", "c1_low_platform",
      "c2_low_platform", "c1_low_platform_error", "c2_low_platform_error",
      "c1_high_platform", "c2_high_platform", "c1_high_platform_error",
      "c2_high_platform_error", "level_max_diff", "level_mean_diff",
      "c1_level_mean", "c2_level_mean", "peak_dbfs", "dc_mean"}


def settings(config: dict) -> dict:
    """The verifiers' settings as the sidecar of `process` hands them on."""
    p = config["params"]
    return dict(sr=config["sample_rate"], threshold=threshold_dbfs(p),
                hyst=p["hysteresis_db"], up_delay_ms=p["up_delay_ms"],
                fc=p["fc"], slope=p["slope"], c1_low=p["c1_low"],
                c1_high=p["c1_high"], c2_low=p["c2_low"],
                c2_high=p["c2_high"], n_fft=p["n_fft"], hop=p["hop"])


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Signals:
    """What both tools compute from x and y, once: the gate frames' levels
    and, per frame lying whole in the file, the spectrum's ratio row and
    the Tilt Index and low-band energy of x and of y."""

    def __init__(self, x, y, s: dict, q=identity):
        x = _t(x)
        y = _t(y)
        x = x[:, None] if x.ndim == 1 else x
        y = y[:, None] if y.ndim == 1 else y
        n, C = x.shape
        n_fft, hop = s["n_fft"], s["hop"]
        pad = n_fft // 2
        self.s, self.q = s, q
        off = -(-pad // hop) * hop - pad     # frame i starts at off + i*hop
        n_gate = len(range(off, n, hop))
        while n_gate and off + (n_gate - 1) * hop + n_fft > n + pad:
            n_gate -= 1
        n_file = max(0, (n - off - n_fft) // hop + 1)
        xp = torch.cat([x.new_zeros((pad, C)), q(x), x.new_zeros((pad, C))])
        ys = y[:n] if len(y) >= n else torch.cat([y, y.new_zeros(
            (n - len(y), y.shape[1]))])
        ys = q(ys)
        self.freqs = np.fft.rfftfreq(n_fft, d=1.0 / s["sr"])
        lo = torch.as_tensor((self.freqs >= 200) & (self.freqs <= 1000))
        hi = torch.as_tensor((self.freqs >= 2000) & (self.freqs <= 8000))
        win = q(_t(np.hanning(n_fft)))
        idx = torch.arange(n_fft)
        self.levels = torch.empty(n_gate, dtype=torch.float64)
        self.ratios = torch.empty((n_file, len(self.freqs)),
                                  dtype=torch.float64)
        ti = {k: torch.empty(n_file, dtype=torch.float64)
              for k in ("ti_x", "ti_y", "el_x", "el_y")}
        for f0 in range(0, n_gate, BLOCK_FRAMES):
            f1 = min(n_gate, f0 + BLOCK_FRAMES)
            starts = off + pad + hop * torch.arange(f0, f1)
            fx = xp[starts[:, None] + idx[None, :]]          # [B, n_fft, C]
            m = q(torch.mean(q(fx * fx), dim=(1, 2)))
            self.levels[f0:f1] = q(20.0 * torch.log10(
                q(torch.sqrt(m + EPS)) + EPS))
            g1 = min(f1, n_file)
            if g1 <= f0:
                continue
            fy = ys[(starts[:g1 - f0] - pad)[:, None] + idx[None, :]]
            mags, pows = [], []
            for fr in (fx[:g1 - f0], fy):
                spec = q(torch.fft.rfft(q(fr.transpose(1, 2) * win), dim=-1))
                mag = q(torch.abs(spec))                     # [B, C, bins]
                mags.append(q(torch.mean(mag, dim=1)))
                pows.append(q(torch.mean(q(mag * mag), dim=1)))
            self.ratios[f0:g1] = q(mags[1] / torch.clamp(mags[0],
                                                         min=RATIO_FLOOR))
            for key, p in (("x", pows[0]), ("y", pows[1])):
                el = q(torch.sum(p[:, lo], dim=-1))
                eh = q(torch.sum(p[:, hi], dim=-1))
                ti["el_" + key][f0:g1] = el
                ti["ti_" + key][f0:g1] = q(10.0 * torch.log10(q(eh / el)
                                                               + EPS))
        self.ti = {k: v.numpy() for k, v in ti.items()}
        self.n_file = n_file

    # B. the gate ----------------------------------------------------------
    def gates(self) -> list:
        """The recomputed gate's states (1 = C1, 2 = C2): first as the
        levels say, then once with each decision within AMBIGUOUS_DB of a
        threshold taken the other way."""
        s = self.s
        ton = s["threshold"] + s["hyst"] / 2.0
        toff = s["threshold"] - s["hyst"] / 2.0
        up = int(s["up_delay_ms"] * s["sr"] / 1000.0)
        lv = self.levels.tolist()
        lva = self.levels.numpy()
        near = np.nonzero((np.abs(lva - ton) <= AMBIGUOUS_DB)
                          | (np.abs(lva - toff) <= AMBIGUOUS_DB))[0]
        return [gate(lv, ton, toff, up, s["hop"], 0, flip=int(j))
                for j in [-1] + list(near)]

    # C. the conditional spectrum ------------------------------------------
    def spectrum(self, states: np.ndarray) -> dict:
        """Per state, the median ratio in dB over the stable frames that
        lie in the file and are loud enough, and their count."""
        q = self.q
        st = np.asarray(states)
        out = {}
        w = 2 * MARGIN + 1
        for name, code in (("c1", 1), ("c2", 2)):
            if len(st) < w:
                idx = np.zeros(0, np.int64)
            else:
                on = np.convolve((st == code).astype(np.int64),
                                 np.ones(w, np.int64), "valid") == w
                idx = np.arange(MARGIN, len(st) - MARGIN)[on]
            idx = idx[idx < self.n_file]
            idx = idx[self.levels.numpy()[idx] >= LEVEL_KEEP_DBFS]
            if len(idx) == 0:
                out[f"{name}_db"], out[f"{name}_frames"] = (
                    np.zeros(len(self.freqs)), 0)
                continue
            med = q(_t(np.median(self.ratios.numpy()[idx], axis=0)))
            out[f"{name}_db"] = q(20.0 * torch.log10(med + EPS)).numpy()
            out[f"{name}_frames"] = len(idx)
        s = self.s
        out["c1_theory"] = tilt_gain_db(self.freqs, s["fc"], s["slope"],
                                        s["c1_low"], s["c1_high"])
        out["c2_theory"] = tilt_gain_db(self.freqs, s["fc"], s["slope"],
                                        s["c2_low"], s["c2_high"])
        return out

    def rmse(self, meas, theory, f_lo, f_hi) -> float:
        m = (self.freqs >= f_lo) & (self.freqs <= f_hi)
        if not m.any():
            return 0.0
        d = _t(meas[m]) - _t(theory[m])
        return float(self.q(torch.sqrt(torch.mean(self.q(d * d)))))

    def mean(self, a) -> float:
        return float(self.q(torch.mean(_t(a))))


def engineering(x, y, sr: int) -> dict:
    """A (validate :62-88): the input's and output's rates, channels and
    lengths, and the output's peak."""
    peak = float(np.max(np.abs(y))) if np.size(y) else 0.0
    return dict(sr_in=sr, sr_out=sr, sr_match=True, ch_in=x.shape[1],
                ch_out=y.shape[1], ch_match=x.shape[1] == y.shape[1],
                frames_in=len(x), frames_out=len(y),
                frames_match=len(x) == len(y), frames_diff=len(y) - len(x),
                peak=peak, peak_safe=peak < 0.98)


def gate_stats(states) -> dict:
    """B's statistics of a state sequence (validate :200-238), with the
    C2 share and jitter flags."""
    st = [int(v) for v in states]
    out = {}
    if st:
        runs, k = [], 0
        for j in range(1, len(st) + 1):
            if j == len(st) or st[j] != st[j - 1]:
                runs.append(j - k)
                k = j
        c2 = st.count(2)
        short = sum(r <= 3 for r in runs)
        out = dict(total_frames=len(st), c2_count=c2, c2_ratio=c2 / len(st),
                   switch_count=len(runs) - 1, run_count=len(runs),
                   run_min=min(runs), run_max=max(runs),
                   run_median=float(np.median(runs)), short_runs=short,
                   short_run_ratio=short / len(runs))
    out["c2_ratio_ok"] = 0.05 <= out.get("c2_ratio", 0) <= 0.95
    out["jitter_ok"] = out.get("short_run_ratio", 0) < 0.30
    return out


def _names(states) -> np.ndarray:
    return np.where(np.asarray(states) == 2, "C2", "C1")


def validate(sig: Signals, x, y, csv_table: dict, states, sim) -> tuple:
    """The validator's results (validate :405-598) and its spectrum dict;
    states: the CSV's states for C (1/2), sim: the recomputed gate's."""
    s = sig.s
    res = {"pass": True, "checks": {}, "threshold_dbfs": s["threshold"]}
    eng = engineering(x, y, s["sr"])
    res["checks"]["engineering"] = eng
    if not (eng["sr_match"] and eng["ch_match"] and eng["frames_match"]
            and eng["peak_safe"]):
        res["pass"] = False
    cs = np.asarray(csv_table["state"])
    n = min(len(cs), len(sim))
    cs_n, ss_n = cs[:n], _names(sim)[:n]
    gap = np.abs(np.asarray(csv_table["level"], np.float64)[:n]
                 - sig.levels.numpy()[:n])
    csv_sw = int(np.sum(cs_n[1:] != cs_n[:-1]))
    sim_sw = int(np.sum(ss_n[1:] != ss_n[:-1]))
    mismatch = int(np.sum(cs_n != ss_n))
    cmp = dict(total_frames=n, mismatch_count=mismatch,
               mismatch_rate=mismatch / n if n else 0.0,
               csv_switches=csv_sw, sim_switches=sim_sw,
               switch_diff=abs(csv_sw - sim_sw),
               level_max_diff=float(gap.max()) if n else 0.0,
               level_mean_diff=sig.mean(gap) if n else 0.0)
    cmp["pass"] = cmp["mismatch_rate"] < 0.01 and cmp["level_max_diff"] < 0.1
    res["checks"]["gate"] = cmp
    if not cmp["pass"]:
        res["pass"] = False
    res["checks"]["gate_stats"] = gate_stats(
        np.where(cs == "C2", 2, 1))
    sp = sig.spectrum(states)
    c1 = [sig.rmse(sp["c1_db"], sp["c1_theory"], lo, hi)
          for _, lo, hi in BANDS]
    c2 = [sig.rmse(sp["c2_db"], sp["c2_theory"], lo, hi)
          for _, lo, hi in BANDS]
    ok = max(c1 + c2) < 1.5
    res["checks"]["spectrum"] = dict(c1_rmse=c1, c2_rmse=c2,
                                     c1_frames=sp["c1_frames"],
                                     c2_frames=sp["c2_frames"],
                                     **{"pass": ok})
    if not ok:
        res["pass"] = False
    return res, sp


def spectrum_metrics(sig: Signals, sp: dict, gain: float) -> dict:
    """C's metrics of the verifier (verify :324-364)."""
    f = sig.freqs
    m = {}
    for key, lo, hi in (("rmse", 100, 8000), ("fc", 900, 1100),
                        ("low", 100, 350), ("high", 3000, 8000)):
        band = (f >= lo) & (f <= hi)
        if not band.any():
            continue
        for c in ("c1", "c2"):
            if key == "rmse":
                m[f"{c}_rmse"] = sig.rmse(sp[f"{c}_db"], sp[f"{c}_theory"],
                                          lo, hi)
            elif key == "fc":
                m[f"{c}_fc_error"] = abs(sig.mean(sp[f"{c}_db"][band]))
            else:
                m[f"{c}_{key}_platform"] = sig.mean(sp[f"{c}_db"][band])
        if key in ("low", "high"):
            sign = 1.0 if key == "low" else -1.0
            m[f"c1_{key}_platform_error"] = abs(m[f"c1_{key}_platform"]
                                                - sign * gain)
            m[f"c2_{key}_platform_error"] = abs(m[f"c2_{key}_platform"]
                                                + sign * gain)
    return m


def tilt_stats(sig: Signals, states) -> dict:
    """D (verify :371-464)."""
    n = min(len(states), sig.n_file)
    st = np.asarray(states)[:n]
    ti = sig.ti
    ok_x = ti["el_x"][:n] > EPS
    ok_y = ti["el_y"][:n] > EPS
    groups = {"input": ti["ti_x"][:n][ok_x], "output": ti["ti_y"][:n][ok_y],
              "c1": ti["ti_y"][:n][ok_y & (st == 1)],
              "c2": ti["ti_y"][:n][ok_y & (st == 2)]}
    q = sig.q
    out = {}
    for key, arr in groups.items():
        if len(arr):
            a = _t(arr)
            out[f"{key}_mean"] = float(q(torch.mean(a)))
            out[f"{key}_std"] = float(q(torch.std(a, correction=0)))
            out[f"{key}_median"] = float(q(_t(np.median(arr))))
            out[f"{key}_min"] = float(a.min())
            out[f"{key}_max"] = float(a.max())
    if "c1_mean" in out and "c2_mean" in out:
        out["ti_effect"] = out["c2_mean"] - out["c1_mean"]
    out["effect_ok"] = out.get("ti_effect", 0) > 5.0
    return out


def verify(sig: Signals, x, y, states) -> tuple:
    """The verifier's results (verify :467-806) and its spectrum dict;
    states: its own recomputed gate's."""
    s = sig.s
    gain = abs(s["c1_low"])
    res = {"pass": True, "checks": {}, "threshold_dbfs": s["threshold"],
           "platform_freqs": [s["fc"] * 2.0 ** (-abs(s["c1_low"])
                                                / s["slope"]),
                              s["fc"] * 2.0 ** (abs(s["c1_high"])
                                                / s["slope"])]}
    eng = engineering(x, y, s["sr"])
    dc = sig.mean(y) if np.size(y) else 0.0
    eng.update(peak_dbfs=20 * math.log10(eng["peak"] + EPS), dc_mean=dc,
               dc_safe=abs(dc) < 0.001)
    eng["pass"] = (eng["sr_match"] and eng["ch_match"]
                   and eng["frames_match"] and eng["peak_safe"]
                   and eng["dc_safe"])
    res["checks"]["engineering"] = eng
    if not eng["pass"]:
        res["pass"] = False
    stats = gate_stats(states)
    duration_min = len(x) / s["sr"] / 60.0
    stats["duration_min"] = duration_min
    stats["switches_per_min"] = (stats.get("switch_count", 0) / duration_min
                                 if duration_min > 0 else 0.0)
    lv = sig.levels.numpy()
    for name, code in (("c1", 1), ("c2", 2)):
        sel = lv[np.asarray(states) == code]
        stats[f"{name}_level_mean"] = sig.mean(sel) if len(sel) else 0.0
    res["checks"]["gate_stats"] = stats
    sp = sig.spectrum(states)
    m = spectrum_metrics(sig, sp, gain)
    rmse_ok = m.get("c1_rmse", 99) < 1.5 and m.get("c2_rmse", 99) < 1.5
    fc_ok = m.get("c1_fc_error", 99) < 0.5 and m.get("c2_fc_error", 99) < 0.5
    platform_ok = all(m.get(k, 99) < 3.0 for k in (
        "c1_low_platform_error", "c2_low_platform_error",
        "c1_high_platform_error", "c2_high_platform_error"))
    ok = rmse_ok and fc_ok and platform_ok
    res["checks"]["spectrum"] = dict(m, c1_frames=sp["c1_frames"],
                                     c2_frames=sp["c2_frames"],
                                     rmse_ok=rmse_ok, fc_ok=fc_ok,
                                     platform_ok=platform_ok, **{"pass": ok})
    if not ok:
        res["pass"] = False
    res["checks"]["tilt_index"] = tilt_stats(sig, states)
    return res, sp


def report_text(res: dict) -> str:
    """The verifier's report as upstream lays it out
    (verify_tomatis_15db.py:514-516, 545-550, 585-588, 637-641, 675-677,
    798-799), from its results."""
    eng = res["checks"]["engineering"]
    st = res["checks"]["gate_stats"]
    sp = res["checks"]["spectrum"]
    ti = res["checks"]["tilt_index"]

    def ok(b):
        return "PASS" if b else "FAIL"

    lines = ["Tomatis ±15dB 验证报告", "=" * 50,
             "\nA. 工程检查",
             f"  采样率一致: {ok(eng['sr_match'])}",
             f"  声道一致: {ok(eng['ch_match'])}",
             f"  样点一致: {ok(eng['frames_match'])} "
             f"(diff={eng['frames_diff']})",
             f"  峰值安全: {ok(eng['peak_safe'])} ({eng['peak']:.4f})",
             f"  DC偏移: {ok(eng['dc_safe'])} ({eng['dc_mean']:.6f})",
             "\nB. Gate 统计",
             f"  C2占比: {st.get('c2_ratio', 0) * 100:.1f}%",
             f"  切换次数: {st.get('switch_count', 0)} "
             f"({st.get('switches_per_min', 0):.1f}/min)",
             f"  短段比例: {st.get('short_run_ratio', 0) * 100:.1f}%",
             "\nC. 条件频谱验证",
             f"  C1 RMSE: {sp.get('c1_rmse', 0):.2f} dB",
             f"  C2 RMSE: {sp.get('c2_rmse', 0):.2f} dB",
             f"  fc误差: C1={sp.get('c1_fc_error', 0):.2f}, "
             f"C2={sp.get('c2_fc_error', 0):.2f} dB",
             f"  结果: {ok(sp['pass'])}",
             "\nD. 效果量化",
             f"  Tomatis效果强度(C2-C1): {ti.get('ti_effect', 0):.2f} dB",
             f"  效果验证: {'PASS' if ti.get('effect_ok') else 'WARN (<5dB)'}",
             "\n" + "=" * 50,
             f"总体结果: {ok(res['pass'])}"]
    return "\n".join(lines)


def write_spectrum_csv(path: str, freqs, sp: dict) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for i, fr in enumerate(freqs):
            w.writerow([f"{fr:.2f}", f"{sp['c1_db'][i]:.4f}",
                        f"{sp['c1_theory'][i]:.4f}",
                        f"{sp['c2_db'][i]:.4f}",
                        f"{sp['c2_theory'][i]:.4f}"])


def _samples(answer) -> np.ndarray:
    if answer.pcm is not None:
        return answer.pcm.astype(np.float64) / FULL_SCALE
    return np.asarray(answer.y, np.float64)


def _csv_states(answer, ref: dict) -> np.ndarray:
    """The CSV rows' states of the configuration's render; on a frame it
    marks masked, the CSV's own (either is right there)."""
    rows = np.asarray(ref["rows"])
    st = np.asarray(ref["states"])[rows].copy()
    masked = np.asarray(ref["masked"])[rows]
    c = answer.csv
    if masked.any() and c is not None and np.array_equal(
            c["frame_idx"], ref["csv_frame_idx"]):
        st[masked] = np.where(np.asarray(c["state"])[masked] == "C2", 2, 1)
    return st


def _bad(a, b) -> bool:
    """Whether a and b are not the same number (NaN is the same as NaN)."""
    fa, fb = float(a), float(b)
    if math.isnan(fa) or math.isnan(fb):
        return math.isnan(fa) != math.isnan(fb)
    return abs(fa - fb) > 1e-9 * max(1.0, abs(fb))


def _gap(a, b) -> float:
    """|a - b|; inf where one is NaN and the other is not."""
    fa, fb = float(a), float(b)
    if math.isnan(fa) or math.isnan(fb):
        return 0.0 if math.isnan(fa) and math.isnan(fb) else math.inf
    return abs(fa - fb)


def _gaps(got: dict, want: dict, out: dict, tilt: bool = False) -> None:
    """Fold the gaps of each key of the reference's results `want` against
    the answer's `got` into out's five numbers (KeyError where the answer
    lacks one)."""
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _gaps(g, w, out, tilt or key == "tilt_index")
        elif isinstance(w, bool):
            out["verify_verdicts"] += g is not w
        elif key in EXACT:
            ws = w if isinstance(w, list) else [w]
            gs = g if isinstance(g, list) else [g]
            out["verify_verdicts"] += len(gs) != len(ws) or any(
                _bad(a, b) for a, b in zip(gs, ws))
        elif key in FRAMES:
            out["verify_gate_frames"] = max(out["verify_gate_frames"],
                                            _gap(g, w))
        elif key in PER:
            per = want[PER[key]]
            out["verify_gate_frames"] = max(out["verify_gate_frames"],
                                            _gap(g, w) * per)
        elif key in DB or tilt:
            name = "verify_tilt_db" if tilt else "verify_metrics_db"
            ws = w if isinstance(w, list) else [w]
            gs = g if isinstance(g, list) else [g]
            worst = (max((_gap(a, b) for a, b in zip(gs, ws)), default=0.0)
                     if len(gs) == len(ws) else math.inf)
            out[name] = max(out[name], worst)
        else:
            raise KeyError(f"no rule for the results' key {key!r}")


def _csv_gaps(path: str, freqs, sp: dict, out: dict) -> None:
    """The measured columns' gaps into verify_spectrum_db, the theory
    columns' into verify_metrics_db; inf where a row or its frequency is
    not the reference's."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows or rows[0] != CSV_HEADER or len(rows) != len(freqs) + 1:
        raise ValueError(f"{os.path.basename(path)}: not the spectrum CSV "
                         f"of {len(freqs)} bins")
    body = rows[1:]
    if [r[0] for r in body] != [f"{fr:.2f}" for fr in freqs]:
        out["verify_spectrum_db"] = math.inf
        return
    cols = np.array([[float(v) for v in r[1:]] for r in body])
    for j, key, name in ((0, "c1_db", "verify_spectrum_db"),
                         (1, "c1_theory", "verify_metrics_db"),
                         (2, "c2_db", "verify_spectrum_db"),
                         (3, "c2_theory", "verify_metrics_db")):
        d = np.abs(cols[:, j] - np.asarray(sp[key], np.float64))
        out[name] = max(out[name], math.inf if np.isnan(d).any()
                        else float(d.max(initial=0.0)))


def audit(answer, x, ref: dict, config: dict, quantise=identity,
          got: dict | None = None) -> dict:
    """Both tools' results and spectra on x and the answer's samples, with
    each gate the alternative (gates()) nearest the answer's results
    `got` ({tool: results}) where given."""
    y = _samples(answer)
    x = np.asarray(x, np.float64)
    sig = Signals(x, y, settings(config), quantise)
    if answer.csv is None:
        raise ValueError(f"{answer.name}: no state CSV for the validator")
    states = _csv_states(answer, ref)
    out = {}
    gates = sig.gates()
    for tool in TOOLS:
        best = None
        for sim in gates:
            res, sp = (validate(sig, x, y, answer.csv, states, sim)
                       if tool == "validate" else verify(sig, x, y, sim))
            if got is None:
                best = (res, sp)
                break
            score = dict.fromkeys(NUMBERS, 0.0)
            _gaps(got[tool], res, score)
            key = (score["verify_gate_frames"], score["verify_verdicts"])
            if best is None or key < best[2]:
                best = (res, sp, key)
        out[tool] = best[:2]
    out["freqs"] = sig.freqs
    return out


def _load(files: dict) -> dict:
    got = {}
    for tool in TOOLS:
        with open(files[f"{tool}_json"], encoding="utf-8") as f:
            got[tool] = json.load(f)
    return got


def numbers(answer, x, ref, config, quantise=identity) -> dict:
    files = answer.files
    got = _load(files)
    out = dict.fromkeys(NUMBERS, 0.0)
    try:
        want = audit(answer, x, ref, config, quantise, got)
        for tool in TOOLS:
            _gaps(got[tool], want[tool][0], out)
        with open(files["verify15_report"], encoding="utf-8") as f:
            lines = f.read().split("\n")
        expect = report_text(got["verify15"]).split("\n")
    except (TypeError, AttributeError, IndexError) as e:
        raise ValueError(f"{answer.name}: malformed results: {e!r}") from e
    out["verify_verdicts"] += abs(len(lines) - len(expect)) + sum(
        a != b for a, b in zip(lines, expect))
    for tool in TOOLS:
        _csv_gaps(files[f"{tool}_csv"], want["freqs"], want[tool][1], out)
    return {k: float(v) for k, v in out.items()}


def outputs(answer, x, ref, config, quantise, directory) -> dict:
    """The further outputs as the driver writes them (drivers/
    verify_process.py), made by this module at quantise's precision."""
    want = audit(answer, x, ref, config, quantise)
    files = {}
    for tool in TOOLS:
        res, sp = want[tool]
        files[f"{tool}_csv"] = os.path.join(directory, f"{tool}.csv")
        write_spectrum_csv(files[f"{tool}_csv"], want["freqs"], sp)
        files[f"{tool}_json"] = os.path.join(directory, f"{tool}.json")
        with open(files[f"{tool}_json"], "w", encoding="utf-8") as f:
            json.dump(res, f)
    files["verify15_report"] = os.path.join(directory, "verify15.txt")
    with open(files["verify15_report"], "w", encoding="utf-8") as f:
        f.write(report_text(want["verify15"][0]))
    return files
