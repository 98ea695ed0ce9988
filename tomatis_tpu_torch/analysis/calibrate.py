"""Calibrators, PyTorch port of tomatis_tpu/analysis/calibrate.py: fit gate
parameters to a device ("baseline") recording.

v1 (ref src/calibrate_to_baseline.py): align by envelope xcorr, cluster the
baseline's band tilt into C1/C2 labels, grid-search T x hyst x up_delay
minimizing state mismatch (+ tiny switch penalty) -> calibration.json.

v2 (ref src/calibrate_to_baseline_v2.py): adds a music-frame mask, median
filtering of the tilt, debounce of baseline states, and a joint gain search
(T grid auto-centered per gain); converts T back to the raw-audio domain
-> calibration_v2.json. Produced the production numbers gate_offset=-61.08,
hyst=1.0, gain_db=-17.77 (docs/Workflow_v2.md:49-53).

All grid combinations run as lanes of one loop over the frames on the
device (analysis.gridgate); v2's gain values ride in the same loop as a
batch axis. Each result carries "timings": the wall time of the
alignment, the frame features and the grid gate.
"""
from __future__ import annotations

import json
import time

import numpy as np
from scipy.signal import medfilt

from tomatis_tpu_torch.analysis.align import (find_delay_by_corr,
                                              read_aligned_overlap)
from tomatis_tpu_torch.analysis.features import (debounce_state,
                                                 frame_features,
                                                 tilt_to_states)
from tomatis_tpu_torch.analysis.gridgate import (grid_search,
                                                 grid_search_batched)
from tomatis_tpu_torch.utils.device import resolve_device


def calibrate_v1(orig_path, base_path, gate_ui: float = 50.0,
                 n_fft: int = 4096, hop: int = 2048, sr: int = 48000,
                 search_t=(-40.0, -10.0, 0.5),
                 hyst_list=(0, 1, 2, 3, 4, 6, 8),
                 delay_list_ms=(0, 50, 100, 150, 200, 250, 300),
                 max_minutes: float = 8.0,
                 out_json="calibration.json", device="cuda") -> dict:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    delay = find_delay_by_corr(orig_path, base_path, sr=sr)
    xo, xb = read_aligned_overlap(orig_path, base_path, delay,
                                  max_minutes * 60, sr)
    t1 = time.perf_counter()
    levels, _, tilts, starts = frame_features(xo, xb, sr, n_fft, hop,
                                              device=dev)
    base_state = tilt_to_states(tilts)
    t2 = time.perf_counter()

    t_min, t_max, t_step = search_t
    ts = np.arange(t_min, t_max + 1e-9, t_step)
    combos = [dict(T=float(T), hyst=float(h), up_ms=float(u))
              for u in delay_list_ms for h in hyst_list for T in ts]
    best = grid_search(levels, starts, base_state, combos, sr,
                       switch_penalty=1e-6, device=dev)
    t3 = time.perf_counter()

    gate_offset = best["T"] - gate_ui
    result = dict(gate_offset=gate_offset, hyst_db=best["hyst"],
                  up_delay_ms=best["up_ms"], gate_ui=gate_ui)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f)
    result.update(best=best, delay_samples=delay,
                  timings=_timings(t0, t1, t2, t3))
    return result


def _timings(t0, t1, t2, t3) -> dict:
    return dict(align_read_s=round(t1 - t0, 4), features_s=round(t2 - t1, 4),
                grid_gate_s=round(t3 - t2, 4))


def calibrate_v2(orig_path, base_path, gate_ui: float = 50.0,
                 gate_scale: float = 1.0, n_fft: int = 4096,
                 hop: int = 2048, sr: int = 48000,
                 max_minutes: float = 6.0,
                 hyst_list=(0, 1, 2, 3, 4, 6),
                 delay_list_ms=(0, 50, 100, 150, 200, 250),
                 tilt_lo=(200, 1000), tilt_hi=(2000, 8000),
                 tilt_medfilt: int = 5, music_dbfs: float = -65.0,
                 gain_search_pm_db: float = 3.0, gain_step_db: float = 0.5,
                 t_pm_db: float = 10.0, t_step_db: float = 0.25,
                 out_json="calibration_v2.json", device="cuda") -> dict:
    dev = resolve_device(device)
    t_0 = time.perf_counter()
    delay = find_delay_by_corr(orig_path, base_path, sr=sr)
    xo, xb = read_aligned_overlap(orig_path, base_path, delay,
                                  max_minutes * 60, sr)
    t_1 = time.perf_counter()
    orig_level, base_level, tilts, starts = frame_features(
        xo, xb, sr, n_fft, hop, lo=tilt_lo, hi=tilt_hi, device=dev)

    music_mask = base_level > music_dbfs
    music_ratio = float(np.mean(music_mask))

    k = int(tilt_medfilt) | 1
    k = max(3, k)
    tilts_s = medfilt(tilts, kernel_size=k).astype(np.float32)

    base_state = np.ones(len(tilts), np.int32)
    base_state[music_mask] = tilt_to_states(tilts_s[music_mask])
    base_state = debounce_state(base_state, min_run=3)

    gain_db0 = float(np.median((base_level - orig_level)[music_mask]))
    gains = np.arange(gain_db0 - gain_search_pm_db,
                      gain_db0 + gain_search_pm_db + 1e-9,
                      gain_step_db).astype(np.float32)

    idx = np.flatnonzero(music_mask)
    fs_fit = starts[idx]
    s_fit = base_state[idx]
    lv_fit = orig_level[idx]

    # NOTE (reference parity, src/calibrate_to_baseline_v2.py:241-265):
    # the joint gain search is structurally a no-op: T0 is re-centered
    # from the SAME gain-shifted levels, so the gate simulation is
    # shift-invariant and every gain scores identically (modulo f32
    # rounding); with the strict '<' the first grid value (gain_db0 -
    # gain_search_pm_db) wins, exactly as in the reference. T_raw and
    # gate_offset are gain-invariant and unaffected.
    # The gains are rows of one batched simulation; each row's lanes,
    # scores and first-minimum are those of a grid_search of its own, and
    # the rows are then compared in gain order with the strict '<'.
    t_2 = time.perf_counter()
    n1, n2 = int(np.sum(s_fit == 1)), int(np.sum(s_fit == 2))
    levels_b, combos_b = [], []
    if n1 >= 10 and n2 >= 10:
        for gain_db in gains:
            levels_adj = lv_fit + gain_db
            t0 = 0.5 * (float(np.median(levels_adj[s_fit == 1]))
                        + float(np.median(levels_adj[s_fit == 2])))
            ts = np.arange(t0 - t_pm_db, t0 + t_pm_db + 1e-9, t_step_db)
            levels_b.append(levels_adj)
            combos_b.append([dict(T=float(T), hyst=float(h), up_ms=float(u),
                                  gain_db=float(gain_db), T0=float(t0))
                             for u in delay_list_ms for h in hyst_list
                             for T in ts])
    best = None
    if combos_b:
        for cand in grid_search_batched(levels_b, fs_fit, s_fit, combos_b,
                                        sr, switch_penalty=1e-5,
                                        device=dev):
            if best is None or cand["score"] < best["score"]:
                best = cand
    t_3 = time.perf_counter()
    if best is None:
        raise RuntimeError("no usable solution: relax music_dbfs or "
                           "increase max_minutes")

    t_adj = best["T"]
    gain_db = best["gain_db"]
    t_raw = t_adj - gain_db
    gate_offset = t_raw - gate_scale * gate_ui

    result = {
        "orig": str(orig_path), "base": str(base_path),
        "delay_samples_orig_minus_base": int(delay),
        "music_dbfs": float(music_dbfs),
        "gain_db_base_minus_orig": float(gain_db),
        "T_adj_dbfs": float(t_adj),
        "T_raw_dbfs": float(t_raw),
        "gate_ui": float(gate_ui),
        "gate_scale": float(gate_scale),
        "gate_offset": float(gate_offset),
        "hyst_db": float(best["hyst"]),
        "up_delay_ms": float(best["up_ms"]),
        "mismatch": float(best["mismatch"]),
        "switches": int(best["switches"]),
    }
    if out_json:
        with open(out_json, "w", encoding="utf-8") as f:
            json.dump(result, f, ensure_ascii=False, indent=2)
    result["music_ratio"] = music_ratio
    result["gain_db0"] = gain_db0
    result["timings"] = _timings(t_0, t_1, t_2, t_3)
    return result
