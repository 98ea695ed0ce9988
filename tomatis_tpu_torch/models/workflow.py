"""Automated device-matching workflow, PyTorch port of
tomatis_tpu/models/workflow.py (docs/Workflow_v2.md as one call).

The reference chains six scripts by hand: calibrate_to_baseline_v2 ->
process_tomatis --calibration -> layer2_analyze_eq -> layer2_apply_eq ->
compare_audio -> layer2b_apply_residual_eq(_safe). This module runs the
whole chain, threading each stage's artifact into the next, and reports
the per-stage band errors and each stage's wall time.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from tomatis_tpu_torch.analysis.analyze_eq import analyze_eq
from tomatis_tpu_torch.analysis.calibrate import calibrate_v2
from tomatis_tpu_torch.analysis.compare import compare_audio
from tomatis_tpu_torch.models import eq as eqm
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.utils.device import resolve_device


def music_err(compare_result: dict) -> float:
    """Mean |band delta| over the 200 Hz - 8 kHz music bands
    (ref compare_to_baseline.py music_err)."""
    b = compare_result["bands"]
    return float(np.mean([abs(b["200-1000"]["mean"]),
                          abs(b["1000-3000"]["mean"]),
                          abs(b["3000-8000"]["mean"])]))


def match_device(orig_path, device_path, outdir, gate_ui: float = 50.0,
                 c1_low: float = 15.0, c1_high: float = -15.0,
                 c2_low: float = -15.0, c2_high: float = 15.0,
                 fc: float = 1000.0, slope: float = 12.0,
                 n_fft: int = 4096, hop: int = 2048,
                 safe_residual: bool = True, max_minutes: float = 6.0,
                 require_48k_stereo: bool = True,
                 progress=print, device="cuda") -> dict:
    """Run the full matching workflow. Returns a dict of artifact paths and
    per-stage metrics; the final audio is <outdir>/matched.flac.
    device_path is the device RECORDING; device is the torch device.
    report["timings"] holds each stage's wall time, with the calibrator's
    own split (alignment, features, grid gate)."""
    dev = resolve_device(device)
    timings = {}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        now = time.perf_counter()
        timings[key] = round(timings.get(key, 0.0) + now - t0, 4)
        t0 = now

    os.makedirs(outdir, exist_ok=True)
    art = lambda name: os.path.join(outdir, name)  # noqa: E731
    report = {"outdir": outdir, "stages": {}}

    progress("[1/5] calibrating gate parameters against the device "
             "recording...")
    cal = calibrate_v2(orig_path, device_path, gate_ui=gate_ui,
                       max_minutes=max_minutes,
                       out_json=art("calibration_v2.json"), device=dev)
    lap("calibrate_s")
    timings["calibrate"] = cal["timings"]
    report["stages"]["calibrate"] = {
        k: cal[k] for k in ("T_raw_dbfs", "gate_offset", "hyst_db",
                            "up_delay_ms", "gain_db_base_minus_orig",
                            "mismatch")}
    progress(f"      T={cal['T_raw_dbfs']:.2f} dBFS hyst={cal['hyst_db']} "
             f"up={cal['up_delay_ms']:.0f}ms "
             f"(state mismatch {cal['mismatch'] * 100:.1f}%)")

    progress("[2/5] layer 1: gate-controlled tilt processing...")
    p = StandardParams(gate_ui=cal["gate_ui"], gate_mode="linear",
                       gate_scale=cal["gate_scale"],
                       gate_offset=cal["gate_offset"],
                       hysteresis_db=cal["hyst_db"],
                       up_delay_ms=cal["up_delay_ms"], fc=fc, slope=slope,
                       c1_low=c1_low, c1_high=c1_high, c2_low=c2_low,
                       c2_high=c2_high, n_fft=n_fft, hop=hop,
                       require_48k_stereo=require_48k_stereo)
    l1 = art("layer1.flac")
    stats = process(orig_path, l1, p, state_csv_path=art("state.csv"),
                    device=dev)
    lap("layer1_process_s")
    l1 = stats["out_path"]   # may be the .wav fallback when FLAC encode
    # is unavailable: later stages must read what was actually written
    report["stages"]["layer1"] = dict(
        c2_ratio=stats["c2_ratio"],
        realtime_factor=stats["realtime_factor"])
    r0 = compare_audio(device_path, l1, out_csv=None, device=dev)
    lap("compare_s")
    report["stages"]["layer1"]["music_err_db"] = music_err(r0)
    progress(f"      C2 {stats['c2_ratio'] * 100:.1f}%  "
             f"music_err {music_err(r0):.2f} dB")

    progress("[3/5] layer 2: static EQ toward the device spectrum...")
    analyze_eq(device_path, l1, out_csv=art("layer2_eq_curve.csv"),
               out_png=art("layer2_eq_curve.png"),
               max_minutes=max_minutes, n_fft=8192, hop=4096, device=dev)
    lap("analyze_eq_s")
    l2 = art("layer2.flac")
    eq_res = eqm.apply_eq(l1, l2, art("layer2_eq_curve.csv"), pad=True,
                          n_fft=n_fft, hop=hop, device=dev)
    lap("apply_eq_s")
    l2 = eq_res["out_path"]
    if eq_res.get("gain_protected_path"):
        # the plain render clipped in PCM; carry the peak-safe rescale
        # forward (compare_audio gain-anchors, so the scale is neutral)
        l2 = eq_res["gain_protected_path"]
        progress(f"      using gain-protected render ({l2})")
    r1 = compare_audio(device_path, l2, out_csv=None, device=dev)
    lap("compare_s")
    report["stages"]["layer2"] = dict(music_err_db=music_err(r1))
    progress(f"      music_err {music_err(r1):.2f} dB")

    progress("[4/5] layer 2b: residual EQ"
             + (" (Safe-B)" if safe_residual else "") + "...")
    compare_audio(device_path, l2, out_csv=art("diff_spectrum.csv"),
                  device=dev)
    lap("compare_s")
    matched = art("matched.flac")
    res_out = eqm.apply_residual_eq(l2, matched, art("diff_spectrum.csv"),
                                    safe=safe_residual, n_fft=n_fft, hop=hop,
                                    device=dev)
    matched = res_out["out_path"]
    if res_out["peak_seen"] > 0.99:
        # The uncropped OLA stream blows up its first/last few samples
        # (window-sum ~ 0 at the edges: same artifact the reference's
        # residual appliers write). Only re-render with a pre-gain when the
        # INTERIOR actually clips; edge transients alone aren't worth
        # crushing the level for.
        x_m, _sr = audio.read(matched)
        interior = x_m[n_fft:-n_fft] if len(x_m) > 2 * n_fft else x_m
        ipk = float(np.max(np.abs(interior)))
        if ipk > 0.99:
            pg_db = float(20.0 * np.log10(0.99 / ipk))
            res_out = eqm.apply_residual_eq(
                l2, matched, art("diff_spectrum.csv"), safe=safe_residual,
                n_fft=n_fft, hop=hop, pre_gain_db=pg_db, device=dev)
            matched = res_out["out_path"]
            report["stages"].setdefault("residual", {})[
                "peak_protect_db"] = pg_db
            progress(f"      peak-protected final render ({pg_db:+.2f} dB)")

    lap("apply_residual_eq_s")
    progress("[5/5] final comparison...")
    r2 = compare_audio(device_path, matched,
                       out_csv=art("final_diff_spectrum.csv"), device=dev)
    lap("compare_s")
    report["stages"]["final"] = dict(
        music_err_db=music_err(r2),
        noise_delta_db=r2["bands"]["8000-16000"]["mean"],
        snr_db=r2["snr_db"])
    report["matched_path"] = matched
    report["timings"] = timings
    report["device"] = str(dev)
    progress(f"      music_err {music_err(r2):.2f} dB  "
             f"noise delta {r2['bands']['8000-16000']['mean']:+.2f} dB")

    with open(art("match_report.json"), "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    return report
