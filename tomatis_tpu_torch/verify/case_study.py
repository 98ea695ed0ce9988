"""Worked calibration case study, PyTorch port of
tomatis_tpu/verify/case_study.py: the acceptance evidence the reference
ships as documents (production numbers gate_offset=-61.08, hyst=1.0,
gain_db=-17.77 with the workflow that produced them, ref
docs/Workflow_v2.md:49-63, and the calibration report
docs/最终校准报告.md:8-40), regenerated end to end from a synthetic
"device" so the whole loop is checked and reproducible:

  1. synthesize a music-like original;
  2. make a fake device recording with KNOWN gate/tilt/gain/offset (the
     port's standard processor plays the device);
  3. `calibrate-v2` recovers the parameters blind;
  4. `process --calibration` applies them (writes the params sidecar);
  5. `validate` PASSes against the sidecar (no hand-copied flags);
  6. `compare` quantifies the match against the device recording.

Every step runs on `device`. `python -m tomatis_tpu_torch.verify.case_study
<outdir> [--device cpu]` regenerates the artifacts into <outdir>; nothing
is written anywhere else.
"""
from __future__ import annotations

import json
import os

import numpy as np

SR = 48000

# Ground truth baked into the fake device (the case study's answer key).
# Linear gate at T = -32 dBFS via the reference's idiom (scale 1, offset
# T - gate_ui), hysteresis 2.0 dB, the validator's ±5 dB plateaus, a
# device recording 12 dB quieter that starts 0.8 s late. hyst is 2.0
# rather than the reference's production 1.0 because calibrate-v2's
# tilt-state debounce (min_run=3, reference parity) absorbs sub-2 dB
# hysteresis — a 1.0 dB truth recovers as 2.0 (one grid step), while
# >= 2.0 recovers exactly; documented in REPORT.md.
TRUE = dict(threshold_dbfs=-32.0, hyst_db=2.0, up_delay_ms=0.0,
            gain_db=-12.0, start_offset_s=0.8,
            c1_low=5.0, c1_high=-5.0, c2_low=-5.0, c2_high=5.0)


def synth_original(seconds: float = 60.0, seed: int = 7) -> np.ndarray:
    """Music-like broadband signal: percussive note onsets (sharp
    envelope structure keeps the alignment cross-correlation
    unambiguous) whose level swings across the gate threshold, with
    enough noise floor that validate's conditional-spectrum check has
    broadband content and stable quiet frames above -60 dBFS."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    amp = np.full(n, 0.012, np.float32)
    pos = 0
    while pos < n:
        dur = int(SR * rng.uniform(0.2, 0.7))
        # onset peaks are lognormal but CAPPED: an uncapped tail forces
        # the peak normalization below the calibrator's music mask
        peak = min(0.09 * 10 ** (0.35 * rng.standard_normal()), 0.22)
        seg = min(dur, n - pos)
        amp[pos:pos + seg] += peak * np.exp(-np.arange(seg) / (0.3 * SR))
        pos += dur
    x = amp * (0.30 * rng.standard_normal(n)
               + 0.5 * np.sin(2 * np.pi * 400 * t)
               + 0.3 * np.sin(2 * np.pi * 2500 * t))
    # headroom: validate's engineering check requires the PROCESSED peak
    # < 0.98; the matched run boosts bands by +c1_low dB and the
    # frequency-domain tilt overshoots the naive time-domain bound on
    # correlated content. Peak-NORMALIZE rather than clip — hard-clipped
    # flat tops ring (Gibbs) far past the per-bin gain bound when the
    # tilt filter hits them (measured: clamp at 0.999 even from a 0.39
    # input cap).
    cap = 0.72 / 10 ** (TRUE["c1_low"] / 20)
    y = np.stack([x, 0.93 * x], 1).astype(np.float32)
    return y * np.float32(cap / np.max(np.abs(y)))


def make_device_recording(x: np.ndarray, device="cuda"):
    """The 'physical device': gate + tilt + level drop + late start."""
    from tomatis_tpu_torch.models.standard import (StandardParams,
                                                   process_array)
    p = StandardParams(
        gate_ui=50.0, gate_mode="linear", gate_scale=1.0,
        gate_offset=TRUE["threshold_dbfs"] - 50.0,
        hysteresis_db=TRUE["hyst_db"], up_delay_ms=TRUE["up_delay_ms"],
        c1_low=TRUE["c1_low"], c1_high=TRUE["c1_high"],
        c2_low=TRUE["c2_low"], c2_high=TRUE["c2_high"],
        output_gain_db=TRUE["gain_db"], require_48k_stereo=False)
    y, _ = process_array(x, SR, p, device=device)
    return y[int(TRUE["start_offset_s"] * SR):]


def run_case_study(outdir, seconds: float = 60.0, seed: int = 7,
                   device="cuda") -> dict:
    """Execute the full loop into `outdir` on `device`; returns the report
    dict (also written as report.json + REPORT.md)."""
    from tomatis_tpu_torch.analysis.calibrate import calibrate_v2
    from tomatis_tpu_torch.analysis.compare import compare_audio
    from tomatis_tpu_torch.cli import process as cli_process
    from tomatis_tpu_torch.cli import validate as cli_validate
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.utils.device import resolve_device

    dev = str(resolve_device(device))

    os.makedirs(outdir, exist_ok=True)

    def p(name):
        return os.path.join(str(outdir), name)

    x = synth_original(seconds, seed)
    audio.write(p("orig.flac"), x, SR, subtype="PCM_24")
    audio.write(p("device.flac"), make_device_recording(x, dev), SR,
                subtype="PCM_24")

    # step 2 of Workflow_v2: fit gate + gain to the device recording
    cal = calibrate_v2(p("orig.flac"), p("device.flac"),
                       out_json=p("calibration_v2.json"), device=dev)

    # step 3: Layer-1 processing with the calibrated parameters — the
    # CLI path, so the calibration JSON and the params sidecar both
    # travel exactly as a user's would
    rc = cli_process.main([
        "-i", p("orig.flac"), "-o", p("matched.flac"),
        "--calibration", p("calibration_v2.json"),
        "--state_csv", p("matched_state.csv"),
        "--c1_low", str(TRUE["c1_low"]), "--c1_high", str(TRUE["c1_high"]),
        "--c2_low", str(TRUE["c2_low"]), "--c2_high", str(TRUE["c2_high"]),
        "--allow_any_rate", "--device", dev])
    if rc != 0:
        raise RuntimeError("process --calibration failed")

    # step 4: the naive validate drive — sidecar only, no flags
    validate_rc = cli_validate.main([
        "-i", p("orig.flac"), "-o", p("matched.flac"),
        "--state_csv", p("matched_state.csv"),
        "--out_csv", p("layer1_spectrum_check.csv"),
        "--out_png", p("layer1_spectrum_check.png"), "--device", dev])

    # step 5: how close is the matched audio to the device recording?
    cmp_res = compare_audio(p("device.flac"), p("matched.flac"),
                            out_csv=p("diff_spectrum.csv"), device=dev)

    report = {
        "true": TRUE,
        "seconds": seconds,
        "seed": seed,
        "device": dev,
        "recovered": {
            "threshold_dbfs": cal["T_raw_dbfs"],
            "gate_offset": cal["gate_offset"],
            "hyst_db": cal["hyst_db"],
            "up_delay_ms": cal["up_delay_ms"],
            "gain_db": cal["gain_db_base_minus_orig"],
            "delay_s": cal["delay_samples_orig_minus_base"] / SR,
            "state_mismatch": cal["mismatch"],
        },
        "errors": {
            "threshold_db": abs(cal["T_raw_dbfs"]
                                - TRUE["threshold_dbfs"]),
            "hyst_db": abs(cal["hyst_db"] - TRUE["hyst_db"]),
            "gain_db": abs(cal["gain_db_base_minus_orig"]
                           - TRUE["gain_db"]),
            "delay_s": abs(cal["delay_samples_orig_minus_base"] / SR
                           - TRUE["start_offset_s"]),
        },
        "validate_pass": validate_rc == 0,
        "compare": {
            "anchor_gain_db": cmp_res["anchor_gain_db"],
            "snr_db": cmp_res["snr_db"],
            "bands": cmp_res["bands"],
        },
    }
    with open(p("report.json"), "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    _write_markdown(p("REPORT.md"), report)
    return report


def _write_markdown(path, r) -> None:
    t, rec, err = r["true"], r["recovered"], r["errors"]
    lines = [
        "# Calibration case study (regenerated artifact)",
        "",
        "The reference documents its acceptance as a worked example: "
        "production numbers `gate_offset=-61.08, hyst=1.0, "
        "gain_db=-17.77` plus the workflow that produced them "
        "(ref docs/Workflow_v2.md:49-63, docs/最终校准报告.md:8-40). "
        "This is the same artifact class for this framework, with a "
        "synthetic device so truth is known and the loop reproducible: "
        "`python -m tomatis_tpu_torch.verify.case_study <outdir>`.",
        "",
        f"Fake device: linear gate T={t['threshold_dbfs']} dBFS, "
        f"hyst {t['hyst_db']} dB, tilt ±{t['c1_low']} dB, level "
        f"{t['gain_db']} dB, starts {t['start_offset_s']} s late "
        f"({r['seconds']:.0f} s program, seed {r['seed']}).",
        "",
        "| quantity | truth | calibrate-v2 recovered | error |",
        "|---|---|---|---|",
        f"| threshold (dBFS) | {t['threshold_dbfs']:.2f} | "
        f"{rec['threshold_dbfs']:.2f} | {err['threshold_db']:.2f} dB |",
        f"| hysteresis (dB) | {t['hyst_db']:.1f} | {rec['hyst_db']:.1f} "
        f"| {err['hyst_db']:.1f} |",
        f"| gain (dB) | {t['gain_db']:.2f} | {rec['gain_db']:.2f} | "
        f"{err['gain_db']:.2f} dB |",
        f"| start offset (s) | {t['start_offset_s']:.3f} | "
        f"{rec['delay_s']:.3f} | {err['delay_s']:.3f} s |",
        "",
        f"Gate-simulation state mismatch at the fitted optimum: "
        f"{100 * rec['state_mismatch']:.2f}% (reference expected >95% "
        f"switch agreement, 最终校准报告.md:40).",
        "",
        "Calibrator resolution note: calibrate-v2's tilt-state debounce "
        "(min_run=3, reference parity) absorbs sub-2 dB hysteresis — a "
        "1.0 dB device recovers as 2.0 (one step of the reference's "
        "hyst grid 0/1/2/3/4/6); ≥2 dB recovers exactly, which is why "
        "this study's device uses 2.0.",
        "",
        f"`process --calibration` then the NAIVE `validate` drive "
        f"(params sidecar, zero flags): "
        f"**{'PASS' if r['validate_pass'] else 'FAIL'}**.",
        "",
        f"Matched audio vs the device recording (`compare`): anchor "
        f"gain {r['compare']['anchor_gain_db']:.2f} dB, residual SNR "
        f"{r['compare']['snr_db']:.1f} dB.",
        "",
        "Per-band mean |Δ| (dB), matched vs device:",
        "",
        "| band (Hz) | mean Δ | std |",
        "|---|---|---|",
    ]
    for band, st in r["compare"]["bands"].items():
        lines.append(f"| {band} | {st['mean']:.2f} | {st['std']:.2f} |")
    lines.append("")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="regenerate the calibration "
                                 "case study into a directory")
    ap.add_argument("outdir")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    a = ap.parse_args()
    rep = run_case_study(a.outdir, a.seconds, device=a.device)
    print(json.dumps({k: rep[k] for k in ("recovered", "errors",
                                          "validate_pass")}, indent=2))
