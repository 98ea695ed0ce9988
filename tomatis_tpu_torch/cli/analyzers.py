"""CLIs for the level/segment analyzers, PyTorch port of
tomatis_tpu/cli/analyzers.py (parity with the reference's standalone
scripts: analyze_dbfs_simple, analyze_gate_threshold, analyze_stereo_state,
merge_state_volume, inspect_tomatis_d, inspect_transition,
find_main_segment, find_start_smart, find_end_smart). Only analyze-stereo
runs torch ops (its min-hold gate), so only it takes --device; the other
nine are host numpy and scipy."""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def _wrap(fn):
    def runner(argv=None) -> int:
        try:
            return fn(argv)
        except Exception as e:
            import traceback
            print(f"[ERR] {e}")
            traceback.print_exc()
            return 1
    return runner


# -- analyze-dbfs (analyze_dbfs_simple) -------------------------------------

@_wrap
def dbfs_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch analyze-dbfs",
        description="RMS dBFS distribution for gate threshold selection")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import dbfs_distribution
    res = dbfs_distribution(args.input, args.n_fft, args.hop)
    p = res["percentiles"]
    print(f"frames: {res['n_frames']}")
    for q in (1, 10, 50, 90, 99):
        print(f"  p{q:<3} {p[q]:6.1f} dBFS")
    print(f"dynamic range: {res['dynamic_range']:.1f} dB")
    print("suggested gate_ui (gate_offset=-100):")
    for name, s in res["suggestions"].items():
        print(f"  {name}: T = {s['threshold_dbfs']:6.1f} dBFS -> "
              f"gate_ui = {s['gate_ui']:.0f}")
    return 0


# -- analyze-gate-threshold --------------------------------------------------

@_wrap
def gate_threshold_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch analyze-gate-threshold",
        description="Estimate the device gate threshold from dBFS CSVs")
    ap.add_argument("csv", help="CSV with t,in_dbfs,<out>_dbfs columns")
    ap.add_argument("--diff_threshold", type=float, default=3.0)
    ap.add_argument("--out_png", default=None,
                    help="annotated level-track plot (switch points + "
                         "estimated threshold)")
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import (gate_threshold_from_csv,
                                                   read_track_csv)
    res = gate_threshold_from_csv(args.csv, args.diff_threshold)
    if res is None:
        print("no clear gate switch points detected")
        return 0
    print(f"switch points: {res['n_switches']}")
    print(f"input level at switches: mean {res['mean']:.2f} dB, "
          f"median {res['median']:.2f} dB, std {res['std']:.2f} dB")
    print(f"range: [{res['min']:.2f}, {res['max']:.2f}] dB")
    if args.out_png:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np
            df = {k: np.asarray(v, float)
                  for k, v in read_track_csv(args.csv).items()}
            fig, ax = plt.subplots(figsize=(12, 5))
            ax.plot(df["t"], df["in_dbfs"], lw=0.7, label="input dBFS")
            # the column the ANALYSIS matched, not a positional guess
            out_col = res["out_col"]
            ax.plot(df["t"], df[out_col], lw=0.7, alpha=0.7, label=out_col)
            ax.scatter(res["times"], res["levels"], s=18, c="red", zorder=3,
                       label="switch points")
            ax.axhline(res["median"], ls="--", c="red", lw=1,
                       label=f"threshold ~ {res['median']:.1f} dBFS")
            ax.set_xlabel("time (s)")
            ax.set_ylabel("dBFS")
            ax.legend(loc="lower right", fontsize=8)
            ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(args.out_png, dpi=110)
            plt.close(fig)
            print(f"plot: {args.out_png}")
        except Exception as e:
            print(f"[WARN] plot failed: {e}")
    return 0


# -- analyze-stereo ----------------------------------------------------------

@_wrap
def stereo_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch analyze-stereo",
        description="Per-channel threshold search + min-hold gate CSV")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True, help="output CSV")
    ap.add_argument("--target_c2", type=float, default=0.5)
    ap.add_argument("--hyst_db", type=float, default=3.0)
    ap.add_argument("--min_hold_ms", type=float, default=250.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import analyze_stereo_state
    res = analyze_stereo_state(args.input, args.output, args.target_c2,
                               args.hyst_db, args.min_hold_ms,
                               args.n_fft, args.hop, device=args.device)
    for name in ("left", "right"):
        print(f"{name}: T={res[name]['threshold']:.2f} dBFS, "
              f"C2={res[name]['c2_ratio'] * 100:.1f}%")
    print(f"wrote {res['out_csv']} ({res['n_frames']} frames)")
    return 0


# -- merge-state-volume ------------------------------------------------------

@_wrap
def merge_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch merge-state-volume",
        description="Join a state CSV with per-channel dBFS of the audio")
    ap.add_argument("--state_csv", required=True)
    ap.add_argument("--audio", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import merge_state_volume
    res = merge_state_volume(args.state_csv, args.audio, args.output,
                             args.n_fft, args.hop)
    print(f"wrote {res['out_csv']} ({res['n_rows']} rows, "
          f"{res['channels']} channels)")
    return 0


# -- inspect / inspect-transition -------------------------------------------

@_wrap
def inspect_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch inspect",
        description="0.5 s amplitude profile with ASCII bars + plot")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--chunk_sec", type=float, default=0.5)
    ap.add_argument("--out_png", default=None)
    ap.add_argument("--print_sec", type=float, default=60.0)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import amplitude_profile
    res = amplitude_profile(args.input, args.chunk_sec, args.out_png)
    print("Time (s) | Level (dBFS) | Status")
    print("-" * 40)
    for t, lvl in zip(res["times"], res["levels"]):
        if t >= args.print_sec:
            break
        status = ("SILENCE" if lvl < -60 else
                  "LOW" if lvl < -40 else "ACTIVE")
        bar = "#" * int((lvl + 100) / 5) if lvl > -100 else ""
        print(f"{t:6.1f}   | {lvl:6.1f}       | {status} {bar}")
    if args.out_png:
        print(f"plot saved to {args.out_png}")
    return 0


@_wrap
def transition_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch inspect-transition",
        description="100 ms dBFS table of a time window")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--start", type=float, default=10.0)
    ap.add_argument("--end", type=float, default=20.0)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.levels import transition_profile
    res = transition_profile(args.input, args.start, args.end)
    print("Time (s) | Level (dBFS) | Status")
    print("-" * 40)
    for t, lvl in zip(res["times"], res["levels"]):
        status = ("SILENCE" if lvl < -60 else
                  "LOW" if lvl < -40 else "ACTIVE")
        bar = "#" * int((lvl + 100) / 4) if lvl > -80 else ""
        print(f"{t:6.1f}   | {lvl:6.1f}       | {status} {bar}")
    return 0


# -- find-segment / find-start / find-end -----------------------------------

@_wrap
def find_segment_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch find-segment",
        description="Find the main music segment by windowed RMS",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--win_ms", type=float, default=100.0)
    ap.add_argument("--hop_ms", type=float, default=50.0)
    ap.add_argument("--margin_db", type=float, default=15.0)
    ap.add_argument("--min_seg_sec", type=float, default=60.0)
    ap.add_argument("--pad_sec", type=float, default=0.5)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.segments import find_main_segment
    res = find_main_segment(args.input, args.win_ms, args.hop_ms,
                            args.margin_db, args.min_seg_sec, args.pad_sec)
    print(f"duration: {res['duration']:.2f}s  sr: {res['sr']}")
    print(f"noise floor (p10): {res['noise_floor']:.1f} dBFS  "
          f"threshold: {res['threshold']:.1f} dBFS")
    if not res.get("found"):
        print("no main segment found (adjust margin_db / min_seg_sec)")
        return 0
    print(f"main segment: start={res['start']:.3f}s end={res['end']:.3f}s "
          f"len={res['length']:.1f}s")
    print(f"suggested cut (+pad): start={res['start_padded']:.3f}s "
          f"end={res['end_padded']:.3f}s")
    return 0


@_wrap
def find_start_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch find-start",
        description="Smart music-start detection (RMS/centroid/ZCR)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--search_duration", type=float, default=30.0)
    ap.add_argument("--focus_lo", type=float, default=14.0)
    ap.add_argument("--focus_hi", type=float, default=19.0)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.segments import find_start_smart
    res = find_start_smart(args.input, args.search_duration,
                           (args.focus_lo, args.focus_hi))
    print(f"noise floor: {res['noise_floor']:.1f} dB  "
          f"trigger threshold: {res['threshold']:.1f} dB")
    if res["candidates"]:
        print("potential start points: "
              + ", ".join(f"{c:.2f}s" for c in res["candidates"]))
    else:
        print("no clear jump detected in the focus window")
    return 0


@_wrap
def find_end_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch find-end",
        description="Smart music-end detection (reverse scan)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--search_duration", type=float, default=30.0)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.segments import find_end_smart
    res = find_end_smart(args.input, args.search_duration)
    print(f"duration: {res['duration']:.2f}s  tail noise floor: "
          f"{res['noise_floor']:.1f} dB  threshold: {res['threshold']:.1f} dB")
    if res["found"]:
        print(f"audio ends around {res['end_time']:.2f}s")
        if res["recommended_cut"]:
            print(f"recommended end cut: {res['recommended_cut']:.2f}s "
                  f"(+1.0s tail margin)")
    else:
        print("no silence detected at end")
    return 0


@_wrap
def compare_dbfs_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch compare-dbfs",
        description="Align N recordings to an input and emit frame-dBFS "
                    "track CSVs (feed into analyze-gate-threshold)")
    ap.add_argument("-i", "--input", required=True,
                    help="the source recording")
    ap.add_argument("-c", "--candidate", action="append", required=True,
                    metavar="NAME=PATH",
                    help="a candidate recording (repeatable)")
    ap.add_argument("--sr", type=int, default=None,
                    help="resample target (default: input rate)")
    ap.add_argument("--frame_ms", type=float, default=20.0)
    ap.add_argument("--hop_ms", type=float, default=10.0)
    ap.add_argument("--max_lag_s", type=float, default=2.0)
    ap.add_argument("--out_prefix", default="dbfs",
                    help="CSV prefix: <prefix>_<name>.csv")
    args = ap.parse_args(argv)
    cands = {}
    for spec in args.candidate:
        if "=" in spec:
            name, path = spec.split("=", 1)
        else:
            import os
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        cands[name] = path
    from tomatis_tpu_torch.analysis.levels import compare_dbfs_tracks
    res = compare_dbfs_tracks(args.input, cands, sr_target=args.sr,
                              frame_ms=args.frame_ms, hop_ms=args.hop_ms,
                              max_lag_s=args.max_lag_s,
                              out_prefix=args.out_prefix)
    for name, r in res.items():
        print(f"{name}: lag {r['lag']} samples, {len(r['t'])} frames -> "
              f"{args.out_prefix}_{name}.csv")
    return 0


main = dbfs_main

if __name__ == "__main__":
    sys.exit(dbfs_main())
