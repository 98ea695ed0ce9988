"""CLI: standard Tomatis processor on the PyTorch port.

    python -m tomatis_tpu_torch.cli.main process -i in.wav -o out.wav --gate_ui 50

Takes the reference flags (tomatis_tpu/cli/process.py). --device picks the
card (default cuda); --profile_dir writes a torch.profiler trace;
--checkpoint is refused (checkpoint/resume is not yet ported).
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import (add_engine_flags, add_filter_flags,
                                          add_gate_flags, add_io_flags,
                                          add_stft_flags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch process",
        description="Tomatis processor: gate-controlled C1/C2 tilt filter",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_io_flags(ap)
    add_gate_flags(ap)
    add_filter_flags(ap)
    add_stft_flags(ap)
    ap.add_argument("--state_csv", default=None,
                    help="per-frame state CSV output path")
    ap.add_argument("--output_gain_db", type=float, default=0.0,
                    help="output gain compensation (dB)")
    ap.add_argument("--calibration", default=None,
                    help="calibration(.json) from calibrate/calibrate-v2: "
                         "overrides gate_ui/scale/offset/hyst/up_delay")
    ap.add_argument("--checkpoint", default=None,
                    help="not yet ported: refused")
    ap.add_argument("--checkpoint_every", type=int, default=8,
                    help="chunks between checkpoints (with --checkpoint)")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler chrome trace of the run "
                         "here")
    ap.add_argument("--progress", action="store_true",
                    help="print per-chunk progress")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "wire", "pcm24", "f32"],
                    help="device->host transport: pcm24 = device-packed "
                         "PCM_24 bytes, f32 = raw floats, auto picks pcm24; "
                         "wire is not yet ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    add_engine_flags(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.standard import StandardParams, process
    cal = {}
    if args.calibration:
        import json
        with open(args.calibration, "r", encoding="utf-8") as f:
            cal = json.load(f)
        print(f"calibration loaded: {args.calibration}")
    p = StandardParams(
        gate_ui=cal.get("gate_ui", args.gate_ui),
        gate_mode="linear" if cal else args.gate_mode,
        dynamic_range=args.dynamic_range,
        gate_scale=cal.get("gate_scale", args.gate_scale),
        gate_offset=cal.get("gate_offset", args.gate_offset),
        hysteresis_db=cal.get("hyst_db", args.hyst_db),
        up_delay_ms=cal.get("up_delay_ms", args.up_delay_ms),
        fc=args.fc, slope=args.slope,
        c1_low=args.c1_low, c1_high=args.c1_high,
        c2_low=args.c2_low, c2_high=args.c2_high,
        n_fft=args.n_fft, hop=args.hop,
        output_gain_db=args.output_gain_db,
        require_48k_stereo=not args.allow_any_rate)
    print(f"threshold: {p.threshold_dbfs():.1f} dBFS "
          f"(Ton {p.threshold_dbfs() + p.hysteresis_db / 2:.1f}, "
          f"Toff {p.threshold_dbfs() - p.hysteresis_db / 2:.1f})")
    prog = None
    if args.progress:
        def prog(done, total_frames):
            print(f"  processed {done}/{total_frames} frames "
                  f"({100 * done / max(1, total_frames):.0f}%)", flush=True)
    kw = dict(state_csv_path=args.state_csv,
              frames_per_chunk=args.frames_per_chunk,
              checkpoint_path=args.checkpoint, progress=prog,
              transport=args.transport, device=args.device)
    if args.profile_dir:
        import os
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            stats = process(args.input, args.output, p, **kw)
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
    else:
        stats = process(args.input, args.output, p, **kw)
    n = max(1, stats["n_frames"])
    print(f"frames: {stats['n_frames']}  "
          f"C1: {stats['c1_frames']} ({100 * stats['c1_frames'] / n:.1f}%)  "
          f"C2: {stats['c2_frames']} ({100 * stats['c2_frames'] / n:.1f}%)")
    from tomatis_tpu_torch.cli._sidecar import linear_gate, write_sidecar
    write_sidecar(args.output, "process", dict(
        **linear_gate(p.gate_ui, p.threshold_dbfs()),
        gate_mode=p.gate_mode, dynamic_range=p.dynamic_range,
        hyst_db=p.hysteresis_db, up_delay_ms=p.up_delay_ms,
        fc=p.fc, slope=p.slope,
        c1_low=p.c1_low, c1_high=p.c1_high,
        c2_low=p.c2_low, c2_high=p.c2_high,
        n_fft=p.n_fft, hop=p.hop, output_gain_db=p.output_gain_db))
    print(f"output: {stats['out_path']} ({stats['total']} samples)")
    print(f"wall: {stats['wall_seconds']:.2f}s "
          f"({stats['realtime_factor']:.1f}x realtime on {stats['device']})")
    t = stats.get("timings", {})
    if t:
        print(f"stages: input {t.get('input_host_s', 0):.2f}s  "
              f"device {t.get('dispatch_compute_s', 0):.2f}s  "
              f"readback {t.get('consume_s', 0):.2f}s")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # reference prints traceback and exits 1 (:538-542)
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
