"""CLI: adaptive Tomatis processor on the PyTorch port (parity with
ref src/process_tomatis_adaptive.py:376-421; the reference flags and
--device).

    python -m tomatis_tpu_torch.cli.main process-adaptive -i in.flac -o out.flac
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import (add_device_flag,
                                          add_filter_flags, add_io_flags,
                                          add_stft_flags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch process-adaptive",
        description="Adaptive Tomatis processor: auto threshold to a target "
                    "C2 ratio, min-hold gate, crossfade, headroom management",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_io_flags(ap)
    ap.add_argument("--state_csv", default=None, help="state CSV output path")
    add_filter_flags(ap)
    ap.add_argument("--target_c2", type=float, default=0.5,
                    help="target C2 ratio")
    ap.add_argument("--hyst_db", type=float, default=3.0, help="hysteresis dB")
    ap.add_argument("--min_hold_ms", type=float, default=250.0,
                    help="min hold after a switch (ms)")
    ap.add_argument("--xfade_ms", type=float, default=500.0,
                    help="crossfade transition (ms)")
    ap.add_argument("--headroom_margin", type=float, default=2.0,
                    help="pre-attenuation margin (dB)")
    add_stft_flags(ap)
    ap.add_argument("--frames_per_chunk", type=int, default=1024,
                    help="frames per device chunk step")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash recovery of the STFT "
                         "pass; re-running the same command resumes")
    ap.add_argument("--checkpoint_every", type=int, default=8,
                    help="chunks between checkpoints")
    ap.add_argument("--progress", action="store_true",
                    help="print per-chunk progress")
    add_device_flag(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.adaptive import AdaptiveParams, process
    p = AdaptiveParams(
        fc=args.fc, slope=args.slope,
        c1_low=args.c1_low, c1_high=args.c1_high,
        c2_low=args.c2_low, c2_high=args.c2_high,
        target_c2=args.target_c2, hyst_db=args.hyst_db,
        min_hold_ms=args.min_hold_ms, xfade_ms=args.xfade_ms,
        headroom_margin=args.headroom_margin,
        n_fft=args.n_fft, hop=args.hop)
    prog = None
    if args.progress:
        def prog(done, total_frames):
            print(f"  processed {done}/{total_frames} frames "
                  f"({100 * done / max(1, total_frames):.0f}%)", flush=True)
    stats = process(args.input, args.output, p,
                    state_csv_path=args.state_csv,
                    frames_per_chunk=args.frames_per_chunk,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every, progress=prog,
                    device=args.device)
    print(f"pre-attenuation: {-stats['atten_db']:.2f} dB")
    print(f"optimal threshold: {stats['optimal_threshold']:.2f} dBFS")
    print(f"C2 ratio: {stats['c2_ratio'] * 100:.1f}%  "
          f"switches: {stats['switch_count']} "
          f"({stats['switches_per_min']:.1f}/min)  "
          f"short runs: {stats['short_run_ratio'] * 100:.1f}%")
    from tomatis_tpu_torch.cli._sidecar import write_sidecar
    # no gate_scale/gate_offset triple here: the adaptive gate is a
    # min-hold machine over the PRE-ATTENUATED signal, which validate's
    # up-delay recompute cannot reproduce; verify-15db-v2 (the matching
    # verifier) re-solves the threshold itself from target_c2
    write_sidecar(args.output, "process-adaptive", dict(
        target_c2=p.target_c2, hyst_db=p.hyst_db,
        min_hold_ms=p.min_hold_ms, xfade_ms=p.xfade_ms,
        fc=p.fc, slope=p.slope,
        c1_low=p.c1_low, c1_high=p.c1_high,
        c2_low=p.c2_low, c2_high=p.c2_high,
        n_fft=p.n_fft, hop=p.hop,
        optimal_threshold_dbfs=float(stats["optimal_threshold"]),
        atten_db=float(stats["atten_db"])))
    print(f"output: {stats['out_path']}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
