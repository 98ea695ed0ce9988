"""CLI: crossfade Tomatis processor on the PyTorch port (linear gate
mapping only, as the reference's variant).

    python -m tomatis_tpu_torch.cli.main process-xfade -i in.flac -o out.flac --xfade_ms 80

Takes the reference flags (tomatis_tpu/cli/process_xfade.py) and --device.
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import (add_device_flag,
                                          add_engine_flags, add_filter_flags,
                                          add_gate_flags, add_io_flags,
                                          add_stft_flags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch process-xfade",
        description="Tomatis processor with crossfade state transitions",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_io_flags(ap)
    add_gate_flags(ap, gate_mode=False)  # this variant is linear-only
    ap.add_argument("--xfade_ms", type=float, default=0.0,
                    help="crossfade transition time (ms), 0 = hard switch")
    add_filter_flags(ap)
    add_stft_flags(ap)
    ap.add_argument("--state_csv", default=None,
                    help="per-frame state CSV output path (with alpha)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash recovery")
    ap.add_argument("--checkpoint_every", type=int, default=8,
                    help="chunks between checkpoints (with --checkpoint)")
    ap.add_argument("--progress", action="store_true",
                    help="print per-chunk progress")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "pcm24", "f32"],
                    help="host<->device link transport (see process)")
    add_device_flag(ap)
    add_engine_flags(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.xfade import XfadeParams, process
    p = XfadeParams(
        gate_ui=args.gate_ui, gate_scale=args.gate_scale,
        gate_offset=args.gate_offset, hysteresis_db=args.hyst_db,
        up_delay_ms=args.up_delay_ms, xfade_ms=args.xfade_ms,
        fc=args.fc, slope=args.slope,
        c1_low=args.c1_low, c1_high=args.c1_high,
        c2_low=args.c2_low, c2_high=args.c2_high,
        n_fft=args.n_fft, hop=args.hop,
        require_48k_stereo=not args.allow_any_rate)
    prog = None
    if args.progress:
        def prog(done, total_frames):
            print(f"  processed {done}/{total_frames} frames "
                  f"({100 * done / max(1, total_frames):.0f}%)", flush=True)
    stats = process(args.input, args.output, p,
                    state_csv_path=args.state_csv,
                    frames_per_chunk=args.frames_per_chunk,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    progress=prog, transport=args.transport,
                    device=args.device)
    n = max(1, stats["n_frames"])
    print(f"threshold: {stats['threshold_dbfs']:.1f} dBFS, "
          f"xfade: {stats['xfade_frames']} frames")
    print(f"frames: {stats['n_frames']}  "
          f"C1: {stats['c1_frames']} ({100 * stats['c1_frames'] / n:.1f}%)  "
          f"C2: {stats['c2_frames']} ({100 * stats['c2_frames'] / n:.1f}%)")
    from tomatis_tpu_torch.cli._sidecar import linear_gate, write_sidecar
    write_sidecar(args.output, "process-xfade", dict(
        **linear_gate(p.gate_ui, p.threshold_dbfs()),
        hyst_db=p.hysteresis_db, up_delay_ms=p.up_delay_ms,
        xfade_ms=p.xfade_ms, fc=p.fc, slope=p.slope,
        c1_low=p.c1_low, c1_high=p.c1_high,
        c2_low=p.c2_low, c2_high=p.c2_high,
        n_fft=p.n_fft, hop=p.hop))
    print(f"output: {stats['out_path']}")
    print(f"wall: {stats['wall_seconds']:.2f}s "
          f"({stats['realtime_factor']:.1f}x realtime on {stats['device']})")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # as the reference: print the traceback, exit 1
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
