"""CLI: the processors sharded over a mesh of devices, on the PyTorch port.

One file's frames are split across the 'seq' shards of a ('data', 'seq')
mesh: the FFT gain bank runs frame-parallel per shard, the gate automaton
crosses shards as a block-composed scan, and the OLA halo is one copy per
shard boundary (parallel.sharded). Output is that of `process` (same flush
plan, per-flush clamp, state CSV).

    python -m tomatis_tpu_torch.cli.main process-sharded -i in.flac \\
        -o out.flac --devices 4 --frames_per_shard 256

Takes the reference flags (tomatis_tpu/cli/process_sharded.py) and
--device: "cuda" (the default, or TOMATIS_PLATFORM) puts one shard on each of the first
--devices cards (all of them without --devices, as the reference); a named
device (cuda:0, cpu) puts --devices shards on that one device, so
`--device cuda:0 --devices 4` runs four shards on one card.
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import (add_device_flag,
                                          add_filter_flags, add_gate_flags,
                                          add_io_flags, add_stft_flags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch process-sharded",
        description="Standard Tomatis processor sharded over a device mesh "
                    "(sequence-parallel frames, gate block scan + OLA halo)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_io_flags(ap)
    ap.add_argument("--state_csv", default=None,
                    help="state CSV output path")
    add_gate_flags(ap)
    add_filter_flags(ap)
    add_stft_flags(ap)
    ap.add_argument("--output_gain_db", type=float, default=0.0,
                    help="output gain (dB)")
    ap.add_argument("--allow_any_rate", action="store_true",
                    help="skip the 48 kHz stereo requirement")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of devices to use (default: all); every "
                         "device goes on the 'seq' axis; for parallelism "
                         "across FILES use process-batch instead")
    ap.add_argument("--frames_per_shard", type=int, default=256,
                    help="frames per device per super-chunk")
    ap.add_argument("--variant", choices=("standard", "xfade", "adaptive"),
                    default="standard",
                    help="processor variant (xfade adds the rate-limited "
                         "alpha ramp with dB-domain gain blending; adaptive "
                         "adds auto threshold, min-hold gate, pre-atten "
                         "and global peak protect)")
    ap.add_argument("--xfade_ms", type=float, default=None,
                    help="crossfade transition (ms); default 0 for the "
                         "xfade variant, 500 for adaptive (the reference "
                         "CLIs' respective defaults)")
    ap.add_argument("--target_c2", type=float, default=0.5,
                    help="adaptive: target C2 ratio for the threshold "
                         "search")
    ap.add_argument("--min_hold_ms", type=float, default=250.0,
                    help="adaptive: minimum state hold (ms)")
    ap.add_argument("--headroom_margin", type=float, default=2.0,
                    help="adaptive: pre-attenuation margin (dB)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash recovery; re-running "
                         "the same command on the same mesh resumes with "
                         "byte-identical output (the adaptive variant "
                         "resumes its heavy STFT pass; its cheap "
                         "level/threshold passes recompute)")
    ap.add_argument("--checkpoint_every", type=int, default=8,
                    help="super-chunks between checkpoints")
    add_device_flag(ap, help="cuda: one shard per card; a named device "
                             "(cuda:N, cpu): --devices shards on it")
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.parallel.stream import (process_sharded,
                                                   process_sharded_adaptive)
    from tomatis_tpu_torch.utils.device import resolve_devices
    devices = resolve_devices(args.devices, args.device)
    if args.variant == "adaptive":
        from tomatis_tpu_torch.models.adaptive import AdaptiveParams
        if args.output_gain_db:
            print("[ERR] --output_gain_db is not supported by the adaptive "
                  "variant (reference parity: src/process_tomatis_adaptive"
                  ".py applies pre-attenuation/restore instead)")
            return 2
        p = AdaptiveParams(
            fc=args.fc, slope=args.slope,
            c1_low=args.c1_low, c1_high=args.c1_high,
            c2_low=args.c2_low, c2_high=args.c2_high,
            target_c2=args.target_c2, hyst_db=args.hyst_db,
            min_hold_ms=args.min_hold_ms,
            xfade_ms=500.0 if args.xfade_ms is None else args.xfade_ms,
            headroom_margin=args.headroom_margin,
            n_fft=args.n_fft, hop=args.hop)
        stats = process_sharded_adaptive(
            args.input, args.output, p, devices=devices,
            frames_per_shard=args.frames_per_shard,
            state_csv_path=args.state_csv,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every)
        m = stats["mesh"]
        print(f"mesh: data={m['data']} seq={m['seq']}  "
              f"frames/shard: {stats['frames_per_shard']}")
        print(f"auto threshold: {stats['optimal_threshold']:.1f} dBFS  "
              f"(target C2 {args.target_c2 * 100:.0f}%)")
        print(f"pre-attenuation: {stats['atten_db']:.1f} dB")
        print(f"frames: {stats['n_frames']}  "
              f"C2 ratio: {stats['c2_ratio'] * 100:.1f}%  "
              f"switches: {stats['switch_count']}")
        print(f"output: {stats['out_path']} ({stats['total']} samples)")
        print(f"wall: {stats['wall_seconds']:.2f}s "
              f"({stats['realtime_factor']:.1f}x realtime)")
        return 0
    if args.variant == "xfade":
        from tomatis_tpu_torch.models.xfade import XfadeParams
        if args.output_gain_db:
            print("[ERR] --output_gain_db is not supported by the xfade "
                  "variant (reference parity: src/process_tomatis_xfade.py "
                  "has no output gain)")
            return 2
        explicit = any(a == "--gate_mode" or a.startswith("--gate_mode=")
                       for a in getattr(args, "raw_argv", []))
        if args.gate_mode != "linear" and explicit:
            # only when the user actually asked for a non-linear mapping:
            # the flag DEFAULTS to log_percent, and warning on every
            # default run would claim a choice the user never made
            print("note: the crossfade variant supports only the LINEAR "
                  "gate mapping (ref src/process_tomatis_xfade.py:28-30); "
                  f"--gate_mode {args.gate_mode} is ignored")
        p = XfadeParams(
            gate_ui=args.gate_ui, gate_scale=args.gate_scale,
            gate_offset=args.gate_offset, hysteresis_db=args.hyst_db,
            up_delay_ms=args.up_delay_ms,
            xfade_ms=0.0 if args.xfade_ms is None else args.xfade_ms,
            fc=args.fc, slope=args.slope,
            c1_low=args.c1_low, c1_high=args.c1_high,
            c2_low=args.c2_low, c2_high=args.c2_high,
            n_fft=args.n_fft, hop=args.hop,
            require_48k_stereo=not args.allow_any_rate)
    else:
        from tomatis_tpu_torch.models.standard import StandardParams
        p = StandardParams(
            gate_ui=args.gate_ui, gate_mode=args.gate_mode,
            dynamic_range=args.dynamic_range, gate_scale=args.gate_scale,
            gate_offset=args.gate_offset, hysteresis_db=args.hyst_db,
            up_delay_ms=args.up_delay_ms,
            fc=args.fc, slope=args.slope,
            c1_low=args.c1_low, c1_high=args.c1_high,
            c2_low=args.c2_low, c2_high=args.c2_high,
            n_fft=args.n_fft, hop=args.hop,
            output_gain_db=args.output_gain_db,
            require_48k_stereo=not args.allow_any_rate)
    stats = process_sharded(args.input, args.output, p, devices=devices,
                            frames_per_shard=args.frames_per_shard,
                            state_csv_path=args.state_csv,
                            variant=args.variant,
                            checkpoint_path=args.checkpoint,
                            checkpoint_every=args.checkpoint_every)
    m = stats["mesh"]
    print(f"mesh: data={m['data']} seq={m['seq']}  "
          f"frames/shard: {stats['frames_per_shard']}")
    print(f"threshold: {stats['threshold_dbfs']:.1f} dBFS")
    print(f"frames: {stats['n_frames']}  "
          f"C1: {stats['c1_frames']} ({stats['c1_ratio'] * 100:.1f}%)  "
          f"C2: {stats['c2_frames']} ({stats['c2_ratio'] * 100:.1f}%)")
    print(f"output: {stats['out_path']} ({stats['total']} samples)")
    print(f"wall: {stats['wall_seconds']:.2f}s "
          f"({stats['realtime_factor']:.1f}x realtime)")
    return 0


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    # run() tells an explicit --gate_mode from the argparse default (the
    # xfade variant warns only on a real user choice)
    args.raw_argv = argv
    try:
        return run(args)
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
