"""CLI: batch processor on the PyTorch port — one lane per file, one
batched chunk-tail launch per chunk, per-file failure isolation.

    python -m tomatis_tpu_torch.cli.main process-batch -i a.flac b.flac -o outdir/

Takes the reference flags (tomatis_tpu/cli/process_batch.py); --device
picks the card (default cuda). --devices N shards the lanes over the first
N cards, or puts N lane blocks on the one device that --device names
(cuda:0, cpu).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from tomatis_tpu_torch.cli._flags import (add_device_flag,
                                          add_filter_flags, add_gate_flags,
                                          add_stft_flags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch process-batch",
        description="Process many files per device step (file lanes)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--inputs", required=True, nargs="+")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--suffix", default="_tomatis",
                    help="output name suffix")
    add_gate_flags(ap)
    add_filter_flags(ap)
    add_stft_flags(ap)
    ap.add_argument("--state_csv_dir", default=None,
                    help="write per-file state CSVs here")
    ap.add_argument("--output_gain_db", type=float, default=0.0)
    ap.add_argument("--frames_per_chunk", type=int, default=1024)
    ap.add_argument("--allow_any_rate", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the lane axis over the first N devices "
                         "(0 = single device)")
    add_device_flag(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.standard import StandardParams
    from tomatis_tpu_torch.parallel.batch import process_batch
    p = StandardParams(
        gate_ui=args.gate_ui, gate_mode=args.gate_mode,
        dynamic_range=args.dynamic_range, gate_scale=args.gate_scale,
        gate_offset=args.gate_offset, hysteresis_db=args.hyst_db,
        up_delay_ms=args.up_delay_ms, fc=args.fc, slope=args.slope,
        c1_low=args.c1_low, c1_high=args.c1_high, c2_low=args.c2_low,
        c2_high=args.c2_high, n_fft=args.n_fft, hop=args.hop,
        output_gain_db=args.output_gain_db,
        require_48k_stereo=not args.allow_any_rate)
    os.makedirs(args.outdir, exist_ok=True)
    jobs = []
    csvs = []
    for ip in args.inputs:
        stem, ext = os.path.splitext(os.path.basename(ip))
        jobs.append((ip, os.path.join(args.outdir,
                                      f"{stem}{args.suffix}{ext or '.flac'}")))
        csvs.append(os.path.join(args.state_csv_dir, f"{stem}.csv")
                    if args.state_csv_dir else None)
    if args.state_csv_dir:
        os.makedirs(args.state_csv_dir, exist_ok=True)
    t0 = time.perf_counter()
    stats = process_batch(jobs, p, frames_per_chunk=args.frames_per_chunk,
                          state_csv_paths=csvs,
                          devices=args.devices or None, device=args.device)
    dt = time.perf_counter() - t0
    ok = [s for s in stats if s["failed"] is None]
    failed = [s for s in stats if s["failed"] is not None]
    audio_sec = sum(s["n_frames"] * args.hop / s["sr"]
                    for s in ok if s.get("sr"))
    for s in stats:
        if s["failed"] is None:
            print(f"[OK]   {s['in_path']} -> {s['out_path']} "
                  f"(C2 {s['c2_ratio'] * 100:.1f}%)")
        else:
            print(f"[FAIL] {s['in_path']}: {s['failed']}")
    print(f"{len(ok)}/{len(stats)} files, ~{audio_sec:.0f}s audio in "
          f"{dt:.1f}s -> {audio_sec / dt:.1f}x realtime aggregate")
    return 0 if not failed else 1


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
