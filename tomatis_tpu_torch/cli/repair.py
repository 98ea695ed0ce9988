"""CLIs: declick (ref src/declick_inpaint.py CLI) and cut (head trimmer,
ref src/cut_tomatis_d.py) on the PyTorch port. Host numpy: no --device."""
from __future__ import annotations

import argparse
import sys


def build_declick_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch declick",
        description="Detect and inpaint clicks/pops",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--k", type=float, default=12.0,
                    help="threshold factor (higher = more conservative)")
    ap.add_argument("--pad_ms", type=float, default=1.5,
                    help="expand each hit by this window (ms)")
    ap.add_argument("--merge_gap_ms", type=float, default=0.5,
                    help="merge nearby hits (ms)")
    ap.add_argument("--max_fix_ms", type=float, default=8.0,
                    help="skip segments longer than this (ms)")
    ap.add_argument("--report_csv", default=None,
                    help="optional segment list CSV")
    return ap


def declick_main(argv=None) -> int:
    args = build_declick_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.models.repair import declick
        stats = declick(args.input, args.output, k=args.k,
                        pad_ms=args.pad_ms, merge_gap_ms=args.merge_gap_ms,
                        max_fix_ms=args.max_fix_ms,
                        report_csv=args.report_csv)
        print(f"[DETECT] sigma={stats['sigma']:.6g} "
              f"thr={stats['threshold']:.6g} hits={stats['hits']}")
        if "kept_segments" in stats:
            print(f"[SEGS] raw={stats['raw_segments']} "
                  f"kept={stats['kept_segments']}")
        print(f"[SAVE] {stats['out_path']}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


def build_cut_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch cut",
        description="Trim the first N seconds off a recording",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("cut_seconds", nargs="?", type=float, default=16.0)
    return ap


def cut_main(argv=None) -> int:
    args = build_cut_parser().parse_args(argv)
    out = args.output
    if out is None:
        import os
        root, ext = os.path.splitext(str(args.input))
        secs = args.cut_seconds
        tag = f"{secs:g}".replace(".", "p")
        out = f"{root}_cut{tag}s{ext or '.flac'}"
    try:
        from tomatis_tpu_torch.models.repair import cut_head
        stats = cut_head(args.input, out, args.cut_seconds)
        print(f"cut {args.cut_seconds}s ({stats['cut_samples']} samples); "
              f"output {stats['n_out']} samples -> {stats['out_path']}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


main = declick_main

if __name__ == "__main__":
    sys.exit(declick_main())
