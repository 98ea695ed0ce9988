r"""CLI: Layer-2 EQ analyzer on the PyTorch port (parity with
ref src/layer2_analyze_eq.py CLI; the reference flags and --device).

    python -m tomatis_tpu_torch.cli.main analyze-eq --base ref.flac \
        --target cand.flac
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch analyze-eq",
        description="Derive the static EQ curve (base - target) from median "
                    "log-power spectra",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--base", required=True, help="reference recording")
    ap.add_argument("--target", required=True, help="audio to be matched")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--max_minutes", type=float, default=6.0)
    ap.add_argument("--n_fft", type=int, default=8192)
    ap.add_argument("--hop", type=int, default=4096)
    ap.add_argument("--music_dbfs", type=float, default=-65.0)
    ap.add_argument("--anchor_lo", type=float, default=300.0)
    ap.add_argument("--anchor_hi", type=float, default=3000.0)
    ap.add_argument("--clamp_db", type=float, default=12.0)
    ap.add_argument("--smooth_bins", type=int, default=71)
    ap.add_argument("--out_csv", default="layer2_eq_curve.csv")
    ap.add_argument("--out_png", default="layer2_eq_curve.png")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.analysis.analyze_eq import analyze_eq
        res = analyze_eq(args.base, args.target, sr=args.sr,
                         max_minutes=args.max_minutes, n_fft=args.n_fft,
                         hop=args.hop, music_dbfs=args.music_dbfs,
                         anchor_lo=args.anchor_lo, anchor_hi=args.anchor_hi,
                         clamp_db=args.clamp_db,
                         smooth_bins=args.smooth_bins,
                         out_csv=args.out_csv, out_png=args.out_png,
                         device=args.device)
        print(f"[ALIGN] delay (target - base): {res['delay_samples']} samples")
        print(f"[STATS] music frames base/target: "
              f"{res['used_frames_base']}/{res['used_frames_target']}")
        print(f"[INFO] anchor = {res['anchor_db']:+.2f} dB (removed)")
        print(f"[SAVED] {args.out_csv}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
