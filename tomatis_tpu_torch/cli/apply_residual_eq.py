r"""CLI: Layer-2b residual EQ appliers on the PyTorch port (parity with
ref src/layer2b_apply_residual_eq.py and _safe.py; --safe selects Safe-B;
the reference flags and --device).

    python -m tomatis_tpu_torch.cli.main apply-residual-eq --in_audio a.flac \
        --out_audio b.flac --diff_csv diff_spectrum.csv [--safe]
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch apply-residual-eq",
        description="Apply a clamped residual EQ from diff_spectrum.csv",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--in_audio", required=True)
    ap.add_argument("--out_audio", required=True)
    ap.add_argument("--diff_csv", default="diff_spectrum.csv")
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--safe", action="store_true",
                    help="Safe-B clamps: +-1 dB, 0 dB above 3 kHz "
                         "(recommended final stage)")
    ap.add_argument("--smooth_win", type=int, default=None,
                    help="log-f smoothing window (default 41; 61 with --safe)")
    ap.add_argument("--clamp_hi", type=float, default=None,
                    help="upper clamp dB (default 6.0; 1.0 with --safe)")
    ap.add_argument("--mid_start", type=float, default=3000.0)
    ap.add_argument("--mid_clamp_hi", type=float, default=2.0)
    ap.add_argument("--hf_start", type=float, default=None,
                    help="HF band start (default 8000; 3000 with --safe)")
    ap.add_argument("--hf_clamp_hi", type=float, default=0.0)
    ap.add_argument("--frames_per_chunk", type=int, default=1024)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash recovery / resume")
    add_device_flag(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.eq import apply_residual_eq
    # None smooth_win/clamp_hi/hf_start resolve PER MODE inside
    # apply_residual_eq (standard 41/+6dB/8kHz, Safe-B 61/+1dB/3kHz):
    # one home for the Safe-B clamp constants
    res = apply_residual_eq(
        args.in_audio, args.out_audio, args.diff_csv,
        n_fft=args.n_fft, hop=args.hop, smooth_win=args.smooth_win,
        clamp_hi=args.clamp_hi, mid_start=args.mid_start,
        mid_clamp_hi=args.mid_clamp_hi, hf_start=args.hf_start,
        hf_clamp_hi=args.hf_clamp_hi, safe=args.safe,
        frames_per_chunk=args.frames_per_chunk,
        checkpoint_path=args.checkpoint, device=args.device)
    tag = "SafeB " if args.safe else ""
    print(f"[DONE] Applied {tag}residual EQ to {res['out_path']} "
          f"({res['n_frames']} frames)")
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
