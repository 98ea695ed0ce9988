r"""CLI: Layer-2 static EQ applier on the PyTorch port (parity with
ref src/layer2_apply_eq.py; the reference flags of
tomatis_tpu/cli/apply_eq.py and --device).

    python -m tomatis_tpu_torch.cli.main apply-eq -i in.flac -o out.flac \
        --eq_csv eq.csv
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch apply-eq",
        description="Apply a static EQ curve (CSV) via streaming STFT",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--eq_csv", required=True)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--no_pad", action="store_true")
    ap.add_argument("--gain_db", type=float, default=0.0,
                    help="extra global gain (dB)")
    ap.add_argument("--no_gain_protect", action="store_true")
    ap.add_argument("--frames_per_chunk", type=int, default=1024)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash recovery / resume")
    ap.add_argument("--progress", action="store_true",
                    help="print per-chunk progress")
    add_device_flag(ap)
    return ap


def run(args) -> int:
    from tomatis_tpu_torch.models.eq import apply_eq
    prog = None
    if args.progress:
        def prog(done, total_frames):
            print(f"  processed {done}/{total_frames} frames "
                  f"({100 * done / max(1, total_frames):.0f}%)", flush=True)
    res = apply_eq(args.input, args.output, args.eq_csv,
                   n_fft=args.n_fft, hop=args.hop, pad=not args.no_pad,
                   global_gain_db=args.gain_db,
                   auto_gain_protect=not args.no_gain_protect,
                   frames_per_chunk=args.frames_per_chunk,
                   checkpoint_path=args.checkpoint, progress=prog,
                   device=args.device)
    print(f"frames: {res['n_frames']}  peak: {res['peak_seen']:.4f}")
    print(f"output: {res['out_path']}")
    if res.get("gain_protected_path"):
        print(f"[GAIN_PROTECT] peak > 0.99, "
              f"scale={res['gain_protect_scale']:.4f}"
              f" -> {res['gain_protected_path']}")
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
