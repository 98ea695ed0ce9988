"""CLI: tilt amplitude verifier (parity with ref src/verify_tilt_amplitude.py
— parameterized instead of the reference's hard-coded file names).

PyTorch port of tomatis_tpu/cli/verify_tilt.py: the reference flags,
defaults, exit codes and console layout, plus --device (default cuda).
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch verify-tilt",
        description="Measure realized tilt amplitude by input-level grouping",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--c1_below", type=float, default=-45.0)
    ap.add_argument("--c2_above", type=float, default=-30.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.verify.tilt_amplitude import (
            TEST_FREQS, analyze_tilt_amplitude)
        res = analyze_tilt_amplitude(args.input, args.output, sr=args.sr,
                                     n_fft=args.n_fft, hop=args.hop,
                                     c1_below=args.c1_below,
                                     c2_above=args.c2_above,
                                     device=args.device)
        print(f"Delay: {res['delay_samples']} samples")
        print(f"C1 frames (level < {args.c1_below} dBFS): {res['n_c1']}")
        print(f"C2 frames (level > {args.c2_above} dBFS): {res['n_c2']}")
        if "c1_tilt" in res:
            for name in ("c1", "c2"):
                print(f"{name.upper()} gains:")
                for f in TEST_FREQS:
                    print(f"  {f:5d} Hz: {res[f'{name}_gains'][f]:+.1f} dB")
            print(f"C1 tilt (4kHz - 250Hz): {res['c1_tilt']:+.1f} dB "
                  f"(theory -30)")
            print(f"C2 tilt (4kHz - 250Hz): {res['c2_tilt']:+.1f} dB "
                  f"(theory +30)")
        else:
            print("not enough frames in one of the groups")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
