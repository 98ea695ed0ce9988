"""CLI: pairwise comparator on the PyTorch port (parity with
ref src/compare_audio.py; the reference flags and --device).

    python -m tomatis_tpu_torch.cli.main compare base.flac cand.flac
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch compare",
        description="Align + level-anchor two recordings, report band "
                    "deltas and residual SNR, write diff_spectrum.csv")
    ap.add_argument("base", help="base audio file")
    ap.add_argument("cand", help="candidate audio file")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--out_csv", default="diff_spectrum.csv")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.analysis.compare import compare_audio
        res = compare_audio(args.base, args.cand, sr=args.sr,
                            n_fft=args.n_fft, hop=args.hop,
                            out_csv=args.out_csv, device=args.device)
        d = res["delay_samples"]
        print(f"[ALIGN] delay_samples (cand - base) = {d} "
              f"({d / args.sr * 1000:.2f} ms)")
        print(f"[LEVEL] anchor gain on cand = {res['anchor_gain_db']:.2f} dB")
        for band, st in res["bands"].items():
            print(f"[BAND {band}Hz] mean dDB (base-cand) = "
                  f"{st['mean']:.2f} dB, std={st['std']:.2f}")
        print(f"[RESIDUAL] SNR (base vs residual) = {res['snr_db']:.2f} dB")
        print(f"[OUT] wrote {args.out_csv}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
