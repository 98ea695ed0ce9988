"""CLI: device parameter reverse-engineering on the PyTorch port (parity
with ref src/reverse_engineer_params.py CLI).

    python -m tomatis_tpu_torch.cli.main reverse-engineer -i in.flac -o dev.flac

Takes the reference flags (tomatis_tpu/cli/reverse.py) and --device, the
torch device of the per-frame tilt pass (default cuda)."""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch reverse-engineer",
        description="Reverse-engineer device gate/tilt parameters from an "
                    "input/output recording pair")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True,
                    help="device output recording")
    ap.add_argument("--csv", default=None, help="per-frame CSV dump")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.analysis.reverse import analyze_device_params
        res = analyze_device_params(args.input, args.output, args.csv,
                                    sr=args.sr, n_fft=args.n_fft,
                                    hop=args.hop, device=args.device)
        print(f"delay: {res['delay_samples']} samples; "
              f"frames: {res['n_frames']}")
        print("\ntilt by input level:")
        print(f"{'level range':<16}{'mean tilt':>10}{'std':>8}"
              f"{'frames':>8}  state")
        for row in res["level_table"]:
            print(f"{row['lo']:>4}~{row['hi']:<4} dBFS  "
                  f"{row['mean_tilt']:>+8.1f}{row['std_tilt']:>8.1f}"
                  f"{row['n']:>8}   {row['state']}")
        t = res["gate_threshold"]
        if t:
            print(f"\nC1 frames (tilt<-5): {t['c1_frames']}  "
                  f"C2 frames (tilt>+5): {t['c2_frames']}")
            print(f"C1 max level: {t['c1_max_level']:.1f} dBFS  "
                  f"C2 min level: {t['c2_min_level']:.1f} dBFS")
            print(f"estimated gate threshold: {t['estimate']:.1f} dBFS")
        else:
            print("\nno clear C1/C2 separation detected")
        print("\ntilt histogram:")
        for h in res["histogram"]:
            bar = "#" * int(h["pct"] / 2)
            print(f"  {h['lo']:>+3}~{h['hi']:>+3} dB: {h['count']:>5} "
                  f"({h['pct']:>5.1f}%) {bar}")
        if args.csv:
            print(f"\nwrote {args.csv}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
