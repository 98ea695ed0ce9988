"""CLI: automated device matching on the PyTorch port: the whole
Workflow_v2 chain in one command (the reference runs six scripts by hand,
docs/Workflow_v2.md).

    python -m tomatis_tpu_torch.cli.main match --orig orig.flac \
        --device device.flac -o outdir/

`--device` is the DEVICE RECORDING, as in the reference command; the
torch device is chosen with `--torch_device` (cuda, cuda:N or cpu).
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch match",
        description="calibrate -> process -> layer2 EQ -> residual EQ, "
                    "producing audio matched to a device recording",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--orig", required=True, help="original audio")
    ap.add_argument("--device", required=True, help="device recording")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--gate_ui", type=float, default=50.0)
    ap.add_argument("--fc", type=float, default=1000.0)
    ap.add_argument("--slope", type=float, default=12.0)
    ap.add_argument("--c1_low", type=float, default=15.0)
    ap.add_argument("--c1_high", type=float, default=-15.0)
    ap.add_argument("--c2_low", type=float, default=-15.0)
    ap.add_argument("--c2_high", type=float, default=15.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--max_minutes", type=float, default=6.0)
    ap.add_argument("--no_safe_residual", action="store_true",
                    help="use the full-range residual clamps instead of "
                         "Safe-B")
    ap.add_argument("--allow_any_rate", action="store_true")
    add_device_flag(ap, "--torch_device",
                    help="torch device to run on (cuda, cuda:N or cpu); "
                         "--device is the device recording")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.models.workflow import match_device
        report = match_device(
            args.orig, args.device, args.outdir, gate_ui=args.gate_ui,
            c1_low=args.c1_low, c1_high=args.c1_high, c2_low=args.c2_low,
            c2_high=args.c2_high, fc=args.fc, slope=args.slope,
            n_fft=args.n_fft, hop=args.hop,
            safe_residual=not args.no_safe_residual,
            max_minutes=args.max_minutes,
            require_48k_stereo=not args.allow_any_rate,
            device=args.torch_device)
        print(f"matched audio: {report['matched_path']}")
        print(f"report: {args.outdir}/match_report.json")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
