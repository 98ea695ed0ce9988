"""CLIs: calibrators v1/v2 on the PyTorch port (parity with
ref src/calibrate_to_baseline.py:124-137 and
src/calibrate_to_baseline_v2.py:130-158; the reference flags and
--device)."""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_v1_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch calibrate",
        description="Fit gate params to a device recording (v1)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--orig", required=True)
    ap.add_argument("--base", required=True)
    ap.add_argument("--gate_ui", type=float, default=50.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--search_T_min", type=float, default=-40.0)
    ap.add_argument("--search_T_max", type=float, default=-10.0)
    ap.add_argument("--search_T_step", type=float, default=0.5)
    ap.add_argument("--hyst_list", type=float, nargs="+",
                    default=[0, 1, 2, 3, 4, 6, 8])
    ap.add_argument("--delay_list_ms", type=float, nargs="+",
                    default=[0, 50, 100, 150, 200, 250, 300])
    ap.add_argument("--max_minutes", type=float, default=8.0)
    ap.add_argument("--out_json", default="calibration.json")
    add_device_flag(ap)
    return ap


def v1_main(argv=None) -> int:
    args = build_v1_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.analysis.calibrate import calibrate_v1
        res = calibrate_v1(
            args.orig, args.base, gate_ui=args.gate_ui, n_fft=args.n_fft,
            hop=args.hop, sr=args.sr,
            search_t=(args.search_T_min, args.search_T_max,
                      args.search_T_step),
            hyst_list=args.hyst_list, delay_list_ms=args.delay_list_ms,
            max_minutes=args.max_minutes, out_json=args.out_json,
            device=args.device)
        b = res["best"]
        print(f"[ALIGN] delay (orig - base): {res['delay_samples']} samples")
        print(f"[BEST] T={b['T']:.2f} hyst={b['hyst']:.1f} "
              f"up={b['up_ms']:.0f}ms mismatch={b['mismatch'] * 100:.2f}% "
              f"switches={b['switches']}")
        print(f"[RECOMMEND] gate_ui={res['gate_ui']:.1f}, gate_scale=1.0, "
              f"gate_offset={res['gate_offset']:.2f}")
        print(f"[RECOMMEND] hyst_db={res['hyst_db']:.1f}, "
              f"up_delay_ms={res['up_delay_ms']:.0f}")
        print(f"[SAVED] {args.out_json}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


def build_v2_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch calibrate-v2",
        description="Fit gate params + gain to a device recording (v2)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--orig", required=True)
    ap.add_argument("--base", required=True)
    ap.add_argument("--gate_ui", type=float, default=50.0)
    ap.add_argument("--gate_scale", type=float, default=1.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--max_minutes", type=float, default=6.0)
    ap.add_argument("--hyst_list", type=float, nargs="+",
                    default=[0, 1, 2, 3, 4, 6])
    ap.add_argument("--delay_list_ms", type=float, nargs="+",
                    default=[0, 50, 100, 150, 200, 250])
    ap.add_argument("--tilt_lo", type=int, nargs=2, default=[200, 1000])
    ap.add_argument("--tilt_hi", type=int, nargs=2, default=[2000, 8000])
    ap.add_argument("--tilt_medfilt", type=int, default=5)
    ap.add_argument("--music_dbfs", type=float, default=-65.0)
    ap.add_argument("--gain_search_pm_db", type=float, default=3.0)
    ap.add_argument("--gain_step_db", type=float, default=0.5)
    ap.add_argument("--T_pm_db", type=float, default=10.0)
    ap.add_argument("--T_step_db", type=float, default=0.25)
    ap.add_argument("--out_json", default="calibration_v2.json")
    add_device_flag(ap)
    return ap


def v2_main(argv=None) -> int:
    args = build_v2_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.analysis.calibrate import calibrate_v2
        res = calibrate_v2(
            args.orig, args.base, gate_ui=args.gate_ui,
            gate_scale=args.gate_scale, n_fft=args.n_fft, hop=args.hop,
            sr=args.sr, max_minutes=args.max_minutes,
            hyst_list=args.hyst_list, delay_list_ms=args.delay_list_ms,
            tilt_lo=args.tilt_lo, tilt_hi=args.tilt_hi,
            tilt_medfilt=args.tilt_medfilt, music_dbfs=args.music_dbfs,
            gain_search_pm_db=args.gain_search_pm_db,
            gain_step_db=args.gain_step_db, t_pm_db=args.T_pm_db,
            t_step_db=args.T_step_db, out_json=args.out_json,
            device=args.device)
        print(f"[ALIGN] delay: {res['delay_samples_orig_minus_base']} samples")
        print(f"[GAIN] gain_db (base - orig): "
              f"{res['gain_db_base_minus_orig']:+.2f} dB")
        print(f"[RECOMMEND] T_raw={res['T_raw_dbfs']:.2f} dBFS  "
              f"gate_offset={res['gate_offset']:.2f}")
        print(f"[RECOMMEND] hyst_db={res['hyst_db']:.1f}, "
              f"up_delay_ms={res['up_delay_ms']:.0f}")
        print(f"[RECOMMEND] mismatch={res['mismatch'] * 100:.2f}%, "
              f"switches={res['switches']} (music frames)")
        print(f"[SAVED] {args.out_json}")
        return 0
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


main = v1_main

if __name__ == "__main__":
    sys.exit(v1_main())
