"""CLI: Layer-1 validator (parity with ref src/validate_layer1.py:405-436;
defaults are the reference's production-calibrated values).

PyTorch port of tomatis_tpu/cli/validate.py: the reference flags,
defaults, exit codes and console layout, plus --device (default cuda).
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch validate",
        description="Layer-1 validation: gate recomputation + filter shape "
                    "+ engineering checks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True, help="original input")
    ap.add_argument("-o", "--output", required=True, help="processed output")
    ap.add_argument("--state_csv", required=True)
    ap.add_argument("--gate_ui", type=float, default=50)
    ap.add_argument("--gate_scale", type=float, default=1.0)
    ap.add_argument("--gate_offset", type=float, default=-61.08)
    ap.add_argument("--hyst_db", type=float, default=1.0)
    ap.add_argument("--up_delay_ms", type=float, default=0)
    ap.add_argument("--fc", type=float, default=1000)
    ap.add_argument("--slope", type=float, default=12)
    ap.add_argument("--c1_low", type=float, default=5.0)
    ap.add_argument("--c1_high", type=float, default=-5.0)
    ap.add_argument("--c2_low", type=float, default=-5.0)
    ap.add_argument("--c2_high", type=float, default=5.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--out_csv", default="layer1_spectrum_check.csv")
    ap.add_argument("--out_png", default="layer1_spectrum_check.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    from tomatis_tpu_torch.cli._sidecar import add_params_flag
    add_params_flag(ap)
    return ap


def run(args) -> int:
    """Sectioned bilingual console audit — same layout and field lines as
    the reference (ref src/validate_layer1.py:437-455, 460-469, 483-507,
    518-540, 548-590, 655-678)."""
    from tomatis_tpu_torch.verify.validate_layer1 import BANDS, validate

    print("=" * 60)
    print("Layer1 验证工具")
    print("=" * 60)
    print()
    print('验证目标: 算法实现是否符合参数设定')
    print('  - 门控逻辑: RMS dBFS + 回差 + 延迟')
    print('  - 滤波形状: fc/slope/gain')
    print('  - 工程完整性: 长度、削波')
    print('注意: 本工具不验证"与硬件一模一样"')
    print()
    threshold_dbfs = args.gate_scale * args.gate_ui + args.gate_offset
    print("参数:")
    print(f"  Gate: UI={args.gate_ui}, T={threshold_dbfs:.2f} dBFS, "
          f"hyst={args.hyst_db} dB, delay={args.up_delay_ms} ms")
    print(f"  Filter: fc={args.fc} Hz, slope={args.slope} dB/oct")
    print(f"  C1: low={args.c1_low} dB, high={args.c1_high} dB")
    print(f"  C2: low={args.c2_low} dB, high={args.c2_high} dB")
    print()

    res = validate(args.input, args.output, args.state_csv,
                   gate_ui=args.gate_ui, gate_scale=args.gate_scale,
                   gate_offset=args.gate_offset, hyst_db=args.hyst_db,
                   up_delay_ms=args.up_delay_ms, fc=args.fc,
                   slope=args.slope, c1_low=args.c1_low,
                   c1_high=args.c1_high, c2_low=args.c2_low,
                   c2_high=args.c2_high, n_fft=args.n_fft, hop=args.hop,
                   out_csv=args.out_csv, out_png=args.out_png,
                   device=args.device)

    def ok(b):
        return "PASS" if b else "FAIL"

    eng = res["checks"]["engineering"]
    print("-" * 40)
    print("A. 工程检查")
    print("-" * 40)
    print(f"  采样率: {eng['sr_in']} -> {eng['sr_out']} "
          f"{ok(eng['sr_match'])}")
    print(f"  声道数: {eng['ch_in']} -> {eng['ch_out']} "
          f"{ok(eng['ch_match'])}")
    print(f"  样点数: {eng['frames_in']} -> {eng['frames_out']} "
          f"(diff={eng['frames_diff']}) {ok(eng['frames_match'])}")
    print(f"  峰值: {eng['peak']:.4f} "
          f"{'PASS' if eng['peak_safe'] else 'FAIL (>=0.98)'}")

    g = res["checks"]["gate"]
    print()
    print("-" * 40)
    print("B. Gate 独立复算")
    print("-" * 40)
    print(f"  总帧数: {g['total_frames']}")
    print(f"  状态不匹配: {g['mismatch_count']} "
          f"({g['mismatch_rate'] * 100:.2f}%)")
    print(f"  切换次数: CSV={g['csv_switches']}, SIM={g['sim_switches']}, "
          f"diff={abs(g['csv_switches'] - g['sim_switches'])}")
    print(f"  电平最大差: {g['level_max_diff']:.4f} dB")
    print(f"  电平平均差: {g['level_mean_diff']:.4f} dB")
    print(f"  结果: "
          f"{'PASS' if g['pass'] else 'FAIL (mismatch>1% or level_diff>0.1dB)'}")

    s = res["checks"]["gate_stats"]
    print()
    print("-" * 40)
    print("C. Gate 统计")
    print("-" * 40)
    print(f"  C2 占比: {s['c2_ratio'] * 100:.1f}%")
    print(f"  切换次数: {s['switch_count']}")
    print(f"  Run length: min={s.get('run_min', 0)}, "
          f"max={s.get('run_max', 0)}, median={s.get('run_median', 0):.0f}")
    print(f"  短段(<=3帧): {s.get('short_runs', 0)} "
          f"({s['short_run_ratio'] * 100:.1f}%)")
    print(f"  C2占比范围: {'PASS' if s['c2_ratio_ok'] else 'WARN (极端值)'}")
    print(f"  抖动检测: {'PASS' if s['jitter_ok'] else 'WARN (短段过多)'}")

    sp = res["checks"]["spectrum"]
    print()
    print("-" * 40)
    print("D. 条件频谱验证")
    print("-" * 40)
    print(f"  稳定帧: C1={sp['c1_frames']}, C2={sp['c2_frames']}")
    print("  C1 RMSE:")
    for (name, lo, hi), r in zip(BANDS, sp["c1_rmse"]):
        print(f"    {name} ({lo}-{hi}Hz): {r:.2f} dB")
    print("  C2 RMSE:")
    for (name, lo, hi), r in zip(BANDS, sp["c2_rmse"]):
        print(f"    {name} ({lo}-{hi}Hz): {r:.2f} dB")
    print(f"  结果: {'PASS' if sp['pass'] else 'FAIL (RMSE >= 1.5 dB)'}")
    print(f"\n频谱数据已保存: {args.out_csv}")

    print()
    print("=" * 60)
    print("最终判定")
    print("=" * 60)
    eng_pass = (eng["sr_match"] and eng["ch_match"]
                and eng["frames_match"] and eng["peak_safe"])
    for name, passed in [("工程检查", eng_pass),
                         ("Gate复算", g["pass"]),
                         ("条件频谱", sp["pass"])]:
        print(f"  {name}: {ok(passed)}")
    print()
    if res["pass"]:
        print("Layer1 验证: PASS")
        print("算法实现符合参数设定")
    else:
        print("Layer1 验证: FAIL")
        print("请检查上述 FAIL 项")
    return 0 if res["pass"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from tomatis_tpu_torch.cli._sidecar import apply_params
        apply_params(args, build_parser, argv)
        return run(args)
    except Exception as e:
        import traceback
        print(f"[ERR] {e}")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
