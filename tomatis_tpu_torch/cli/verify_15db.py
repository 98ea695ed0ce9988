"""CLI: ±15 dB verifier (parity with ref src/verify_tomatis_15db.py CLI;
defaults from calibration_v2).

PyTorch port of tomatis_tpu/cli/verify_15db.py: the reference flags,
defaults, exit codes and console layout, plus --device (default cuda).
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch verify-15db",
        description="Full +-15 dB verification: engineering, gate stats, "
                    "conditional spectrum, tilt-index effect",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--gate_ui", type=float, default=50)
    ap.add_argument("--gate_scale", type=float, default=1.0)
    ap.add_argument("--gate_offset", type=float, default=-61.08)
    ap.add_argument("--hyst_db", type=float, default=1.0)
    ap.add_argument("--up_delay_ms", type=float, default=0)
    ap.add_argument("--fc", type=float, default=1000)
    ap.add_argument("--slope", type=float, default=12)
    ap.add_argument("--c1_low", type=float, default=15.0)
    ap.add_argument("--c1_high", type=float, default=-15.0)
    ap.add_argument("--c2_low", type=float, default=-15.0)
    ap.add_argument("--c2_high", type=float, default=15.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--out_prefix", default="verify_15db")
    add_device_flag(ap)
    from tomatis_tpu_torch.cli._sidecar import add_params_flag
    add_params_flag(ap)
    return ap


def run(args) -> int:
    """Sectioned console audit — same layout and field lines as the
    reference (ref src/verify_tomatis_15db.py:496-511, 521-545, 569-583,
    612-634, 668-678, 775-794)."""
    from tomatis_tpu_torch.verify.verify_15db import verify

    gain_limit = abs(args.c1_low)
    threshold = args.gate_scale * args.gate_ui + args.gate_offset
    print("=" * 70)
    print("Tomatis ±15dB 完整验证工具")
    print("=" * 70)
    print()
    print("参数配置:")
    print(f"  Gate: UI={args.gate_ui}, T={threshold:.2f} dBFS, "
          f"hyst={args.hyst_db} dB")
    print(f"  Filter: fc={args.fc} Hz, slope={args.slope} dB/oct")
    print(f"  C1: low=+{args.c1_low} dB, high={args.c1_high} dB")
    print(f"  C2: low={args.c2_low} dB, high=+{args.c2_high} dB")
    print(f"  期望平台: 低频封顶 "
          f"~{args.fc * 2 ** (-gain_limit / args.slope):.0f} Hz, "
          f"高频封顶 ~{args.fc * 2 ** (gain_limit / args.slope):.0f} Hz")
    print()

    res = verify(args.input, args.output, gate_ui=args.gate_ui,
                 gate_scale=args.gate_scale, gate_offset=args.gate_offset,
                 hyst_db=args.hyst_db, up_delay_ms=args.up_delay_ms,
                 fc=args.fc, slope=args.slope, c1_low=args.c1_low,
                 c1_high=args.c1_high, c2_low=args.c2_low,
                 c2_high=args.c2_high, n_fft=args.n_fft, hop=args.hop,
                 out_prefix=args.out_prefix, device=args.device)

    def ok(b):
        return "PASS" if b else "FAIL"

    eng = res["checks"]["engineering"]
    print("-" * 50)
    print("A. 工程检查")
    print("-" * 50)
    print(f"  采样率: {eng['sr_in']} -> {eng['sr_out']} "
          f"{ok(eng['sr_match'])}")
    print(f"  声道数: {eng['ch_in']} -> {eng['ch_out']} "
          f"{ok(eng['ch_match'])}")
    print(f"  样点数: {eng['frames_in']} -> {eng['frames_out']} "
          f"(diff={eng['frames_diff']}) {ok(eng['frames_match'])}")
    print(f"  峰值: {eng['peak']:.4f} ({eng['peak_dbfs']:.2f} dBFS) "
          f"{'PASS' if eng['peak_safe'] else 'FAIL (>=0.98)'}")
    print(f"  DC偏移: {eng['dc_mean']:.6f} "
          f"{'PASS' if eng['dc_safe'] else 'FAIL (>0.001)'}")
    print(f"  工程检查结果: {ok(eng['pass'])}")

    st = res["checks"]["gate_stats"]
    print()
    print("-" * 50)
    print("B. Gate 统计分析")
    print("-" * 50)
    print(f"  总帧数: {st.get('total_frames', 0)}")
    print(f"  时长: {st.get('duration_min', 0):.2f} 分钟")
    print(f"  C2 占比: {st.get('c2_ratio', 0) * 100:.1f}%")
    print(f"  切换次数: {st.get('switch_count', 0)} "
          f"({st.get('switches_per_min', 0):.1f}/min)")
    print(f"  Run length: min={st.get('run_min', 0)}, "
          f"max={st.get('run_max', 0)}, "
          f"median={st.get('run_median', 0):.0f}")
    print(f"  短段(<=3帧): {st.get('short_runs', 0)} "
          f"({st.get('short_run_ratio', 0) * 100:.1f}%)")
    print(f"  C1平均电平: {st.get('c1_level_mean', 0):.2f} dBFS")
    print(f"  C2平均电平: {st.get('c2_level_mean', 0):.2f} dBFS")
    print(f"  C2占比范围(5%-95%): "
          f"{'PASS' if st['c2_ratio_ok'] else 'WARN'}")
    print(f"  抖动检测(<30%短段): {'PASS' if st['jitter_ok'] else 'WARN'}")

    sp = res["checks"]["spectrum"]
    print()
    print("-" * 50)
    print("C. 条件频谱验证")
    print("-" * 50)
    print(f"  稳定帧: C1={sp.get('c1_frames', 0)}, "
          f"C2={sp.get('c2_frames', 0)}")
    print(f"  C1 RMSE (100-8000Hz): {sp.get('c1_rmse', 0):.2f} dB")
    print(f"  C2 RMSE (100-8000Hz): {sp.get('c2_rmse', 0):.2f} dB")
    print(f"  C1 fc误差 (1000Hz): {sp.get('c1_fc_error', 0):.2f} dB")
    print(f"  C2 fc误差 (1000Hz): {sp.get('c2_fc_error', 0):.2f} dB")
    print(f"  C1 低频平台: {sp.get('c1_low_platform', 0):.1f} dB "
          f"(目标 +{gain_limit})")
    print(f"  C2 低频平台: {sp.get('c2_low_platform', 0):.1f} dB "
          f"(目标 -{gain_limit})")
    print(f"  C1 高频平台: {sp.get('c1_high_platform', 0):.1f} dB "
          f"(目标 -{gain_limit})")
    print(f"  C2 高频平台: {sp.get('c2_high_platform', 0):.1f} dB "
          f"(目标 +{gain_limit})")
    print(f"  RMSE验证(<1.5dB): {ok(sp['rmse_ok'])}")
    print(f"  fc过零验证(<0.5dB): {ok(sp['fc_ok'])}")
    print(f"  平台验证(<3dB误差): {ok(sp['platform_ok'])}")
    print(f"  条件频谱结果: {ok(sp['pass'])}")

    ti = res["checks"]["tilt_index"]
    print()
    print("-" * 50)
    print("D. 效果量化 (Tilt Index)")
    print("-" * 50)
    print(f"  输入 TI: mean={ti.get('input_mean', 0):.2f}, "
          f"std={ti.get('input_std', 0):.2f}")
    print(f"  输出 TI: mean={ti.get('output_mean', 0):.2f}, "
          f"std={ti.get('output_std', 0):.2f}")
    print(f"  C1 段 TI: mean={ti.get('c1_mean', 0):.2f}")
    print(f"  C2 段 TI: mean={ti.get('c2_mean', 0):.2f}")
    print(f"  Tomatis 效果强度 (C2-C1): {ti.get('ti_effect', 0):.2f} dB")
    print(f"  效果强度验证(>5dB): "
          f"{'PASS' if ti.get('effect_ok') else 'WARN'}")

    print()
    print("=" * 70)
    print("最终判定")
    print("=" * 70)
    print(f"  A. 工程检查: {ok(eng['pass'])}")
    print(f"  C. 条件频谱验证: {ok(sp['pass'])}")
    print(f"  B. Gate统计: C2占比={st.get('c2_ratio', 0) * 100:.0f}%, "
          f"抖动={st.get('short_run_ratio', 0) * 100:.0f}%")
    print(f"  D. 效果量化: TI差值={ti.get('ti_effect', 0):.1f}dB")
    print()
    if res["pass"]:
        print("验证结果: PASS")
    else:
        print("验证结果: FAIL")
        print("请检查上述 FAIL 项")
    print(f"\n综合报告已保存: {args.out_prefix}_report.txt")
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
