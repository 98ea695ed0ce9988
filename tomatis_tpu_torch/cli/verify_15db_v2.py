"""CLI: ±15 dB verifier v2 (parity with ref src/verify_tomatis_15db_v2.py).

PyTorch port of tomatis_tpu/cli/verify_15db_v2.py: the reference flags,
defaults, exit codes and console layout, plus --device (default cuda).
"""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch verify-15db-v2",
        description="Adaptive-mode +-15 dB verification: auto threshold, "
                    "anchored conditional spectrum, platform/slope RMSE",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--hyst_db", type=float, default=1.0)
    ap.add_argument("--up_delay_ms", type=float, default=0)
    ap.add_argument("--target_c2", type=float, default=0.5)
    ap.add_argument("--fc", type=float, default=1000)
    ap.add_argument("--slope", type=float, default=12)
    ap.add_argument("--c1_low", type=float, default=15.0)
    ap.add_argument("--c1_high", type=float, default=-15.0)
    ap.add_argument("--c2_low", type=float, default=-15.0)
    ap.add_argument("--c2_high", type=float, default=15.0)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--level_percentile", type=float, default=10)
    ap.add_argument("--out_prefix", default="verify_15db_v2")
    add_device_flag(ap)
    from tomatis_tpu_torch.cli._sidecar import add_params_flag
    add_params_flag(ap)
    return ap


def run(args) -> int:
    """Sectioned bilingual console audit — layout and field lines as the
    reference (ref src/verify_tomatis_15db_v2.py:539-541, 565-584,
    590-633, 636-686, 711-734, 818-835)."""
    from tomatis_tpu_torch.verify.verify_15db_v2 import verify_v2

    gain_limit = abs(args.c1_low)
    print("=" * 70)
    print("Tomatis ±15dB 自适应验证工具 v2")
    print("=" * 70)
    print()

    res = verify_v2(args.input, args.output, hyst_db=args.hyst_db,
                    up_delay_ms=args.up_delay_ms, target_c2=args.target_c2,
                    fc=args.fc, slope=args.slope, c1_low=args.c1_low,
                    c1_high=args.c1_high, c2_low=args.c2_low,
                    c2_high=args.c2_high, n_fft=args.n_fft, hop=args.hop,
                    level_percentile=args.level_percentile,
                    out_prefix=args.out_prefix,
                    device=args.device)

    def ok(b):
        return "PASS" if b else "FAIL"

    eng = res["checks"]["engineering"]
    print("-" * 50)
    print("A. 工程检查")
    print("-" * 50)
    print(f"  采样率: {eng['sr_in']} -> {eng['sr_out']} "
          f"{ok(eng['sr_match'])}")
    print(f"  样点数: {eng['frames_in']} -> {eng['frames_out']} "
          f"{ok(eng['frames_match'])}")
    print(f"  峰值: {eng['peak']:.4f} "
          f"{'PASS' if eng['peak_safe'] else 'FAIL (>=0.98)'}")
    print(f"  DC偏移: {eng['dc_mean']:.6f} "
          f"{'PASS' if eng['dc_safe'] else 'FAIL (>0.001)'}")
    print(f"  工程检查结果: {ok(eng['pass'])}")

    print()
    print("-" * 50)
    print("B. 自适应门控复算")
    print("-" * 50)
    print(f"  最优阈值 T: {res['auto_threshold_dbfs']:.2f} dBFS")
    print(f"  C2 占比: {res['achieved_c2_ratio'] * 100:.1f}% "
          f"(目标 {args.target_c2 * 100:.0f}%)")
    print(f"  切换次数: {res['switch_count']}")
    print(f"  C2 占比验证 (±2%): {ok(res['c2_ratio_ok'])}")

    sp = res["checks"]["spectrum"]
    print()
    print("-" * 50)
    print("C. 条件频谱验证 (v2: 弱帧剔除 + 每帧fc锚定)")
    print("-" * 50)
    print(f"  有效帧: C1={sp['c1_frames']}, C2={sp['c2_frames']}")
    print("  低频平台:")
    print(f"    C1: {sp.get('c1_lo_platform_mean', 0):.1f} dB "
          f"(目标 +{gain_limit}), "
          f"RMSE={sp.get('c1_lo_platform_rmse', 0):.2f}")
    print(f"    C2: {sp.get('c2_lo_platform_mean', 0):.1f} dB "
          f"(目标 -{gain_limit}), "
          f"RMSE={sp.get('c2_lo_platform_rmse', 0):.2f}")
    print("  高频平台:")
    print(f"    C1: {sp.get('c1_hi_platform_mean', 0):.1f} dB "
          f"(目标 -{gain_limit}), "
          f"RMSE={sp.get('c1_hi_platform_rmse', 0):.2f}")
    print(f"    C2: {sp.get('c2_hi_platform_mean', 0):.1f} dB "
          f"(目标 +{gain_limit}), "
          f"RMSE={sp.get('c2_hi_platform_rmse', 0):.2f}")
    print("  斜坡段 RMSE:")
    print(f"    C1: {sp.get('c1_slope_rmse', 0):.2f} dB, "
          f"C2: {sp.get('c2_slope_rmse', 0):.2f} dB")
    print("  fc (1000Hz) 误差:")
    print(f"    C1: {sp.get('c1_fc_error', 0):.2f} dB, "
          f"C2: {sp.get('c2_fc_error', 0):.2f} dB")
    print(f"  平台 RMSE (<0.5dB): {ok(sp['platform_rmse_ok'])}")
    print(f"  斜坡 RMSE (<1.0dB): {ok(sp['slope_rmse_ok'])}")
    print(f"  fc 误差 (<0.5dB): {ok(sp['fc_ok'])}")
    print(f"  条件频谱结果: {ok(sp['pass'])}")

    ti = res["checks"]["tilt_index"]
    print()
    print("-" * 50)
    print("D. 效果量化 (Tilt Index)")
    print("-" * 50)
    print(f"  C1 段 TI: mean={ti.get('c1_mean', 0):.2f}")
    print(f"  C2 段 TI: mean={ti.get('c2_mean', 0):.2f}")
    print(f"  分离度 (C2-C1): {ti.get('ti_effect', 0):.2f} dB")
    print(f"  效果强度验证(>5dB): "
          f"{'PASS' if ti.get('effect_ok') else 'WARN'}")

    print()
    print("=" * 70)
    print("最终判定")
    print("=" * 70)
    print(f"  A. 工程检查: {ok(eng['pass'])}")
    print(f"  B. 门控 C2 占比 "
          f"({res['achieved_c2_ratio'] * 100:.0f}%): "
          f"{ok(res['c2_ratio_ok'])}")
    print(f"  C. 条件频谱: {ok(sp['pass'])}")
    print(f"  D. TI 分离度 ({ti.get('ti_effect', 0):.0f}dB): "
          f"{'PASS' if ti.get('effect_ok') else 'WARN'}")
    print()
    if res["pass"]:
        print("验证结果: PASS")
    else:
        print("验证结果: FAIL")
        print("请检查上述 FAIL 项")
    if args.out_prefix:   # verify_v2 writes artifacts only when set
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
