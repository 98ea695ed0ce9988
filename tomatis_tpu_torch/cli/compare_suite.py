"""CLIs: multi-candidate baseline comparator, three-way comparator,
log-grid diff spectrum, diff plotter, on the PyTorch port (parity with the
reference scripts).

    python -m tomatis_tpu_torch.cli.main compare-baseline --baseline b.flac --candidates c.flac --outdir out/

Takes the reference flags (tomatis_tpu/cli/compare_suite.py); the three
comparators add --device, the torch device of their spectra (default
cuda). Plots need matplotlib: without it no PNG is written."""
from __future__ import annotations

import argparse
import sys

from tomatis_tpu_torch.cli._flags import add_device_flag


def _wrap(fn):
    def runner(argv=None) -> int:
        try:
            return fn(argv)
        except Exception as e:
            import traceback
            print(f"[ERR] {e}")
            traceback.print_exc()
            return 1
    return runner


@_wrap
def baseline_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch compare-baseline",
        description="Compare multiple candidates against a baseline "
                    "recording (summary, overlay, envelopes)")
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--candidates", required=True, nargs="+")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n_fft", type=int, default=4096)
    ap.add_argument("--hop", type=int, default=2048)
    ap.add_argument("--max_minutes", type=float, default=8.0)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.compare_suite import compare_to_baseline
    results = compare_to_baseline(args.baseline, args.candidates,
                                  args.outdir, sr=args.sr, n_fft=args.n_fft,
                                  hop=args.hop, max_minutes=args.max_minutes,
                                  device=args.device)
    for r in results:
        print(f"[{r['name']}] music_err={r['music_err']:.2f} dB  "
              f"noise_delta={r['noise_delta']:+.2f} dB  "
              f"snr={r['snr']:.2f} dB")
    print(f"outputs in: {args.outdir}")
    return 0


@_wrap
def three_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch compare-three",
        description="Welch-spectrum + envelope comparison of candidates")
    ap.add_argument("--base", required=True)
    ap.add_argument("--cand", required=True, nargs="+")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--ds_sr", type=int, default=2000)
    ap.add_argument("--plot_sec", type=float, default=500.0)
    ap.add_argument("--max_sec_spec", type=float, default=600.0)
    ap.add_argument("--n_fft", type=int, default=8192)
    ap.add_argument("--hop", type=int, default=4096)
    ap.add_argument("--smooth_win", type=int, default=31)
    ap.add_argument("--out_prefix", default="cmp")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.compare_suite import compare_three
    results = compare_three(args.base, args.cand, sr=args.sr,
                            ds_sr=args.ds_sr, plot_sec=args.plot_sec,
                            max_sec_spec=args.max_sec_spec,
                            n_fft=args.n_fft, hop=args.hop,
                            smooth_win=args.smooth_win,
                            out_prefix=args.out_prefix, device=args.device)
    for r in results:
        print(f"[{r['cand']}] delay={r['delay_ms']:.2f}ms  "
              f"bands: 200-1k {r['band_200_1k_db']:+.2f}  "
              f"1k-3k {r['band_1k_3k_db']:+.2f}  "
              f"3k-8k {r['band_3k_8k_db']:+.2f}  "
              f"8k-16k {r['band_8k_16k_db']:+.2f} dB")
    return 0


@_wrap
def diff_spectrum_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch compare-diff-spectrum",
        description="RMS-gated mean-power diff spectrum on a log-f grid")
    ap.add_argument("--base", required=True)
    ap.add_argument("--cand", required=True)
    ap.add_argument("--out_csv", default="diff_spectrum.csv")
    ap.add_argument("--out_png", default="diff_vs_baseline.png")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n_fft", type=int, default=8192)
    ap.add_argument("--hop", type=int, default=4096)
    ap.add_argument("--max_minutes", type=float, default=10.0)
    ap.add_argument("--rms_gate_dbfs", type=float, default=-80.0)
    ap.add_argument("--anchor_lo", type=float, default=300.0)
    ap.add_argument("--anchor_hi", type=float, default=3000.0)
    ap.add_argument("--clamp_lo", type=float, default=-12.0)
    ap.add_argument("--clamp_hi", type=float, default=12.0)
    ap.add_argument("--smooth_win", type=int, default=31)
    ap.add_argument("--log_grid_n", type=int, default=512)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.compare_suite import compare_diff_spectrum
    res = compare_diff_spectrum(
        args.base, args.cand, sr=args.sr, n_fft=args.n_fft, hop=args.hop,
        max_minutes=args.max_minutes, rms_gate_dbfs=args.rms_gate_dbfs,
        anchor=(args.anchor_lo, args.anchor_hi),
        clamp=(args.clamp_lo, args.clamp_hi), smooth_win=args.smooth_win,
        log_grid_n=args.log_grid_n, out_csv=args.out_csv,
        out_png=args.out_png, device=args.device)
    print(f"[ALIGN] delay = {res['delay_samples']} samples")
    print(f"[ANCHOR] {res['anchor_db']:.2f} dB removed")
    print(f"[SPECTRUM] used frames: base={res['used_frames'][0]}, "
          f"cand={res['used_frames'][1]}")
    print(f"[OUT] {args.out_csv} / {args.out_png}")
    return 0


@_wrap
def plot_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tomatis_tpu_torch plot-diff",
        description="Plot any diff-spectrum CSV (tolerant columns)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--out_png", default=None)
    ap.add_argument("--title", default="Diff Spectrum (base - candidate)")
    ap.add_argument("--smooth_win", type=int, default=31)
    ap.add_argument("--xlim", type=float, nargs=2, default=[20, 20000])
    args = ap.parse_args(argv)
    from tomatis_tpu_torch.analysis.compare_suite import plot_diff_spectrum
    res = plot_diff_spectrum(args.input, args.out_png, args.title,
                             args.smooth_win, tuple(args.xlim))
    for band, v in res["bands"].items():
        print(f"[BAND {band}Hz] {v:+.2f} dB")
    if res["out_png"]:
        print(f"[OUT] {res['out_png']}")
    return 0


main = baseline_main

if __name__ == "__main__":
    sys.exit(baseline_main())
