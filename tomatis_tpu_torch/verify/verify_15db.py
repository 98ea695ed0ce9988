"""±15 dB verifier, PyTorch port of tomatis_tpu/verify/verify_15db.py
(capability parity with ref src/verify_tomatis_15db.py): A engineering
(+DC offset), B gate simulation + stats, C conditional spectrum with
platform/fc/RMSE metrics, D Tilt-Index effect analysis, report TXT +
PNGs, PASS/FAIL exit semantics.

Unlike the Layer-1 validator this tool needs no state CSV: it simulates
the gate itself from the input audio (ref :107-162,560-588). The Tilt
Index frames both signals on the device, a block of frames at a time;
its statistics (np.std is the population one) stay numpy on the host.

verify() times its stages with utils/trace.py spans as validate() does
(verify.verify15 around the call; verify.decode, verify.gate,
verify.spectrum, verify.tilt, verify.artifacts inside it, with
validate_layer1's children) into results["timings"], and counts
spectrum_frames and upload_bytes into results["counters"].
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import dsp, stft
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.verify import validate_layer1 as _l1
from tomatis_tpu_torch.verify.validate_layer1 import (analyze_gate_stats,
                                                      conditional_spectrum,
                                                      simulate_gate,
                                                      to_device,
                                                      write_spectrum_csv)


def check_engineering(in_path, out_path, y: np.ndarray | None = None) -> dict:
    """ref :66-100: the Layer-1 engineering checks plus DC offset and a
    dBFS peak reading. y: pre-decoded output audio."""
    if y is None:
        y, _ = audio.read(out_path)
    eng = _l1.check_engineering(in_path, out_path, y=y)
    dc = float(np.mean(y)) if y.size else 0.0
    eng.update(
        peak_dbfs=20 * np.log10(eng["peak"] + dsp.EPS),
        dc_mean=dc, dc_safe=abs(dc) < 0.001)
    return eng


def compute_spectrum_metrics(freqs, c1_db, c2_db, c1_theory, c2_theory,
                             fc, gain_limit) -> dict:
    """RMSE 100-8000, fc-band error, low/high platform means (ref :324-364)."""
    m = {}
    a = (freqs >= 100) & (freqs <= 8000)
    if np.any(a):
        m["c1_rmse"] = float(np.sqrt(np.mean((c1_db[a] - c1_theory[a]) ** 2)))
        m["c2_rmse"] = float(np.sqrt(np.mean((c2_db[a] - c2_theory[a]) ** 2)))
    f = (freqs >= 900) & (freqs <= 1100)
    if np.any(f):
        m["c1_fc_error"] = float(abs(np.mean(c1_db[f])))
        m["c2_fc_error"] = float(abs(np.mean(c2_db[f])))
    lo = (freqs >= 100) & (freqs <= 350)
    if np.any(lo):
        m["c1_low_platform"] = float(np.mean(c1_db[lo]))
        m["c2_low_platform"] = float(np.mean(c2_db[lo]))
        m["c1_low_platform_error"] = abs(m["c1_low_platform"] - gain_limit)
        m["c2_low_platform_error"] = abs(m["c2_low_platform"] + gain_limit)
    hi = (freqs >= 3000) & (freqs <= 8000)
    if np.any(hi):
        m["c1_high_platform"] = float(np.mean(c1_db[hi]))
        m["c2_high_platform"] = float(np.mean(c2_db[hi]))
        m["c1_high_platform_error"] = abs(m["c1_high_platform"] + gain_limit)
        m["c2_high_platform_error"] = abs(m["c2_high_platform"] - gain_limit)
    return m


def _frame_tilt_index(x: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                      sr: int, block: int = 4096,
                      counters: dict | None = None):
    """Per-frame Tilt Index and 200-1000 Hz energy of a device signal
    [S, C], frames at 0, hop, ...; `block` frames at a time."""
    dev = x.device
    win = to_device(stft.hann_symmetric(n_fft), dev, counters)
    freqs = to_device(stft.rfft_freqs(n_fft, sr), dev, counters)
    lo = (freqs >= 200) & (freqs <= 1000)
    hi = (freqs >= 2000) & (freqs <= 8000)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ti, e_lo = [], []
    for f0 in range(0, n_frames, block):
        nf = min(block, n_frames - f0)
        fr = stft.frame_signal(x[f0 * hop:], n_fft, hop, nf)   # [F, C, n_fft]
        P = torch.mean(torch.abs(torch.fft.rfft(fr * win)) ** 2, dim=1)
        el = torch.sum(torch.where(lo, P, zero), dim=-1)
        eh = torch.sum(torch.where(hi, P, zero), dim=-1)
        ti.append(10.0 * torch.log10(eh / el + dsp.EPS))
        e_lo.append(el)
    return torch.cat(ti).cpu().numpy(), torch.cat(e_lo).cpu().numpy()


def compute_tilt_index(x, y, sr, states, n_fft, hop, device="cuda",
                       counters: dict | None = None) -> dict:
    """Per-frame TI of input/output, split by state (ref :371-441).
    Frames with E_lo <= EPS are dropped, as in the reference."""
    dev = resolve_device(device)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    # align frame i with the gate framing's original-coord start
    # i*hop + off (off == 0 whenever hop divides n_fft//2)
    pad = n_fft // 2
    off = -(-pad // hop) * hop - pad
    n_frames = min(len(states), (len(x) - off - n_fft) // hop + 1)
    if n_frames <= 0:
        z = np.zeros(0)
        return dict(input=z, output=z, c1=z, c2=z)

    def upload(a):
        return to_device(np.asarray(a, np.float32), dev, counters)

    ti_x, elo_x = _frame_tilt_index(upload(x[off:]), n_fft, hop, n_frames, sr,
                                    counters=counters)
    ti_y, elo_y = _frame_tilt_index(upload(y[off:len(x)]), n_fft, hop,
                                    n_frames, sr, counters=counters)
    st = np.asarray(states[:n_frames])
    ok_x = elo_x > dsp.EPS
    ok_y = elo_y > dsp.EPS
    return dict(input=ti_x[ok_x], output=ti_y[ok_y],
                c1=ti_y[ok_y & (st == "C1")], c2=ti_y[ok_y & (st == "C2")])


def analyze_tilt_index(ti: dict) -> dict:
    """Distribution stats + effect = C2 - C1 mean (ref :443-464)."""
    out = {}
    for key in ("input", "output", "c1", "c2"):
        arr = ti[key]
        if len(arr):
            out[f"{key}_mean"] = float(np.mean(arr))
            out[f"{key}_std"] = float(np.std(arr))
            out[f"{key}_median"] = float(np.median(arr))
            out[f"{key}_min"] = float(np.min(arr))
            out[f"{key}_max"] = float(np.max(arr))
    if "c1_mean" in out and "c2_mean" in out:
        out["ti_effect"] = out["c2_mean"] - out["c1_mean"]
    return out


def verify(in_path, out_path, gate_ui=50.0, gate_scale=1.0,
           gate_offset=-61.08, hyst_db=1.0, up_delay_ms=0.0,
           fc=1000.0, slope=12.0, c1_low=15.0, c1_high=-15.0,
           c2_low=-15.0, c2_high=15.0, n_fft=4096, hop=2048,
           out_prefix="verify_15db", device="cuda") -> dict:
    """The A-D audit; results['timings'] holds the decode, the gate
    recomputation, the conditional spectrum, the Tilt Index and the
    artifacts (seconds, the sums of their spans), results['counters']
    spectrum_frames and upload_bytes."""
    dev = resolve_device(device)
    gain_limit = abs(c1_low)
    threshold = gate_scale * gate_ui + gate_offset
    results = {"pass": True, "checks": {}, "threshold_dbfs": threshold,
               "platform_freqs": dsp.tilt_platform_freqs(
                   fc, slope, c1_low, c1_high)}
    timings = {}
    counters = {"spectrum_frames": 0, "upload_bytes": 0}
    with trace.span("verify.verify15"):
        with trace.span("verify.decode", timings, "decode_s"):
            y, _ = audio.read(out_path)   # decoded once, reused by every check
            x, sr = audio.read(in_path)

        with trace.span("verify.gate", timings, "gate_s"):
            eng = check_engineering(in_path, out_path, y=y)
            eng_pass = (eng["sr_match"] and eng["ch_match"]
                        and eng["frames_match"] and eng["peak_safe"]
                        and eng["dc_safe"])
            results["checks"]["engineering"] = dict(eng,
                                                    **{"pass": eng_pass})
            if not eng_pass:
                results["pass"] = False

            states, levels = simulate_gate(x, sr, n_fft, hop, threshold,
                                           hyst_db, up_delay_ms, device=dev,
                                           counters=counters)
            stats = analyze_gate_stats(states)
            stats["c2_ratio_ok"] = 0.05 <= stats.get("c2_ratio", 0) <= 0.95
            stats["jitter_ok"] = stats.get("short_run_ratio", 0) < 0.30
            # console/report extras of the reference audit (ref :568-577)
            duration_min = len(x) / sr / 60.0
            stats["duration_min"] = duration_min
            stats["switches_per_min"] = (
                stats.get("switch_count", 0) / duration_min
                if duration_min > 0 else 0.0)
            st_arr = np.asarray(states)
            lv_arr = np.asarray(levels)
            for name in ("C1", "C2"):
                sel = lv_arr[st_arr == name] if len(lv_arr) else lv_arr
                stats[f"{name.lower()}_level_mean"] = (
                    float(np.mean(sel)) if len(sel) else 0.0)
            results["checks"]["gate_stats"] = stats  # WARN-only

        with trace.span("verify.spectrum", timings, "spectrum_s"):
            freqs, c1_db, c2_db, n1, n2 = conditional_spectrum(
                x, y, sr, states, n_fft, hop, device=dev, counters=counters)
            c1_theory = dsp.build_tilt_gain_db(freqs, fc, slope, c1_low,
                                               c1_high)
            c2_theory = dsp.build_tilt_gain_db(freqs, fc, slope, c2_low,
                                               c2_high)
            metrics = compute_spectrum_metrics(freqs, c1_db, c2_db,
                                               c1_theory, c2_theory, fc,
                                               gain_limit)
            rmse_ok = (metrics.get("c1_rmse", 99) < 1.5
                       and metrics.get("c2_rmse", 99) < 1.5)
            fc_ok = (metrics.get("c1_fc_error", 99) < 0.5
                     and metrics.get("c2_fc_error", 99) < 0.5)
            platform_ok = all(metrics.get(k, 99) < 3.0 for k in (
                "c1_low_platform_error", "c2_low_platform_error",
                "c1_high_platform_error", "c2_high_platform_error"))
            spectrum_pass = rmse_ok and fc_ok and platform_ok
            results["checks"]["spectrum"] = dict(
                metrics, c1_frames=n1, c2_frames=n2, rmse_ok=rmse_ok,
                fc_ok=fc_ok, platform_ok=platform_ok,
                **{"pass": spectrum_pass})
            if not spectrum_pass:
                results["pass"] = False

        with trace.span("verify.tilt", timings, "tilt_s"):
            ti = compute_tilt_index(x, y, sr, states, n_fft, hop, device=dev,
                                    counters=counters)
            ti_stats = analyze_tilt_index(ti)
            ti_stats["effect_ok"] = ti_stats.get("ti_effect", 0) > 5.0
            results["checks"]["tilt_index"] = ti_stats  # WARN-only

        with trace.span("verify.artifacts", timings, "artifacts_s"):
            if out_prefix:
                _write_report(f"{out_prefix}_report.txt", results)
                write_spectrum_csv(f"{out_prefix}_spectrum.csv", freqs,
                                   c1_db, c1_theory, c2_db, c2_theory)
                plot_spectrum(f"{out_prefix}_spectrum.png", freqs, c1_db,
                              c2_db, c1_theory, c2_theory, fc, gain_limit,
                              n1, n2)
                _plot_ti(f"{out_prefix}_tilt_index.png", ti)
    results["timings"] = timings
    results["counters"] = counters
    return results


def _write_report(path, results):
    """Sectioned bilingual report TXT: the reference's layout, headings
    and field lines (ref src/verify_tomatis_15db.py:514-516, 545-550,
    585-588, 637-641, 675-677, 798-799)."""
    eng = results["checks"]["engineering"]
    st = results["checks"]["gate_stats"]
    sp = results["checks"]["spectrum"]
    ti = results["checks"]["tilt_index"]
    ok = lambda b: "PASS" if b else "FAIL"  # noqa: E731
    lines = ["Tomatis ±15dB 验证报告", "=" * 50]
    lines += [
        "\nA. 工程检查",
        f"  采样率一致: {ok(eng['sr_match'])}",
        f"  声道一致: {ok(eng['ch_match'])}",
        f"  样点一致: {ok(eng['frames_match'])} (diff={eng['frames_diff']})",
        f"  峰值安全: {ok(eng['peak_safe'])} ({eng['peak']:.4f})",
        f"  DC偏移: {ok(eng['dc_safe'])} ({eng['dc_mean']:.6f})",
    ]
    lines += [
        "\nB. Gate 统计",
        f"  C2占比: {st.get('c2_ratio', 0) * 100:.1f}%",
        f"  切换次数: {st.get('switch_count', 0)} "
        f"({st.get('switches_per_min', 0):.1f}/min)",
        f"  短段比例: {st.get('short_run_ratio', 0) * 100:.1f}%",
    ]
    lines += [
        "\nC. 条件频谱验证",
        f"  C1 RMSE: {sp.get('c1_rmse', 0):.2f} dB",
        f"  C2 RMSE: {sp.get('c2_rmse', 0):.2f} dB",
        f"  fc误差: C1={sp.get('c1_fc_error', 0):.2f}, "
        f"C2={sp.get('c2_fc_error', 0):.2f} dB",
        f"  结果: {ok(sp['pass'])}",
    ]
    lines += [
        "\nD. 效果量化",
        f"  Tomatis效果强度(C2-C1): {ti.get('ti_effect', 0):.2f} dB",
        f"  效果验证: "
        f"{'PASS' if ti.get('effect_ok') else 'WARN (<5dB)'}",
    ]
    lines += ["\n" + "=" * 50,
              f"总体结果: {ok(results['pass'])}"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


def plot_spectrum(path, freqs, c1_db, c2_db, c1_th, c2_th, fc, g, n1, n2):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(2, 1, figsize=(12, 9))
    for ax, meas, th, color, name, n in [
            (axes[0], c1_db, c1_th, "b", "C1", n1),
            (axes[1], c2_db, c2_th, "r", "C2", n2)]:
        ax.semilogx(freqs, meas, color + "-", alpha=0.7,
                    label=f"{name} measured")
        ax.semilogx(freqs, th, color + "--", linewidth=2,
                    label=f"{name} theory")
        ax.axvline(fc, color="gray", linestyle=":")
        ax.set_xlim(20, 20000)
        ax.set_ylim(-g - 5, g + 5)
        ax.set_title(f"{name} conditional spectrum (n={n})")
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Gain (dB)")
        ax.grid(True, alpha=0.3)
        ax.legend()
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)


def _plot_ti(path, ti):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(10, 6))
    for key, color in [("input", "gray"), ("c1", "b"), ("c2", "r")]:
        if len(ti[key]):
            ax.hist(ti[key], bins=50, alpha=0.5, label=key, color=color)
    ax.set_xlabel("Tilt Index (dB)")
    ax.set_ylabel("frames")
    ax.set_title("Tilt Index distributions")
    ax.legend()
    ax.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)
