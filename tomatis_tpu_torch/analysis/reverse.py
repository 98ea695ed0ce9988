"""Device parameter reverse-engineering, PyTorch port of
tomatis_tpu/analysis/reverse.py (capability parity with
ref src/reverse_engineer_params.py): align in/out, per-frame spectral diff
-> tilt index (2-6 kHz minus 200-500 Hz), tilt-vs-level table over 5 dB
bins, gate threshold estimate from the C1/C2 level separation, histogram,
CSV dump. The per-frame loop is one batched device op (framing, levels,
two rFFTs, the band means); alignment and the tables are host numpy."""
from __future__ import annotations

import csv

import numpy as np
import torch

from tomatis_tpu_torch.analysis.align import EPS, power_mono
from tomatis_tpu_torch.analysis.compare import align_pair, find_delay_full
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device

LEVEL_BINS = [(-70, -60), (-60, -55), (-55, -50), (-50, -45), (-45, -40),
              (-40, -35), (-35, -30), (-30, -25), (-25, -20), (-20, -15),
              (-15, -10)]
HIST_BINS = [(-40, -30), (-30, -20), (-20, -10), (-10, 0), (0, 10),
             (10, 20), (20, 30), (30, 40)]


def _frame_tilts(mono_in, mono_out, n_fft, hop, n_frames, sr, dev):
    """(input levels [F] dBFS, tilt [F] dB) of two aligned host mono
    signals, on dev: symmetric Hann, the hi (2-6 kHz) band mean of the
    per-bin dB difference minus the lo (200-500 Hz) one."""
    win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(dev)
    freqs = torch.from_numpy(stft.rfft_freqs(n_fft, sr)).to(dev)

    def frames(mono):
        t = torch.from_numpy(np.ascontiguousarray(mono, np.float32)).to(dev)
        return stft.frame_signal(t[:, None], n_fft, hop, n_frames)[:, 0, :]

    fi, fo = frames(mono_in), frames(mono_out)
    lv = 20.0 * torch.log10(torch.sqrt(torch.mean(torch.square(fi), dim=-1)
                                       + EPS) + EPS)
    di = 20.0 * torch.log10(torch.abs(torch.fft.rfft(fi * win)) + EPS)
    do = 20.0 * torch.log10(torch.abs(torch.fft.rfft(fo * win)) + EPS)
    diff = do - di
    lo = (freqs >= 200) & (freqs < 500)
    hi = (freqs >= 2000) & (freqs < 6000)
    zero = torch.zeros((), dtype=diff.dtype, device=dev)
    tilt = (torch.where(hi, diff, zero).sum(dim=-1) / hi.sum()
            - torch.where(lo, diff, zero).sum(dim=-1) / lo.sum())
    return lv, tilt


def analyze_device_params(input_path, output_path, out_csv=None,
                          sr: int = 48000, n_fft: int = 4096,
                          hop: int = 2048, device="cuda") -> dict:
    dev = resolve_device(device)
    inp_lr, sr_in = audio.read(input_path)
    out_lr, sr_out = audio.read(output_path)
    # the band edges, times and delay math all assume `sr`; silently
    # trusting the parameter against e.g. 44.1 kHz files would shift
    # every band by 8% with no error (compare_audio raises likewise)
    if sr_in != sr or sr_out != sr:
        raise ValueError(f"sample rate mismatch: files are "
                         f"{sr_in}/{sr_out} Hz, sr={sr} — pass sr=")
    delay = find_delay_full(power_mono(inp_lr), power_mono(out_lr), sr)
    inp_a, out_a = align_pair(inp_lr, out_lr, delay)
    mono_i = power_mono(inp_a).astype(np.float32)
    mono_o = power_mono(out_a).astype(np.float32)
    n_frames = 1 + (len(mono_i) - n_fft) // hop
    lv, tilt = _frame_tilts(mono_i, mono_o, n_fft, hop, n_frames, sr, dev)
    lv = lv.cpu().numpy()
    tilt = tilt.cpu().numpy()
    times = np.arange(n_frames) * hop / sr

    level_table = []
    for lo, hi in LEVEL_BINS:
        sel = (lv >= lo) & (lv < hi)
        if sel.any():
            level_table.append(dict(
                lo=lo, hi=hi, n=int(sel.sum()),
                mean_tilt=float(tilt[sel].mean()),
                std_tilt=float(tilt[sel].std()),
                state="C1" if tilt[sel].mean() < 0 else "C2"))

    c1_sel = tilt < -5
    c2_sel = tilt > 5
    threshold = None
    if c1_sel.any() and c2_sel.any():
        c1_max = float(lv[c1_sel].max())
        c2_min = float(lv[c2_sel].min())
        threshold = dict(c1_frames=int(c1_sel.sum()),
                         c2_frames=int(c2_sel.sum()),
                         c1_max_level=c1_max, c2_min_level=c2_min,
                         estimate=(c1_max + c2_min) / 2)

    hist = []
    for lo, hi in HIST_BINS:
        cnt = int(np.sum((tilt >= lo) & (tilt < hi)))
        hist.append(dict(lo=lo, hi=hi, count=cnt,
                         pct=cnt / max(1, len(tilt)) * 100))

    if out_csv:
        with open(out_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["frame", "time_sec", "inp_level_dbfs", "tilt_db"])
            for i in range(n_frames):
                w.writerow([i, f"{times[i]:.3f}", f"{lv[i]:.2f}",
                            f"{tilt[i]:.2f}"])
    return dict(delay_samples=delay, n_frames=n_frames,
                level_table=level_table, gate_threshold=threshold,
                histogram=hist, levels=lv, tilts=tilt)
