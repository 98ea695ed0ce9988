"""Tilt amplitude verifier, PyTorch port of
tomatis_tpu/verify/tilt_amplitude.py (capability parity with
ref src/verify_tilt_amplitude.py): group frames by input level
(< -45 dBFS -> C1, > -30 dBFS -> C2), average the out-in spectral
difference, report gains at key frequencies and the 4 kHz - 250 Hz tilt
against the +-30 dB theory. The per-frame FFT loop is one batched device
op; the alignment and the group means are host numpy."""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.analysis.align import EPS, power_mono
from tomatis_tpu_torch.analysis.compare import align_pair, find_delay_full
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.ops import stft
from tomatis_tpu_torch.utils.device import resolve_device

TEST_FREQS = (250, 500, 1000, 2000, 4000, 8000)


def _frame_specs(mono_in: torch.Tensor, mono_out: torch.Tensor, n_fft: int,
                 hop: int, n_frames: int):
    """(input frame levels [F], out-in log-magnitude difference
    [F, bins]) of two mono device signals."""
    win = torch.from_numpy(stft.hann_symmetric(n_fft)).to(mono_in.device)
    fi = stft.frame_signal(mono_in[:, None], n_fft, hop, n_frames)[:, 0, :]
    fo = stft.frame_signal(mono_out[:, None], n_fft, hop, n_frames)[:, 0, :]
    lv = 20.0 * torch.log10(torch.sqrt(torch.mean(torch.square(fi), dim=-1)
                                       + EPS) + EPS)
    d_in = 20.0 * torch.log10(torch.abs(torch.fft.rfft(fi * win)) + EPS)
    d_out = 20.0 * torch.log10(torch.abs(torch.fft.rfft(fo * win)) + EPS)
    return lv, d_out - d_in


def band_power_db(spec_db, freqs, f1, f2) -> float:
    m = (freqs >= f1) & (freqs < f2)
    return float(np.mean(np.asarray(spec_db)[m]))


def analyze_tilt_amplitude(input_path, output_path, sr: int = 48000,
                           n_fft: int = 4096, hop: int = 2048,
                           c1_below: float = -45.0,
                           c2_above: float = -30.0, device="cuda") -> dict:
    dev = resolve_device(device)
    inp_lr, sr_in = audio.read(input_path)
    out_lr, sr_out = audio.read(output_path)
    # band edges and delay math assume `sr`: refuse a silent mismatch
    if sr_in != sr or sr_out != sr:
        raise ValueError(f"sample rate mismatch: files are "
                         f"{sr_in}/{sr_out} Hz, sr={sr} — pass sr=")
    delay = find_delay_full(power_mono(inp_lr), power_mono(out_lr), sr)
    inp_a, out_a = align_pair(inp_lr, out_lr, delay)

    def upload(a):
        return torch.from_numpy(power_mono(a).astype(np.float32)).to(dev)

    mono_i, mono_o = upload(inp_a), upload(out_a)
    n_frames = 1 + (len(mono_i) - n_fft) // hop
    lv, diff = _frame_specs(mono_i, mono_o, n_fft, hop, n_frames)
    lv = lv.cpu().numpy()
    diff = diff.cpu().numpy()
    freqs = stft.rfft_freqs(n_fft, sr)

    c1_sel = lv < c1_below
    c2_sel = lv > c2_above
    res = dict(delay_samples=delay, n_c1=int(c1_sel.sum()),
               n_c2=int(c2_sel.sum()), freqs=freqs)
    if res["n_c1"] > 10 and res["n_c2"] > 10:
        c1_avg = diff[c1_sel].mean(axis=0)
        c2_avg = diff[c2_sel].mean(axis=0)
        res["c1_gains"] = {f: float(c1_avg[np.argmin(np.abs(freqs - f))])
                           for f in TEST_FREQS}
        res["c2_gains"] = {f: float(c2_avg[np.argmin(np.abs(freqs - f))])
                           for f in TEST_FREQS}
        res["c1_tilt"] = (band_power_db(c1_avg, freqs, 3500, 4500)
                          - band_power_db(c1_avg, freqs, 200, 300))
        res["c2_tilt"] = (band_power_db(c2_avg, freqs, 3500, 4500)
                          - band_power_db(c2_avg, freqs, 200, 300))
        res["c1_avg"] = c1_avg
        res["c2_avg"] = c2_avg
    return res
