"""Plain reference of the two processors the benchmark runs, written from
the upstream algorithm (xyjk0511/tomatis-audio-processor,
src/process_tomatis.py:160-479 and src/process_tomatis_xfade.py), in
float64 PyTorch on the CPU. It imports nothing of the program and takes
only the input samples the benchmark made.

Per frame of n_fft samples at hop (the signal padded by n_fft/2 in front
and to a whole frame at the end): the level is the RMS dBFS of the
power-averaged mono; the hysteresis gate with its up-switch delay in
absolute samples picks C1 or C2 (the crossfade processor ramps alpha
toward the state at 1/xfade_frames a frame and blends the two tilt curves
in dB); the frame goes through Hann -> rFFT -> gain -> irFFT -> Hann and
is overlap-added with the window-square sum; the output is y / (wsum +
1e-12), cut at the >= 5 s flush points, each cut cropped to the file,
scaled to a 0.999 peak if it exceeds it, and quantised to PCM_24.

A gate decision on a level within AMBIGUOUS_DB of a threshold is a matter
of rounding: float32 and float64 may take either side. render() runs the
gate once more with each such decision taken the other way and marks the
frames whose C1/C2 weight that changes (`masked`); the check does not
hold the program to the reference there.

render() keeps to the contract of benchmark/reference/__init__.py; its
`quantise` is one of reference.precision's roundings.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.precision import identity

EPS = 1e-12
PEAK_LIMIT = 0.999
FLUSH_THRESHOLD = 48000 * 5
FULL_SCALE = 8388608.0
BLOCK_FRAMES = 2048
# a hundred times the largest level gap of the program's sound runs
# (8.7e-6 dB), a hundred times under the bfloat16 control's (0.12 dB)
AMBIGUOUS_DB = 1e-3


def threshold_dbfs(params: dict) -> float:
    if params.get("gate_mode", "linear") == "log_percent":
        dr = params["dynamic_range"]
        return -dr + dr * params["gate_ui"] / 100.0
    return params["gate_scale"] * params["gate_ui"] + params["gate_offset"]


def tilt_gain_db(freqs: np.ndarray, fc, slope, low_db, high_db) -> np.ndarray:
    x = np.log2(np.maximum(freqs, 1.0) / fc)
    lo = np.sign(low_db) * np.minimum(slope * np.maximum(0.0, -x), abs(low_db))
    hi = np.sign(high_db) * np.minimum(slope * np.maximum(0.0, x),
                                       abs(high_db))
    return np.where(x < 0, lo, np.where(x > 0, hi, 0.0))


def gate(levels: list, ton: float, toff: float, up_delay_samples: int,
         hop: int, pad: int, flip: int = -1) -> np.ndarray:
    """The upstream gate, frame by frame in absolute samples
    (src/process_tomatis.py:373-385): 1 = C1, 2 = C2. At frame `flip`
    a comparison with a threshold within AMBIGUOUS_DB of the level is
    taken the other way."""
    state, pending_at = 1, None
    out = np.empty(len(levels), np.int32)
    for j, level in enumerate(levels):
        start = -pad + j * hop
        near = j == flip
        if state == 1:
            if (level >= ton) != (near and abs(level - ton) <= AMBIGUOUS_DB):
                if pending_at is None:
                    pending_at = start + up_delay_samples
            else:
                pending_at = None
            if pending_at is not None and start >= pending_at:
                state, pending_at = 2, None
        elif (level <= toff) != (near
                                 and abs(level - toff) <= AMBIGUOUS_DB):
            state, pending_at = 1, None
        out[j] = state
    return out


def alpha_ramp(states: np.ndarray, step: float) -> np.ndarray:
    """The crossfade ramp (src/process_tomatis_xfade.py:254-262): alpha
    after each frame's move toward its target (1 in C2, 0 in C1)."""
    cur = 0.0
    out = np.empty(len(states), np.float64)
    for j, s in enumerate(states):
        diff = (1.0 if s == 2 else 0.0) - cur
        cur = cur + diff if abs(diff) <= step else cur + math.copysign(step,
                                                                       diff)
        out[j] = cur
    return out


def flush_cuts(total: int, n_frames: int, n_fft: int, hop: int) -> list:
    """(abs_start, length) of each write-out cut: a cut whenever the safe
    span reaches FLUSH_THRESHOLD after a frame, then the rest."""
    pad = n_fft // 2
    cuts, base = [], -pad
    for j in range(n_frames):
        safe = (-pad + (j + 1) * hop) - base - n_fft
        if safe >= FLUSH_THRESHOLD:
            cuts.append((base, safe))
            base += safe
    end = -pad + (n_frames - 1) * hop + n_fft
    if end > base:
        cuts.append((base, end - base))
    return cuts


def render(x: np.ndarray, config: dict, quantise=identity) -> dict:
    """Process x [n, C] (float samples) as `config` says.

    Returns y (float64 [n, C], the output before quantisation), pcm
    (int32 [n, C], its PCM_24 values), levels, states, masked and, for
    the crossfade processor, alpha (one per frame); rows: the indices of
    the frames whose start lies in the file (the state CSV's rows), which
    the CSV numbers as they are (csv_frame_idx); starts: each frame's
    first sample in the file (from -n_fft/2); last_cut: the first sample
    of the file's last flush cut."""
    p = config["params"]
    sr = config["sample_rate"]
    n_fft, hop = p["n_fft"], p["hop"]
    if n_fft % hop or (n_fft // 2) % hop:
        raise ValueError("the reference needs hop | n_fft/2")
    q = quantise
    fft32 = getattr(q, "fft32", False)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    total, C = x.shape
    pad = n_fft // 2
    pad_end = (hop - ((total - n_fft) % hop)) % hop
    xp = torch.cat([x.new_zeros((pad, C)), x, x.new_zeros((pad_end, C))])
    n_frames = (len(xp) - n_fft) // hop + 1
    K = n_fft // hop
    length = (n_frames - 1) * hop + n_fft
    blocks = q(xp[:length]).reshape(-1, hop, C)

    # levels: each frame's power from its K hop blocks
    bpow = (blocks * blocks).sum(dim=(1, 2))
    fpow = sum(bpow[k:k + n_frames] for k in range(K))
    levels = q(20.0 * torch.log10(torch.sqrt(q(fpow / (n_fft * C)) + EPS)
                                  + EPS))
    T = threshold_dbfs(p)
    ton, toff = T + p["hysteresis_db"] / 2.0, T - p["hysteresis_db"] / 2.0
    up = int(sr * p["up_delay_ms"] / 1000.0)
    lv = levels.tolist()
    states = gate(lv, ton, toff, up, hop, pad)
    near = np.nonzero((np.abs(levels.numpy() - ton) <= AMBIGUOUS_DB)
                      | (np.abs(levels.numpy() - toff) <= AMBIGUOUS_DB))[0]
    others = [gate(lv, ton, toff, up, hop, pad, flip=int(j)) for j in near]

    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)
    g1_db = torch.as_tensor(tilt_gain_db(freqs, p["fc"], p["slope"],
                                         p["c1_low"], p["c1_high"]))
    g2_db = torch.as_tensor(tilt_gain_db(freqs, p["fc"], p["slope"],
                                         p["c2_low"], p["c2_high"]))
    alpha = None
    if config["processor"] == "xfade":
        frame_ms = hop / sr * 1000.0
        xf = (max(1, math.ceil(p["xfade_ms"] / frame_ms))
              if p["xfade_ms"] > 0 else 1)
        def weigh(s):
            return alpha_ramp(s, 1.0 / xf)
    elif config["processor"] == "standard":
        def weigh(s):
            return (s == 2).astype(np.float64)
    else:
        raise ValueError(f"no reference for {config['processor']!r}")
    w_np = weigh(states)
    masked = np.zeros(n_frames, bool)
    for s in others:
        masked |= weigh(s) != w_np
    alpha = w_np if config["processor"] == "xfade" else None
    weight = torch.as_tensor(w_np)

    win = q(torch.as_tensor(np.hanning(n_fft)))
    y_sum = torch.zeros((n_frames + K - 1, hop, C), dtype=torch.float64)
    for j0 in range(0, n_frames, BLOCK_FRAMES):
        j1 = min(n_frames, j0 + BLOCK_FRAMES)
        frames = torch.cat([blocks[j0 + k:j1 + k] for k in range(K)], 1)
        frames = frames.permute(0, 2, 1)                 # [Fb, C, n_fft]
        w = weight[j0:j1, None]
        gains = q(10.0 ** (((1.0 - w) * g1_db + w * g2_db) / 20.0))
        fin = q(frames * win)
        spec = q(torch.fft.rfft(fin.float() if fft32 else fin, dim=-1)
                 .to(torch.complex128))
        fout = q(spec * gains[:, None, :])
        y = q(q(torch.fft.irfft(fout.to(torch.complex64) if fft32 else fout,
                                n=n_fft, dim=-1).to(torch.float64)) * win)
        y = y.reshape(j1 - j0, C, K, hop).permute(0, 2, 3, 1)
        for k in range(K):
            y_sum[j0 + k:j1 + k] = q(y_sum[j0 + k:j1 + k] + y[:, k])
    win2 = q(win * win).reshape(K, hop)
    w_sum = torch.zeros((n_frames + K - 1, hop), dtype=torch.float64)
    for k in range(K):
        w_sum[k:k + n_frames] = q(w_sum[k:k + n_frames] + win2[k])
    out = q(y_sum.reshape(-1, C) / (w_sum.reshape(-1, 1) + EPS))

    gain = 10.0 ** (p.get("output_gain_db", 0.0) / 20.0)
    y_out = torch.empty((total, C), dtype=torch.float64)
    cuts = flush_cuts(total, n_frames, n_fft, hop)
    for start, n in cuts:
        s, e = max(0, start), min(total, start + n)
        if e <= s:
            continue
        seg = out[s + pad:e + pad] * gain
        peak = float(seg.abs().max())
        if peak > PEAK_LIMIT:
            seg = q(seg * (PEAK_LIMIT / peak))
        y_out[s:e] = seg
    pcm = torch.clamp(torch.round(y_out * FULL_SCALE), -FULL_SCALE,
                      FULL_SCALE - 1).to(torch.int32)
    starts = -pad + np.arange(n_frames) * hop
    rows = np.nonzero((starts >= 0) & (starts < total))[0]
    return dict(y=y_out.numpy(), pcm=pcm.numpy(), levels=levels.numpy(),
                states=states, alpha=alpha, rows=rows, csv_frame_idx=rows,
                masked=masked, starts=starts, last_cut=max(0, cuts[-1][0]))
