"""Plain reference of the adaptive processor, written from the upstream
script (xyjk0511/tomatis-audio-processor, src/process_tomatis_adaptive.py),
in float64 PyTorch on the CPU. It imports nothing of the program and takes
only the input samples the benchmark made.

Step by step, as upstream:
  1. the global input peak sets a pre-attenuation, atten_db = max(0,
     peak dBFS + max(|c1_low|, |c2_high|) + headroom_margin), and the
     input is scaled by 10^(-atten_db/20) (:201-215);
  2. the signal, padded by n_fft/2 zeros at both ends, is framed at hop;
     only the frames whose start lies in the file and whose end lies in
     the padded signal are kept (:57-84); a frame's level is the RMS dBFS
     of its power averaged over the channels;
  3. the gate threshold is searched over [p5, p95] of the levels above
     silence_threshold: up to 30 bisections, each probe running the
     min-hold gate over every frame and stopping within 1% of target_c2,
     the probe nearest the target kept (:124-154);
  4. the min-hold gate at that threshold, ton/toff = T +- hyst_db/2: from
     C1, a switch is allowed once min_hold frames have passed since the
     last one, the first frame at once (:87-121);
  5. the crossfade weight snaps to the first frame's state and then ramps
     toward each frame's state at 1/xfade_frames a frame (:219-265);
  6. each frame is Hann-windowed, rFFT'd, scaled by 10^(g/20) with g the
     C1/C2 tilt curves blended in dB by the weight, irFFT'd, windowed
     again and overlap-added with the window-square sum; the output is
     y / max(wsum, 1e-8), cropped to the file (:283-332);
  7. the attenuation is restored and one global rescale brings a peak
     over 0.999 down to it (:334-345); PCM_24 by rounding.

Where this departs from upstream:
  - the input is the file's PCM_24 samples over 2^23 in float64, where
    upstream reads float32 (the same values);
  - the gate and ramp run in Python over the frames, the framing and the
    FFTs in blocks of frames; the arithmetic is float64 throughout (the
    upstream script's is float32 and float64 by numpy's promotion);
  - levels, alpha and states come out for the kept frames only, numbered
    0..F-1; the state CSV numbers them 1..F (csv_frame_idx);
  - a gate decision on a level within AMBIGUOUS_DB of ton or toff is a
    matter of rounding: render() runs the gate again with each such
    decision taken the other way and marks the frames whose weight that
    changes (`masked`), as tomatis_ref does for its gate; and it counts
    the search's probes whose C2 count moves when both thresholds move by
    +-AMBIGUOUS_DB (`search["ambiguous_probes"]`): where that count is
    not 0, float32 and float64 may take another path through the search;
  - the file's first hop lies under the first frame's window alone, as
    its last hop under the last frame's: there y / max(wsum, 1e-8)
    divides by w(k)^2 and float32 rounding of the program comes out
    amplified by 1/w(k). last_cut splits off the last hop only.

render() keeps to the contract of benchmark/reference/__init__.py; it
defines no threshold_dbfs(), since the params do not fix the threshold.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.precision import identity
from reference.tomatis_ref import (AMBIGUOUS_DB, BLOCK_FRAMES, EPS,
                                   FULL_SCALE, PEAK_LIMIT, tilt_gain_db)

NORM_FLOOR = 1e-8
SEARCH_ITERS = 30
SEARCH_TOL = 0.01


def frame_range(total: int, n_fft: int, hop: int) -> tuple:
    """(k0, F): the kept frames are k0..k0+F-1 of the padded signal,
    frame k starting at k*hop - n_fft/2 in the file."""
    pad = n_fft // 2
    ks = [k for k in range((total + 2 * pad) // hop + 1)
          if 0 <= k * hop - pad < total and k * hop + n_fft <= total + 2 * pad]
    return (ks[0], len(ks)) if ks else (0, 0)


def gate(levels: list, ton: float, toff: float, hold: int,
         flip: int = -1) -> np.ndarray:
    """The min-hold gate (:87-121), 1 = C1, 2 = C2. At frame `flip` a
    comparison with a threshold within AMBIGUOUS_DB of the level is taken
    the other way."""
    state, since = 1, hold
    out = np.empty(len(levels), np.int32)
    for j, level in enumerate(levels):
        since += 1
        if since >= hold:
            near = j == flip
            if state == 1:
                if (level >= ton) != (near
                                      and abs(level - ton) <= AMBIGUOUS_DB):
                    state, since = 2, 0
            elif (level <= toff) != (near
                                     and abs(level - toff) <= AMBIGUOUS_DB):
                state, since = 1, 0
        out[j] = state
    return out


def search(levels: list, valid: np.ndarray, hyst: float, hold: int,
           target: float) -> dict:
    """The threshold search (:124-154). Returns the threshold, the
    probes run and how many of them a +-AMBIGUOUS_DB move of both
    thresholds would give another C2 count."""
    lv = np.asarray(levels, np.float64)
    if not valid.any():
        return dict(threshold=float(np.median(lv)), probes=0,
                    ambiguous_probes=0)
    lo = float(np.percentile(lv[valid], 5))
    hi = float(np.percentile(lv[valid], 95))
    best_t, best_diff = float(np.median(lv[valid])), 1.0
    probes = ambiguous = 0

    def c2_count(t):
        return int(np.sum(gate(levels, t + hyst / 2.0, t - hyst / 2.0,
                               hold) == 2))

    for _ in range(SEARCH_ITERS):
        mid = (lo + hi) / 2.0
        n = c2_count(mid)
        probes += 1
        ambiguous += any(c2_count(mid + d) != n
                         for d in (-AMBIGUOUS_DB, AMBIGUOUS_DB))
        diff = abs(n / len(levels) - target)
        if diff < best_diff:
            best_diff, best_t = diff, mid
        if diff < SEARCH_TOL:
            break
        if n / len(levels) < target:
            hi = mid
        else:
            lo = mid
    return dict(threshold=best_t, probes=probes, ambiguous_probes=ambiguous)


def ramp(states: np.ndarray, step: float) -> np.ndarray:
    """The snap-first crossfade weight (:251-265): the first frame takes
    its state's weight, each later one moves toward it by `step`."""
    out = np.empty(len(states), np.float64)
    cur = None
    for j, s in enumerate(states):
        want = 1.0 if s == 2 else 0.0
        if cur is None:
            cur = want
        else:
            diff = want - cur
            cur = want if abs(diff) <= step else cur + math.copysign(step,
                                                                     diff)
        out[j] = cur
    return out


def render(x: np.ndarray, config: dict, quantise=identity) -> dict:
    """Process x [n, C] (float samples) as `config` says; the dict of
    reference/__init__.py, and `search`: the threshold, the probes run,
    the ambiguous probes and the pre-attenuation."""
    p = config["params"]
    sr = config["sample_rate"]
    n_fft, hop = p["n_fft"], p["hop"]
    if n_fft % hop:
        raise ValueError("the reference needs hop | n_fft")
    q = quantise
    fft32 = getattr(q, "fft32", False)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    total, C = x.shape
    pad, K = n_fft // 2, n_fft // hop
    k0, F = frame_range(total, n_fft, hop)
    if F == 0:                  # shorter than a frame: the input back
        y = x.numpy()
        none = np.zeros(0, np.int64)
        return dict(y=y, pcm=torch.clamp(torch.round(x * FULL_SCALE),
                                         -FULL_SCALE, FULL_SCALE - 1)
                    .to(torch.int32).numpy(), levels=np.zeros(0),
                    states=np.zeros(0, np.int32), alpha=np.zeros(0),
                    rows=none, csv_frame_idx=none, masked=np.zeros(0, bool),
                    starts=none, last_cut=total,
                    search=dict(threshold=0.0, probes=0, ambiguous_probes=0,
                                atten_db=0.0))

    # 1. pre-attenuation
    peak_in = float(x.abs().max()) if x.numel() else 0.0
    atten_db = max(0.0, 20.0 * math.log10(peak_in + EPS)
                   + max(abs(p["c1_low"]), abs(p["c2_high"]))
                   + p["headroom_margin"])
    xa = q(x * 10.0 ** (-atten_db / 20.0))

    # 2. levels of the kept frames, from their hop blocks
    base = k0 * hop - pad                 # first kept frame's start
    length = (F - 1) * hop + n_fft
    seg = xa[base:base + length]
    seg = torch.cat([seg, seg.new_zeros((length - len(seg), C))])
    blocks = seg.reshape(-1, hop, C)
    bpow = (blocks * blocks).sum(dim=(1, 2))
    fpow = sum(bpow[k:k + F] for k in range(K))
    levels = q(20.0 * torch.log10(torch.sqrt(q(fpow / (n_fft * C)) + EPS)
                                  + EPS))

    # 3-5. search, gate, ramp
    hold = math.ceil(p["min_hold_ms"] / (hop / sr * 1000.0))
    xf = math.ceil(p["xfade_ms"] / (hop / sr * 1000.0))
    step = 1.0 / xf if xf > 0 else 1.0
    lv = levels.tolist()
    found = search(lv, levels.numpy() > p["silence_threshold"],
                   p["hyst_db"], hold, p["target_c2"])
    t = found["threshold"]
    ton, toff = t + p["hyst_db"] / 2.0, t - p["hyst_db"] / 2.0
    states = gate(lv, ton, toff, hold)
    alpha = ramp(states, step)
    lvn = levels.numpy()
    near = np.nonzero((np.abs(lvn - ton) <= AMBIGUOUS_DB)
                      | (np.abs(lvn - toff) <= AMBIGUOUS_DB))[0]
    masked = np.zeros(F, bool)
    for j in near:
        masked |= ramp(gate(lv, ton, toff, hold, flip=int(j)), step) != alpha
    weight = q(torch.as_tensor(alpha))

    # 6. STFT, blended gains, overlap-add, normalise
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)
    g1_db = torch.as_tensor(tilt_gain_db(freqs, p["fc"], p["slope"],
                                         p["c1_low"], p["c1_high"]))
    g2_db = torch.as_tensor(tilt_gain_db(freqs, p["fc"], p["slope"],
                                         p["c2_low"], p["c2_high"]))
    win = q(torch.as_tensor(np.hanning(n_fft)))
    y_sum = torch.zeros((F + K - 1, hop, C), dtype=torch.float64)
    for j0 in range(0, F, BLOCK_FRAMES):
        j1 = min(F, j0 + BLOCK_FRAMES)
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
    w_sum = torch.zeros((F + K - 1, hop), dtype=torch.float64)
    for k in range(K):
        w_sum[k:k + F] = q(w_sum[k:k + F] + win2[k])
    out = q(y_sum.reshape(-1, C)
            / torch.clamp(w_sum.reshape(-1, 1), min=NORM_FLOOR))

    # crop to the file; samples no frame covers stay 0
    y_out = torch.zeros((total, C), dtype=torch.float64)
    e = min(total, base + len(out))
    if e > base:
        y_out[base:e] = out[:e - base]

    # 7. restore the attenuation, one global peak protect
    if atten_db > 0:
        y_out = q(y_out * 10.0 ** (atten_db / 20.0))
    peak = float(y_out.abs().max()) if y_out.numel() else 0.0
    if peak > PEAK_LIMIT:
        y_out = q(y_out * (PEAK_LIMIT / peak))
    pcm = torch.clamp(torch.round(y_out * FULL_SCALE), -FULL_SCALE,
                      FULL_SCALE - 1).to(torch.int32)
    starts = base + np.arange(F) * hop
    rows = np.arange(F)
    last_cut = min(total, base + (F - 1) * hop + n_fft - hop)
    return dict(y=y_out.numpy(), pcm=pcm.numpy(), levels=lvn, states=states,
                alpha=alpha, rows=rows, csv_frame_idx=rows + 1,
                masked=masked, starts=starts, last_cut=max(0, last_cut),
                search=dict(found, atten_db=atten_db))
