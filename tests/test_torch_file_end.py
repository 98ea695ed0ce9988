"""The file's end of the standard and crossfade processors: the port's
process_array against the JAX package's on the CPU, on both transports,
at lengths that put the end under one frame's window tail alone (2, 3
and 160 whole hops) and at lengths that do not.

Every sample before the last flush cut is held to the JAX package's run
within 1e-5. The last cut is held to a float64 witness: the same frames,
gain rows (from the JAX run's logged states and alphas), windows and
flush clamp computed in float64. There the normaliser divides by the
squared window of one frame, down to 5.9e-7, and the cut's 0.999 clamp
scales every sample by a peak taken there, so the bound is derived from
the window: an irfft output in float32 is off by about (2 log2(n_fft)
+ 4) eps times the frame's rms (the rounding of log2(n_fft) stages each
way, spread over the frame's samples), which the normaliser multiplies by
sum(w)/sum(w^2) (1/w(k) where one frame alone covers a sample); the
clamp's scale moves by at most that error at the peak over max(peak,
0.999). The JAX package's run is held to the same bound: it is one any
float32 implementation meets."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tomatis_tpu.models import standard as jstd
from tomatis_tpu.models import xfade as jxf
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.engine.streaming import flush_plan
from tomatis_tpu_torch.models import standard, xfade

torch.set_num_threads(2)

SR = 48000
HOP = 2048
N_FFT = 4096
FPC = 64
MARGIN_DB = 0.01
PEAK_LIMIT = 0.999
EPS32 = float(np.finfo(np.float32).eps)
LSB = 1.0 / 8388608.0
# shorter than or near n_fft (2 and 3 whole hops), 160 whole hops (more
# than one flush cut), one sample past it, and 1792 samples past a hop
LENGTHS = [4096, 6144, 327680, 327681, 329472]
WHOLE_HOPS = {4096, 6144, 327680}


def _signal(n, seed):
    """Stereo tone mix with a quiet/loud alternation that crosses both
    gates' thresholds, with signal up to the file's last sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    env = 0.004 + 0.25 * (np.sin(2 * np.pi * 0.7 * t + 0.3) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t)
               + 0.5 * np.sin(2 * np.pi * 3000 * t))
    x = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(n)], 1)
    return np.clip(x, -1, 1).astype(np.float32)


def _jax_params(processor):
    if processor == "standard":
        return jstd.StandardParams(require_48k_stereo=False)
    return jxf.XfadeParams(require_48k_stereo=False, xfade_ms=100.0)


@functools.lru_cache(maxsize=None)
def _reference(processor, n):
    """The JAX package's run of the processor on the length-n signal
    (what its process_array runs, with the per-frame log kept), shared by
    both transports' cases: (x, y, levels, per-frame gain rows float64,
    thresholds)."""
    x = _signal(n, seed=n % 7)
    jp = _jax_params(processor)
    jmod = jstd if processor == "standard" else jxf
    runner = jmod.make_runner(jp, SR, 2, n, FPC)
    outs, logs = [], {"levels": [], "states": [], "alpha": []}

    def on_frames(f0, starts, log):
        for k in logs:
            if k in log:
                logs[k].append(np.asarray(log[k]))
    runner.run(x, on_audio=outs.append, on_frames=on_frames)
    y = np.concatenate(outs, 0)
    logs = {k: np.concatenate(v) for k, v in logs.items() if v}
    jctl = jmod.build_controller(jp, SR)
    if processor == "standard":
        table, ton, toff = (np.asarray(v, np.float64) for v in jctl.params())
        gains = table[logs["states"].astype(np.int64) - 1]
    else:
        g1, g2, ton, toff, _ = (np.asarray(v, np.float64)
                                for v in jctl.params())
        a = logs["alpha"].astype(np.float64)[:, None]
        gains = 10.0 ** (((1.0 - a) * g1 + a * g2) / 20.0)
    return x, y, logs["levels"], gains, (float(ton), float(toff))


def _port_run(processor, x, transport):
    jp = _jax_params(processor)
    if processor == "standard":
        p = convert.standard_params_from_dict(dataclasses.asdict(jp))
        return standard.process_array(x, SR, p, frames_per_chunk=FPC,
                                      device="cpu", transport=transport)[0]
    p = convert.xfade_params_from_dict(dataclasses.asdict(jp))
    return xfade.process_array(x, SR, p, frames_per_chunk=FPC, device="cpu",
                               transport=transport)[0]


def _witness(x, gains):
    """float64 render of the stream: (y before the clamp, y after each
    flush cut's clamp, sum(w) / (sum(w^2) + 1e-12) and the largest rms of
    a frame's irfft output), cropped to the file."""
    n, ch = x.shape
    plan = flush_plan(n, N_FFT, HOP)
    assert plan.n_frames == len(gains)
    win = np.hanning(N_FFT).astype(np.float32).astype(np.float64)
    xp = np.concatenate([np.zeros((plan.pad, ch)), x.astype(np.float64),
                         np.zeros((plan.pad_end, ch))])
    ysum = np.zeros_like(xp)
    w1 = np.zeros(len(xp))
    w2 = np.zeros(len(xp))
    z_rms = 0.0
    for j, g in enumerate(gains):
        s = slice(j * HOP, j * HOP + N_FFT)
        z = np.fft.irfft(np.fft.rfft(xp[s] * win[:, None], axis=0)
                         * g[:, None], n=N_FFT, axis=0)
        z_rms = max(z_rms, float(np.sqrt((z * z).mean(0)).max()))
        ysum[s] += z * win[:, None]
        w1[s] += win
        w2[s] += win * win
    crop = slice(plan.pad, plan.pad + n)
    y = (ysum / (w2 + 1e-12)[:, None])[crop]
    out = y.copy()
    for start, length in plan.cuts:
        a, b = max(0, start), min(n, start + length)
        if b > a:
            peak = np.abs(y[a:b]).max()
            if peak > PEAK_LIMIT:
                out[a:b] *= PEAK_LIMIT / peak
    return y, out, (w1 / (w2 + 1e-12))[crop], z_rms


def _last_cut_bound(y, cover, z_rms, a, quantised):
    """Per-sample bound [m, C] on |out - witness| over the last cut
    [a, n). Before the clamp, e: the irfft error spread by the
    normaliser and 4 eps of rounding in the products and sums. The
    float32 peak lies where |y| + e reaches the witness's peak less e
    there, so the two peaks differ by at most the largest e of those
    samples, and the clamp's scale min(1, 0.999/peak) by that over
    max(peak, 0.999). Half an LSB more where the output is quantised to
    PCM_24."""
    c_z = (2 * np.log2(N_FFT) + 4) * EPS32 * z_rms
    mag = np.abs(y[a:])
    e = c_z * cover[a:, None] + 4 * EPS32 * mag
    peak = mag.max()
    e_at = e.flat[np.argmax(mag)]
    dp = max(e_at, e[mag + e >= peak - e_at].max())
    return (e + mag * dp / max(peak, PEAK_LIMIT)
            + (0.5 * LSB if quantised else 0.0))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
@pytest.mark.parametrize("processor", ["standard", "xfade"])
def test_file_end_matches_jax_and_float64_witness(processor, transport, n):
    x, y_jax, levels, gains, thresholds = _reference(processor, n)
    for th in thresholds:
        assert np.min(np.abs(levels - th)) >= MARGIN_DB, th
    y = _port_run(processor, x, transport)
    assert y.shape == y_jax.shape == x.shape

    a = max(0, flush_plan(n, N_FFT, HOP).cuts[-1][0])
    assert np.max(np.abs(y[:a] - y_jax[:a]), initial=0.0) <= 1e-5
    if n == 327680:
        assert a > 0, "160 whole hops span more than one flush cut"

    pre, want, cover, z_rms = _witness(x, gains)
    bound = _last_cut_bound(pre, cover, z_rms, a, transport == "pcm24")
    assert np.all(np.abs(y[a:] - want[a:]) <= bound)
    assert np.all(np.abs(y_jax[a:] - want[a:]) <= _last_cut_bound(
        pre, cover, z_rms, a, False))
    if n in WHOLE_HOPS:
        # the end lies under one window tail alone, and the last cut's
        # peak passes 0.999, so its clamp scales every sample held here
        assert cover[-HOP:].max() > 1e5
        assert np.abs(pre[a:]).max() > PEAK_LIMIT
