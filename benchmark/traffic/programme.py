"""The benchmark's traffic generator: synthetic music programmes, after
chip_smoke.py's programme().

Each file of a mix is a stereo programme of passages that alternate
between two levels set relative to the configuration's own gate threshold
(mix["levels_db"], quiet first), each passage mix["passage_s"][0]-[1]
seconds long; the content is tones (mix["tones_hz"], mix["tone_amps"],
the second channel mix["channel_tilt"] quieter in tone) plus Gaussian
noise (mix["noise"]), scaled so that a passage's power-averaged RMS is its
level in dBFS.

Passages start and end on any sample, as in chip_smoke.py, so the frames
that straddle a change of level take every level in between, some of them
at the gate's thresholds; and the file ends with whatever passage is
playing, so its last samples lie under the last frame's window tail,
where the normaliser y / (wsum + 1e-12) divides by a small window-square
sum (the checks split that end off: harness/check.py).

Everything comes from the seed: file i's passages from Generator([seed,
i]), its segment s of mix["segment_s"] seconds from Generator([seed, i, s
+ 1]), so the segments are made side by side on threads and a seed always
gives the same samples.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

THREADS = 8


def _envelope(rng, n: int, sr: int, amps, passage_s) -> np.ndarray:
    env = np.empty(n, np.float32)
    pos, k = 0, 0
    while pos < n:
        m = int(rng.uniform(*passage_s) * sr)
        env[pos:pos + m] = amps[k % 2]
        pos += m
        k += 1
    return env


def make(mix: dict, config: dict, seed: int) -> list:
    """float32 [n, C] programmes, one per entry of mix["lengths_s"]."""
    sr, C = config["sample_rate"], config["channels"]
    seed = int(seed) % 2 ** 63
    tones = list(zip(mix["tones_hz"], mix["tone_amps"]))
    tilt, noise = mix["channel_tilt"], mix["noise"]
    # mean power of the content over the channels, for an envelope of 1
    tone_pow = sum(a * a / 2.0 for _, a in tones)
    power = np.mean([tone_pow * (1.0 - tilt * c) ** 2 + noise * noise
                     for c in range(C)])
    amps = [10.0 ** ((config["threshold_dbfs"] + d) / 20.0) / math.sqrt(power)
            for d in mix["levels_db"]]
    lengths = [int(round(s * sr)) for s in mix["lengths_s"]]
    seg = int(mix["segment_s"] * sr)
    envs = [_envelope(np.random.default_rng([seed, i]), n, sr, amps,
                      mix["passage_s"]) for i, n in enumerate(lengths)]
    outs = [np.empty((n, C), np.float32) for n in lengths]

    def fill(i: int, s: int) -> None:
        lo, hi = s * seg, min(lengths[i], (s + 1) * seg)
        rng = np.random.default_rng([seed, i, s + 1])
        idx = np.arange(lo, hi, dtype=np.float64)
        tone = sum(a * np.sin((2.0 * np.pi * f / sr) * idx) for f, a in tones)
        tone = tone.astype(np.float32)
        nz = rng.standard_normal((hi - lo, C), dtype=np.float32)
        env = envs[i][lo:hi]
        for c in range(C):
            outs[i][lo:hi, c] = env * (tone * np.float32(1.0 - tilt * c)
                                       + nz[:, c] * np.float32(noise))

    with ThreadPoolExecutor(THREADS) as pool:
        futs = [pool.submit(fill, i, s) for i, n in enumerate(lengths)
                for s in range(-(-n // seg))]
        for f in futs:
            f.result()
    return outs

