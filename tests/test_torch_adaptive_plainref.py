"""The port's adaptive processor (tomatis_tpu_torch/models/adaptive.py)
against the benchmark's plain float64 reference of it
(benchmark/reference/adaptive_ref.py), on seeded programmes of 3-8 s
whose passages alternate between -38 and -14 dBFS RMS, quiet first.

Bounds: gate states equal outside the reference's `masked` frames (a
decision within rounding of a threshold); levels within 1e-4 dB; the
state CSV's alpha equal as printed; the threshold within 1e-3 dB; the
samples between the first and the last hop of the stream within 4 LSB
(a file) or 1e-5 (an array); on those two hops 1e-5 + 2e-7/win[k] more,
where one frame's window alone covers sample k and float32 rounding of
the irFFT comes out divided by win[k]. The reference rounded to bfloat16
at every stage fails those bounds: they are tight enough to tell.
"""
import csv
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import adaptive as ad

torch.set_num_threads(2)
SR = 48000
HOP = 2048
FULL = 8388608.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def _load(name: str, *parts: str):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    path = os.path.join(BENCH, *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("adaptive_ref_under_test", "reference", "adaptive_ref.py")
precision = _load("precision_under_test", "reference", "precision.py")
with open(os.path.join(BENCH, "configs", "adaptive_cli_defaults.json"),
          encoding="utf-8") as _f:
    CONFIG = json.load(_f)


def _programme(seconds: float, seed: int) -> np.ndarray:
    """PCM_24-exact stereo passages of 0.5-2 s at -38 and -14 dBFS RMS,
    quiet first: tones at 440 Hz and 3 kHz plus noise."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    env = np.empty(n)
    pos, k = 0, 0
    while pos < n:
        m = int(rng.uniform(0.5, 2.0) * SR)
        env[pos:pos + m] = 10.0 ** ((-38.0 if k % 2 == 0 else -14.0) / 20.0)
        pos, k = pos + m, k + 1
    t = np.arange(n) / SR
    tone = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 3000 * t)
    cols = [(tone * (1.0 - 0.2 * c) + 0.3 * rng.standard_normal(n))
            / np.sqrt(0.625 + 0.09) for c in range(2)]
    x = env[:, None] * np.stack(cols, 1)
    return (np.clip(np.rint(x * FULL), -FULL, FULL - 1) / FULL).astype(
        np.float32)


def _edge_bound(n: int, lsb: bool) -> np.ndarray:
    """Per-sample tolerance [n, 1]: 4 LSB or 1e-5, plus 2e-7/win[k] on the
    stream's first and last hop."""
    b = np.full(n, 4.0 / FULL if lsb else 1e-5)
    k0, F = ad.frame_window(n, 4096, HOP)
    base = k0 * HOP - 2048
    end = base + (F - 1) * HOP + 4096
    extra = 2e-7 / np.maximum(np.hanning(4096)[:HOP], 1e-30)
    for k in range(1, HOP):
        for pos in (base + k, end - 1 - k):
            if 0 <= pos < n:
                b[pos] += extra[k]
    return (b * FULL if lsb else b)[:, None]


def _held(r) -> np.ndarray:
    """Per sample, False under a masked frame."""
    keep = np.ones(len(r["y"]), bool)
    for j in np.nonzero(r["masked"])[0]:
        s = r["starts"][j]
        keep[max(0, s):s + 4096] = False
    return keep


def _gaps(y, r, lsb: bool) -> dict:
    """What the bounds compare, as {name: passes}."""
    if lsb:
        gap = np.abs(y.astype(np.int64) - r["pcm"])
        inner = 4.0
    else:
        gap = np.abs(y.astype(np.float64) - r["y"])
        inner = 1e-5
    keep = _held(r)[:, None]
    bound = _edge_bound(len(gap), lsb)
    lo, hi = HOP, r["last_cut"]
    return {"edges": bool(np.all((gap <= bound) | ~keep)),
            "inner": bool(np.all((gap[lo:hi] <= inner) | ~keep[lo:hi]))}


# (seconds, seed); the last is a whole number of hops
CASES = [(3.0, 1), (5.5, 2), (8.0, 3), (HOP * 150 / SR, 4)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]:.3f}s-seed{c[1]}")
def case(request, tmp_path_factory):
    seconds, seed = request.param
    x = _programme(seconds, seed)
    d = tmp_path_factory.mktemp("plainref")
    ip, op, cp = d / "in.flac", d / "out.flac", d / "s.csv"
    audio.write(ip, x, SR, subtype="PCM_24")
    stats = ad.process(ip, op, ad.AdaptiveParams(), state_csv_path=cp,
                       frames_per_chunk=32, device="cpu")
    y_arr, info = ad.process_array(x, SR, ad.AdaptiveParams(),
                                   frames_per_chunk=32, device="cpu")
    y_file, _ = audio.read(op)
    with open(cp, newline="") as f:
        rows = list(csv.DictReader(f))
    r = ref.render(x.astype(np.float64), CONFIG)
    return dict(x=x, stats=stats, y_arr=y_arr, info=info, rows=rows,
                pcm=np.rint(y_file.astype(np.float64) * FULL), r=r)


def test_gate_levels_and_threshold(case):
    r, info, stats = case["r"], case["info"], case["stats"]
    held = ~r["masked"]
    assert len(r["levels"]) == info["n_frames"] == stats["n_frames"]
    assert np.array_equal(info["states"][held], r["states"][held])
    assert np.abs(info["levels"] - r["levels"]).max() <= 1e-4
    assert abs(stats["optimal_threshold"] - r["search"]["threshold"]) <= 1e-3
    assert abs(info["optimal_threshold"] - r["search"]["threshold"]) <= 1e-3
    assert 0 < np.mean(r["states"] == 2) < 1
    assert stats["search_probes"] == info["search_probes"] >= 1


def test_state_csv_as_printed(case):
    r, rows = case["r"], case["rows"]
    held = ~r["masked"]
    assert [int(w["frame_idx"]) for w in rows] == list(r["csv_frame_idx"])
    got = np.array([w["state"] for w in rows])
    want = np.where(r["states"] == 2, "C2", "C1")
    assert np.array_equal(got[held], want[held])
    alpha = np.array([w["alpha"] for w in rows])
    assert np.array_equal(alpha[held],
                          np.array(["%.4f" % a for a in r["alpha"]])[held])
    # the level to 1e-4 dB, printed to 4 decimals
    lv = np.array([float(w["level_dbfs"]) for w in rows])
    assert np.abs(lv - r["levels"]).max() <= 1e-4 + 5e-5


def test_samples_file_and_array(case):
    r = case["r"]
    assert case["pcm"].shape == r["pcm"].shape
    assert _gaps(case["pcm"], r, lsb=True) == {"edges": True, "inner": True}
    assert _gaps(case["y_arr"], r, lsb=False) == {"edges": True,
                                                  "inner": True}


def test_bfloat16_reference_fails_the_bounds(case):
    """The reference computed in bfloat16, in the port's place, fails at
    least one of the bounds above on every case."""
    r, low = case["r"], ref.render(case["x"].astype(np.float64), CONFIG,
                                   precision.bfloat16)
    held = ~r["masked"]
    fails = {
        "states": not np.array_equal(low["states"][held], r["states"][held]),
        "levels": np.abs(low["levels"] - r["levels"]).max() > 1e-4,
        "threshold": abs(low["search"]["threshold"]
                         - r["search"]["threshold"]) > 1e-3,
        "file": _gaps(low["pcm"], r, lsb=True) != {"edges": True,
                                                   "inner": True},
        "array": _gaps(low["y"], r, lsb=False) != {"edges": True,
                                                   "inner": True},
    }
    assert fails["levels"] and fails["file"] and fails["array"], fails
