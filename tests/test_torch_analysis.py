"""The port's analysis stage (tomatis_tpu_torch/analysis/) against the JAX
package's on the same files and arrays, on the CPU.

Tolerances: alignment delays equal (the same numpy/scipy code); spectra,
levels and tilts <= 1e-3 dB (float32 FFT and sums in another order);
clustering helpers equal (numpy copies); the grid gate's mismatch counts,
switch counts and chosen combination equal on equal inputs (the
simulation is integer and comparison logic, nothing to round), its scores
to 1 ulp; the
calibrators' T within 1e-3 dB and hyst/up_ms equal; the analyze_eq curve
<= 1e-3 dB.
"""
import json

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tests.oracle import refdsp
from tomatis_tpu.analysis import align as jalign
from tomatis_tpu.analysis import analyze_eq as janalyze
from tomatis_tpu.analysis import calibrate as jcal
from tomatis_tpu.analysis import compare as jcompare
from tomatis_tpu.analysis import features as jfeatures
from tomatis_tpu.analysis import gridgate as jgrid
from tomatis_tpu.analysis import spectra as jspectra
from tomatis_tpu_torch.analysis import (align, analyze_eq, calibrate, compare,
                                        features, gridgate, spectra)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.standard import StandardParams, process_array

torch.set_num_threads(2)

SR = 48000
TRUE_T = -30.0
COLOR = [(30, -3.0), (200, 4.0), (1000, 0.0), (4000, -5.0), (16000, -8.0)]


def _music(seconds=24.0, seed=7):
    """Broadband, percussive, level swinging across the gate threshold."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    noise = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    amp = np.full(n, 0.004, np.float32)
    pos = 0
    while pos < n:
        dur = int(SR * rng.uniform(0.15, 0.6))
        peak = 0.05 * 10 ** (0.5 * rng.standard_normal())
        seg = min(dur, n - pos)
        amp[pos:pos + seg] += peak * np.exp(-np.arange(seg) / (0.25 * SR))
        pos += dur
    x = amp * noise
    return np.clip(np.stack([x, 0.95 * x], 1), -1, 1).astype(np.float32)


def _colorize(x, gains_db_at):
    n = len(x)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    fs, dbs = zip(*gains_db_at)
    g = 10 ** (np.interp(np.log10(np.maximum(freqs, 1)),
                         np.log10(fs), dbs) / 20.0)
    y = np.empty_like(x)
    for c in range(x.shape[1]):
        y[:, c] = np.fft.irfft(np.fft.rfft(x[:, c]) * g, n)
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(orig path, device path, x, device array): the device rendition is
    the port's standard processor at a known threshold, -6 dB, coloured,
    starting 0.4 s late."""
    tmp = tmp_path_factory.mktemp("ana")
    x = _music()
    p = StandardParams(gate_ui=50.0, gate_mode="linear",
                       gate_offset=TRUE_T - 50.0, hysteresis_db=2.0,
                       up_delay_ms=0.0, c1_low=9.0, c1_high=-9.0,
                       c2_low=-9.0, c2_high=9.0, require_48k_stereo=False,
                       output_gain_db=-6.0)
    y, _ = process_array(x, SR, p, frames_per_chunk=64, device="cpu")
    y = _colorize(y, COLOR)
    off = int(0.4 * SR)
    op, bp = tmp / "orig.flac", tmp / "device.flac"
    audio.write(op, x, SR, subtype="PCM_24")
    audio.write(bp, np.clip(y[off:], -1, 1), SR, subtype="PCM_24")
    return op, bp, x, y[off:]


# ---------------------------------------------------------------------------
# align, compare delays
# ---------------------------------------------------------------------------

def test_align_delay_equal(pair):
    op, bp, x, y = pair
    d_t = align.find_delay_by_corr(op, bp, sr=SR)
    d_j = jalign.find_delay_by_corr(op, bp, sr=SR)
    assert d_t == d_j
    assert abs(d_t - int(0.4 * SR)) < SR * 0.03
    xo_t, xb_t = align.read_aligned_overlap(op, bp, d_t, 10.0, SR)
    xo_j, xb_j = jalign.read_aligned_overlap(op, bp, d_j, 10.0, SR)
    np.testing.assert_array_equal(xo_t, xo_j)
    np.testing.assert_array_equal(xb_t, xb_j)
    np.testing.assert_array_equal(align.power_mono(x), jalign.power_mono(x))
    assert align.rms_dbfs_mono(x[:, 0]) == jalign.rms_dbfs_mono(x[:, 0])


def test_align_refuses_a_short_orig(tmp_path, pair):
    op, bp, x, _ = pair
    short = tmp_path / "short.flac"
    audio.write(short, x[:SR * 5], SR, subtype="PCM_24")
    with pytest.raises(ValueError, match="too short"):
        align.find_delay_by_corr(short, bp, sr=SR)


def test_compare_delay_and_align_pair_equal(pair):
    _, _, x, y = pair
    bm, cm = align.power_mono(y), align.power_mono(x)
    d_t = compare.find_delay_full(bm, cm, SR)
    assert d_t == jcompare.find_delay_full(bm, cm, SR)
    for d in (d_t, -d_t, 0):
        a_t, b_t = compare.align_pair(y, x, d)
        a_j, b_j = jcompare.align_pair(y, x, d)
        np.testing.assert_array_equal(a_t, a_j)
        np.testing.assert_array_equal(b_t, b_j)


# ---------------------------------------------------------------------------
# spectra, features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop", [(4096, 2048), (8192, 4096)])
def test_logpower_median(pair, n_fft, hop):
    x = pair[2][:SR * 12]
    f_t, med_t, used_t = spectra.logpower_median(x, SR, n_fft, hop, -65.0,
                                                 device="cpu")
    f_j, med_j, used_j = jspectra.logpower_median(x, SR, n_fft, hop, -65.0)
    np.testing.assert_array_equal(f_t, f_j)
    assert used_t == used_j
    assert med_t.dtype == np.float32
    assert np.abs(med_t - med_j).max() <= 1e-3        # dB


def test_logpower_median_refusals(pair):
    x = pair[2]
    with pytest.raises(ValueError, match="too short"):
        spectra.logpower_median(x[:4096 * 4], SR, 4096, 2048, -65.0,
                                device="cpu")
    with pytest.raises(ValueError, match="too few music frames"):
        spectra.logpower_median(x[:SR * 4], SR, 4096, 2048, 0.0,
                                device="cpu")


def test_mag_avg_and_band_helpers(pair):
    mono = align.power_mono(pair[2][:SR * 8])
    m_t = spectra.mag_avg(mono, 4096, 2048, device="cpu")
    m_j = jspectra.mag_avg(mono, 4096, 2048)
    assert m_t.shape == m_j.shape
    assert np.abs(20 * np.log10((m_t + 1e-12) / (m_j + 1e-12))).max() <= 1e-3
    freqs = np.fft.rfftfreq(4096, 1 / SR).astype(np.float32)
    assert spectra.band_energy(m_j, freqs, 300, 3000) == \
        jspectra.band_energy(m_j, freqs, 300, 3000)
    delta = np.random.default_rng(0).normal(0, 8, len(freqs)) \
        .astype(np.float32)
    d_t, a_t = spectra.anchored_delta(delta, freqs, 300, 3000, 12.0)
    d_j, a_j = jspectra.anchored_delta(delta, freqs, 300, 3000, 12.0)
    np.testing.assert_array_equal(d_t, d_j)
    assert a_t == a_j


def test_frame_features(pair):
    op, bp, _, _ = pair
    d = align.find_delay_by_corr(op, bp, sr=SR)
    xo, xb = align.read_aligned_overlap(op, bp, d, 15.0, SR)
    got = features.frame_features(xo, xb, SR, 4096, 2048, device="cpu")
    want = jfeatures.frame_features(xo, xb, SR, 4096, 2048)
    for g, w, name in zip(got[:3], want[:3], ("orig", "base", "tilt")):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-3, name       # dB
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].dtype == np.int64


def test_clustering_helpers_equal():
    rng = np.random.default_rng(4)
    tilts = np.r_[rng.normal(-6, 1, 200), rng.normal(5, 1.5, 150)] \
        .astype(np.float32)
    rng.shuffle(tilts)
    lab_t, a_t, b_t = features.kmeans2_1d(tilts)
    lab_j, a_j, b_j = jfeatures.kmeans2_1d(tilts)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert (a_t, b_t) == (a_j, b_j)
    st_t = features.tilt_to_states(tilts)
    np.testing.assert_array_equal(st_t, jfeatures.tilt_to_states(tilts))
    for min_run in (2, 3, 5):
        np.testing.assert_array_equal(
            features.debounce_state(st_t, min_run),
            jfeatures.debounce_state(st_t, min_run))


# ---------------------------------------------------------------------------
# grid gate
# ---------------------------------------------------------------------------

def _grid_case(gapped: bool, seed=0, n=400):
    rng = np.random.default_rng(seed)
    levels = (-45 + 25 * rng.random(n)).astype(np.float32)
    idx = np.arange(n)
    if gapped:                      # music-masked frames: holes in starts
        idx = np.flatnonzero(rng.random(n * 2) > 0.45)[:n]
    starts = (idx * 2048).astype(np.int64)
    tgt = (1 + (rng.random(n) > 0.5)).astype(np.int32)
    combos = [dict(T=float(T), hyst=float(h), up_ms=float(u))
              for u in (0, 50, 130, 250) for h in (0, 1, 2.5, 6)
              for T in np.arange(-42, -22, 1.5)]
    return levels, starts, tgt, combos


def _lanes(combos):
    tons = np.array([c["T"] + c["hyst"] / 2 for c in combos], np.float32)
    toffs = np.array([c["T"] - c["hyst"] / 2 for c in combos], np.float32)
    ups = np.array([int(round(SR * c["up_ms"] / 1000)) for c in combos],
                   np.int32)
    return tons, toffs, ups


@pytest.mark.parametrize("gapped", [False, True])
def test_grid_gate_equals_reference(gapped):
    levels, starts, tgt, combos = _grid_case(gapped)
    tons, toffs, ups = _lanes(combos)
    s_t, m_t, w_t = gridgate.grid_gate_scores(
        levels, starts.astype(np.int32), tons, toffs, ups, 1e-5, tgt,
        device="cpu")
    s_j, m_j, w_j = (np.asarray(a) for a in jgrid.grid_gate_scores(
        levels, starts.astype(np.int32), tons, toffs, ups,
        np.float32(1e-5), tgt))
    np.testing.assert_array_equal(w_t, w_j)               # switches
    np.testing.assert_array_equal(m_t, m_j)               # mismatch rates
    # scores: mismatch + penalty*switches, each step rounded to float32
    # here; XLA's CPU compiler contracts its multiply-add into one fma, so
    # its scores may differ in the last bit (1 ulp of 0.5 is 6e-8)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1.2e-7)
    assert s_t.dtype == np.float32 and w_t.dtype == np.int32
    best_t = gridgate.grid_search(levels, starts, tgt, combos, SR, 1e-5,
                                  device="cpu")
    best_j = jgrid.grid_search(levels, starts, tgt, combos, SR, 1e-5)
    assert {k: best_t[k] for k in ("T", "hyst", "up_ms", "switches")} == \
        {k: best_j[k] for k in ("T", "hyst", "up_ms", "switches")}
    assert best_t["mismatch"] == best_j["mismatch"]
    assert best_t["score"] == pytest.approx(best_j["score"], abs=1.2e-7)


def test_grid_gate_matches_loop_oracle():
    levels, starts, _, combos = _grid_case(False)
    tgt = np.ones(len(levels), np.int32)
    tons, toffs, ups = _lanes(combos[::7])
    _, mism, sw = gridgate.grid_gate_scores(
        levels, starts.astype(np.int32), tons, toffs, ups, 0.0, tgt,
        device="cpu")
    for i, c in enumerate(combos[::7]):
        ref = refdsp.gate_updelay_loop(
            levels, c["T"] + c["hyst"] / 2, c["T"] - c["hyst"] / 2,
            int(round(SR * c["up_ms"] / 1000)), 2048)
        assert abs(mism[i] - np.mean(ref != tgt)) < 1e-6, c
        assert sw[i] == int(np.sum(ref[1:] != ref[:-1])), c


def test_grid_search_batched_equals_rows():
    """The batch axis (the v2 calibrator's gain-shifted level tracks) gives
    each row what a grid_search of its own gives, also with combo lists of
    unequal length."""
    levels, starts, tgt, combos = _grid_case(True, seed=3)
    rows = [levels + np.float32(g) for g in (-1.5, 0.0, 2.0)]
    combos_b = [[dict(c, T=c["T"] + g, gain_db=g) for c in combos][:n]
                for g, n in zip((-1.5, 0.0, 2.0),
                                (len(combos), len(combos) - 3, len(combos)))]
    got = gridgate.grid_search_batched(rows, starts, tgt, combos_b, SR,
                                       1e-5, device="cpu")
    for lv, cb, g in zip(rows, combos_b, got):
        assert g == gridgate.grid_search(lv, starts, tgt, cb, SR, 1e-5,
                                         device="cpu")


# ---------------------------------------------------------------------------
# calibrators, analyzer, comparator
# ---------------------------------------------------------------------------

def test_calibrate_v2_equals_reference(pair, tmp_path):
    op, bp, _, _ = pair
    kw = dict(gate_ui=50.0, max_minutes=1.0)
    r_t = calibrate.calibrate_v2(op, bp, out_json=str(tmp_path / "t.json"),
                                 device="cpu", **kw)
    r_j = jcal.calibrate_v2(op, bp, out_json=str(tmp_path / "j.json"), **kw)
    assert r_t["delay_samples_orig_minus_base"] == \
        r_j["delay_samples_orig_minus_base"]
    assert r_t["hyst_db"] == r_j["hyst_db"]
    assert r_t["up_delay_ms"] == r_j["up_delay_ms"]
    assert r_t["switches"] == r_j["switches"]
    assert r_t["mismatch"] == pytest.approx(r_j["mismatch"], abs=1e-6)
    for k in ("T_raw_dbfs", "T_adj_dbfs", "gate_offset",
              "gain_db_base_minus_orig", "gain_db0"):
        assert abs(r_t[k] - r_j[k]) <= 1e-3, k            # dB
    assert abs(r_t["T_raw_dbfs"] - TRUE_T) <= 2.0
    saved_t = json.load(open(tmp_path / "t.json"))
    saved_j = json.load(open(tmp_path / "j.json"))
    assert set(saved_t) == set(saved_j)
    assert set(r_t["timings"]) == {"align_read_s", "features_s",
                                   "grid_gate_s"}


def test_calibrate_v1_equals_reference(pair, tmp_path):
    op, bp, _, _ = pair
    kw = dict(gate_ui=50.0, max_minutes=1.0, search_t=(-40.0, -20.0, 1.0),
              hyst_list=(0, 2, 4), delay_list_ms=(0, 100))
    r_t = calibrate.calibrate_v1(op, bp, out_json=str(tmp_path / "t.json"),
                                 device="cpu", **kw)
    r_j = jcal.calibrate_v1(op, bp, out_json=str(tmp_path / "j.json"), **kw)
    for k in ("gate_offset", "hyst_db", "up_delay_ms", "gate_ui",
              "delay_samples"):
        assert r_t[k] == r_j[k], k
    assert r_t["best"]["switches"] == r_j["best"]["switches"]
    assert r_t["best"]["mismatch"] == pytest.approx(r_j["best"]["mismatch"],
                                                    abs=1e-6)
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


def test_analyze_eq_equals_reference(pair, tmp_path):
    op, bp, _, _ = pair
    r_t = analyze_eq.analyze_eq(bp, op, out_csv=str(tmp_path / "t.csv"),
                                out_png=None, max_minutes=1.0, device="cpu")
    r_j = janalyze.analyze_eq(bp, op, out_csv=str(tmp_path / "j.csv"),
                              out_png=None, max_minutes=1.0)
    assert r_t["delay_samples"] == r_j["delay_samples"]
    assert r_t["used_frames_base"] == r_j["used_frames_base"]
    assert r_t["used_frames_target"] == r_j["used_frames_target"]
    assert abs(r_t["anchor_db"] - r_j["anchor_db"]) <= 1e-3
    np.testing.assert_array_equal(r_t["freqs"], r_j["freqs"])
    assert np.abs(r_t["delta_raw"] - r_j["delta_raw"]).max() <= 1e-3
    assert np.abs(r_t["delta_smooth"] - r_j["delta_smooth"]).max() <= 1e-3
    head_t = open(tmp_path / "t.csv").readline().strip()
    assert head_t == open(tmp_path / "j.csv").readline().strip() == \
        "freq_hz,delta_db_raw,delta_db_smooth"
    a = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1e-3


def test_analyze_eq_plot_is_optional(pair, tmp_path, monkeypatch):
    """out_png on a machine without matplotlib: no plot, no error."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    op, bp, _, _ = pair
    res = analyze_eq.analyze_eq(bp, op, out_csv=None,
                                out_png=str(tmp_path / "c.png"),
                                max_minutes=0.3, device="cpu")
    assert not (tmp_path / "c.png").exists()
    assert res["out_csv"] is None and len(res["delta_smooth"]) == 4097


def test_compare_audio_equals_reference(pair, tmp_path):
    op, bp, _, _ = pair
    r_t = compare.compare_audio(bp, op, sr=SR,
                                out_csv=str(tmp_path / "t.csv"),
                                device="cpu")
    r_j = jcompare.compare_audio(bp, op, sr=SR,
                                 out_csv=str(tmp_path / "j.csv"))
    assert r_t["delay_samples"] == r_j["delay_samples"]
    assert abs(r_t["anchor_gain_db"] - r_j["anchor_gain_db"]) <= 1e-3
    assert abs(r_t["snr_db"] - r_j["snr_db"]) <= 1e-3
    assert set(r_t["bands"]) == set(r_j["bands"])
    for band in r_t["bands"]:
        for k in ("mean", "std"):
            assert abs(r_t["bands"][band][k] - r_j["bands"][band][k]) \
                <= 1e-3, (band, k)
    # bins with almost no energy (below the 30 Hz corner) are noise on
    # both sides; hold the audible band
    sel = r_t["freqs"] >= 50
    assert np.abs(r_t["diff_db"] - r_j["diff_db"])[sel].max() <= 1e-3
    assert open(tmp_path / "t.csv").readline().strip() == \
        "freq_hz,delta_db_base_minus_cand"


def test_compare_audio_refusals(pair, tmp_path):
    op, bp, x, _ = pair
    mono = tmp_path / "m.wav"
    audio.write(mono, x[:SR, :1], SR, subtype="PCM_24")
    with pytest.raises(ValueError, match="stereo"):
        compare.compare_audio(mono, op, device="cpu")
    with pytest.raises(ValueError, match="expected 44100"):
        compare.compare_audio(bp, op, sr=44100, device="cpu")


def test_default_device_raises_without_card(pair):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    op, bp, x, _ = pair
    mono = align.power_mono(x[:SR])
    for call in (
            lambda: spectra.mag_avg(mono),
            lambda: spectra.logpower_median(x, SR, 4096, 2048, -65.0),
            lambda: features.frame_features(x, x, SR, 4096, 2048),
            lambda: gridgate.grid_gate_scores(
                mono[:4], np.arange(4), [0.0], [0.0], [0], 0.0,
                np.ones(4, np.int32)),
            lambda: calibrate.calibrate_v2(op, bp, out_json=None),
            lambda: calibrate.calibrate_v1(op, bp, out_json=None),
            lambda: analyze_eq.analyze_eq(bp, op, out_csv=None,
                                          out_png=None),
            lambda: compare.compare_audio(bp, op, out_csv=None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
