"""The port's verifiers (tomatis_tpu_torch/verify/) against the JAX package's
on the same files, on the CPU: validate, verify-15db, verify-15db-v2, the
tilt-amplitude verifier and the case study's pieces.

The files are 8-second seeded signals processed by the port on the CPU;
both verifiers read the same files. Tolerances: verdicts, booleans and
counts equal; frame levels within 1e-4 dB (torch and XLA sum the mean of
squares in different orders, a few 1e-6 dB apart); conditional spectra
within 1e-3 dB per bin over 20 Hz-20 kHz on validate's white-noise
signal, 1e-2 dB on the verify-15db signals; RMSEs, platform means, fc
errors and Tilt-Index statistics within 1e-3 dB; find_optimal_threshold
exactly.

The verify-15db signals are AR(1) noise under three tones: in their quiet
(C1) frames the bins between the tones sit 60-80 dB under the strongest
one, where the rounding of torch's and XLA's CPU FFTs (about 1e-7 of the
strongest bin) moves a per-frame ratio by up to 5e-3 dB
(test_verify_15db_matches_jax,
test_verify_v2_on_adaptive_output_matches_jax). The per-bin medians
inherit that; the metrics, means over hundreds of bins, do not.
"""
import sys

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tomatis_tpu.verify import case_study as jcase
from tomatis_tpu.verify import tilt_amplitude as jtilt
from tomatis_tpu.verify import validate_layer1 as jl1
from tomatis_tpu.verify import verify_15db as j15
from tomatis_tpu.verify import verify_15db_v2 as j15v2
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import adaptive, standard
from tomatis_tpu_torch.verify import case_study
from tomatis_tpu_torch.verify import tilt_amplitude
from tomatis_tpu_torch.verify import validate_layer1 as l1
from tomatis_tpu_torch.verify import verify_15db as v15
from tomatis_tpu_torch.verify import verify_15db_v2 as v15v2

torch.set_num_threads(2)

SR = 48000
DB = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _no_plots():
    """The PNGs are optional (each plot is skipped when matplotlib cannot
    be imported); these tests do without the minute a first matplotlib
    import can spend on its font cache."""
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        yield


def _l1_signal(seconds=8.0, seed=5):
    """tests/test_validate.py's signal: tones plus noise, 0.5 Hz on/off."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.002 + 0.12 * (np.sin(2 * np.pi * 0.5 * t) > 0)
    x = env * (np.sin(2 * np.pi * 300 * t) + 0.7 * np.sin(2 * np.pi * 1000 * t)
               + 0.5 * np.sin(2 * np.pi * 4000 * t)
               + 0.1 * rng.standard_normal(n))
    return np.clip(np.stack([x, 0.9 * x], 1), -1, 1).astype(np.float32)


def _broadband(seconds=8.0, seed=9, quiet=0.002, loud=0.04):
    """tests/test_verify_15db.py's signal: coloured noise and tones."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = quiet + loud * (np.sin(2 * np.pi * 0.45 * t) > 0)
    noise = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    x = env * (0.6 * noise + np.sin(2 * np.pi * 330 * t)
               + 0.6 * np.sin(2 * np.pi * 1000 * t)
               + 0.4 * np.sin(2 * np.pi * 5000 * t))
    return np.clip(np.stack([x, 0.95 * x], 1), -1, 1).astype(np.float32)


L1_PARAMS = dict(gate_ui=40.0, gate_mode="linear", gate_offset=-61.08,
                 hysteresis_db=1.0, up_delay_ms=0.0, c1_low=5.0,
                 c1_high=-5.0, c2_low=-5.0, c2_high=5.0)
GATE = dict(gate_ui=40.0, gate_scale=1.0, gate_offset=-75.0,
            hyst_db=1.0, up_delay_ms=0.0)   # T = -35 dBFS


@pytest.fixture(scope="module")
def l1_files(tmp_path_factory):
    """Input, port-processed output and state CSV for validate."""
    d = tmp_path_factory.mktemp("l1")
    ip, op, cp = d / "in.flac", d / "out.flac", d / "state.csv"
    audio.write(ip, _l1_signal(), SR, subtype="PCM_24")
    standard.process(ip, op, standard.StandardParams(**L1_PARAMS),
                     state_csv_path=cp, device="cpu")
    return d, ip, op, cp


@pytest.fixture(scope="module")
def v15_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("v15")
    ip, op = d / "in.flac", d / "out.flac"
    audio.write(ip, _broadband(), SR, subtype="PCM_24")
    standard.process(ip, op, standard.StandardParams(
        gate_mode="linear", gate_ui=40.0, gate_offset=-75.0,
        hysteresis_db=1.0, up_delay_ms=0.0), device="cpu")
    return d, ip, op


def _assert_same_checks(a: dict, b: dict, tol=DB):
    """Every key of two result dicts: bools, ints and strings equal,
    floats within tol, lists elementwise."""
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            _assert_same_checks(va, vb, tol)
        elif isinstance(va, (bool, np.bool_, int, np.integer, str)):
            assert va == vb, (k, va, vb)
        elif isinstance(va, (list, tuple)):
            np.testing.assert_allclose(va, vb, atol=tol, err_msg=k)
        else:
            assert abs(float(va) - float(vb)) <= tol, (k, va, vb)


def _spectrum_csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1)


def _assert_spectrum_bins(f, a, b, tol=DB):
    """Per-bin dB values over 20 Hz-20 kHz."""
    band = (f >= 20) & (f <= 20000)
    np.testing.assert_allclose(a[band], b[band], atol=tol)


def _assert_spectra_close(pa, pb, tol=DB):
    """Two spectrum CSVs: the same bins, values within tol plus the
    1e-4 of their 4 printed decimals."""
    a, b = _spectrum_csv(pa), _spectrum_csv(pb)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    _assert_spectrum_bins(a[:, 0], a[:, 1:], b[:, 1:], tol + 1e-4)


# -- validate ---------------------------------------------------------------

def test_validate_matches_jax(l1_files):
    d, ip, op, cp = l1_files
    res = l1.validate(ip, op, cp, gate_ui=40.0, out_csv=str(d / "p.csv"),
                      out_png=None, device="cpu")
    ref = jl1.validate(ip, op, cp, gate_ui=40.0, out_csv=str(d / "j.csv"),
                       out_png=None)
    assert res["pass"] and ref["pass"]
    # level agreement is the port's own CSV against each recomputation
    for k in ("level_max_diff", "level_mean_diff"):
        assert res["checks"]["gate"][k] <= 1e-4
        assert ref["checks"]["gate"][k] <= 1e-4
        res["checks"]["gate"].pop(k), ref["checks"]["gate"].pop(k)
    _assert_same_checks(res["checks"], ref["checks"])
    assert res["threshold_dbfs"] == ref["threshold_dbfs"]
    _assert_spectra_close(d / "p.csv", d / "j.csv")
    assert set(res["timings"]) == {"decode_s", "gate_s", "spectrum_s",
                                   "artifacts_s"}


@pytest.mark.parametrize("n_fft,hop", [(4096, 2048), (1024, 384)])
def test_gate_and_conditional_spectrum_match_jax(l1_files, n_fft, hop):
    """The recomputed gate and the conditional spectrum on the same states;
    1024/384 puts the level framing off the sample grid's hop multiples
    (off = 256), which the spectrum's frame starts must follow."""
    _, ip, op, _ = l1_files
    x, _ = audio.read(ip)
    y, _ = audio.read(op)
    thr = 40.0 - 61.08
    st, lv = l1.simulate_gate(x, SR, n_fft, hop, thr, 1.0, 50.0,
                              device="cpu")
    jst, jlv = jl1.simulate_gate(x, SR, n_fft, hop, thr, 1.0, 50.0)
    assert st == jst and len(lv) == len(jlv) > 0
    np.testing.assert_allclose(lv, jlv, atol=1e-4)
    f, c1, c2, n1, n2 = l1.conditional_spectrum(x, y, SR, jst, n_fft, hop,
                                                batch=64, device="cpu")
    jf, jc1, jc2, jn1, jn2 = jl1.conditional_spectrum(x, y, SR, jst, n_fft,
                                                      hop)
    assert (n1, n2) == (jn1, jn2) and n1 > 0 and n2 > 0
    np.testing.assert_array_equal(f, jf)
    _assert_spectrum_bins(f, c1, jc1)
    _assert_spectrum_bins(f, c2, jc2)


def test_validate_off_grid_framing_matches_jax(l1_files):
    """A whole validate run at n_fft 1024, hop 384 (off != 0): the state
    CSV was written at 4096/2048, so the gate check fails on both sides,
    with the same counts."""
    d, ip, op, cp = l1_files
    kw = dict(gate_ui=40.0, n_fft=1024, hop=384, out_png=None)
    res = l1.validate(ip, op, cp, out_csv=str(d / "po.csv"), device="cpu",
                      **kw)
    ref = jl1.validate(ip, op, cp, out_csv=str(d / "jo.csv"), **kw)
    assert res["pass"] == ref["pass"]
    g, jg = res["checks"]["gate"], ref["checks"]["gate"]
    for k in ("total_frames", "mismatch_count", "csv_switches",
              "sim_switches", "pass"):
        assert g[k] == jg[k], k
    _assert_same_checks(res["checks"]["spectrum"], ref["checks"]["spectrum"])
    _assert_spectra_close(d / "po.csv", d / "jo.csv")


def test_validate_fails_on_wrong_csv(l1_files, tmp_path):
    """tests/test_validate.py's flipped-state CSV, on the port."""
    _, ip, op, cp = l1_files
    lines = open(cp).read().splitlines()
    flipped = [lines[0]]
    for ln in lines[1:]:
        parts = ln.split(",")
        parts[3] = "C2" if parts[3] == "C1" else "C1"
        flipped.append(",".join(parts))
    bad = tmp_path / "bad.csv"
    bad.write_text("\n".join(flipped))
    res = l1.validate(ip, op, bad, gate_ui=40.0, out_csv=None, out_png=None,
                      device="cpu")
    assert not res["checks"]["gate"]["pass"] and not res["pass"]
    ref = jl1.validate(ip, op, bad, gate_ui=40.0, out_csv=None, out_png=None)
    assert res["checks"]["gate"]["mismatch_count"] == \
        ref["checks"]["gate"]["mismatch_count"]


def test_port_cli_process_then_validate_passes(tmp_path, capsys):
    """The port's `process` then its `validate` with no parameter flag: the
    sidecar alone drives the verifier; exit 0 and the reference layout."""
    rng = np.random.default_rng(11)
    n = 8 * SR
    amp = np.full(n, 0.005)
    amp[int(2.5 * SR):int(5.5 * SR)] = 0.05
    x = np.clip(0.4 * rng.standard_normal((n, 2)) * amp[:, None],
                -0.98, 0.98).astype(np.float32)
    ip, op, cp = (str(tmp_path / f) for f in ("in.flac", "out.flac", "s.csv"))
    audio.write(ip, x, SR, subtype="PCM_24")
    assert cli_main.main(["process", "-i", ip, "-o", op, "--state_csv", cp,
                          "--gate_ui", "50", "--gate_mode", "log_percent",
                          "--device", "cpu"]) == 0
    capsys.readouterr()
    rc = cli_main.main(["validate", "-i", ip, "-o", op, "--state_csv", cp,
                        "--out_csv", str(tmp_path / "spec.csv"),
                        "--out_png", str(tmp_path / "spec.png"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "params loaded from out.flac.params.json" in out
    assert "Layer1 验证: PASS" in out and "D. 条件频谱验证" in out


# -- verify-15db ------------------------------------------------------------

def test_verify_15db_matches_jax(v15_files):
    d, ip, op = v15_files
    res = v15.verify(ip, op, out_prefix=str(d / "p"), device="cpu", **GATE)
    ref = j15.verify(ip, op, out_prefix=str(d / "j"), **GATE)
    assert res["pass"] and ref["pass"]
    assert res["checks"]["tilt_index"]["ti_effect"] > 5.0
    _assert_same_checks(res["checks"], ref["checks"])
    assert res["platform_freqs"] == ref["platform_freqs"]
    _assert_spectra_close(d / "p_spectrum.csv", d / "j_spectrum.csv", 1e-2)
    rep = open(d / "p_report.txt", encoding="utf-8").read()
    assert rep.startswith("Tomatis ±15dB 验证报告") and "总体结果: PASS" in rep
    assert rep == open(d / "j_report.txt", encoding="utf-8").read()
    assert set(res["timings"]) == {"decode_s", "gate_s", "spectrum_s",
                                   "tilt_s", "artifacts_s"}


def test_verify_15db_fails_on_passthrough(tmp_path):
    x = _broadband(5.0)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    audio.write(op, x, SR, subtype="PCM_24")     # an unprocessed copy
    res = v15.verify(ip, op, out_prefix=None, device="cpu", **GATE)
    ref = j15.verify(ip, op, out_prefix=None, **GATE)
    assert not res["checks"]["spectrum"]["pass"] and not res["pass"]
    assert res["checks"]["tilt_index"].get("ti_effect", 0.0) < 5.0
    _assert_same_checks(res["checks"], ref["checks"])


def test_tilt_index_off_grid_matches_jax(v15_files):
    _, ip, op = v15_files
    x, _ = audio.read(ip)
    y, _ = audio.read(op)
    states, _ = jl1.simulate_gate(x, SR, 1024, 384, -35.0, 1.0, 0.0)
    ti = v15.compute_tilt_index(x, y, SR, states, 1024, 384, device="cpu")
    jti = j15.compute_tilt_index(x, y, SR, states, 1024, 384)
    for k in ti:
        assert len(ti[k]) == len(jti[k]) > 0, k
        np.testing.assert_allclose(ti[k], jti[k], atol=DB)


# -- verify-15db-v2 ---------------------------------------------------------

@pytest.mark.parametrize("target,hyst,delay", [(0.5, 1.0, 0), (0.3, 3.0, 0),
                                               (0.7, 2.0, 4)])
def test_find_optimal_threshold_equals_jax(target, hyst, delay):
    rng = np.random.default_rng(1)
    levels = np.concatenate([rng.normal(-50, 2, 500),
                             rng.normal(-25, 2, 500)]).astype(np.float32)
    rng.shuffle(levels[200:800])
    got = v15v2.find_optimal_threshold(levels, hyst, target, delay,
                                       device="cpu")
    want = j15v2.find_optimal_threshold(levels, hyst, target, delay)
    assert got == want
    assert v15v2.simulate_gate_frames(levels, got[0], hyst, delay,
                                      device="cpu") == \
        j15v2.simulate_gate_frames(levels, want[0], hyst, delay)


def test_verify_v2_on_adaptive_output_matches_jax(tmp_path):
    x = _broadband(seed=13, quiet=0.003, loud=0.05)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    # hard switching (xfade 0) so the conditional spectra are clean
    adaptive.process(ip, op, adaptive.AdaptiveParams(xfade_ms=0.0,
                                                     min_hold_ms=0.0),
                     device="cpu")
    res = v15v2.verify_v2(ip, op, out_prefix=str(tmp_path / "p"),
                          device="cpu")
    ref = j15v2.verify_v2(ip, op, out_prefix=str(tmp_path / "j"))
    assert res["pass"] == ref["pass"]
    assert res["checks"]["engineering"]["pass"]
    # 30 bisection steps shrink the interval below the levels' 1e-6 dB
    # spread, so the last steps may part; the answer is within it
    assert abs(res["auto_threshold_dbfs"] - ref["auto_threshold_dbfs"]) \
        < 1e-4
    for k in ("achieved_c2_ratio", "switch_count", "c2_ratio_ok"):
        assert res[k] == ref[k], k
    _assert_same_checks(res["checks"], ref["checks"])
    sp = res["checks"]["spectrum"]
    assert sp["c1_fc_error"] < 0.5 and sp["c2_fc_error"] < 0.5
    _assert_spectra_close(tmp_path / "p_spectrum.csv",
                          tmp_path / "j_spectrum.csv", 1e-2)
    assert open(tmp_path / "p_report.txt", encoding="utf-8").read() == \
        open(tmp_path / "j_report.txt", encoding="utf-8").read()


# -- verify-tilt ------------------------------------------------------------

def test_tilt_amplitude_matches_jax(tmp_path):
    """tests/test_verify_v2_tilt.py's broadband probe through the port's
    standard processor."""
    rng = np.random.default_rng(3)
    n = int(6.0 * SR)
    t = np.arange(n) / SR
    env = 0.003 + 0.05 * (np.sin(2 * np.pi * 0.45 * t) > 0)
    w = rng.standard_normal(n)
    x = np.clip(np.stack([env * w, env * 0.95 * w], 1), -1,
                1).astype(np.float32)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    standard.process(ip, op, standard.StandardParams(
        gate_mode="linear", gate_ui=40.0, gate_offset=-75.0,
        hysteresis_db=1.0, up_delay_ms=0.0), device="cpu")
    res = tilt_amplitude.analyze_tilt_amplitude(ip, op, sr=SR, device="cpu")
    ref = jtilt.analyze_tilt_amplitude(ip, op, sr=SR)
    assert res["n_c1"] == ref["n_c1"] > 10 and res["n_c2"] == ref["n_c2"] > 10
    assert res["delay_samples"] == ref["delay_samples"]
    assert res["c1_tilt"] < -10
    for k in ("c1_tilt", "c2_tilt"):
        assert abs(res[k] - ref[k]) < DB, k
    for k in ("c1_gains", "c2_gains"):
        for f in tilt_amplitude.TEST_FREQS:
            assert abs(res[k][f] - ref[k][f]) < DB, (k, f)
    np.testing.assert_allclose(res["c1_avg"], ref["c1_avg"], atol=DB)


# -- case study ---------------------------------------------------------------

def test_case_study_original_equals_jax():
    np.testing.assert_array_equal(case_study.synth_original(3.0, 7),
                                  jcase.synth_original(3.0, 7))
    assert case_study.TRUE == jcase.TRUE and case_study.SR == jcase.SR


def test_case_study_device_recording_matches_jax():
    x = case_study.synth_original(10.0, 7)
    y = case_study.make_device_recording(x, device="cpu")
    jy = jcase.make_device_recording(x)
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=0)


@pytest.mark.slow
def test_case_study_regenerates_on_the_port(tmp_path):
    """tests/test_case_study.py's tolerances on the port's whole loop."""
    r = case_study.run_case_study(tmp_path, seconds=40.0, device="cpu")
    err = r["errors"]
    assert err["threshold_db"] < 0.6
    assert err["hyst_db"] < 0.01
    assert err["gain_db"] < 1.0
    assert err["delay_s"] < 0.03
    assert r["validate_pass"]
    assert abs(r["compare"]["anchor_gain_db"]
               - case_study.TRUE["gain_db"]) < 0.5
    for f in ("calibration_v2.json", "report.json", "REPORT.md",
              "matched.flac", "matched.flac.params.json"):
        assert (tmp_path / f).exists(), f


def test_verifier_entry_points_default_to_cuda(l1_files):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    _, ip, op, cp = l1_files
    with pytest.raises(RuntimeError, match="CUDA"):
        l1.validate(ip, op, cp, out_csv=None, out_png=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        v15.verify(ip, op, out_prefix=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        v15v2.verify_v2(ip, op, out_prefix=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tilt_amplitude.analyze_tilt_amplitude(ip, op)
    for cmd in ("validate", "verify-15db", "verify-15db-v2", "verify-tilt"):
        argv = [cmd, "-i", str(ip), "-o", str(op)]
        if cmd == "validate":
            argv += ["--state_csv", str(cp), "--out_csv", "",
                     "--out_png", ""]
        else:
            argv += ["--out_prefix", ""] if cmd != "verify-tilt" else []
        assert cli_main.main(argv) == 1, cmd
