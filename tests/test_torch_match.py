"""The port's `match` workflow (tomatis_tpu_torch/models/workflow.py) against
the JAX package's match_device on one synthetic original and "device"
rendition, on the CPU, and the port's new CLI commands through cli.main
with --device cpu.

Tolerances: the same artifacts; T_raw_dbfs, hyst and up-delay equal (the
grid gate is integer logic on levels that agree to 1e-4 dB); music_err_db
per stage within 0.05 dB (each stage reads the previous stage's PCM_24
file, which agrees to a few LSB).
"""
import csv
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tomatis_tpu.models import workflow as jworkflow
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import workflow
from tomatis_tpu_torch.models.standard import StandardParams, process_array

torch.set_num_threads(2)

SR = 48000
TRUE_T = -28.0
TRUE_HYST = 2.0
DEVICE_GAIN = -4.0
DEVICE_COLOR = [(30, -4.0), (300, 3.0), (1000, 0.0), (5000, -6.0),
                (16000, -9.0)]
ARTIFACTS = ("calibration_v2.json", "state.csv", "layer1.flac",
             "layer2_eq_curve.csv", "layer2.flac", "diff_spectrum.csv",
             "matched.flac", "final_diff_spectrum.csv", "match_report.json")
TILT = dict(c1_low=3.0, c1_high=-3.0, c2_low=-3.0, c2_high=3.0)


def _music(seconds=26.0, seed=33):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    noise = lfilter([1.0], [1.0, -0.93], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    amp = np.full(n, 0.004, np.float32)
    pos = 0
    while pos < n:
        dur = int(SR * rng.uniform(0.2, 0.7))
        peak = 0.05 * 10 ** (0.4 * rng.standard_normal())
        seg = min(dur, n - pos)
        amp[pos:pos + seg] += peak * np.exp(-np.arange(seg) / (0.3 * SR))
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


@pytest.fixture(scope="module", autouse=True)
def _no_plots():
    """The EQ curve's PNG is optional (analyze_eq skips it when matplotlib
    cannot be imported); these tests do without it, and without the
    minute a first matplotlib import can spend on its font cache."""
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The original and a fake device recording: gated tilt at known
    parameters, an overall gain, a coloration and 0.3 s of latency."""
    tmp = tmp_path_factory.mktemp("match")
    orig = _music()
    p_dev = StandardParams(gate_ui=50.0, gate_mode="linear",
                           gate_offset=TRUE_T - 50.0,
                           hysteresis_db=TRUE_HYST, up_delay_ms=0.0,
                           require_48k_stereo=False,
                           output_gain_db=DEVICE_GAIN, **TILT)
    dev, _ = process_array(orig, SR, p_dev, frames_per_chunk=64,
                           device="cpu")
    dev = _colorize(dev, DEVICE_COLOR)
    off = int(0.3 * SR)
    orig_p, dev_p = tmp / "orig.flac", tmp / "device.flac"
    audio.write(orig_p, orig, SR, subtype="PCM_24")
    audio.write(dev_p, np.clip(dev[off:], -1, 1), SR, subtype="PCM_24")
    return tmp, orig_p, dev_p


@pytest.fixture(scope="module")
def reports(files):
    tmp, orig_p, dev_p = files
    kw = dict(max_minutes=1.0, require_48k_stereo=False,
              progress=lambda *_: None, **TILT)
    rep_t = workflow.match_device(orig_p, dev_p, str(tmp / "t"),
                                  device="cpu", **kw)
    rep_j = jworkflow.match_device(orig_p, dev_p, str(tmp / "j"), **kw)
    return rep_t, rep_j


def test_match_writes_the_same_artifacts(files, reports):
    tmp = files[0]
    for name in ARTIFACTS:
        assert os.path.exists(tmp / "t" / name), name
        assert os.path.exists(tmp / "j" / name), name
    rep_t, rep_j = reports
    assert os.path.basename(rep_t["matched_path"]) == \
        os.path.basename(rep_j["matched_path"]) == "matched.flac"
    assert set(rep_j["stages"]) == set(rep_t["stages"])
    for stage in rep_j["stages"]:
        assert set(rep_j["stages"][stage]) <= set(rep_t["stages"][stage])
    saved = json.load(open(tmp / "t" / "match_report.json"))
    assert saved["stages"] == rep_t["stages"]
    assert set(rep_t["timings"]) >= {
        "calibrate_s", "layer1_process_s", "compare_s", "analyze_eq_s",
        "apply_eq_s", "apply_residual_eq_s", "calibrate"}
    assert set(rep_t["timings"]["calibrate"]) == {
        "align_read_s", "features_s", "grid_gate_s"}
    # every rendered file has the length of the reference's
    for name in ("layer1.flac", "layer2.flac", "matched.flac"):
        assert audio.info(tmp / "t" / name).frames == \
            audio.info(tmp / "j" / name).frames, name
    cal_t = json.load(open(tmp / "t" / "calibration_v2.json"))
    cal_j = json.load(open(tmp / "j" / "calibration_v2.json"))
    assert set(cal_t) == set(cal_j)


def test_match_calibration_equals_reference(reports):
    rep_t, rep_j = reports
    ct, cj = rep_t["stages"]["calibrate"], rep_j["stages"]["calibrate"]
    assert ct["T_raw_dbfs"] == pytest.approx(cj["T_raw_dbfs"], abs=1e-3)
    assert ct["hyst_db"] == cj["hyst_db"]
    assert ct["up_delay_ms"] == cj["up_delay_ms"]
    assert ct["mismatch"] == pytest.approx(cj["mismatch"], abs=1e-6)
    assert abs(ct["T_raw_dbfs"] - TRUE_T) < 2.0


def test_match_stage_errors_equal_reference(reports):
    rep_t, rep_j = reports
    st, sj = rep_t["stages"], rep_j["stages"]
    for stage in ("layer1", "layer2", "final"):
        assert abs(st[stage]["music_err_db"]
                   - sj[stage]["music_err_db"]) <= 0.05, stage
    assert st["layer1"]["c2_ratio"] == pytest.approx(
        sj["layer1"]["c2_ratio"], abs=1e-9)
    assert abs(st["final"]["noise_delta_db"]
               - sj["final"]["noise_delta_db"]) <= 0.05
    assert abs(st["final"]["snr_db"] - sj["final"]["snr_db"]) <= 0.05
    # the chain converges: each stage tightens the spectral match
    assert st["layer2"]["music_err_db"] < st["layer1"]["music_err_db"]
    assert st["final"]["music_err_db"] < 0.4
    assert workflow.music_err(dict(bands={
        "200-1000": dict(mean=-1.0), "1000-3000": dict(mean=0.5),
        "3000-8000": dict(mean=0.0)})) == pytest.approx(0.5)


def test_match_interiors_equal_reference(files, reports):
    """The rendered stages, sample for sample. Layer 1 is within 4 LSB of
    the reference's everywhere. Layers 2 and 2b apply a curve analysed
    from the previous stage's file, and the two packages' curves agree to
    1e-3 dB = 1.2e-4 relative: off the edge hops the renders agree to
    1e-5 (84 LSB). The final interior does not clip."""
    tmp = files[0]
    for name, edge, tol in (("layer1.flac", 0, 4), ("layer2.flac", 4096, 84),
                            ("matched.flac", 4096, 84)):
        a, _ = audio.read(tmp / "t" / name)
        b, _ = audio.read(tmp / "j" / name)
        d = np.abs(np.rint(a * 8388608) - np.rint(b * 8388608))
        inner = d[edge:len(d) - edge] if edge else d
        assert inner.max() <= tol, (name, inner.max())
    y, _ = audio.read(tmp / "t" / "matched.flac")
    assert np.max(np.abs(y[4096:-4096])) <= 0.9901


def test_cli_match(files, reports, capsys):
    tmp, orig_p, dev_p = files
    outdir = tmp / "cli"
    rc = cli_main.main(["match", "--orig", str(orig_p), "--device",
                        str(dev_p), "-o", str(outdir), "--c1_low", "3",
                        "--c1_high", "-3", "--c2_low", "-3", "--c2_high",
                        "3", "--max_minutes", "1.0", "--allow_any_rate",
                        "--torch_device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "matched audio:" in out and "[5/5]" in out
    for name in ARTIFACTS:
        assert os.path.exists(outdir / name), name
    rep = json.load(open(outdir / "match_report.json"))
    ref = json.load(open(tmp / "t" / "match_report.json"))
    assert rep["stages"]["calibrate"] == ref["stages"]["calibrate"]
    assert rep["stages"]["final"]["music_err_db"] == \
        ref["stages"]["final"]["music_err_db"]
    assert rep["device"] == "cpu"


def test_cli_analysis_commands(files, reports, capsys):
    """calibrate, calibrate-v2, analyze-eq, compare through cli.main,
    each against the artifact the workflow wrote with the same call."""
    tmp, orig_p, dev_p = files
    d = tmp / "cmds"
    d.mkdir(exist_ok=True)
    assert cli_main.main([
        "calibrate-v2", "--orig", str(orig_p), "--base", str(dev_p),
        "--max_minutes", "1.0", "--out_json", str(d / "cal2.json"),
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[RECOMMEND] T_raw=" in out
    cal2 = json.load(open(d / "cal2.json"))
    ref = json.load(open(tmp / "t" / "calibration_v2.json"))
    for k in ("T_raw_dbfs", "hyst_db", "up_delay_ms", "gate_offset"):
        assert cal2[k] == ref[k], k

    assert cli_main.main([
        "calibrate", "--orig", str(orig_p), "--base", str(dev_p),
        "--max_minutes", "0.4", "--search_T_min", "-36", "--search_T_max",
        "-20", "--search_T_step", "2", "--hyst_list", "0", "2",
        "--delay_list_ms", "0", "100", "--out_json", str(d / "cal1.json"),
        "--device", "cpu"]) == 0
    assert "[BEST] T=" in capsys.readouterr().out
    assert set(json.load(open(d / "cal1.json"))) == {
        "gate_offset", "hyst_db", "up_delay_ms", "gate_ui"}

    l1 = tmp / "t" / "layer1.flac"
    assert cli_main.main([
        "analyze-eq", "--base", str(dev_p), "--target", str(l1),
        "--max_minutes", "1.0", "--out_csv", str(d / "eq.csv"),
        "--out_png", str(d / "eq.png"), "--device", "cpu"]) == 0
    assert "[SAVED]" in capsys.readouterr().out
    a = np.loadtxt(d / "eq.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp / "t" / "layer2_eq_curve.csv", delimiter=",",
                   skiprows=1)
    np.testing.assert_array_equal(a, b)

    # the workflow carries the gain-protected render forward if there is one
    l2 = tmp / "t" / "layer2_gp.flac"
    if not l2.exists():
        l2 = tmp / "t" / "layer2.flac"
    assert cli_main.main([
        "compare", str(dev_p), str(l2), "--out_csv",
        str(d / "diff.csv"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[ALIGN]" in out and "[RESIDUAL]" in out
    assert open(d / "diff.csv").read() == \
        open(tmp / "t" / "diff_spectrum.csv").read()


def test_cli_appliers_and_adaptive(files, reports, capsys):
    """apply-eq, apply-residual-eq and process-adaptive through cli.main,
    each against the library call it wraps."""
    tmp, orig_p, dev_p = files
    d = tmp / "apply"
    d.mkdir(exist_ok=True)
    l1 = tmp / "t" / "layer1.flac"
    assert cli_main.main([
        "apply-eq", "-i", str(l1), "-o", str(d / "l2.flac"), "--eq_csv",
        str(tmp / "t" / "layer2_eq_curve.csv"), "--frames_per_chunk", "256",
        "--progress", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frames:" in out and "processed" in out
    a, _ = audio.read(d / "l2.flac")
    b, _ = audio.read(tmp / "t" / "layer2.flac")
    # another chunk size: the same stream to float rounding
    assert len(a) == len(b)
    assert np.abs(a - b)[4096:-4096].max() <= 4 / 8388608

    assert cli_main.main([
        "apply-residual-eq", "--in_audio", str(tmp / "t" / "layer2.flac"),
        "--out_audio", str(d / "m.flac"), "--diff_csv",
        str(tmp / "t" / "diff_spectrum.csv"), "--safe", "--device",
        "cpu"]) == 0
    assert "[DONE] Applied SafeB residual EQ" in capsys.readouterr().out
    assert audio.info(d / "m.flac").frames == \
        audio.info(tmp / "t" / "matched.flac").frames

    out_p = d / "adaptive.flac"
    assert cli_main.main([
        "process-adaptive", "-i", str(orig_p), "-o", str(out_p),
        "--state_csv", str(d / "s.csv"), "--frames_per_chunk", "128",
        "--checkpoint", str(d / "ck.npz"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "optimal threshold:" in out and "C2 ratio:" in out
    assert not os.path.exists(d / "ck.npz")
    assert audio.info(out_p).frames == audio.info(orig_p).frames
    side = json.load(open(str(out_p) + ".params.json"))
    assert side["tool"] == "process-adaptive"
    assert {"target_c2", "hyst_db", "min_hold_ms", "xfade_ms",
            "optimal_threshold_dbfs", "atten_db", "n_fft", "hop"} <= set(side)
    rows = list(csv.reader(open(d / "s.csv")))
    assert rows[0] == ["frame_idx", "time_sec", "level_dbfs", "state",
                       "alpha"]
    assert {r[3] for r in rows[1:]} == {"C1", "C2"}


def test_cli_lists_thirteen_commands(capsys):
    """Every ported command: the fourteen of the processors, the appliers,
    the repair tools and match, then the verifiers, the analyzers and
    doctor, then the sharded processor, the comparison suite and
    reverse-engineer, 35 in all."""
    assert cli_main.main(["--help"]) == 0
    out = capsys.readouterr().out
    for cmd in ("process", "process-xfade", "convert", "process-adaptive",
                "apply-eq", "apply-residual-eq", "declick", "cut",
                "compare", "analyze-eq", "calibrate", "calibrate-v2",
                "match", "process-batch", "validate", "verify-15db",
                "verify-15db-v2", "verify-tilt", "doctor", "analyze-dbfs",
                "analyze-gate-threshold", "analyze-stereo", "compare-dbfs",
                "merge-state-volume", "inspect", "inspect-transition",
                "find-segment", "find-start", "find-end",
                "process-sharded", "compare-baseline", "compare-three",
                "compare-diff-spectrum", "plot-diff", "reverse-engineer"):
        assert f"\n  {cmd} " in out, cmd
    assert len(cli_main.COMMANDS) == 35


def test_cli_default_device_fails_without_card(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    tmp, orig_p, dev_p = files
    o = tmp / "nocard"
    assert cli_main.main(["match", "--orig", str(orig_p), "--device",
                          str(dev_p), "-o", str(o)]) == 1
    assert cli_main.main(["process-adaptive", "-i", str(orig_p), "-o",
                          str(tmp / "x.flac")]) == 1
    assert cli_main.main(["compare", str(dev_p), str(orig_p)]) == 1
    assert "CUDA" in capsys.readouterr().out
    assert not os.path.exists(tmp / "x.flac")
