"""The port's reverse-engineer (tomatis_tpu_torch/analysis/reverse.py and
cli/reverse.py) against the JAX package's on tests/test_reverse.py's
signal, on the CPU.

Tolerances: the delay, frame count, histogram counts and the level
table's bins, counts and states equal; the threshold estimate, the level
table's tilt means and spreads and every per-frame level and tilt within
1e-3 dB (float32 rFFTs in another rounding); the CSV's frame and time
columns equal, its level and tilt columns (printed to 0.01) within 0.01.
"""
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tomatis_tpu.analysis import reverse as jrev
from tomatis_tpu_torch.analysis.reverse import analyze_device_params
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.standard import StandardParams, process_array

torch.set_num_threads(2)

SR = 48000
TRUE_T = -32.0
DB = 1e-3


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rev")
    rng = np.random.default_rng(21)
    n = int(20.0 * SR)
    t = np.arange(n) / SR
    noise = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    noise = noise / np.max(np.abs(noise))
    env = 0.05 * 10 ** (1.2 * np.sin(2 * np.pi * 0.21 * t) / 2)
    x = np.clip(np.stack([env * noise, 0.95 * env * noise], 1), -1,
                1).astype(np.float32)
    p = StandardParams(gate_mode="linear", gate_ui=50.0,
                       gate_offset=TRUE_T - 50.0, hysteresis_db=1.0,
                       up_delay_ms=0.0, require_48k_stereo=False)
    y, _ = process_array(x, SR, p, device="cpu")
    ip, op = tmp / "in.flac", tmp / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    audio.write(op, y, SR, subtype="PCM_24")
    return ip, op


def test_reverse_engineer_matches_jax(pair, tmp_path):
    ip, op = pair
    res = analyze_device_params(ip, op, out_csv=str(tmp_path / "rev.csv"),
                                device="cpu")
    jres = jrev.analyze_device_params(ip, op,
                                      out_csv=str(tmp_path / "jrev.csv"))
    for k in ("delay_samples", "n_frames", "histogram"):
        assert res[k] == jres[k], k
    np.testing.assert_allclose(res["levels"], jres["levels"], rtol=0,
                               atol=DB)
    np.testing.assert_allclose(res["tilts"], jres["tilts"], rtol=0, atol=DB)
    assert len(res["level_table"]) == len(jres["level_table"])
    for r, j in zip(res["level_table"], jres["level_table"]):
        for k in ("lo", "hi", "n", "state"):
            assert r[k] == j[k], k
        for k in ("mean_tilt", "std_tilt"):
            assert abs(r[k] - j[k]) <= DB, k
    t, jt = res["gate_threshold"], jres["gate_threshold"]
    assert (t["c1_frames"], t["c2_frames"]) == (jt["c1_frames"],
                                                jt["c2_frames"])
    for k in ("c1_max_level", "c2_min_level", "estimate"):
        assert abs(t[k] - jt[k]) <= DB, k
    assert abs(t["estimate"] - TRUE_T) < 4.0
    states = [row["state"] for row in res["level_table"] if row["n"] > 5]
    assert states[0] == "C1" and states[-1] == "C2"
    rows = open(tmp_path / "rev.csv").read().splitlines()
    jrows = open(tmp_path / "jrev.csv").read().splitlines()
    assert rows[0] == jrows[0] == "frame,time_sec,inp_level_dbfs,tilt_db"
    assert len(rows) == len(jrows) == res["n_frames"] + 1
    for a, b in zip(rows[1:], jrows[1:]):
        ca, cb = a.split(","), b.split(",")
        assert ca[:2] == cb[:2]
        assert abs(float(ca[2]) - float(cb[2])) <= 0.0100001
        assert abs(float(ca[3]) - float(cb[3])) <= 0.0100001


def test_reverse_engineer_refuses_another_rate(pair, tmp_path):
    ip, _ = pair
    x, _ = audio.read(ip)
    other = tmp_path / "o44.wav"
    audio.write(other, x[:44100 * 5], 44100, subtype="PCM_24")
    with pytest.raises(ValueError, match="sample rate mismatch"):
        analyze_device_params(ip, other, device="cpu")


def test_reverse_engineer_command(pair, tmp_path, capsys):
    ip, op = pair
    rc = cli_main.main(["reverse-engineer", "-i", str(ip), "-o", str(op),
                        "--csv", str(tmp_path / "r.csv"), "--device",
                        "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    res = analyze_device_params(ip, op, device="cpu")
    assert f"estimated gate threshold: " \
           f"{res['gate_threshold']['estimate']:.1f} dBFS" in out
    assert f"delay: {res['delay_samples']} samples; frames: " \
           f"{res['n_frames']}" in out
    assert (tmp_path / "r.csv").exists()
    if not torch.cuda.is_available():
        rc = cli_main.main(["reverse-engineer", "-i", str(ip), "-o",
                            str(op)])
        assert rc == 1 and "CUDA" in capsys.readouterr().out
