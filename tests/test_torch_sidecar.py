"""The port's params sidecar loader (tomatis_tpu_torch/cli/_sidecar.py):
the cases of tests/test_sidecar.py on the port's verifier parsers, and a
port-written sidecar loading into the same arguments under the port's
and the JAX package's apply_params. Precedence: tool defaults < sidecar <
typed flags; --params none disables; auto applies only when the file
exists; a sidecar never sets --device."""
import json

import numpy as np
import pytest
import torch

from tomatis_tpu.cli import _sidecar as jsidecar
from tomatis_tpu.cli import validate as jvalidate
from tomatis_tpu.cli import verify_15db as jverify
from tomatis_tpu.cli import verify_15db_v2 as jverify2
from tomatis_tpu_torch.cli import _sidecar as sidecar
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.cli import validate as cli_validate
from tomatis_tpu_torch.cli import verify_15db, verify_15db_v2
from tomatis_tpu_torch.io import audio

torch.set_num_threads(2)


def _noise_signal(seconds=8.0, sr=48000, seed=11):
    """tests/test_sidecar.py's signal: broadband noise, loud middle."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = 0.4 * rng.standard_normal((n, 2))
    amp = np.full(n, 0.005)
    amp[int(2.5 * sr):int(5.5 * sr)] = 0.05
    return np.clip(x * amp[:, None], -0.98, 0.98).astype(np.float32)


def _parse(module, apply, argv):
    args = module.build_parser().parse_args(argv)
    apply(args, module.build_parser, argv)
    return args


def test_sidecar_precedence_and_absence(tmp_path):
    side_file = tmp_path / "x.params.json"
    side_file.write_text(json.dumps(
        {"tool": "process", "gate_offset": -40.0, "gate_scale": 0.0,
         "hyst_db": 3.0, "up_delay_ms": 250.0, "c1_low": 15.0,
         "not_a_flag": 123}))

    def parse(argv):
        return _parse(cli_validate, sidecar.apply_params, argv)

    base = ["-i", "a", "-o", str(tmp_path / "b"), "--state_csv", "c"]
    # no sidecar next to -o, no --params: reference defaults intact
    args = parse(base)
    assert args.gate_offset == -61.08 and args.hyst_db == 1.0
    assert args.up_delay_ms == 0 and args.c1_low == 5.0
    assert args.device == "cuda"
    # explicit --params: sidecar fills untyped flags, skips unknown keys
    args = parse(base + ["--params", str(side_file)])
    assert args.gate_offset == -40.0 and args.gate_scale == 0.0
    assert args.hyst_db == 3.0 and args.up_delay_ms == 250.0
    assert args.c1_low == 15.0
    assert not hasattr(args, "not_a_flag")
    # a typed flag beats the sidecar; untyped ones still load
    args = parse(base + ["--params", str(side_file), "--hyst_db", "2.5"])
    assert args.hyst_db == 2.5 and args.gate_offset == -40.0
    # --params none disables even when a file exists
    args = parse(base + ["--params", "none"])
    assert args.gate_offset == -61.08


def test_auto_detection_only_when_sidecar_exists(tmp_path):
    out = tmp_path / "out.wav"
    argv = ["-i", "a", "-o", str(out), "--state_csv", "c"]
    assert _parse(cli_validate, sidecar.apply_params, argv).hyst_db == 1.0
    (tmp_path / "out.wav.params.json").write_text(
        json.dumps({"hyst_db": 3.0}))
    assert _parse(cli_validate, sidecar.apply_params, argv).hyst_db == 3.0


def test_sidecar_never_sets_the_device(tmp_path):
    out = tmp_path / "out.wav"
    (tmp_path / "out.wav.params.json").write_text(
        json.dumps({"hyst_db": 3.0, "device": "cpu"}))
    argv = ["-i", "a", "-o", str(out), "--state_csv", "c"]
    args = _parse(cli_validate, sidecar.apply_params, argv)
    assert args.hyst_db == 3.0 and args.device == "cuda"
    args = _parse(cli_validate, sidecar.apply_params,
                  argv + ["--device", "cuda:1"])
    assert args.device == "cuda:1"


@pytest.mark.parametrize("port,ref,extra", [
    (cli_validate, jvalidate, ["--state_csv", "c"]),
    (verify_15db, jverify, []),
    (verify_15db_v2, jverify2, [])])
def test_port_sidecar_loads_the_same_under_both_packages(tmp_path, port,
                                                         ref, extra):
    """The port's `process` writes the sidecar; the port's and the JAX
    package's verifier parsers, each with its own apply_params, end with
    the same arguments (the port's --device aside)."""
    ip, op = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    audio.write(ip, _noise_signal(2.0), 48000, subtype="PCM_24")
    assert cli_main.main(["process", "-i", ip, "-o", op, "--gate_ui", "50",
                          "--gate_mode", "log_percent", "--hyst_db", "2.0",
                          "--device", "cpu"]) == 0
    argv = ["-i", ip, "-o", op, "--hop", "1024"] + extra
    a = vars(_parse(port, sidecar.apply_params, argv))
    b = vars(_parse(ref, jsidecar.apply_params, argv))
    assert a.pop("device") == "cuda"
    assert a == b
    if port is not verify_15db_v2:
        assert a["gate_scale"] == 0.0 and a["gate_offset"] == -40.0
    assert a["hyst_db"] == 2.0 and a["hop"] == 1024   # typed wins


def test_xfade_and_adaptive_sidecars(tmp_path):
    """The port's crossfade and adaptive CLIs write the sidecars the
    verifiers read (tests/test_sidecar.py::test_xfade_and_adaptive_
    sidecars)."""
    ip = str(tmp_path / "in.wav")
    audio.write(ip, _noise_signal(4.0), 48000, subtype="PCM_24")
    ox = str(tmp_path / "ox.wav")
    assert cli_main.main(["process-xfade", "-i", ip, "-o", ox, "--xfade_ms",
                          "80", "--gate_ui", "40", "--gate_offset",
                          "-61.08", "--allow_any_rate",
                          "--device", "cpu"]) == 0
    side = json.load(open(sidecar.sidecar_path(ox)))
    assert side["tool"] == "process-xfade" and side["xfade_ms"] == 80.0
    assert abs(side["gate_offset"] - (40 * 1.0 - 61.08)) < 1e-9
    oa = str(tmp_path / "oa.wav")
    assert cli_main.main(["process-adaptive", "-i", ip, "-o", oa,
                          "--device", "cpu"]) == 0
    side = json.load(open(sidecar.sidecar_path(oa)))
    assert side["tool"] == "process-adaptive"
    assert side["target_c2"] == 0.5 and "optimal_threshold_dbfs" in side
    assert "gate_offset" not in side
    args = _parse(verify_15db_v2, sidecar.apply_params,
                  ["-i", ip, "-o", oa])
    assert args.hyst_db == side["hyst_db"] and args.target_c2 == 0.5
