"""The port's `doctor` (tomatis_tpu_torch/cli/doctor.py) and its
dispatcher: doctor passes on the CPU when asked for it, and without a
card it fails its device check instead of quietly running on the CPU;
the dispatcher holds all 35 of the JAX package's commands."""
import sys

import pytest
import torch

from tomatis_tpu.cli import main as jmain
from tomatis_tpu_torch.cli import doctor
from tomatis_tpu_torch.cli import main as cli_main

torch.set_num_threads(2)

QUEUED = set()


@pytest.fixture(autouse=True)
def _no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _lines(out: str) -> dict:
    """'[OK]   name: detail' lines -> {name: (status, detail)}."""
    res = {}
    for ln in out.splitlines():
        if ln.startswith("[OK]") or ln.startswith("[FAIL]"):
            status, rest = ln.split("]", 1)
            name, _, detail = rest.strip().partition(": ")
            res[name] = (status[1:], detail)
    return res


def test_doctor_on_cpu_passes(capsys):
    assert doctor.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = _lines(out)
    assert all(s == "OK" for s, _ in lines.values()), out
    assert lines["CUDA device"][1] == "not used (--device cpu)"
    assert "csrc/flac.cpp, csrc/wire.cpp" in lines["native builds"][1]
    assert lines["streaming engine"][1].endswith("on cpu")
    assert "440 Hz sine" in lines["STFT smoke test"][1]
    assert out.rstrip().endswith("environment OK")


def test_doctor_without_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    assert cli_main.main(["doctor"]) == 1
    out = capsys.readouterr().out
    lines = _lines(out)
    assert lines["CUDA device"][0] == "FAIL"
    assert "no CUDA device" in lines["CUDA device"][1]
    for name in ("chunk-tail kernel", "STFT smoke test", "streaming engine"):
        assert lines[name] == ("FAIL", "the CUDA device check failed")
    assert lines["audio codecs"][0] == "OK"
    assert "environment OK" not in out and "environment NOT OK" in out


def test_doctor_skip_device_says_cpu(capsys):
    assert doctor.main(["--skip_device"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines["CUDA device"][1].startswith("skipped")
    assert lines["chunk-tail kernel"][1].startswith("skipped")
    assert lines["streaming engine"][1].endswith("on cpu")


def test_dispatcher_lists_35_commands(capsys):
    assert cli_main.main(["--help"]) == 0
    out = capsys.readouterr().out
    for cmd in cli_main.COMMANDS:
        assert f"\n  {cmd} " in out, cmd
    assert len(cli_main.COMMANDS) == 35
    assert set(jmain.COMMANDS) - set(cli_main.COMMANDS) == QUEUED
    assert set(cli_main.COMMANDS) <= set(jmain.COMMANDS)
    # three-element entries name the function that runs, as the
    # reference's do
    for name, spec in cli_main.COMMANDS.items():
        ref = jmain.COMMANDS[name]
        assert len(spec) == len(ref), name
        if len(spec) > 2:
            assert spec[2] == ref[2], name


def test_unknown_command():
    assert cli_main.main(["no-such-command"]) == 2
