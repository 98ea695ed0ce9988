"""The port's public surface against the JAX package's: the top-level
names, the six sub-packages' re-exports, the `tomatis-torch` command and
TOMATIS_PLATFORM, on the CPU."""
import importlib
import os
import re
import tomllib

import numpy as np
import pytest
import torch

import tomatis_tpu
import tomatis_tpu_torch as tt
from tomatis_tpu.utils.stateio import read_state_csv as j_read_state_csv
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.cli._flags import default_device
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.utils.pcm import i32_from_le24
from tomatis_tpu_torch.utils.stateio import read_state_csv

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000
MARGIN_DB = 0.01

# (sub-package or "" for the top level, name, the module that defines it,
# its attribute there or None for the module itself): the names of
# tomatis_tpu/__init__.py and of its six sub-packages' __init__ files
SURFACE = [
    ("", "StandardParams", "models.standard", "StandardParams"),
    ("", "process", "models.standard", "process"),
    ("", "process_array", "models.standard", "process_array"),
    ("", "XfadeParams", "models.xfade", "XfadeParams"),
    ("", "AdaptiveParams", "models.adaptive", "AdaptiveParams"),
    ("", "process_batch", "parallel.batch", "process_batch"),
    ("", "audio", "io.audio", None),
    ("ops", "dsp", "ops.dsp", None),
    ("ops", "gate", "ops.gate", None),
    ("ops", "stft", "ops.stft", None),
    ("engine", "ChunkedStftEngine", "engine.streaming", "ChunkedStftEngine"),
    ("engine", "FlushPlan", "engine.streaming", "FlushPlan"),
    ("engine", "StreamRunner", "engine.streaming", "StreamRunner"),
    ("engine", "flush_plan", "engine.streaming", "flush_plan"),
    ("models", "standard", "models.standard", None),
    ("parallel", "make_mesh", "parallel.sharded", "make_mesh"),
    ("parallel", "sharded_process_step", "parallel.sharded",
     "sharded_process_step"),
    ("io", "AudioFile", "io.audio", "AudioFile"),
    ("io", "info", "io.audio", "info"),
    ("io", "read", "io.audio", "read"),
    ("io", "write", "io.audio", "write"),
    ("native", "load_library", "native.build", "load_library"),
]


def _resolve(root, package, name, module, attr):
    """(the name as the package gives it, the object it should be)."""
    pkg = importlib.import_module(f"{root}.{package}" if package else root)
    mod = importlib.import_module(f"{root}.{module}")
    return getattr(pkg, name), (mod if attr is None else getattr(mod, attr))


@pytest.mark.parametrize("package,name,module,attr", SURFACE,
                         ids=[f"{s[0] or 'top'}.{s[1]}" for s in SURFACE])
def test_name_resolves_to_the_ports_own_object(package, name, module, attr):
    ref, ref_src = _resolve("tomatis_tpu", package, name, module, attr)
    assert ref is ref_src     # the reference gives the name so
    got, src = _resolve("tomatis_tpu_torch", package, name, module, attr)
    assert got is src
    home = got.__name__ if attr is None else got.__module__
    assert home == f"tomatis_tpu_torch.{module}"


def test_version_and_unknown_names():
    assert tt.__version__ == tomatis_tpu.__version__
    import tomatis_tpu_torch.engine
    import tomatis_tpu_torch.ops
    for mod in (tt, tomatis_tpu_torch.ops, tomatis_tpu_torch.engine):
        with pytest.raises(AttributeError, match="no_such_name"):
            getattr(mod, "no_such_name")
    # a sub-module outside the lazy table still imports by name
    from tomatis_tpu_torch.ops import wire
    assert wire.__name__ == "tomatis_tpu_torch.ops.wire"


def _signal(seconds=2.0, seed=1):
    """Stereo tone mix with quiet/loud alternation around the default
    -40 dBFS gate (test_torch_standard.py's signal)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.004 + 0.25 * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t) + 0.5 * np.sin(2 * np.pi * 3000 * t))
    x = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(n)], 1)
    return np.clip(x, -1, 1).astype(np.float32)


def test_top_level_process_array_matches_jax():
    x = _signal(2.0)
    y, st = tt.process_array(x, SR, device="cpu")
    y_j, st_j = tomatis_tpu.process_array(x, SR)
    y_j = np.asarray(y_j)
    assert y.shape == y_j.shape == x.shape
    assert np.max(np.abs(y - y_j)) <= 1e-5
    for k in ("n_frames", "c1_frames", "c2_frames"):
        assert st[k] == st_j[k], k
    assert st["c1_frames"] > 0 and st["c2_frames"] > 0


def test_top_level_process_matches_jax(tmp_path):
    """tt.process with default parameters against tomatis_tpu.process on a
    WAV: PCM_24 within 1 LSB (the signal peaks well under full scale),
    state CSV rows equal, levels within 1e-4 dB."""
    x = _signal(3.0, seed=2) * np.float32(0.25)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    j_out, j_csv = tmp_path / "j.wav", tmp_path / "j.csv"
    tomatis_tpu.process(ip, j_out, state_csv_path=j_csv, transport="pcm24")
    out, csv = tmp_path / "t.wav", tmp_path / "t.csv"
    st = tt.process(ip, out, state_csv_path=csv, device="cpu")
    assert st["transport"] == "pcm24" and st["device"] == "cpu"
    a = np.frombuffer(out.read_bytes()[44:], np.uint8)
    b = np.frombuffer(j_out.read_bytes()[44:], np.uint8)
    assert a.size == b.size == x.size * 3
    assert np.max(np.abs(i32_from_le24(a) - i32_from_le24(b))) <= 1
    c, cj = read_state_csv(csv), j_read_state_csv(j_csv)
    p = tt.StandardParams()
    for th in (p.threshold_dbfs() + p.hysteresis_db / 2,
               p.threshold_dbfs() - p.hysteresis_db / 2):
        assert np.min(np.abs(cj["level_dbfs"] - th)) >= MARGIN_DB
    for k in ("frame_idx", "time_sec", "state"):
        np.testing.assert_array_equal(c[k], cj[k])
    assert set(c["state"]) == {"C1", "C2"}
    np.testing.assert_allclose(c["level_dbfs"], cj["level_dbfs"], atol=1e-4)


def test_console_script_resolves_to_the_dispatcher():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["tomatis"] == "tomatis_tpu.cli.main:main"
    mod, fn = scripts["tomatis-torch"].split(":")
    assert getattr(importlib.import_module(mod), fn) is cli_main.main


@pytest.mark.parametrize("value,device", [
    (None, "cuda"), ("cpu", "cpu"), ("cuda", "cuda"), ("gpu", "cuda"),
    ("cuda:1", "cuda:1")])
def test_default_device_follows_tomatis_platform(monkeypatch, value, device):
    if value is None:
        monkeypatch.delenv("TOMATIS_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("TOMATIS_PLATFORM", value)
    assert default_device() == device


def _wav(tmp_path, seconds=2.0):
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(seconds), SR, subtype="PCM_24")
    return str(ip)


@pytest.mark.parametrize("value", ["tpu", "cuda:x", "CPU"])
def test_unknown_platform_fails_loudly(monkeypatch, tmp_path, capsys, value):
    monkeypatch.setenv("TOMATIS_PLATFORM", value)
    with pytest.raises(ValueError, match="TOMATIS_PLATFORM"):
        default_device()
    op = tmp_path / "out.wav"
    for extra in ([], ["--device", "cpu"]):
        assert cli_main.main(["process", "-i", _wav(tmp_path), "-o",
                              str(op)] + extra) == 2
        assert f"TOMATIS_PLATFORM={value!r}" in capsys.readouterr().err
    assert not op.exists()


def test_tomatis_platform_cpu_runs_without_device_flag(monkeypatch, tmp_path,
                                                       capsys):
    monkeypatch.setenv("TOMATIS_PLATFORM", "cpu")
    op = tmp_path / "out.wav"
    assert cli_main.main(["process", "-i", _wav(tmp_path), "-o", str(op),
                          "--frames_per_chunk", "16"]) == 0
    assert "realtime on cpu" in capsys.readouterr().out
    assert audio.info(op).frames == 2 * SR


def test_explicit_device_wins_over_tomatis_platform(monkeypatch, tmp_path,
                                                    capsys):
    monkeypatch.setenv("TOMATIS_PLATFORM", "cuda")
    op = tmp_path / "out.wav"
    assert cli_main.main(["process", "-i", _wav(tmp_path), "-o", str(op),
                          "--device", "cpu",
                          "--frames_per_chunk", "16"]) == 0
    assert "realtime on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("value", [None, "cuda"])
def test_card_default_raises_without_a_card(monkeypatch, tmp_path, capsys,
                                            value):
    """Unset (or set to the card), the CLI and the library default to the
    card and fail without one: no path falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    if value is None:
        monkeypatch.delenv("TOMATIS_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("TOMATIS_PLATFORM", value)
    ip, op = _wav(tmp_path), tmp_path / "out.wav"
    assert cli_main.main(["process", "-i", ip, "-o", str(op)]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.process(ip, op)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.process_array(_signal(0.5), SR)


def test_every_commands_device_default_follows_the_variable(monkeypatch):
    """The commands with a build_parser read TOMATIS_PLATFORM for their
    torch device's default; no command of cli/ hard-codes cuda."""
    monkeypatch.setenv("TOMATIS_PLATFORM", "cpu")
    seen = 0
    for spec in cli_main.COMMANDS.values():
        mod = importlib.import_module(spec[0])
        if len(spec) > 2 or not hasattr(mod, "build_parser"):
            continue
        dests = {a.dest: a.default for a in mod.build_parser()._actions}
        dest = "torch_device" if "torch_device" in dests else "device"
        if dest in dests:
            assert dests[dest] == "cpu", spec[0]
            seen += 1
    assert seen >= 15
    cli_dir = os.path.join(REPO, "tomatis_tpu_torch", "cli")
    for name in os.listdir(cli_dir):
        if name.endswith(".py"):
            with open(os.path.join(cli_dir, name)) as f:
                assert not re.search(r"default=\"cuda", f.read()), name


def test_doctor_names_tomatis_platform(monkeypatch, capsys):
    """Without a card the port's doctor says how to check the CPU path, as
    the reference's does; with TOMATIS_PLATFORM=cpu it checks it."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    monkeypatch.delenv("TOMATIS_PLATFORM", raising=False)
    assert cli_main.main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "TOMATIS_PLATFORM=cpu" in out and "--skip_device" in out
    monkeypatch.setenv("TOMATIS_PLATFORM", "cpu")
    assert cli_main.main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "[OK]   CUDA device: not used (--device cpu)" in out
    assert out.rstrip().endswith("environment OK")
