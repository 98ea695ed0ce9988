"""The port's level and segment analyzers (tomatis_tpu_torch/analysis/
levels.py, segments.py, cli/analyzers.py) against the JAX package's on
the same files, on the CPU: all ten commands through each package's
entry function, console output equal and every CSV byte-equal; the
min-hold threshold search equal to the reference's exactly."""
import importlib
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu.analysis import levels as jlevels
from tomatis_tpu.cli import analyzers as janalyzers
from tomatis_tpu_torch.analysis import levels
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard

torch.set_num_threads(2)

SR = 48000


@pytest.fixture(scope="module", autouse=True)
def _no_plots():
    """No matplotlib: the optional plots are skipped, and the first
    import's font-cache minute with them."""
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        yield


def _stepped(path, quiet=0.003, loud=0.2, seconds=6.0):
    """tests/test_analyzers.py's quiet/loud/quiet 440 Hz step."""
    t = np.arange(int(seconds * SR)) / SR
    env = quiet + loud * ((t > 2.0) & (t < 4.0))
    x = env * np.sin(2 * np.pi * 440 * t)
    audio.write(path, np.stack([x, 0.9 * x], 1).astype(np.float32), SR,
                subtype="FLOAT")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyzers")
    f = {"stepped": _stepped(d / "a.wav"),
         "segment": _stepped(d / "s.wav", quiet=0.0005, loud=0.3)}
    # a 25 s file with a 5 s burst: the start and end finders' case
    t = np.arange(int(25.0 * SR)) / SR
    env = 0.0005 + 0.25 * ((t > 16.0) & (t < 21.0))
    x = env * np.sin(2 * np.pi * 500 * t)
    f["long"] = str(d / "m.wav")
    audio.write(f["long"], np.stack([x, x], 1).astype(np.float32), SR,
                subtype="FLOAT")
    # the stepped file through the port's standard processor: a state CSV
    # and an output whose level track switches with the gate
    f["out"], f["state"] = str(d / "out.flac"), str(d / "st.csv")
    standard.process(f["stepped"], f["out"],
                     standard.StandardParams(require_48k_stereo=False),
                     state_csv_path=f["state"], device="cpu")
    f["tracks"] = str(d / "ref")
    jlevels.compare_dbfs_tracks(f["stepped"], {"dev": f["out"]},
                                out_prefix=f["tracks"])
    f["tracks"] += "_dev.csv"
    return f


# command -> (argv with {d} for the output directory, outputs to compare)
CASES = {
    "analyze-dbfs": (["-i", "{stepped}"], []),
    "analyze-gate-threshold": (["{tracks}"], []),
    "analyze-stereo": (["-i", "{stepped}", "-o", "{d}/stereo.csv",
                        "--target_c2", "0.4"], ["stereo.csv"]),
    "compare-dbfs": (["-i", "{stepped}", "-c", "dev={out}", "-c", "{out}",
                      "--out_prefix", "{d}/dbfs"],
                     ["dbfs_dev.csv", "dbfs_out.csv"]),
    "merge-state-volume": (["--state_csv", "{state}", "--audio", "{out}",
                            "-o", "{d}/merged.csv"], ["merged.csv"]),
    "inspect": (["-i", "{stepped}", "--print_sec", "6"], []),
    "inspect-transition": (["-i", "{stepped}", "--start", "1.5", "--end",
                            "2.5"], []),
    "find-segment": (["-i", "{segment}", "--min_seg_sec", "1.0"], []),
    "find-start": (["-i", "{long}", "--search_duration", "25"], []),
    "find-end": (["-i", "{long}", "--search_duration", "8"], []),
}


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_command_matches_jax(files, tmp_path, capsys, cmd):
    argv, outputs = CASES[cmd]
    module, _, entry = cli_main.COMMANDS[cmd]
    assert module == "tomatis_tpu_torch.cli.analyzers"
    runs = {}
    for side, fn in (("port", getattr(importlib.import_module(module),
                                      entry)),
                     ("jax", getattr(janalyzers, entry))):
        d = tmp_path / side
        d.mkdir()
        args = [a.format(d=d, **files) for a in argv]
        if side == "port" and cmd == "analyze-stereo":
            args += ["--device", "cpu"]
        rc = fn(args)
        out = capsys.readouterr().out.replace(str(d), "<dir>")
        runs[side] = (rc, out, [(d / o).read_bytes() for o in outputs])
    assert runs["port"][0] == runs["jax"][0] == 0, runs["port"][1]
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][1].strip()
    for name, a, b in zip(outputs, runs["port"][2], runs["jax"][2]):
        assert a == b, name


def test_stereo_command_goes_through_the_dispatcher(files, tmp_path,
                                                    capsys):
    o = tmp_path / "st.csv"
    assert cli_main.main(["analyze-stereo", "-i", files["stepped"], "-o",
                          str(o), "--device", "cpu"]) == 0
    assert f"wrote {o}" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the default device is the card: no quiet run on the CPU
        assert cli_main.main(["analyze-stereo", "-i", files["stepped"],
                              "-o", str(o)]) == 1


@pytest.mark.parametrize("target,hyst,hold", [(0.5, 3.0, 6), (0.4, 1.0, 1),
                                              (0.7, 2.0, 12)])
def test_minhold_threshold_equals_jax(target, hyst, hold):
    """Both bisections overwrite their answer at every step (the
    reference's own quirk); the same levels give the same answer."""
    rng = np.random.default_rng(2)
    lv = np.concatenate([rng.normal(-55, 3, 400), rng.normal(-30, 3, 400),
                         np.full(50, -90.0)]).astype(np.float32)
    rng.shuffle(lv[100:700])
    got = levels._minhold_threshold(lv, target, hyst, hold, device="cpu")
    assert got == jlevels._minhold_threshold(lv, target, hyst, hold)


def test_gate_threshold_from_csv_equals_jax(files):
    """The csv-module reader against the reference's pandas one: the same
    column, switch points and statistics."""
    res = levels.gate_threshold_from_csv(files["tracks"])
    ref = jlevels.gate_threshold_from_csv(files["tracks"])
    assert res["out_col"] == ref["out_col"] == "dev_dbfs"
    assert res["n_switches"] == ref["n_switches"] > 0
    for k in ("mean", "median", "std", "min", "max"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k
    np.testing.assert_array_equal(res["times"], ref["times"])
    np.testing.assert_array_equal(res["levels"], ref["levels"])


def test_gate_threshold_csv_without_output_column(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("t,in_dbfs\n0.0,-40.0\n")
    with pytest.raises(ValueError, match="no output level column"):
        levels.gate_threshold_from_csv(p)
