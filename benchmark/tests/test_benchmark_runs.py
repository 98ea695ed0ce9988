"""Whole runs on the CPU: each cell rehearsed end to end, with and without
the trace; a run that finds no card prints nothing and fails; a run that
has loaded JAX or the JAX package prints nothing and fails; a new cell,
configuration, mix, generator, driver and metric added as new files only
run without an edit to any file the benchmark has."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from harness import spec
from helpers import ROOT, rehearse, run_module

CELLS = [w["name"] for w in spec.load_json(ROOT, "BENCHMARK.json")
         ["workloads"]]
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")


@pytest.fixture
def env_kept():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@needs_gxx
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_cells_line(cell, trace, capsys, env_kept):
    rc, line = rehearse(capsys, cell, seed=2 ** 31 + 99, trace=trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0, line
    c = spec.load_cell(cell)
    rows = c.per_layer if trace else c.end_to_end
    want = {m["name"] for m in rows if m["source"] != "device_trace"
            and m["name"] != "peak_device_mb"}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["memory_peak_bytes"] is None


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2
    assert p.stdout == ""
    assert "CUDA card" in p.stderr


def test_top_level_names_compared_whole():
    run = run_module()
    saved = dict(sys.modules)
    try:
        for ok in ("tomatis_tpu_torch", "jax_helpers", "flaxen"):
            sys.modules[ok] = types.ModuleType(ok)
        assert run.forbidden_modules() == []
        sys.modules["tomatis_tpu.io"] = types.ModuleType("tomatis_tpu.io")
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        assert run.forbidden_modules() == ["jaxlib", "tomatis_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@needs_gxx
def test_a_loaded_jax_package_fails_the_run(capsys, env_kept,
                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "tomatis_tpu",
                        types.ModuleType("tomatis_tpu"))
    rc, line = rehearse(capsys, "xfade.array_10min")
    assert rc == 3 and line is None


def test_the_harness_loads_no_jax():
    """A whole rehearsal in a fresh process: run.py itself exits 3 when
    JAX or the JAX package is loaded after the window."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "xfade.array_10min", "--seed", "3", "--seconds",
                        "0.5", "--trace", "0", "--rehearse"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


NEW_GENERATOR = '''
import numpy as np
def make(mix, config, seed):
    rng = np.random.default_rng(seed)
    n = int(mix["lengths_s"][0] * config["sample_rate"])
    return [(rng.standard_normal((n, 2)) * 0.01).astype(np.float32)]
'''
NEW_DRIVER = '''
from harness.check import Answer
from harness.driving import program_params, timed_job
class D:
    def __init__(self, ctx):
        from tomatis_tpu_torch.models import standard
        self.ctx, self.fn = ctx, standard.process_array
        self.p = program_params(ctx.cell.config)
    def warm(self):
        self.fn(self.ctx.inputs.warm(0), 48000, self.p, device="cpu")
    def job(self, k):
        x = self.ctx.inputs.samples[0]
        def one():
            y, st = self.fn(x, 48000, self.p, device="cpu",
                            frames_per_chunk=self.ctx.frames_per_chunk)
            return len(x) / 48000, st, [(0, y)]
        return timed_job(k, self.ctx.spans, "job", one)
    def answers(self, jobs):
        return [Answer("last", 0, y=jobs[-1].outputs[0][1])]
    def release(self):
        pass
def make(ctx):
    return D(ctx)
'''
NEW_METRIC = '''
UNIT, SOURCE, MOVES = "n", "host_clock", "realtime_x"
READS = "the number of jobs in the window"
def read(run):
    return float(len(run.jobs))
'''


def test_new_cell_as_new_files_only(tmp_path):
    """A throwaway cell with its own configuration, mix, generator,
    driver and metric, added to a copy of the benchmark as new files and
    BENCHMARK.json entries; no file the benchmark has is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "benchmark").rglob("*") if x.is_file())}
    b = spec.load_json(ROOT, "BENCHMARK.json")
    bench = root / "benchmark"
    cfg = spec.load_json(ROOT, "benchmark/configs/standard_cli_defaults.json")
    cfg["name"] = "noise_cfg"
    (bench / "configs/noise_cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic/noise.json").write_text(json.dumps(
        {"name": "noise", "generator": "white", "format": "array",
         "lengths_s": [100.0], "warm_s": 40.0}))
    (bench / "traffic/white.py").write_text(NEW_GENERATOR)
    (bench / "drivers/plain_array.py").write_text(NEW_DRIVER)
    (bench / "metrics/jobs_n.py").write_text(NEW_METRIC)
    (bench / "workloads/noise.plain.json").write_text(json.dumps(
        {"name": "noise.plain", "config": "noise_cfg", "traffic": "noise",
         "driver": "plain_array", "chips": 1,
         "limits": {"audio_lsb": 8, "end_lsb": 8}}))
    b["workloads"].append({"name": "noise.plain", "config": "noise_cfg",
                           "traffic": "noise", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "jobs_n", "unit": "n", "better": "higher",
                           "source": "host_clock", "layer": "entry",
                           "moves": "realtime_x",
                           "workloads": ["noise.plain"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "noise.plain", "--seed", "4", "--seconds", "0.5",
                        "--trace", "1", "--rehearse"], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["jobs_n"]["value"] >= 1
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: no program to import, so no result."""
    root = tmp_path / "only"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[1], "--seed", "1", "--seconds", "0.5",
                        "--trace", "0", "--rehearse"], cwd=root,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout == ""
