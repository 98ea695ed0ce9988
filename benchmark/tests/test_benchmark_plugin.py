"""A processor is a plug-in: its configuration names the program's entry,
its params class and its plain reference (reference/<module>.py), so a new
one is added with new files alone. A name that leads nowhere ends the run
with exit 1 and a message that names it, never a run of another
processor. A reference whose state CSV numbers its rows otherwise than by
frame index (csv_frame_idx) is compared row for row."""
import json
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from harness import check, control, spec
from reference import precision, tomatis_ref

ROOT = spec.ROOT
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")
SEED = 2 ** 31 + 4321
ANSWER = re.compile(r"answer (\S+): (.*)$", re.M)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with new files only: a copy of tomatis_ref
    under another name, for a processor of another name, a configuration
    naming both with the crossfade entry, a cell of it on the album mix,
    and BENCHMARK.json listing both; besides, configurations that name a
    reference, an entry and a params class that are not there, each with
    a cell."""
    root = tmp_path_factory.mktemp("plugin") / "checkout"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    src = (bench / "reference/tomatis_ref.py").read_text()
    assert src.count('"xfade"') == 2
    (bench / "reference/xfade_copy_ref.py").write_text(
        src.replace('"xfade"', '"xfade_copy"'))
    b = spec.load_json(ROOT, "BENCHMARK.json")
    base = spec.load_json(ROOT, "benchmark/configs/xfade_500ms.json")
    wl = spec.load_json(ROOT, "benchmark/workloads/xfade.flac_tracks.json")
    configs = {
        "xfade_copy": {"processor": "xfade_copy",
                       "reference": "xfade_copy_ref",
                       "entry": "tomatis_tpu_torch.models.xfade:process"},
        "no_reference": {"reference": "no_such_ref"},
        "no_entry": {"entry": "tomatis_tpu_torch.models.xfade:no_such"},
        "no_params": {"params_class": "tomatis_tpu_torch.models.no_such:P"},
    }
    for name, keys in configs.items():
        cfg = dict(base, name=name, **keys)
        (bench / f"configs/{name}.json").write_text(json.dumps(cfg))
        cell = dict(wl, name=f"{name}.flac_tracks", config=name)
        (bench / f"workloads/{name}.flac_tracks.json").write_text(
            json.dumps(cell))
        b["configs"].append({"name": name, "source": base["source"],
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "test"})
        b["workloads"].append({"name": cell["name"], "config": name,
                               "traffic": "flac_tracks", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, before


def _rehearse(root, cell: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "0.2", "--trace", "0", "--rehearse"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))


@needs_gxx
def test_a_processor_added_as_new_files_alone(checkout):
    """The copied reference under its own name, for its own processor,
    through the entry its configuration names, gives every answer the
    numbers that the crossfade cell's own rehearsal gives on the same
    input and seed."""
    root, before = checkout
    runs = {}
    for cell in ("xfade_copy.flac_tracks", "xfade.flac_tracks"):
        p = _rehearse(root, cell)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["failed"] == 0, line
        runs[cell] = dict(ANSWER.findall(p.stderr))
    new, old = runs["xfade_copy.flac_tracks"], runs["xfade.flac_tracks"]
    common = set(new) & set(old)
    assert common, (new, old)
    assert {k: new[k] for k in common} == {k: old[k] for k in common}
    for path, data in before.items():
        assert path.read_bytes() == data, path


@needs_gxx
@pytest.mark.parametrize("config,named", [
    ("no_reference", "no_such_ref.py"),
    ("no_entry", "no_such"),
    ("no_params", "tomatis_tpu_torch.models.no_such")])
def test_a_name_that_leads_nowhere_ends_the_run(checkout, config, named):
    p = _rehearse(checkout[0], f"{config}.flac_tracks")
    assert p.returncode == 1, p.stderr[-3000:]
    assert p.stdout == ""
    last = p.stderr.strip().splitlines()[-1]
    assert last.startswith("no result:") and named in last, last


class _Inputs:
    """One input as the harness's Inputs hands it to the reference."""
    format = "flac"

    def __init__(self, x):
        self.x = x

    def __len__(self):
        return 1

    def reference_input(self, i):
        return self.x


def test_csv_numbered_apart_from_rows_is_compared_row_for_row(
        monkeypatch):
    """A reference whose state CSV numbers each row one above its frame
    index (as the adaptive processor's numbers its frames from 1): the
    control's table takes that numbering, and the check compares it row
    for row; a table numbered by frame index reads every row missing."""
    cell = spec.load_cell("xfade.flac_tracks")
    mix = dict(cell.mix, lengths_s=[20.0])
    x = spec.load_module("traffic", mix["generator"]).make(
        mix, cell.config, 3)[0].astype(np.float64)

    def render(x, config, quantise):
        r = tomatis_ref.render(x, config, quantise)
        r["csv_frame_idx"] = r["rows"] + 1
        return r
    offset_ref = types.ModuleType("bench_reference_offset_ref")
    offset_ref.render = render
    # where harness.spec keeps reference/offset_ref.py once loaded
    monkeypatch.setitem(sys.modules, offset_ref.__name__, offset_ref)
    config = dict(cell.config, reference="offset_ref")
    inputs = _Inputs(x)
    limits = cell.workload["limits"]

    answers = control.answers(inputs, config, precision.identity)
    ref = tomatis_ref.render(x, cell.config)
    assert np.array_equal(answers[0].csv["frame_idx"], ref["rows"] + 1)
    ok, checks = check.judge(check.compare(answers, inputs, config), limits)
    assert ok, checks
    assert checks["state_frames"]["value"] == 0

    # one state written the other way is one row, not every row
    table = answers[0].csv
    held = np.nonzero(~ref["masked"][ref["rows"]])[0]
    k = int(held[len(held) // 2])
    table["state"] = table["state"].copy()
    table["state"][k] = "C1" if table["state"][k] == "C2" else "C2"
    nums = check.compare(answers, inputs, config)
    assert nums["state_frames"] == 1 and np.isfinite(nums["level_db"])

    # numbered by frame index, where the reference says one above: every
    # row missing
    table["state"][k] = "C1" if table["state"][k] == "C2" else "C2"
    table["frame_idx"] = ref["rows"].astype(np.int64)
    nums = check.compare(answers, inputs, config)
    assert nums["state_frames"] == len(ref["rows"])
    assert nums["level_db"] == np.inf
