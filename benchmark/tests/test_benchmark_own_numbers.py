"""A cell's numbers of its own are a plug-in too: the cell's driver hands
the check further outputs beside the audio and the state CSV, and a module
that the workload names under "numbers" holds them to its own plain
implementation, with new files alone. Rehearsed on a copied checkout: a
driver that runs the standard entry and then the program's engineering
check (verify.verify_15db.check_engineering: frame counts, peak, peak in
dBFS) on the output, writing it as JSON beside the FLAC; a module that
declares one number on that JSON, held against the answer's own samples;
cells of the standard configuration as it is, which name that module. The
lower-precision control carries the same further outputs and fails that
number; a NaN reads inf; the four cells that are there keep exactly their
numbers."""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from harness import check, control, driving, spec
from harness.inputs import to_pcm24
from reference import precision

ROOT = spec.ROOT
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")
SEED = 2 ** 31 + 2323
ANSWER = re.compile(r"answer (\S+): (.*)$", re.M)
NUMBER = "engineering_peak_db"
LIMIT = 1e-6
FULL_SCALE = 8388608.0

REFERENCE = '''"""One number of the cell's own, on the engineering check that the
driver writes beside each output as JSON (the further output
"engineering")."""
import json
import math
import os

import numpy as np
import torch

FULL_SCALE = 8388608.0
EPS = 1e-12
NUMBERS = {"engineering_peak_db": "the engineering check's peak in dBFS "
           "against the answer's own, dB; inf where its frame counts are "
           "not the input's and the answer's"}


def _samples(answer):
    if answer.pcm is not None:
        return answer.pcm.astype(np.float64) / FULL_SCALE
    return np.asarray(answer.y, np.float64)


def _engineering(x, y, quantise):
    """The frame counts, and the output's peak in dBFS with each stage
    rounded by quantise."""
    peak = quantise(torch.tensor(np.abs(y).max(initial=0.0),
                                 dtype=torch.float64))
    peak_db = quantise(20 * torch.log10(peak + EPS))
    return {"frames_in": len(x), "frames_out": len(y),
            "peak_dbfs": float(peak_db)}


def numbers(answer, x, ref, config, quantise):
    path = answer.files.get("engineering")
    if path is None:
        return {"engineering_peak_db": math.inf}
    with open(path, encoding="utf-8") as f:
        got = json.load(f)
    want = _engineering(x, _samples(answer), quantise)
    if any(got[k] != want[k] for k in ("frames_in", "frames_out")):
        return {"engineering_peak_db": math.inf}
    return {"engineering_peak_db": abs(got["peak_dbfs"] - want["peak_dbfs"])}


def outputs(answer, x, ref, config, quantise, directory):
    path = os.path.join(directory, "engineering.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(_engineering(x, _samples(answer), quantise), f)
    return {"engineering": path}
'''

DRIVER = '''"""Entry driver: file_process's jobs, then the program's engineering
check (tomatis_tpu_torch.verify.verify_15db.check_engineering) on
each output, written as JSON beside the FLAC and handed to the check as
the further output "engineering"."""
import json

from harness import spec
from harness.driving import Context, Job, timed_job

file_process = spec.load_module("drivers", "file_process")


class EngineeringProcess(file_process.FileProcess):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        from tomatis_tpu_torch.verify import verify_15db
        self.check_engineering = verify_15db.check_engineering

    def report(self, in_path: str, out: str) -> dict:
        return self.check_engineering(in_path, out)

    def job(self, k: int) -> Job:
        inputs = self.ctx.inputs
        i = k % len(inputs)

        def one():
            stats, out, csv_path = self._run(inputs.paths[i], f"job{k}")
            path = out + ".engineering.json"
            with open(path, "w", encoding="utf-8") as f:
                json.dump(self.report(inputs.paths[i], out), f,
                          default=float)
            return (inputs.seconds(i), stats,
                    [(i, out, csv_path, {"engineering": path})])
        return timed_job(k, self.ctx.spans, "job", one)


def make(ctx: Context) -> EngineeringProcess:
    return EngineeringProcess(ctx)
'''

FAULT_DRIVER = '''"""engineering_process with the report's peak 0.001 dB high: an
answer altered where it is produced, in the further output alone."""
from harness import spec

base = spec.load_module("drivers", "engineering_process")


class Fault(base.EngineeringProcess):
    def report(self, in_path, out):
        r = super().report(in_path, out)
        return dict(r, peak_dbfs=r["peak_dbfs"] + 1e-3)


def make(ctx):
    return Fault(ctx)
'''

NAN_DRIVER = '''"""engineering_process with the report's peak NaN, as a verifier's
median over no frames reads."""
from harness import spec

base = spec.load_module("drivers", "engineering_process")


class Nan(base.EngineeringProcess):
    def report(self, in_path, out):
        return dict(super().report(in_path, out), peak_dbfs=float("nan"))


def make(ctx):
    return Nan(ctx)
'''

CELL = "standard.engineering"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with new files only: the module of numbers
    and the drivers above, a mix that is flac_10min under its own name,
    and cells of the standard configuration as it is on that mix, which
    name the module: the cell as it would be committed (listed in
    BENCHMARK.json), one with the fault, one with the NaN, one whose
    limits leave the new number out."""
    root = tmp_path_factory.mktemp("own_numbers") / "checkout"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "reference/engineering_ref.py").write_text(REFERENCE)
    (bench / "drivers/engineering_process.py").write_text(DRIVER)
    (bench / "drivers/engineering_fault.py").write_text(FAULT_DRIVER)
    (bench / "drivers/engineering_nan.py").write_text(NAN_DRIVER)
    mix = spec.load_json(ROOT, "benchmark/traffic/flac_10min.json")
    (bench / "traffic/engineering_10min.json").write_text(
        json.dumps(dict(mix, name="engineering_10min")))
    wl = spec.load_json(ROOT, "benchmark/workloads/standard.flac_10min.json")
    limits = dict(wl["limits"], **{NUMBER: LIMIT})
    cells = {CELL: ("engineering_process", limits),
             f"{CELL}_fault": ("engineering_fault", limits),
             f"{CELL}_nan": ("engineering_nan", limits),
             f"{CELL}_no_limit": ("engineering_process", wl["limits"])}
    for name, (driver, lims) in cells.items():
        cell = dict(wl, name=name, traffic="engineering_10min",
                    driver=driver, numbers="engineering_ref", limits=lims)
        (bench / f"workloads/{name}.json").write_text(json.dumps(cell))
    b = spec.load_json(ROOT, "BENCHMARK.json")
    b["workloads"].append({"name": CELL, "config": wl["config"],
                           "traffic": "engineering_10min", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, before


def _rehearse(root, cell: str) -> tuple:
    """(the run, its last line as JSON, its answers' numbers by name)."""
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "0.2", "--trace", "0", "--rehearse"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    answers = {name: dict(kv.split("=") for kv in nums.split())
               for name, nums in ANSWER.findall(p.stderr)}
    return p, json.loads(p.stdout.strip().splitlines()[-1]), answers


@needs_gxx
def test_a_number_of_its_own_added_as_new_files_alone(checkout):
    """The new number is read on every answer and printed beside its
    limit; the answers' other numbers are the standard cell's on the same
    input and seed; no file that was there has changed."""
    root, before = checkout
    p, line, new = _rehearse(root, CELL)
    assert line["correct"] is True and line["failed"] == 0, line
    value = line["checks"][NUMBER]["value"]
    assert line["checks"][NUMBER]["limit"] == LIMIT and value <= 1e-12
    assert f"check {NUMBER} {value!r} limit {LIMIT}" in \
        p.stderr.splitlines()
    assert new and all(float(nums[NUMBER]) <= 1e-12 for nums in new.values())
    _, _, old = _rehearse(root, "standard.flac_10min")
    common = set(new) & set(old)
    assert common, (new, old)
    for name in common:
        assert {k: v for k, v in new[name].items() if k != NUMBER} == \
            old[name]
    for path, data in before.items():
        assert path.read_bytes() == data, path


@needs_gxx
def test_a_fault_in_the_further_output_is_not_correct(checkout):
    """The report's peak 0.001 dB high fails the new number, and only
    it."""
    _, line, _ = _rehearse(checkout[0], f"{CELL}_fault")
    assert line["correct"] is False
    over = {k for k, c in line["checks"].items()
            if not float(c["value"]) <= c["limit"]}
    assert over == {NUMBER}
    assert abs(line["checks"][NUMBER]["value"] - 1e-3) < 1e-9


@needs_gxx
def test_a_nan_in_the_further_output_is_not_correct(checkout):
    """The report's peak NaN reads inf, over its limit, and only it."""
    _, line, answers = _rehearse(checkout[0], f"{CELL}_nan")
    assert line["correct"] is False
    assert line["checks"][NUMBER]["value"] == "inf"
    assert answers and all(nums[NUMBER] == "inf"
                           for nums in answers.values())
    over = {k for k, c in line["checks"].items()
            if not float(c["value"]) <= c["limit"]}
    assert over == {NUMBER}


@needs_gxx
def test_a_number_without_a_limit_is_not_correct(checkout):
    _, line, _ = _rehearse(checkout[0], f"{CELL}_no_limit")
    assert line["correct"] is False
    assert line["checks"][NUMBER]["limit"] is None
    assert line["checks"][NUMBER]["value"] <= 1e-12
    over = {k for k, c in line["checks"].items()
            if k != NUMBER and not float(c["value"]) <= c["limit"]}
    assert not over, line["checks"]


class _Inputs:
    """Inputs as the harness's hands them to the reference and the
    control: one file's samples and a working directory."""
    format = "flac"

    def __init__(self, x, workdir):
        self.x, self.workdir = x, str(workdir)

    def __len__(self):
        return 1

    def reference_input(self, i):
        return self.x


def _short_input(cell: spec.Cell, seconds: float = 20.0) -> np.ndarray:
    """A PCM_24 input of the cell's mix, as a file's samples over 2^23."""
    mix = dict(cell.mix, lengths_s=[seconds])
    x = spec.load_module("traffic", mix["generator"]).make(
        mix, cell.config, 5)[0]
    return to_pcm24(x).astype(np.float64) / FULL_SCALE


@pytest.fixture
def engineering(checkout, monkeypatch):
    """The copy's module of numbers, loaded where harness.spec keeps it."""
    root = checkout[0]
    name = "bench_reference_engineering_ref"
    mod_spec = importlib.util.spec_from_file_location(
        name, root / "benchmark/reference/engineering_ref.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


def test_the_control_carries_the_further_outputs(checkout, tmp_path,
                                                 engineering):
    """The control's answer carries the module's further output, made at
    bfloat16, and reads the new number over its limit; the reference in
    the program's place at its own precision reads 0. The configuration
    is the standard one as it is."""
    cell = spec.load_cell("standard.flac_10min")
    config = cell.config
    limits = spec.load_json(checkout[0],
                            f"benchmark/workloads/{CELL}.json")["limits"]
    x = _short_input(cell)

    (low,) = control.answers(_Inputs(x, tmp_path / "low"), config,
                             own=engineering)
    with open(low.files["engineering"], encoding="utf-8") as f:
        report = json.load(f)
    assert report["frames_in"] == report["frames_out"] == len(x)
    ok, checks = check.judge(check.compare([low], _Inputs(x, tmp_path),
                                           config, own=engineering), limits)
    assert not ok and checks[NUMBER]["value"] > limits[NUMBER]

    (same,) = control.answers(_Inputs(x, tmp_path / "same"), config,
                              quantise=precision.identity, own=engineering)
    nums = check.compare([same], _Inputs(x, tmp_path), config,
                         own=engineering)
    assert nums[NUMBER] == 0.0 and nums["audio_lsb"] == 0


def test_an_output_that_cannot_be_read_reads_inf(tmp_path, engineering,
                                                 capsys):
    """A further output missing, not JSON, or NaN reads inf, not a crash
    and not a pass; where it cannot be read, the cause is logged."""
    config = spec.load_cell("standard.flac_10min").config
    x = _short_input(spec.load_cell("standard.flac_10min"), 10.0)
    (a,) = control.answers(_Inputs(x, tmp_path), config, own=engineering)
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    nan = tmp_path / "nan.json"
    with open(a.files["engineering"], encoding="utf-8") as f:
        nan.write_text(json.dumps(dict(json.load(f), peak_dbfs=np.nan)))
    for files in ({}, {"engineering": str(tmp_path / "none.json")},
                  {"engineering": str(bad)}, {"engineering": str(nan)}):
        a.files = files
        capsys.readouterr()
        nums = check.compare([a], _Inputs(x, tmp_path), config,
                             own=engineering)
        assert nums[NUMBER] == np.inf, files
        logged = capsys.readouterr().err
        if files and files["engineering"] != str(nan):
            assert f"check: {a.name}: " in logged, files


def test_a_nan_sample_reads_inf(tmp_path):
    """An array answer with a NaN sample reads inf, and fails."""
    cell = spec.load_cell("standard.flac_10min")
    x = _short_input(cell, 10.0)
    inputs = _Inputs(x, tmp_path)
    inputs.format = "array"
    (a,) = control.answers(inputs, cell.config, precision.identity)
    a.y = a.y.copy()
    a.y[[len(x) // 4, -1], 0] = np.nan      # before the last cut, and in it
    nums = check.compare([a], inputs, cell.config)
    assert nums["audio_lsb"] == nums["end_lsb"] == np.inf
    assert not check.judge(nums, {"audio_lsb": 1024, "end_lsb": 128})[0]


TODAY = {
    "standard.flac_10min": {"audio_lsb", "end_lsb", "state_frames",
                            "level_db"},
    "standard.batch8_flac": {"audio_lsb", "end_lsb", "state_frames",
                             "level_db"},
    "xfade.flac_tracks": {"audio_lsb", "end_lsb", "state_frames",
                          "level_db", "alpha_frames"},
    "adaptive.flac_10min": {"audio_lsb", "end_lsb", "state_frames",
                            "level_db", "alpha_frames"},
}


@pytest.mark.parametrize("name", sorted(TODAY))
def test_the_cells_there_keep_their_numbers(name, tmp_path):
    """Each of the four cells' control is compared on exactly its
    numbers, each reading what the audio and CSV gaps alone read, with no
    further output."""
    cell = spec.load_cell(name)
    assert set(cell.workload["limits"]) == TODAY[name]
    x = _short_input(cell)
    inputs = _Inputs(x, tmp_path)
    answers = control.answers(inputs, cell.config)
    assert [a.files for a in answers] == [{}]
    nums = check.compare(answers, inputs, cell.config)
    assert set(nums) == TODAY[name]
    ref = spec.reference(cell.config).render(x, cell.config)
    a = answers[0]
    alone = check._audio_gaps(a, ref, cell.config["params"]["n_fft"])
    alone.update(check._csv_gaps(a, ref, cell.config))
    assert nums == alone


@needs_gxx
def test_further_files_fold_by_their_bytes(tmp_path):
    """Outputs of equal audio and CSV are one answer only where their
    further files are equal too, and the answer carries their paths; a
    three-element output is an answer with no further file."""
    from reference import flaccodec
    audio = tmp_path / "a.flac"
    pcm = (np.arange(8192, dtype=np.int32).reshape(-1, 2) * 997) % 4096
    flaccodec.encode(str(audio), pcm, 48000)
    reports = []
    for k, text in enumerate(("1", "1", "2")):
        reports.append(tmp_path / f"r{k}.json")
        reports[-1].write_text(text)
    jobs = [driving.Job(k, 1.0, 1.0, outputs=[
        (0, str(audio), None, {"report": str(r)})])
        for k, r in enumerate(reports)]
    answers = driving.file_answers(jobs)
    assert sorted(a.files["report"] for a in answers) == [
        str(reports[0]), str(reports[2])]
    assert all(np.array_equal(a.pcm, pcm) for a in answers)
    (plain,) = driving.file_answers([driving.Job(0, 1.0, 1.0, outputs=[
        (0, str(audio), None)])])
    assert plain.files == {} and plain.csv is None
