"""The audited job, standard.verify_10min, rehearsed on the CPU: `correct`
through the port's process, validate and verify against
reference/verify_ref.py, with the five audit metrics read from the
verifiers' spans and counters; a window's repeats of its one input fold
to one answer; and `correct` false under each fault of the verifiers'
outputs, each planted where the program produces it:
  - one bin of the validator's spectrum CSV 0.01 dB high;
  - one ok flag of the verifier's results flipped;
  - the verifier's report not written;
  - a NaN in one of the validator's band RMSEs;
and for the bfloat16 control in the program's place."""
import functools
import math
import os
import re
import shutil
import sys

import numpy as np
import pytest

from harness import check, control, driving, spec
from harness.inputs import Inputs
from helpers import rehearse, run_module

CELL = "standard.verify_10min"
OWN = ("verify_gate_frames", "verify_spectrum_db", "verify_metrics_db",
       "verify_tilt_db", "verify_verdicts")
AUDIT = {"audit_decode_pct", "audit_gate_pct", "audit_spectrum_pct",
         "audit_spectrum_frame_us", "audit_artifacts_pct",
         "realtime_x.per_layer"}
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")


@pytest.fixture
def quiet(monkeypatch):
    """No PNGs (a first matplotlib import under a fresh HOME spends a
    minute on its font cache), two CPU threads, the environment kept."""
    import torch
    torch.set_num_threads(2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _over(line: dict) -> set:
    return {k for k, c in line["checks"].items()
            if not float(c["value"]) <= c["limit"]}


@needs_gxx
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(trace, capsys, quiet):
    rc, line = rehearse(capsys, CELL, seed=2 ** 31 + 2424, trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0, line
    assert set(OWN) <= set(line["checks"])
    if trace:
        assert set(line["metrics"]) == AUDIT
        assert all(m["value"] > 0 for m in line["metrics"].values())


def _seed_keeping_round(first: int) -> int:
    """A seed whose kept round of the one input is `first`."""
    return next(s for s in range(2 ** 31, 2 ** 31 + 1000)
                if driving.OutputSlots(s, 1).kept[0] == first)


@needs_gxx
def test_repeats_fold_to_one_answer(capsys, quiet):
    """The kept round (the first job) and the newest job wrote their
    outputs to two paths; their bytes, the further outputs' among them,
    are equal, so the check holds one answer."""
    seed = _seed_keeping_round(0)
    rc = run_module().main(["--workload", CELL, "--seed", str(seed),
                            "--seconds", "2.5", "--trace", "0",
                            "--rehearse"])
    out = capsys.readouterr()
    assert rc == 0
    run = [ln for ln in out.err.splitlines() if ln.startswith("run: ")]
    jobs = re.search(r'"jobs": \[(.*?)\]\], ', run[0]).group(1)
    assert jobs.count("[") >= 2, jobs
    answers = re.findall(r"^answer (\S+):", out.err, re.M)
    assert len(answers) == 1, answers
    assert "check: 1 output(s)" in out.err


def _spectrum_bin_high(monkeypatch):
    # verify_15db binds write_spectrum_csv when it is imported: import it
    # before the patch, so that only the validator's CSV is altered
    from tomatis_tpu_torch.verify import validate_layer1, verify_15db  # noqa
    write = validate_layer1.write_spectrum_csv

    def high(path, freqs, c1_db, *rest):
        c1_db = np.array(c1_db, copy=True)
        c1_db[len(c1_db) // 3] += 0.01
        return write(path, freqs, c1_db, *rest)

    monkeypatch.setattr(validate_layer1, "write_spectrum_csv", high)


def _verdict_flipped(monkeypatch):
    from tomatis_tpu_torch.verify import verify_15db
    verify = verify_15db.verify

    @functools.wraps(verify)      # the driver reads the entry's signature
    def flipped(*a, **kw):
        res = verify(*a, **kw)
        sp = res["checks"]["spectrum"]
        sp["fc_ok"] = not sp["fc_ok"]
        return res

    monkeypatch.setattr(verify_15db, "verify", flipped)


def _report_missing(monkeypatch):
    from tomatis_tpu_torch.verify import verify_15db
    monkeypatch.setattr(verify_15db, "_write_report", lambda *a: None)


def _nan_metric(monkeypatch):
    from tomatis_tpu_torch.verify import validate_layer1
    validate = validate_layer1.validate

    @functools.wraps(validate)
    def nan(*a, **kw):
        res = validate(*a, **kw)
        res["checks"]["spectrum"]["c1_rmse"][1] = math.nan
        return res

    monkeypatch.setattr(validate_layer1, "validate", nan)


@needs_gxx
@pytest.mark.parametrize("fault, over", [
    (_spectrum_bin_high, {"verify_spectrum_db"}),
    (_verdict_flipped, {"verify_verdicts"}),
    (_report_missing, set(OWN)),
    (_nan_metric, {"verify_metrics_db"}),
])
def test_fault_is_not_correct(fault, over, capsys, monkeypatch, quiet):
    fault(monkeypatch)
    rc, line = rehearse(capsys, CELL, seed=2 ** 31 + 31)
    assert rc == 0
    assert line["correct"] is False
    assert _over(line) == over, line["checks"]


def test_the_bfloat16_control_is_not_correct(tmp_path, quiet):
    """The configuration's reference and both verifiers computed in
    bfloat16, in the program's place, fail the cell's own numbers (at a
    twentieth of the programme, as the rehearsal runs it)."""
    cell = spec.load_cell(CELL)
    inputs = Inputs(cell, 2 ** 31 + 11, str(tmp_path), 1 / 20)
    nums = check.compare(control.answers(inputs, cell.config,
                                         own=cell.numbers),
                         inputs, cell.config, own=cell.numbers)
    ok, checks = check.judge(nums, cell.workload["limits"])
    assert not ok
    assert {"verify_spectrum_db", "verify_metrics_db",
            "verify_tilt_db"} <= _over({"checks": checks}), checks
