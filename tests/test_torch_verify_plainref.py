"""The port's two verifiers (tomatis_tpu_torch/verify/validate_layer1.py
and verify_15db.py) against the benchmark's plain float64 reference of
them (benchmark/reference/verify_ref.py), on seeded programmes of 6-10 s
made by the benchmark's traffic generator (passages of 1-3 s, 12 dB
under and over the -40 dBFS gate, quiet first) and processed by the
port's `process` with StandardParams(); each verifier gets the sidecar's
settings, as the audited job runs them.

Bounds, each with its reason:
  - gate counts and run statistics (in frames) and every PASS/FAIL and ok
    flag, the exact values and the report's lines: equal (0); no level of
    these programmes lies within rounding of a threshold;
  - the spectrum CSVs' measured columns: 1e-3 dB, the CSV's four
    decimals (5e-5) and float32 rounding of the per-frame |rfft| ratios
    (the CPU reads up to 1.3e-4 dB);
  - band RMSEs, fc errors, platforms, level gaps and means, theory
    columns: 1e-3 dB, the same four decimals on the theory columns and
    float32 sums over a band;
  - the Tilt Index statistics: 1e-4 dB, float32 band energies (the CPU
    reads up to 3e-6 dB).
The reference rounded to bfloat16 at every stage, in the port's place,
fails them: they are tight enough to tell.
"""
import importlib.util
import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.cli.process import sidecar_fields
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.verify import validate_layer1, verify_15db

torch.set_num_threads(2)
SR = 48000
FULL = 8388608.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
BOUNDS = {"verify_gate_frames": 0.0, "verify_verdicts": 0.0,
          "verify_spectrum_db": 1e-3, "verify_metrics_db": 1e-3,
          "verify_tilt_db": 1e-4}


def _load(name: str, *parts: str):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("verify_ref_under_test", "reference", "verify_ref.py")
tomatis_ref = _load("tomatis_ref_under_test", "reference", "tomatis_ref.py")
precision = _load("precision_under_test", "reference", "precision.py")
programme = _load("programme_under_test", "traffic", "programme.py")
with open(os.path.join(BENCH, "configs", "standard_audited.json"),
          encoding="utf-8") as _f:
    CONFIG = json.load(_f)
with open(os.path.join(BENCH, "traffic", "verify_10min.json"),
          encoding="utf-8") as _f:
    MIX = json.load(_f)


class Answer:
    """What the reference reads of an answer (harness.check.Answer)."""

    def __init__(self, name, pcm, csv, files=None):
        self.name, self.pcm, self.y = name, pcm, None
        self.csv, self.files = csv, files or {}


def _csv_table(path) -> dict:
    from tomatis_tpu_torch.utils.stateio import read_state_csv
    t = read_state_csv(path)
    return {"frame_idx": t["frame_idx"], "level": t["level_dbfs"],
            "state": t["state"]}


def _call(fn, fields: dict, *pos, **kw):
    """fn with the sidecar's fields that it takes."""
    names = inspect.signature(fn).parameters
    return fn(*pos, **{k: v for k, v in fields.items() if k in names}, **kw)


def _results_json(res: dict, path) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({k: v for k, v in res.items()
                   if k not in ("timings", "counters")}, f)
    return str(path)


# (seconds, seed); the last is not a whole number of hops
CASES = [(6.0, 2 ** 31 + 5), (8.0, 7), (9.7, 2 ** 33 + 1)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}s-seed{c[1]}")
def case(request, tmp_path_factory):
    seconds, seed = request.param
    mix = dict(MIX, lengths_s=[seconds], passage_s=[1.0, 3.0])
    x = programme.make(mix, CONFIG, seed)[0]
    x = np.clip(np.rint(x.astype(np.float64) * FULL), -FULL, FULL - 1) / FULL
    d = tmp_path_factory.mktemp("verify_plainref")
    ip, op, cp = d / "in.flac", d / "out.flac", d / "s.csv"
    audio.write(ip, x.astype(np.float32), SR, subtype="PCM_24")
    params = StandardParams()
    process(ip, op, params, state_csv_path=cp, frames_per_chunk=64,
            device="cpu")
    fields = sidecar_fields(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)   # no PNGs
        val = _call(validate_layer1.validate, fields, ip, op, cp,
                    out_csv=str(d / "v.csv"), out_png=None, device="cpu")
        ver = _call(verify_15db.verify, fields, ip, op,
                    out_prefix=str(d / "f"), device="cpu")
    y, _ = audio.read(op)
    pcm = np.rint(y.astype(np.float64) * FULL).astype(np.int32)
    files = {"validate_csv": str(d / "v.csv"),
             "verify15_csv": str(d / "f_spectrum.csv"),
             "verify15_report": str(d / "f_report.txt"),
             "validate_json": _results_json(val, d / "v.json"),
             "verify15_json": _results_json(ver, d / "f.json")}
    answer = Answer("port", pcm, _csv_table(cp), files)
    r = tomatis_ref.render(x, CONFIG)
    nums = ref.numbers(answer, x, r, CONFIG)
    return dict(x=x, r=r, val=val, ver=ver, nums=nums, dir=d)


def test_gate_counts_and_verdicts_equal(case):
    nums, val, ver = case["nums"], case["val"], case["ver"]
    assert nums["verify_gate_frames"] == 0 and nums["verify_verdicts"] == 0
    # the programmes switch, and each tool's spectrum has frames of both
    # states to hold
    assert 0 < ver["checks"]["gate_stats"]["c2_ratio"] < 1
    for res in (val, ver):
        sp = res["checks"]["spectrum"]
        assert sp["c1_frames"] > 0 and sp["c2_frames"] > 0


def test_spectrum_metrics_and_tilt_within_bounds(case):
    nums = case["nums"]
    for k in ("verify_spectrum_db", "verify_metrics_db", "verify_tilt_db"):
        assert nums[k] <= BOUNDS[k], (k, nums[k])


def test_results_are_the_references_own(case):
    """The numbers read 0 where the answer is the reference's own outputs
    (outputs() at float64): the comparison itself adds nothing but the
    CSVs' printing."""
    x, r, d = case["x"], case["r"], case["dir"]
    own = Answer("reference", r["pcm"], {
        "frame_idx": r["csv_frame_idx"], "level": r["levels"][r["rows"]],
        "state": np.where(r["states"][r["rows"]] == 2, "C2", "C1")})
    os.makedirs(d / "own", exist_ok=True)
    own.files = ref.outputs(own, x, r, CONFIG, precision.identity,
                            str(d / "own"))
    nums = ref.numbers(own, x, r, CONFIG)
    assert nums["verify_gate_frames"] == nums["verify_verdicts"] == 0
    assert nums["verify_tilt_db"] == 0
    assert nums["verify_spectrum_db"] <= 5e-5 + 1e-9
    assert nums["verify_metrics_db"] <= 5e-5 + 1e-9


def test_bfloat16_reference_fails_the_bounds(case):
    """The reference computed in bfloat16, in the port's place (its render
    and both verifiers), fails at least one bound on every case."""
    x, d = case["x"], case["dir"]
    low = tomatis_ref.render(x, CONFIG, precision.bfloat16)
    answer = Answer("bfloat16", low["pcm"], {
        "frame_idx": low["csv_frame_idx"],
        "level": low["levels"][low["rows"]],
        "state": np.where(low["states"][low["rows"]] == 2, "C2", "C1")})
    os.makedirs(d / "low", exist_ok=True)
    answer.files = ref.outputs(answer, x, low, CONFIG, precision.bfloat16,
                               str(d / "low"))
    nums = ref.numbers(answer, x, case["r"], CONFIG)
    over = {k for k, v in nums.items() if not v <= BOUNDS[k]}
    assert {"verify_spectrum_db", "verify_tilt_db"} <= over, nums
