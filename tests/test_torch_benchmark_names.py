"""The names the benchmark reads from the port, pinned on short CPU runs:
every stage timer a reader in benchmark/metrics/ names (each "<key>_s"
string in its source) is in the stats of the runs of its kind, a FLAC
`process`, a crossfade `process`, a B = 2 `process_batch`, a
`process_array`, an adaptive `process`, and the two verifiers of the
audited job (`validate`, `verify`) on the `process` output; every launch
counter of benchmark/harness/counters.py is on ops/cuda_ola.py; and the
timers keep their identities. The benchmark's
own tests are not in the Tier-1 command, so a renamed timer would pass
it without this file."""
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.cli.process import sidecar_fields
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import adaptive, standard, xfade
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.parallel import batch
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.verify import validate_layer1, verify_15db

torch.set_num_threads(2)
SR = 48000
FPC = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(REPO, "benchmark", "metrics")


def _sig(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.003 + 0.1 * (np.sin(2 * np.pi * 0.4 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t) + 0.05 * rng.standard_normal(n))
    return np.stack([x, 0.8 * x], 1).astype(np.float32)


def _read_keys() -> dict:
    """{metric file: the "<key>_s" names its source reads}."""
    out = {}
    for f in sorted(os.listdir(METRICS)):
        if f.endswith(".py"):
            src = open(os.path.join(METRICS, f), encoding="utf-8").read()
            keys = set(re.findall(r'"(\w+_s)"', src))
            if keys:
                out[f[:-3]] = keys
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("names")
    ip = d / "in.flac"
    audio.write(ip, _sig(6.0), SR, subtype="PCM_24")
    lanes = []
    for i in (0, 1):
        lanes.append(d / f"l{i}.flac")
        audio.write(lanes[-1], _sig(2.5 + i, seed=i + 1), SR,
                    subtype="PCM_24")
    with trace.timeline():
        st = process(ip, d / "o.flac", StandardParams(),
                     state_csv_path=d / "s.csv", frames_per_chunk=FPC,
                     device="cpu")
        rows = [r for r in trace.rows() if r.job == st["job_id"]]
    xf = xfade.process(ip, d / "x.flac", xfade.XfadeParams(xfade_ms=500),
                       state_csv_path=d / "x.csv", frames_per_chunk=FPC,
                       device="cpu")
    batch.process_batch([(p, d / f"b{i}.flac") for i, p in enumerate(lanes)],
                        StandardParams(), frames_per_chunk=FPC,
                        state_csv_paths=[d / "b0.csv", d / "b1.csv"],
                        device="cpu")
    lt = dict(batch.LAST_TIMINGS)
    _, arr = standard.process_array(_sig(3.0), SR, frames_per_chunk=FPC,
                                    transport="pcm24", device="cpu")
    ad = adaptive.process(ip, d / "a.flac", adaptive.AdaptiveParams(),
                          state_csv_path=d / "a.csv", frames_per_chunk=FPC,
                          device="cpu")
    # the audited job's verifiers with the sidecar's settings, no PNGs
    fields = {k: v for k, v in sidecar_fields(StandardParams()).items()
              if k not in ("threshold_dbfs", "gate_mode", "dynamic_range",
                           "output_gain_db")}
    with pytest.MonkeyPatch.context() as mp, trace.timeline():
        mp.setitem(sys.modules, "matplotlib", None)
        trace.clear()
        val = validate_layer1.validate(ip, d / "o.flac", d / "s.csv",
                                       out_csv=str(d / "v.csv"),
                                       out_png=None, device="cpu", **fields)
        val_rows = trace.rows()
        trace.clear()
        ver = verify_15db.verify(ip, d / "o.flac", out_prefix=str(d / "f"),
                                 device="cpu", **fields)
        ver_rows = trace.rows()
    return dict(process=st, xfade=xf, batch=lt, array=arr, rows=rows,
                adaptive=ad, validate=val, verify15=ver,
                verify_rows={"validate": val_rows, "verify15": ver_rows})


def test_every_timer_a_reader_names_is_there(runs):
    keys = _read_keys()
    # the readers this repo has, old and new
    assert {"writer_wait_pct", "input_wait_pct", "dispatch_pct",
            "job_setup_ms", "array_collect_pct", "batch_read_pct",
            "batch_write_pct", "writer_encode_pct", "writer_busy_pct",
            "producer_decode_pct", "producer_wait_pct", "batch_encode_pct",
            "batch_decode_pct", "adaptive_decode_pct", "adaptive_probe_ms",
            "adaptive_pass3_pct", "adaptive_finalize_pct", "audit_decode_pct",
            "audit_gate_pct", "audit_spectrum_pct", "audit_spectrum_frame_us",
            "audit_artifacts_pct"} <= set(keys)
    for metric, names in keys.items():
        if metric.startswith("batch_"):
            kinds = ("batch",)
        elif metric.startswith("array_"):
            kinds = ("array",)
        elif metric.startswith("adaptive_"):
            kinds = ("adaptive",)
        elif metric.startswith("audit_"):
            kinds = ("validate", "verify15")
        else:
            kinds = ("process", "xfade")
        for kind in kinds:
            have = runs[kind] if kind == "batch" else runs[kind]["timings"]
            assert names <= set(have), (metric, kind, names - set(have))


def test_every_counter_the_benchmark_reads_is_there():
    path = os.path.join(REPO, "benchmark", "harness", "counters.py")
    spec = importlib.util.spec_from_file_location("bench_counters_pin", path)
    counters = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(counters)
    assert set(counters.snapshot()) == set(counters.COUNTERS)


def test_the_timers_keep_their_identities(runs):
    for kind in ("process", "xfade"):
        t = runs[kind]["timings"]
        assert t["input_host_s"] >= t["producer_wait_s"] >= 0
        assert t["consume_s"] >= 0 and t["encode_s"] > 0
        assert t["decode_s"] > 0 and t["writer_busy_s"] > 0
    # the writer's own encode lies inside its busy time; the last flush
    # cut's encode (the final drain) and the encoder's close run on the
    # calling thread
    t, rows = runs["process"]["timings"], runs["rows"]
    outside = sum(r.t1 - r.t0 for r in rows
                  if r.name in ("writer.encode", "writer.close")
                  and r.thread != "writer")
    csv = sum(r.t1 - r.t0 for r in rows if r.name == "writer.csv")
    assert outside > 0 and csv > 0
    assert t["writer_busy_s"] >= t["encode_s"] + csv - outside - 3e-4
    lt = runs["batch"]
    assert len(lt["lane_encode_s"]) == len(lt["lane_decode_s"]) \
        == len(lt["lane_write_s"]) == 2
    assert all(e > 0 for e in lt["lane_encode_s"] + lt["lane_decode_s"])
    for k in ("chunks", "block_launches", "devices", "transport"):
        assert k in lt
    assert runs["array"]["timings"]["output_decode_s"] >= 0


def test_the_adaptive_timers_keep_their_identities(runs):
    """The adaptive processor's probe count is there for adaptive_probe_ms,
    its reads lie inside the three passes, and a chunk's step and staging
    write inside pass 3."""
    st = runs["adaptive"]
    t = st["timings"]
    assert st["search_probes"] >= 1 and t["threshold_search_s"] > 0
    assert 0 < t["decode_s"] <= t["peak_scan_s"] + t["levels_s"] \
        + t["pass3_s"]
    assert 0 < t["step_s"] + t["stage_write_s"] <= t["pass3_s"]
    assert 0 < t["encode_s"] <= t["restore_protect_s"]


# span name -> (the timer it sums into, or None, and its parents)
VERIFY_SPANS = {
    "verify.decode": ("decode_s", {"verify.validate", "verify.verify15"}),
    "verify.gate": ("gate_s", {"verify.validate", "verify.verify15"}),
    "verify.levels": (None, {"verify.gate"}),
    "verify.gate_scan": (None, {"verify.gate"}),
    "verify.spectrum": ("spectrum_s", {"verify.validate", "verify.verify15"}),
    "verify.ratios": (None, {"verify.spectrum"}),
    "verify.median": (None, {"verify.spectrum"}),
    "verify.tilt": ("tilt_s", {"verify.verify15"}),
    "verify.artifacts": ("artifacts_s", {"verify.validate",
                                         "verify.verify15"}),
}
PARENT = {"validate": "verify.validate", "verify15": "verify.verify15"}


def test_the_verifier_timers_keep_their_identities(runs):
    """The audited job's readers find their counters; each verifier's
    stage timers sum to no more than its call's span; the spectrum
    computed at least the frames it kept; the call uploaded."""
    for tool in ("validate", "verify15"):
        res = runs[tool]
        t, c = res["timings"], res["counters"]
        want = {"decode_s", "gate_s", "spectrum_s", "artifacts_s"}
        if tool == "verify15":
            want.add("tilt_s")
        assert set(t) == want and all(v > 0 for v in t.values()), t
        (call,) = [r for r in runs["verify_rows"][tool]
                   if r.name == PARENT[tool]]
        assert sum(t.values()) <= call.t1 - call.t0
        sp = res["checks"]["spectrum"]
        assert c["spectrum_frames"] >= sp["c1_frames"] + sp["c2_frames"] > 0
        assert c["upload_bytes"] > 0
    # one upload a signal and use at least: the validator's levels and
    # spectrum take the input twice and the output once, the verifier's
    # Tilt Index both once more
    n = runs["validate"]["checks"]["engineering"]["frames_in"]
    assert runs["validate"]["counters"]["upload_bytes"] >= 3 * n * 2 * 4
    assert runs["verify15"]["counters"]["upload_bytes"] >= 5 * n * 2 * 4


def test_the_verifier_spans_are_rows(runs):
    """Under trace.timeline() each verifier's call is one parent row on the
    calling thread, its stages nested as they are, each stage timer the
    sum of its spans."""
    for tool, rows in runs["verify_rows"].items():
        assert {r.thread for r in rows} == {"MainThread"}
        names = {r.name for r in rows}
        want = set(VERIFY_SPANS) | {PARENT[tool]}
        if tool == "validate":
            want.discard("verify.tilt")
        assert names == want, names ^ want
        for r in rows:
            if r.name == PARENT[tool]:
                assert r.parent is None
            else:
                assert r.parent in VERIFY_SPANS[r.name][1], r
        t = runs[tool]["timings"]
        for name, (key, _) in VERIFY_SPANS.items():
            if key in t:
                total = sum(r.t1 - r.t0 for r in rows if r.name == name)
                assert abs(total - t[key]) <= 1e-6, (name, total, t[key])
