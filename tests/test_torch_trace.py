"""The port's span recorder (tomatis_tpu_torch/utils/trace.py) on the CPU:
rows from the calling, producer and writer threads and from the batch's
lanes, parents that nest, one job id a run, each stage timer the sum of
its spans, no rows with the timeline off, a bounded buffer, the same
output bytes with the timeline on and off, and the program's spans as
tracks of their own in `process --profile_dir`'s trace."""
import collections
import json

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import xfade
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.parallel import batch
from tomatis_tpu_torch.utils import trace

# two intra-op threads: the suite runs several workers side by side
torch.set_num_threads(2)
SR = 48000
FPC = 32

# the stage timer each span name sums into (StreamRunner.run and
# process_file)
KEYS = {"stream.setup": "runner_setup_s", "stream.input": "input_host_s",
        "stream.producer_wait": "producer_wait_s",
        "stream.dispatch": "dispatch_compute_s",
        "stream.consume": "consume_s", "stream.final_drain": "final_drain_s",
        "producer.decode": "decode_s", "writer.job": "writer_busy_s",
        "writer.encode": "encode_s", "writer.close": "encode_s"}


def _sig(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.003 + 0.1 * (np.sin(2 * np.pi * 0.4 * t) > 0)
    x = env * (np.sin(2 * np.pi * 700 * t) + 0.05 * rng.standard_normal(n))
    return np.stack([x, 0.9 * x], 1).astype(np.float32)


def _flac(tmp_path, name="in.flac", seconds=6.0, seed=0):
    path = tmp_path / name
    audio.write(path, _sig(seconds, seed), SR, subtype="PCM_24")
    return path


def _process(ip, op, csv):
    return process(ip, op, StandardParams(), state_csv_path=csv,
                   frames_per_chunk=FPC, device="cpu")


def _job_rows(stats):
    return [r for r in trace.rows() if r.job == stats["job_id"]]


@pytest.fixture
def timeline_on(monkeypatch):
    monkeypatch.setenv("TOMATIS_TRACE", "1")


def test_rows_from_every_thread_nest_and_share_the_job(tmp_path,
                                                       timeline_on):
    ip = _flac(tmp_path)
    st = _process(ip, tmp_path / "o.flac", tmp_path / "s.csv")
    st2 = _process(ip, tmp_path / "o2.flac", tmp_path / "s2.csv")
    assert st["job_id"] != st2["job_id"]
    rows = _job_rows(st)
    by_thread = collections.defaultdict(set)
    for r in rows:
        by_thread[r.thread].add(r.name)
    assert {"stream.setup", "stream.input", "stream.dispatch",
            "stream.consume", "stream.final_drain",
            "writer.close"} <= by_thread["MainThread"]
    assert by_thread["producer"] == {"producer.decode"}
    assert by_thread["writer"] == {"writer.job", "writer.csv",
                                   "writer.encode"}
    parent = {(r.name, r.thread): r.parent for r in rows}
    assert parent[("stream.producer_wait", "MainThread")] == "stream.input"
    assert parent[("stream.upload", "MainThread")] == "stream.input"
    assert parent[("stream.step", "MainThread")] == "stream.dispatch"
    assert parent[("stream.readback", "MainThread")] == "stream.consume"
    assert parent[("writer.csv", "writer")] == "writer.job"
    assert parent[("writer.encode", "writer")] == "writer.job"
    assert parent[("producer.decode", "producer")] is None
    assert parent[("stream.dispatch", "MainThread")] is None
    # a child lies inside its parent, on its parent's chunk
    jobs = [r for r in rows if r.name == "writer.job"]
    for r in rows:
        if r.name == "writer.csv":
            p = next(j for j in jobs if j.t0 <= r.t0 and r.t1 <= j.t1)
            assert r.at == p.at
    # one dispatch per chunk, at the chunk's first frame, in order
    at = [r.at for r in rows if r.name == "stream.dispatch"]
    assert len(at) == st["chunks"] > 3 and at == sorted(at) and at[0] == 0
    assert all(r.t0 <= r.t1 for r in rows)


def test_each_timer_is_the_sum_of_its_spans(tmp_path, timeline_on):
    ip = _flac(tmp_path)
    st = _process(ip, tmp_path / "o.flac", tmp_path / "s.csv")
    rows = _job_rows(st)
    t = st["timings"]
    sums = collections.Counter()
    for r in rows:
        if r.name in KEYS:
            sums[KEYS[r.name]] += r.t1 - r.t0
    assert set(sums) == set(KEYS.values())
    for key, s in sums.items():
        # the stats round each timer to 0.1 ms (process_file twice)
        assert t[key] == pytest.approx(s, abs=2e-4), key
    names = collections.Counter(r.name for r in rows)
    assert names["producer.decode"] > 0
    assert names["writer.encode"] > 1                        # two flushes
    # the CSV rows are a span of the timeline only, summed into no timer
    assert names["writer.csv"] > 0 and "csv_s" not in t


def test_timeline_off_keeps_no_rows_and_times_all_the_same(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("TOMATIS_TRACE", raising=False)
    ip = _flac(tmp_path)
    st = _process(ip, tmp_path / "o.flac", tmp_path / "s.csv")
    assert not _job_rows(st)
    t = st["timings"]
    assert t["encode_s"] > 0 and t["decode_s"] > 0
    assert t["writer_busy_s"] > 0 and t["producer_wait_s"] >= 0
    # the same with the switch at 0
    monkeypatch.setenv("TOMATIS_TRACE", "0")
    st = _process(ip, tmp_path / "o2.flac", tmp_path / "s2.csv")
    assert not _job_rows(st)


def test_outputs_equal_with_the_timeline_on_and_off(tmp_path, monkeypatch):
    ip = _flac(tmp_path)
    lanes = [_flac(tmp_path, f"l{i}.flac", 3.0 + i, seed=i) for i in (0, 1)]
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("TOMATIS_TRACE", mode)
        d = tmp_path / f"m{mode}"
        d.mkdir()
        _process(ip, d / "o.flac", d / "s.csv")
        xfade.process(ip, d / "x.flac", xfade.XfadeParams(xfade_ms=100),
                      state_csv_path=d / "x.csv", frames_per_chunk=FPC,
                      device="cpu")
        batch.process_batch([(p, d / f"b{i}.flac")
                             for i, p in enumerate(lanes)],
                            StandardParams(), frames_per_chunk=FPC,
                            state_csv_paths=[d / "b0.csv", d / "b1.csv"],
                            device="cpu")
        outs[mode] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    assert len(outs["0"]) == 8
    assert outs["0"] == outs["1"]


def test_batch_rows_carry_the_lane(tmp_path, timeline_on):
    lanes = [_flac(tmp_path, f"l{i}.flac", 2.0 + i, seed=i)
             for i in (0, 1, 2)]
    stats = batch.process_batch(
        [(p, tmp_path / f"o{i}.flac") for i, p in enumerate(lanes)],
        StandardParams(), frames_per_chunk=FPC, device="cpu")
    assert all(s["failed"] is None for s in stats)
    job = batch.LAST_TIMINGS["job_id"]
    rows = [r for r in trace.rows() if r.job == job]
    for i in range(3):
        mine = [r for r in rows if r.at == i]
        names = {r.name for r in mine}
        assert {"producer.decode", "writer.job", "writer.encode",
                "writer.close"} <= names
        assert {r.thread for r in mine if r.name == "writer.job"} == {
            f"writer-lane{i}"}
        assert all(r.thread.startswith("batch-read")
                   for r in mine if r.name == "producer.decode")
        lt = batch.LAST_TIMINGS
        for name, key in (("producer.decode", "lane_decode_s"),
                          ("writer.job", "lane_write_s")):
            s = sum(r.t1 - r.t0 for r in mine if r.name == name)
            assert lt[key][i] == pytest.approx(s, abs=1e-4)
        s = sum(r.t1 - r.t0 for r in mine
                if r.name in ("writer.encode", "writer.close"))
        assert lt["lane_encode_s"][i] == pytest.approx(s, abs=1e-4)
    assert lt["read_s"] == pytest.approx(
        sum(r.t1 - r.t0 for r in rows if r.name == "batch.read"), abs=1e-4)
    main = {r.name for r in rows if r.thread == "MainThread"}
    assert {"batch.stage", "batch.dispatch", "batch.consume",
            "batch.finish"} <= main


def test_buffer_stays_bounded(tmp_path, timeline_on, monkeypatch):
    assert trace._rows.maxlen == trace.MAX_ROWS
    small = collections.deque(maxlen=25)
    monkeypatch.setattr(trace, "_rows", small)
    acc = {}
    for k in range(100):
        with trace.span("unit.outer", acc, "outer_s", job=7, at=k):
            with trace.span("unit.inner"):
                pass
    rows = trace.rows()
    assert len(rows) == 25 and rows[-1].name == "unit.outer"
    assert rows[-1].at == 99 and rows[-2].at == 99     # inherited
    assert rows[-2].parent == "unit.outer"
    trace.clear()
    assert trace.rows() == []


def test_span_accumulates_with_the_timeline_off(monkeypatch):
    monkeypatch.delenv("TOMATIS_TRACE", raising=False)
    acc = {"a_s": 0.0}
    for _ in range(3):
        with trace.span("unit.a", acc, "a_s"):
            pass
    with trace.span("unit.none"):
        pass
    assert acc["a_s"] >= 0 and set(acc) == {"a_s"}
    assert not trace.enabled()
    with trace.timeline():
        assert trace.enabled()
    assert not trace.enabled()


def test_main_thread_spans_are_profiler_ranges(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setenv("TOMATIS_TRACE", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("unit.ranged"):
            torch.ones(4) + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "unit.ranged" in names


def test_profile_dir_adds_the_program_tracks(tmp_path, capsys):
    ip, op = _flac(tmp_path, seconds=3.0), tmp_path / "o.flac"
    rc = cli_main.main(["process", "-i", str(ip), "-o", str(op),
                        "--device", "cpu", "--frames_per_chunk", "16",
                        "--profile_dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "writer wait" in out and "encode" in out and "decode" in out
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    mine = [e for e in events if e.get("cat") == "program_span"]
    tracks = {e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"
              and str(e["args"].get("name", "")).startswith("program: ")}
    assert {"program: MainThread", "program: producer",
            "program: writer"} <= tracks
    assert {"writer.encode", "producer.decode",
            "stream.dispatch"} <= {e["name"] for e in mine}
    # aligned: the calling thread's dispatch span lies on the profiler's
    # range of the same name
    ranges = [e for e in events if e.get("name") == "stream.dispatch"
              and e.get("cat") != "program_span" and e.get("ph") == "X"]
    ours = sorted((e for e in mine if e["name"] == "stream.dispatch"),
                  key=lambda e: e["ts"])
    assert len(ranges) == len(ours) > 0
    for a, b in zip(sorted(ranges, key=lambda e: e["ts"]), ours):
        assert abs(a["ts"] - b["ts"]) < 500      # microseconds
