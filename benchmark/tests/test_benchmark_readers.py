"""The metric readers on a run made up here: shares of the window, the
kernels' rates from the program's counters and the trace's kernel time, and
nothing where there is nothing sound to read; the trace's busy union and
idle gaps."""
import collections
import json

import pytest

from harness import spec
from harness.driving import Job
from harness.record import Run
from harness.trace import DeviceTrace
from reference.roofline import batched_tail_bytes, tail_bytes

SINGLE = "void chunk_tail_kernel<1, 0, 2, false>(Args, int const*)"
BATCHED = "void chunk_tail_kernel<1, 0, 2, true>(Args, int const*)"


def fake_trace(by_name, intervals=((0.0, 0.5),), t0=0.0, t1=10.0):
    t = object.__new__(DeviceTrace)
    t.by_name = {k: list(v) for k, v in by_name.items()}
    t.intervals = list(intervals)
    t.t0, t.t1 = t0, t1
    return t


class Ctx:
    def __init__(self, lanes, frames=1024):
        self.inputs = [None] * lanes
        self.frames_per_chunk = frames


def read(name, run):
    return spec.load_module("metrics", name).read(run)


def single_run(trace, by_frames, variants):
    cell = spec.load_cell("standard.flac_10min")
    jobs = [Job(k, 600.0, 12.0, {"timings": {
        "runner_setup_s": 0.02, "input_host_s": 0.1,
        "dispatch_compute_s": 0.2, "consume_s": 9.0,
        "output_decode_s": 0.0}}) for k in range(3)]
    counters = {"chunk_tail.by_frames": collections.Counter(by_frames),
                "chunk_tail.by_variant": collections.Counter(variants)}
    return Run(cell, Ctx(1), 15.0, 36.0, jobs, counters, trace, 450e6)


def test_window_shares_and_rates():
    run = single_run(None, {}, {})
    assert read("realtime_x", run) == pytest.approx(1800 / 36)
    assert read("realtime_x.per_layer", run) == pytest.approx(1800 / 36)
    assert read("setup_s", run) == 15.0
    assert read("job_setup_ms", run) == pytest.approx(20.0)
    assert read("writer_wait_pct", run) == pytest.approx(100 * 27 / 36)
    assert read("input_wait_pct", run) == pytest.approx(100 * 0.3 / 36)
    assert read("peak_device_mb", run) == pytest.approx(450.0)
    assert read("device_idle_pct", run) is None
    assert read("device_ms_per_audio_min", run) is None
    assert read("chunk_tail_gbps", run) is None
    assert read("batch_read_pct", run) is None


def test_chunk_tail_rate_from_counts_and_trace():
    frames = {256: 3, 512: 3, 1024: 39}
    trace = fake_trace({SINGLE: (0.0013, 45), BATCHED: (1.0, 2),
                        "Memcpy HtoD": (0.5, 90)})
    run = single_run(trace, frames, {("eps", "pcm24", 2): 45})
    want = sum(n * tail_bytes(F, 2, 4096, 2048, "pcm24")
               for F, n in frames.items()) / 0.0013 / 1e9
    assert read("chunk_tail_gbps", run) == pytest.approx(want)
    # the trace missed a launch: no sound reading
    run.trace = fake_trace({SINGLE: (0.0013, 44)})
    assert read("chunk_tail_gbps", run) is None
    # two variants in one window: the counts by size cannot be split
    run = single_run(trace, frames, {("eps", "pcm24", 2): 40,
                                     ("eps", "f32", 2): 5})
    assert read("chunk_tail_gbps", run) is None
    # the counters print with tuple keys made strings
    json.dumps({str(k): v for k, v in run.counters[
        "chunk_tail.by_variant"].items()})


def test_batched_rate_and_batch_shares():
    cell = spec.load_cell("standard.batch8_flac")
    jobs = [Job(k, 952.0, 4.0, {"lanes": [], "timings": {
        "read_s": 1.0, "lane_write_s": [1.0, 2.5, 2.0]}}) for k in range(8)]
    trace = fake_trace({BATCHED: (0.0075, 32)})
    run = Run(cell, Ctx(8), 20.0, 32.0, jobs,
              {"chunk_tail_batched.launches": 32,
               "chunk_tail_batched.by_variant":
               collections.Counter({("eps", "pcm24", 2): 32})}, trace, 1e9)
    want = 32 * batched_tail_bytes(8, 1024, 2, 4096, 2048, "pcm24") \
        / 0.0075 / 1e9
    assert read("chunk_tail_batched_gbps", run) == pytest.approx(want)
    assert read("batch_read_pct", run) == pytest.approx(100 * 8 / 32)
    assert read("batch_write_pct", run) == pytest.approx(100 * 20 / 32)
    assert read("chunk_tail_gbps", run) is None


def test_busy_union_and_idle_gaps():
    t = fake_trace({}, intervals=[(1.0, 2.0), (1.5, 3.0), (5.0, 6.0),
                                  (9.5, 12.0)], t0=0.0, t1=10.0)
    assert t.busy() == [[1.0, 3.0], [5.0, 6.0], [9.5, 10.0]]
    assert t.busy_s() == pytest.approx(3.5)
    spans = [("job", 0.0, 10.0), ("entry.process", 2.5, 8.0)]
    gaps = dict(t.idle_gaps(spans))
    assert gaps == pytest.approx({"entry.process": 5.5, "job": 1.0})
    run = single_run(t, {}, {})
    assert read("device_idle_pct", run) == pytest.approx(65.0)
    # 3.5 s of device time over three jobs of 600 s of audio
    assert read("device_ms_per_audio_min", run) == pytest.approx(
        1000 * 3.5 / 30)


def test_events_of_a_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from harness.trace import _events
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(DeviceTrace.ANCHOR):
            pass
        torch.ones(8) + 1
    events = _events(prof)
    anchor = [e for e in events if e[0] == DeviceTrace.ANCHOR]
    assert len(anchor) == 1 and anchor[0][4] and not anchor[0][1]
    assert all(a <= b for _, _, a, b, _ in events)
    assert any(e[0] == "aten::add" for e in events)
