"""The readers of the program's span totals on a run made up here: the
writer's and the producer's shares of the window, the batch's slowest lane,
and nothing from a program whose stats lack the spans."""
import pytest

from harness import spec
from harness.driving import Job
from harness.record import Run

SPAN_METRICS = ("writer_encode_pct", "writer_busy_pct", "producer_decode_pct",
                "producer_wait_pct", "batch_encode_pct", "batch_decode_pct")


class Ctx:
    def __init__(self, lanes, frames=1024):
        self.inputs = [None] * lanes
        self.frames_per_chunk = frames


def read(name, run):
    return spec.load_module("metrics", name).read(run)


def file_run(timings):
    cell = spec.load_cell("standard.flac_10min")
    jobs = [Job(k, 600.0, 12.0, {"timings": dict(timings)}) for k in range(3)]
    return Run(cell, Ctx(1), 15.0, 36.0, jobs, {}, None, 450e6)


def batch_run(timings, batches):
    cell = spec.load_cell("standard.batch8_flac")
    jobs = [Job(k, 952.0, 4.0, {"lanes": [], "timings": dict(timings)})
            for k in range(batches)]
    return Run(cell, Ctx(8), 20.0, 32.0, jobs, {}, None, 1e9)


def test_span_shares_of_the_writer_and_the_producer():
    run = file_run({"input_host_s": 2.5, "producer_wait_s": 2.0,
                    "decode_s": 2.25, "consume_s": 9.0,
                    "writer_busy_s": 10.5, "encode_s": 9.75})
    assert read("writer_encode_pct", run) == pytest.approx(100 * 29.25 / 36)
    assert read("writer_busy_pct", run) == pytest.approx(100 * 31.5 / 36)
    assert read("producer_decode_pct", run) == pytest.approx(100 * 6.75 / 36)
    assert read("producer_wait_pct", run) == pytest.approx(100 * 6 / 36)
    assert read("batch_encode_pct", run) is None
    assert read("batch_decode_pct", run) is None


def test_span_shares_read_nothing_from_a_program_without_the_spans():
    """A program whose stats lack the span totals (the timers before the
    recorder) reports none of the six, and the older shares as before."""
    run = file_run({"runner_setup_s": 0.02, "input_host_s": 0.1,
                    "dispatch_compute_s": 0.2, "consume_s": 9.0,
                    "output_decode_s": 0.0})
    for name in SPAN_METRICS:
        assert read(name, run) is None, name
    assert read("writer_wait_pct", run) == pytest.approx(100 * 27 / 36)
    run = batch_run({"read_s": 1.0, "lane_write_s": [1.0, 2.5]}, 1)
    assert read("batch_encode_pct", run) is None
    assert read("batch_decode_pct", run) is None
    assert read("batch_write_pct", run) == pytest.approx(100 * 2.5 / 32)


def test_batch_span_shares_take_the_slowest_lane():
    run = batch_run({"read_s": 1.0, "lane_write_s": [1.0, 2.5, 2.0],
                     "lane_encode_s": [0.75, 2.25, 1.5],
                     "lane_decode_s": [0.5, 0.25, 1.0]}, 8)
    assert read("batch_encode_pct", run) == pytest.approx(100 * 18 / 32)
    assert read("batch_decode_pct", run) == pytest.approx(100 * 8 / 32)
    assert read("writer_encode_pct", run) is None
