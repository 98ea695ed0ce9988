"""The port's stream-pipelining primitives (tomatis_tpu_torch/utils/
pipeline.py) and the EQ applier's threaded error path: the cases of
tests/test_pipeline.py on the port's classes, on the CPU."""
import threading
import time

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.utils.pipeline import (OrderedWorker, Prefetcher,
                                              StagedPipeline)

# two intra-op threads: the suite runs several workers side by side, and
# torch ops called from the stream's helper threads each bring a pool
torch.set_num_threads(2)

def test_prefetcher_order_and_end():
    p = Prefetcher(iter(range(7)), depth=2)
    try:
        assert [p.get() for _ in range(7)] == list(range(7))
        with pytest.raises(StopIteration):
            p.get()
        with pytest.raises(StopIteration):   # end is sticky
            p.get()
    finally:
        p.close()


def test_prefetcher_exception_in_order_and_sticky():
    def gen():
        yield 1
        yield 2
        raise ValueError("midstream")

    p = Prefetcher(gen(), depth=2)
    try:
        assert p.get() == 1
        assert p.get() == 2
        with pytest.raises(ValueError, match="midstream"):
            p.get()
        # a retry must raise again, not deadlock on the dead producer
        with pytest.raises(ValueError, match="midstream"):
            p.get()
    finally:
        p.close()


def test_prefetcher_close_unblocks_full_queue():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=2)
    assert p.get() == 0
    p.close()    # producer blocked on a full queue must exit promptly
    assert not p._thread.is_alive()
    assert len(produced) < 100   # it stopped early


def test_ordered_worker_runs_in_order():
    w = OrderedWorker()
    seen = []
    try:
        for i in range(20):
            w.submit(lambda i=i: seen.append(i))
        w.check(join=True)
        assert seen == list(range(20))
    finally:
        w.close()


def test_ordered_worker_error_skips_later_jobs():
    w = OrderedWorker()
    ran = []
    w.submit(lambda: ran.append("a"))
    w.submit(lambda: (_ for _ in ()).throw(RuntimeError("job failed")))
    # the error surfaces at a later submit or check; later jobs are skipped
    with pytest.raises(RuntimeError, match="job failed"):
        w.submit(lambda: ran.append("b"))
        w.check(join=True)
    with pytest.raises(RuntimeError, match="job failed"):
        w.check()
    w.close()
    assert ran == ["a"]


def test_apply_eq_progress_error_propagates(tmp_path):
    """A failing progress callback on the worker thread must fail
    apply_gain_stream itself and leave no helper threads behind."""
    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.models.eq import apply_gain_stream

    sr = 48000
    t = np.arange(int(1.5 * sr)) / sr
    x = (0.05 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    ip = tmp_path / "in.wav"
    audio.write(ip, np.stack([x, x], 1), sr, subtype="PCM_24")
    gain = np.ones(4096 // 2 + 1, np.float32)

    baseline = threading.active_count()

    def bad_progress(done, total):
        raise RuntimeError("progress exploded")

    with pytest.raises(RuntimeError, match="progress exploded"):
        apply_gain_stream(ip, tmp_path / "out.wav", gain,
                          frames_per_chunk=8, progress=bad_progress,
                          device="cpu")
    deadline = time.time() + 6.0
    while time.time() < deadline and threading.active_count() > baseline:
        time.sleep(0.05)
    assert threading.active_count() <= baseline, threading.enumerate()


def test_stage_encode_to_device_contract():
    """stage_to_device uploads a float window as it is and scales a
    window of PCM_24 ints on the device as the file readers scale them;
    the wire batch's host_encode tags a PCM_24-exact float window "wire"
    (its stream unpacks to the window bit for bit) and any other
    "raw_inexact", which ships as floats."""
    from tomatis_tpu_torch.engine.streaming import stage_to_device
    from tomatis_tpu_torch.ops import wire as wire_ops
    from tomatis_tpu_torch.parallel import batch

    n, ch = 512, 2
    exact = (np.arange(n * ch, dtype=np.float32).reshape(n, ch)
             / 8388608.0)
    inexact = exact + np.float32(1e-9)
    ints = np.arange(n * ch, dtype=np.int32).reshape(n, ch) - 500

    out = stage_to_device(inexact, "cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), inexact)
    dev = stage_to_device(ints, "cpu")
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(
        dev.numpy(), ints.astype(np.float32) / np.float32(8388608.0))

    kind, val = batch.host_encode(exact)
    assert kind == "wire" and 0 < len(val) < exact.nbytes
    words = torch.from_numpy(np.frombuffer(val.tobytes(), np.int32).copy())
    np.testing.assert_array_equal(
        wire_ops.unpack_device(words, n, ch, batch.WIRE_RICE_IN).numpy(),
        exact)
    kind, val = batch.host_encode(inexact)
    assert kind == "raw_inexact" and val is inexact


def test_staged_pipeline_stage_order_and_depth():
    """StagedPipeline: every chunk passes S1->S2->S3 exactly once, in
    stream order; retire fires only past the depth; drain finishes the
    rest stage-by-stage (all S2 fetches issued before any S3 blocks)."""
    events = []

    class Arr:
        def __init__(self, i):
            self.i = i

        def block_until_ready(self):
            events.append(("wait", self.i))

        def copy_to_host_async(self):
            events.append(("copy", self.i))

    def start(ck):
        events.append(("start", ck["ready"]))
        return f"fetch{ck['ready']}"

    def finish(ck):
        assert ck["started"] == f"fetch{ck['ready']}"
        events.append(("finish", ck["ready"]))

    pipe = StagedPipeline(start, finish)
    for k in range(6):
        pipe.push(k, Arr(k))
        pipe.promote()
        pipe.retire()
    pipe.drain()
    assert pipe.items == []

    # each chunk hits each stage exactly once, in stream order
    for name in ("wait", "copy", "start", "finish"):
        seq = [i for n, i in events if n == name]
        assert seq == list(range(6)), (name, seq)
    # stage order per chunk: wait/copy -> start -> finish
    pos = {(n, i): j for j, (n, i) in enumerate(events)}
    for i in range(6):
        assert pos[("wait", i)] < pos[("copy", i)] < pos[("start", i)] \
            < pos[("finish", i)]
    # retire depth: chunk 0 finishes only in iteration 3 (after chunk 3
    # was pushed and chunk 2 entered S1)
    assert pos[("finish", 0)] > pos[("wait", 2)] > pos[("start", 1)]
    # drain interleaving: the last chunks' starts all precede their
    # finishes collectively (fetches issued before materialize blocks)
    assert pos[("start", 5)] < pos[("finish", 4)]


def test_staged_pipeline_wait_arr_without_methods():
    """Host-only arrays (no block_until_ready/copy_to_host_async) pass
    through S1 silently; an AttributeError raised INSIDE a handle's method
    is a fault and surfaces."""
    done = []
    pipe = StagedPipeline(lambda ck: None, lambda ck: done.append(ck["ready"]))
    for k in range(2):
        pipe.push(k, object())
        pipe.promote()
        pipe.retire()
    pipe.drain()
    assert done == [0, 1]

    class Broken:
        def block_until_ready(self):
            raise AttributeError("inside the handle")

        def copy_to_host_async(self):
            pass

    pipe.push(9, Broken())
    with pytest.raises(AttributeError, match="inside the handle"):
        pipe.drain()


def test_staged_pipeline_shallow_depth_advances_all_stages():
    """retire() must run S1/S2 itself when a shallow depth retires a
    chunk before promote() reached it (depth=1)."""
    done = []

    def start(ck):
        return ("fetch", ck["ready"])

    def finish(ck):
        assert ck["started"] == ("fetch", ck["ready"])
        done.append(ck["ready"])

    pipe = StagedPipeline(start, finish, depth=1)
    for k in range(4):
        pipe.push(k, object())
        pipe.promote()
        retired = pipe.retire()
        assert retired == (k >= 1)
    pipe.drain()
    assert done == [0, 1, 2, 3]


def test_chunk_readback_stages_on_cpu():
    """ChunkReadback on CPU tensors: no pinned memory and no event, the
    host arrays are the tensors; the stream form hands over
    words[:used]."""
    from tomatis_tpu_torch.engine.streaming import ChunkReadback

    payload = torch.arange(12, dtype=torch.uint8)
    aux = torch.ones((2, 3))
    rb = ChunkReadback([payload, aux])
    rb.block_until_ready()
    rb.copy_to_host_async()
    rb.start_stream()                      # a no-op without a stream
    got = rb.materialize()
    np.testing.assert_array_equal(got[0], payload.numpy())
    np.testing.assert_array_equal(got[1], aux.numpy())

    words = torch.arange(10, dtype=torch.int32)
    rb = ChunkReadback([aux], stream=(words, torch.tensor(4,
                                                          dtype=torch.int32)))
    rb.block_until_ready()
    rb.copy_to_host_async()
    rb.start_stream()
    got = rb.materialize()
    np.testing.assert_array_equal(got[0], aux.numpy())
    np.testing.assert_array_equal(got[1], np.arange(4, dtype=np.int32))
