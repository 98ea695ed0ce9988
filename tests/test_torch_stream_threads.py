"""The port's stream-runner threading: error propagation and clean
shutdown, the cases of tests/test_stream_threads.py on the port's runner
(CPU), and the engine's refusal to rebind its log rows."""
import threading
import time

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                StreamRunner)
from tomatis_tpu_torch.models.controllers import StaticGainController
from tomatis_tpu_torch.models.standard import (StandardParams,
                                               build_controller)

# two intra-op threads: the suite runs several workers side by side, and
# torch ops called from the stream's helper threads each bring a pool
torch.set_num_threads(2)
SR = 48000


def _sig(seconds=2.0):
    t = np.arange(int(seconds * SR)) / SR
    x = 0.05 * np.sin(2 * np.pi * 700 * t)
    return np.stack([x, 0.9 * x], 1).astype(np.float32)


def _runner(total, transport="f32"):
    p = StandardParams(require_48k_stereo=False)
    eng = ChunkedStftEngine(p.n_fft, p.hop, 2, frames_per_chunk=8,
                            device="cpu")
    return StreamRunner(eng, build_controller(p, SR, "cpu"), total,
                        transport=transport)


def _wait_threads_settle(baseline, timeout=6.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if threading.active_count() <= baseline:
            return True
        time.sleep(0.05)
    return threading.active_count() <= baseline


@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_consumer_exception_propagates_and_threads_exit(transport):
    """on_audio (file-write stand-in) raising on the consumer thread must
    fail the run itself, not hang it or die silently."""
    sig = _sig(3.0)
    baseline = threading.active_count()
    r = _runner(len(sig), transport)

    calls = []

    def bad_audio(chunk):
        calls.append((len(chunk), threading.current_thread()))
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        r.run(sig, on_audio=bad_audio)
    assert calls, "the failing sink was never invoked"
    assert calls[0][1] is not threading.main_thread(), \
        "sinks run on the writer thread"
    assert _wait_threads_settle(baseline), \
        f"helper threads leaked: {threading.enumerate()}"


def test_producer_exception_propagates_and_threads_exit():
    """A source whose read() fails mid-stream (producer thread) must
    surface the original exception from run()."""
    class FlakySource:
        """ndarray-like reader: first block ok, then an I/O error."""
        def __init__(self, x):
            self.x = x
            self.pos = 0
            self.reads = 0

        def read(self, n):
            self.reads += 1
            if self.reads > 1:
                raise IOError("stream went away")
            blk = self.x[self.pos:self.pos + n]
            self.pos += len(blk)
            return blk

    sig = _sig(4.0)
    baseline = threading.active_count()
    r = _runner(len(sig))

    class _Src:
        read = FlakySource(sig).read
    with pytest.raises(IOError, match="stream went away"):
        r.run(_Src(), on_audio=lambda c: None)
    assert _wait_threads_settle(baseline), \
        f"helper threads leaked: {threading.enumerate()}"


def test_run_after_failure_is_reusable():
    """A failed run must not poison module or runner state: the same
    runner, and a fresh one over a new engine, still produce the full
    output."""
    sig = _sig(2.0)
    r = _runner(len(sig))
    with pytest.raises(RuntimeError):
        r.run(sig, on_audio=lambda c: (_ for _ in ()).throw(
            RuntimeError("boom")))

    ys = []
    for runner in (r, _runner(len(sig))):
        outs = []
        stats = runner.run(sig, on_audio=outs.append)
        y = np.concatenate([o.reshape(-1, 2) for o in outs])
        assert len(y) == len(sig)
        assert stats["n_frames"] > 0
        ys.append(y)
    np.testing.assert_array_equal(ys[0], ys[1])


def test_engine_rejects_log_keys_rebinding():
    """One engine serves one controller type: the aux rows' layout
    follows LOG_KEYS, so rebinding must fail loudly."""
    p = StandardParams(require_48k_stereo=False)
    eng = ChunkedStftEngine(p.n_fft, p.hop, 2, frames_per_chunk=8,
                            device="cpu")
    ctl = build_controller(p, SR, "cpu")
    eng.make_chunk_fn(ctl)                              # LOG_KEYS=('states',)
    eng.make_chunk_fn(ctl, transport="pcm24")           # same rows: allowed
    gains = np.ones(p.n_fft // 2 + 1, np.float32)
    with pytest.raises(ValueError, match="LOG_KEYS"):
        eng.make_chunk_fn(StaticGainController(gains))  # LOG_KEYS=()
    assert eng.log_keys == ("states",)


def test_sinks_see_stream_order_from_one_thread():
    """on_frames, on_audio and on_progress all run on the writer thread,
    in stream order, and the threaded run's output equals the sum of its
    pieces whatever the transport's payload type."""
    sig = _sig(6.0)
    r = _runner(len(sig), "pcm24")
    seen = {"frames": [], "progress": [], "threads": set()}
    outs = []

    def on_frames(f0, starts, log):
        seen["frames"].append(f0)
        seen["threads"].add(threading.current_thread())

    def on_audio(b):
        outs.append(b)
        seen["threads"].add(threading.current_thread())

    def on_progress(done, total):
        seen["progress"].append((done, total))
        seen["threads"].add(threading.current_thread())

    stats = r.run(sig, on_audio=on_audio, on_frames=on_frames,
                  on_progress=on_progress)
    assert len(seen["threads"]) == 1
    assert threading.main_thread() not in seen["threads"]
    assert seen["frames"] == sorted(seen["frames"])
    assert seen["progress"][-1] == (stats["n_frames"], stats["n_frames"])
    assert sum(len(o) for o in outs) == len(sig) * 2 * 3


def test_timing_detail_env(monkeypatch):
    """The stage timers are there either way, each the total of a span of
    utils/trace.py; TOMATIS_TRACE=1 (the switch that replaced
    TOMATIS_TIMING_DETAIL and its per-chunk dicts) records the spans as
    rows of the run's job: one stream.dispatch a chunk, at its first frame,
    with the chunk step's enqueue and the promotion inside it."""
    from tomatis_tpu_torch.utils import trace
    monkeypatch.delenv("TOMATIS_TRACE", raising=False)
    sig = _sig(3.0)
    st = _runner(len(sig)).run(sig, on_audio=lambda c: None)
    assert "chunk_timings" not in st
    assert set(st["timings"]) == {"runner_setup_s", "input_host_s",
                                  "producer_wait_s", "dispatch_compute_s",
                                  "consume_s", "final_drain_s", "decode_s",
                                  "writer_busy_s", "encode_s"}
    assert not [r for r in trace.rows() if r.job == st["job_id"]]
    monkeypatch.setenv("TOMATIS_TRACE", "1")
    st = _runner(len(sig)).run(sig, on_audio=lambda c: None)
    assert "chunk_timings" not in st
    rows = [r for r in trace.rows() if r.job == st["job_id"]]
    disp = [r for r in rows if r.name == "stream.dispatch"]
    assert len(disp) == st["chunks"] > 3
    assert [r.at for r in disp] == [8 * k for k in range(st["chunks"])]
    for name in ("stream.step", "stream.promote"):
        inner = [r for r in rows if r.name == name]
        assert [(r.parent, r.at) for r in inner] == [
            ("stream.dispatch", r.at) for r in disp]
    inputs = [r.at for r in rows if r.name == "stream.input"]
    assert inputs == [r.at for r in disp]
    assert sum(r.name == "stream.consume" for r in rows) == \
        st["chunks"] - 3 + 1   # every retire, then the drain


def _in_order_run(runner, sig, on_frames):
    """The same stream, dispatched, read back and routed chunk by chunk
    on one thread with nothing in flight: the oracle of the pipeline's
    ordering (what run() did before it was threaded)."""
    from tomatis_tpu_torch.engine.streaming import SinkState
    from tomatis_tpu_torch.utils.rolling import RollingReader
    eng, plan = runner.engine, runner.plan
    pad, hop, n_frames = plan.pad, eng.hop, plan.n_frames
    byte_payload = runner.transport == "pcm24"
    pos = [0]

    def read(n):
        blk = sig[pos[0]:pos[0] + n]
        pos[0] += len(blk)
        return blk

    reader = RollingReader(read, 2, left_pad=pad, base=-pad,
                           block=eng.emit_len)
    sink, outs = SinkState(pad), []
    carry = runner.controller.init_carry()
    ot, wt = eng.zero_tails()
    frame0, last_full = 0, False
    while frame0 < n_frames:
        e_i, fn = runner._by_F[runner._chunk_F(frame0)]
        nf = min(e_i.frames_per_chunk, n_frames - frame0)
        last_full = nf == e_i.frames_per_chunk
        x = torch.from_numpy(np.ascontiguousarray(
            reader.window(-pad + frame0 * hop, e_i.chunk_input_len)))
        payload, aux, out, carry, ot, wt = fn(
            x, nf, carry, ot, wt, runner.ctl_params, runner.gain_f32)
        sink.route(runner, e_i, frame0, nf, payload.numpy(), aux.numpy(), out,
                   on_frames, outs.append, byte_payload)
        frame0 += nf
        if frame0 < n_frames:
            reader.advance(-pad + frame0 * hop)
    if last_full:
        sink.append_tail(runner, eng, n_frames, ot, wt, byte_payload)
    sink.final_drain(runner, outs.append)
    return outs


@pytest.mark.parametrize("transport", ["f32", "pcm24"])
@pytest.mark.parametrize("seconds,fpc", [(7.0, 8), (31.0, 256)],
                         ids=["many_chunks", "ramp_and_full_last"])
def test_threaded_run_equals_in_order_run(transport, seconds, fpc):
    """The threaded pipeline writes what an in-order loop writes: the same
    flushes (count, sizes, bytes) and the same per-frame log, across the
    flush clamp (a hot passage), the ramp schedule and both kinds of last
    chunk."""
    rng = np.random.default_rng(12)
    sig = _sig(seconds)
    sig[SR:2 * SR] *= 30.0                      # trips the 0.999 clamp
    sig += (1e-3 * rng.standard_normal(sig.shape)).astype(np.float32)
    if fpc == 256:          # a whole number of chunks: the tail is in the
        n_full = 64 + 128 + 256 * 2             # carry after a full chunk
        sig = sig[:n_full * 2048]

    def build():
        p = StandardParams(require_48k_stereo=False)
        eng = ChunkedStftEngine(p.n_fft, p.hop, 2, frames_per_chunk=fpc,
                                device="cpu")
        return StreamRunner(eng, build_controller(p, SR, "cpu"), len(sig),
                            transport=transport)

    logs = {"thr": [], "ord": []}

    def logger(key):
        def on_frames(f0, starts, log):
            logs[key].append((f0, starts.copy(), log["levels"].copy(),
                              log["states"].copy()))
        return on_frames

    r = build()
    if fpc == 256:
        assert r._ramp and r.plan.n_frames == n_full
    got = []
    r.run(sig, on_audio=got.append, on_frames=logger("thr"))
    want = _in_order_run(build(), sig, logger("ord"))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert len(logs["thr"]) == len(logs["ord"])
    for a, b in zip(logs["thr"], logs["ord"]):
        assert a[0] == b[0]
        for u, v in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(u, v)
    peak = max(float(np.max(np.abs(w))) for w in want) \
        if transport == "f32" else None
    assert peak is None or peak <= 0.999 + 1e-6
