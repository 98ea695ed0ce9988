"""The adaptive cell, adaptive.flac_10min, rehearsed on the CPU: `correct`
through the adaptive processor's file path against
reference/adaptive_ref.py, and `correct` false under each fault of
test_benchmark_faults.py's kinds planted in that path:
  - a step that returns its state unchanged (the chunk step hands back
    the carries it was given);
  - an answer altered where it is produced (one output sample changed
    where StageEmitter.emit writes it to the staging file);
  - one gate decision flipped in gate_plan (the state and the ramp after
    it follow the flipped decision)."""
import os
import shutil

import numpy as np
import pytest

from helpers import rehearse

CELL = "adaptive.flac_10min"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")


@pytest.fixture
def env_kept():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _unchanged_state(monkeypatch):
    from tomatis_tpu_torch.engine import streaming
    single = streaming.ChunkedStftEngine.make_chunk_fn

    def make_chunk_fn(self, *a, **kw):
        fn = single(self, *a, **kw)

        def step(sig, n_valid, ctl, out_t, w_t, params, gain):
            return fn(sig, n_valid, ctl, out_t, w_t, params, gain)[:3] + (
                ctl, out_t, w_t)
        return step

    monkeypatch.setattr(streaming.ChunkedStftEngine, "make_chunk_fn",
                        make_chunk_fn)


def _altered_sample(monkeypatch):
    from tomatis_tpu_torch.models import adaptive
    emit = adaptive.StageEmitter.emit

    def altered(self, stream_lo, piece):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls == 2:         # each job's second chunk, in the file
            piece = np.array(piece, copy=True)
            piece[len(piece) // 2, 0] += 0.125
        return emit(self, stream_lo, piece)

    monkeypatch.setattr(adaptive.StageEmitter, "emit", altered)


def _flipped_decision(monkeypatch):
    import torch

    from tomatis_tpu_torch.models import adaptive
    from tomatis_tpu_torch.ops import gate
    plan = adaptive.gate_plan

    def flipped(levels, p, min_hold, xfade, *a, **kw):
        out = plan(levels, p, min_hold, xfade, *a, **kw)
        states = out["states"].copy()
        k = len(states) // 2
        states[k] = 3 - states[k]
        alpha = gate.alpha_ramp_snap_first(
            torch.from_numpy((states == 2).astype(np.float32)), out["astep"])
        return dict(out, states=states, alpha=alpha.numpy())

    monkeypatch.setattr(adaptive, "gate_plan", flipped)


@needs_gxx
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(trace, capsys, env_kept):
    import torch
    torch.set_num_threads(2)
    rc, line = rehearse(capsys, CELL, seed=2 ** 31 + 77, trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0, line
    if trace:
        assert set(line["metrics"]) == {
            "adaptive_decode_pct", "adaptive_probe_ms", "adaptive_pass3_pct",
            "adaptive_finalize_pct"}
        assert all(m["value"] > 0 for m in line["metrics"].values())


@needs_gxx
@pytest.mark.parametrize("fault", [_unchanged_state, _altered_sample,
                                   _flipped_decision])
def test_fault_is_not_correct(fault, capsys, monkeypatch, env_kept):
    import torch
    torch.set_num_threads(2)
    fault(monkeypatch)
    rc, line = rehearse(capsys, CELL, seed=31)
    assert rc == 0
    assert line["correct"] is False, line["checks"]
