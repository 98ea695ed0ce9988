"""Each fault a cell can have, planted in the program underneath a whole
rehearsed run, comes out as `correct` false:
  - a step that returns its state unchanged (the chunk step hands back the
    carries it was given: gate state and overlap-add tails);
  - half of the batch left out (process_batch runs the first half of its
    lanes);
  - an answer altered where it is produced (one output sample changed as
    the stream writes it out).
No cell runs across chips, so no exchange between chips can be left out."""
import numpy as np
import pytest

from helpers import rehearse

SINGLE = ["standard.flac_10min", "xfade.array_10min", "xfade.flac_tracks"]
ALL = SINGLE + ["standard.batch8_flac"]


@pytest.fixture
def env_kept(monkeypatch):
    import os
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _unchanged_state(monkeypatch):
    from tomatis_tpu_torch.engine import streaming
    single = streaming.ChunkedStftEngine.make_chunk_fn
    batched = streaming.ChunkedStftEngine.make_batch_chunk_fn

    def make_chunk_fn(self, *a, **kw):
        fn = single(self, *a, **kw)

        def step(sig, n_valid, ctl, out_t, w_t, params, gain):
            return fn(sig, n_valid, ctl, out_t, w_t, params, gain)[:3] + (
                ctl, out_t, w_t)
        return step

    def make_batch_chunk_fn(self, *a, **kw):
        fn = batched(self, *a, **kw)

        def step(sig, n_valid, ctls, out_t, w_t, params, gain):
            return fn(sig, n_valid, ctls, out_t, w_t, params, gain)[:3] + (
                list(ctls), out_t, w_t)
        return step

    monkeypatch.setattr(streaming.ChunkedStftEngine, "make_chunk_fn",
                        make_chunk_fn)
    monkeypatch.setattr(streaming.ChunkedStftEngine, "make_batch_chunk_fn",
                        make_batch_chunk_fn)


def _altered_answer(monkeypatch):
    from tomatis_tpu_torch.engine import streaming
    pcm24 = streaming.StreamRunner._write_cut_pcm24
    f32 = streaming.StreamRunner._write_cut_f32

    def write_pcm24(self, chunk_bytes, *a):
        b = np.array(chunk_bytes, copy=True)
        b[len(b) // 6 * 3 + 2] ^= 0x10  # the top byte of one sample
        return pcm24(self, b, *a)

    def write_f32(self, chunk, *a):
        c = np.array(chunk, copy=True)
        c[len(c) // 2, 0] += 1e-4
        return f32(self, c, *a)

    monkeypatch.setattr(streaming.StreamRunner, "_write_cut_pcm24",
                        write_pcm24)
    monkeypatch.setattr(streaming.StreamRunner, "_write_cut_f32", write_f32)


def _half_the_batch(monkeypatch):
    import tomatis_tpu_torch
    from tomatis_tpu_torch.parallel import batch
    # the package resolves its name lazily: resolve it before the patch,
    # so that the undo restores the real function
    real = tomatis_tpu_torch.process_batch

    def half(jobs, *a, state_csv_paths=None, **kw):
        jobs = list(jobs)
        n = len(jobs) // 2
        return real(jobs[:n], *a, state_csv_paths=state_csv_paths[:n], **kw)

    monkeypatch.setattr(tomatis_tpu_torch, "process_batch", half)
    monkeypatch.setattr(batch, "process_batch", half)


@pytest.mark.parametrize("cell", ALL)
@pytest.mark.parametrize("fault", [_unchanged_state, _altered_answer])
def test_fault_is_not_correct(cell, fault, capsys, monkeypatch, env_kept):
    import torch
    torch.set_num_threads(2)
    fault(monkeypatch)
    rc, line = rehearse(capsys, cell, seed=31)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


def test_half_the_batch_is_not_correct(capsys, monkeypatch, env_kept):
    _half_the_batch(monkeypatch)
    rc, line = rehearse(capsys, "standard.batch8_flac", seed=32)
    assert rc == 0
    assert line["correct"] is False, line["checks"]
