"""Checkpoint/resume of the port: interrupt a run mid-stream, rerun the
same call, and the output bytes and the state CSV equal an uninterrupted
run's. Also the port's .npz against the JAX package's key names, and the
refusals (changed parameters, changed transport, stale checkpoint).
"""
import numpy as np
import pytest
import torch

from tomatis_tpu.models import standard as jstd
from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard, xfade

torch.set_num_threads(2)

SR = 48000


def _signal(seconds=8.0, seed=17):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.002 + 0.05 * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t) + 0.02 * rng.standard_normal(n))
    return np.clip(np.stack([x, 0.9 * x], 1), -1, 1).astype(np.float32)


class _Bomb(Exception):
    pass


def _arm(monkeypatch, after: int):
    """Make the staged sink raise on every write past the first `after`."""
    calls = {"n": 0}
    orig_raw, orig = standard._RawWav.write_raw, standard._RawWav.write

    def wrap(fn):
        def bomb(self, data):
            calls["n"] += 1
            if calls["n"] > after:
                raise _Bomb()
            return fn(self, data)
        return bomb
    monkeypatch.setattr(standard._RawWav, "write_raw", wrap(orig_raw))
    monkeypatch.setattr(standard._RawWav, "write", wrap(orig))


MODELS = {
    "standard": (standard.process, lambda: standard.StandardParams(
        require_48k_stereo=False)),
    "xfade": (xfade.process, lambda: xfade.XfadeParams(
        gate_ui=60.0, xfade_ms=120.0, require_48k_stereo=False)),
}


@pytest.mark.parametrize("transport", ["auto", "f32"])
@pytest.mark.parametrize("ext", ["flac", "wav"])
@pytest.mark.parametrize("model", ["standard", "xfade"])
def test_resume_after_interrupt(tmp_path, monkeypatch, model, ext,
                                transport):
    process, params = MODELS[model]
    p = params()
    ip = tmp_path / "in.flac"
    audio.write(ip, _signal(), SR)
    kw = dict(frames_per_chunk=16, device="cpu", transport=transport)
    ref, out = tmp_path / f"ref.{ext}", tmp_path / f"out.{ext}"
    ref_csv, out_csv = tmp_path / "ref.csv", tmp_path / "out.csv"
    ck = tmp_path / "ck.npz"
    st_ref = process(ip, ref, p, state_csv_path=ref_csv, **kw)

    # 8 s of audio has two flush cuts; die on the second
    _arm(monkeypatch, 1)
    with pytest.raises(_Bomb):
        process(ip, out, p, state_csv_path=out_csv, checkpoint_path=ck,
                checkpoint_every=4, **kw)
    monkeypatch.undo()
    assert ck.exists()
    stage = out if ext == "wav" else tmp_path / "out.flac.part.wav"
    assert stage.exists()
    with np.load(ck) as z:
        n_leaves = 2 if model == "xfade" else 1
        assert {f"carry{i}" for i in range(n_leaves)} <= set(z.files)
        assert f"carry{n_leaves}" not in z.files

    st = process(ip, out, p, state_csv_path=out_csv, checkpoint_path=ck,
                 checkpoint_every=4, **kw)
    assert not ck.exists()          # cleared on success
    assert not (tmp_path / "out.flac.part.wav").exists()
    assert st["out_path"] == str(out)
    assert st["chunks"] < st_ref["chunks"]      # it did resume mid-stream
    for k in ("n_frames", "c1_frames", "c2_frames"):
        assert st[k] == st_ref[k], k
    assert out.read_bytes() == ref.read_bytes()
    assert out_csv.read_text() == ref_csv.read_text()
    assert st_ref["c1_frames"] > 0 and st_ref["c2_frames"] > 0


def test_checkpoint_keys_match_reference(tmp_path, monkeypatch):
    """The port's checkpoint names its state as the JAX package's does, and
    its fingerprint has the same fields."""
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(), SR)
    cks = {}
    for name, mod, extra in (("port", standard, dict(device="cpu")),
                             ("jax", jstd, {})):
        cks[name] = tmp_path / f"{name}.npz"
        p = mod.StandardParams(require_48k_stereo=False)
        calls = {"n": 0}
        orig = mod._RawWav.write_raw

        def bomb(self, raw, orig=orig, calls=calls):
            calls["n"] += 1
            if calls["n"] > 1:
                raise _Bomb()
            return orig(self, raw)
        monkeypatch.setattr(mod._RawWav, "write_raw", bomb)
        with pytest.raises(_Bomb):
            mod.process(ip, tmp_path / f"{name}.wav", p, frames_per_chunk=16,
                        checkpoint_path=cks[name], checkpoint_every=4,
                        transport="pcm24", **extra)
        monkeypatch.undo()
    import json
    with np.load(cks["port"]) as a, np.load(cks["jax"]) as b:
        assert set(a.files) == set(b.files)
        ma, mb = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
        assert ma["scalars"] == mb["scalars"]
        ca, cb = ma["config"], mb["config"]
        assert set(ca) == set(cb) and "device" not in ca
        for k in ca:
            if k != "in_path":
                assert ca[k] == cb[k], k
        for k in ("carry0", "states_count", "peak_pend"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a["carry0"], b["carry0"])
        np.testing.assert_array_equal(a["states_count"], b["states_count"])
        assert a["out_pend"].dtype == np.uint8
        assert a["out_pend"].shape == b["out_pend"].shape
        assert a["ref_floats"].shape == b["ref_floats"].shape
        np.testing.assert_allclose(a["out_tail"], b["out_tail"], atol=1e-5)


def _interrupted(tmp_path, monkeypatch, p, **kw):
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(4.0), SR)
    ck = tmp_path / "ck.npz"
    _arm(monkeypatch, 0)   # 4 s has a single, final flush: die on it
    with pytest.raises(_Bomb):
        standard.process(ip, tmp_path / "o.flac", p, frames_per_chunk=8,
                         checkpoint_path=ck, checkpoint_every=2,
                         device="cpu", **kw)
    monkeypatch.undo()
    assert ck.exists()
    return ip, ck


def test_checkpoint_rejects_changed_config(tmp_path, monkeypatch):
    p = standard.StandardParams(require_48k_stereo=False)
    ip, ck = _interrupted(tmp_path, monkeypatch, p)
    p2 = standard.StandardParams(require_48k_stereo=False, gate_ui=60.0)
    with pytest.raises(ValueError, match="different parameters"):
        standard.process(ip, tmp_path / "o.flac", p2, frames_per_chunk=8,
                         checkpoint_path=ck, checkpoint_every=2,
                         device="cpu")
    with pytest.raises(ValueError, match="different parameters"):
        standard.process(ip, tmp_path / "o.flac", p, frames_per_chunk=16,
                         checkpoint_path=ck, checkpoint_every=2,
                         device="cpu")
    assert ck.exists()


def test_checkpoint_rejects_transport_and_ramp_change(tmp_path, monkeypatch):
    """Pending output is PCM bytes under pcm24 and floats under f32; the
    chunk schedule decides the summation order. Neither may change."""
    p = standard.StandardParams(require_48k_stereo=False)
    ip, ck = _interrupted(tmp_path, monkeypatch, p, transport="auto")
    kw = dict(frames_per_chunk=8, checkpoint_path=ck, checkpoint_every=2,
              device="cpu")
    with pytest.raises(ValueError, match="different parameters"):
        standard.process(ip, tmp_path / "o.flac", p, transport="f32", **kw)
    monkeypatch.setenv("TOMATIS_NO_RAMP", "1")
    with pytest.raises(ValueError, match="different parameters"):
        standard.process(ip, tmp_path / "o.flac", p, **kw)
    monkeypatch.delenv("TOMATIS_NO_RAMP")
    # the resolved value counts: auto resolved to pcm24, so pcm24 resumes
    st = standard.process(ip, tmp_path / "o.flac", p, transport="pcm24", **kw)
    assert st["transport"] == "pcm24" and not ck.exists()


def test_stale_checkpoint_without_stage_is_cleared(tmp_path, monkeypatch):
    p = standard.StandardParams(require_48k_stereo=False)
    ip, ck = _interrupted(tmp_path, monkeypatch, p)
    (tmp_path / "o.flac.part.wav").unlink()
    ref = tmp_path / "ref.flac"
    st_ref = standard.process(ip, ref, p, frames_per_chunk=8, device="cpu")
    st = standard.process(ip, tmp_path / "o.flac", p, frames_per_chunk=8,
                          checkpoint_path=ck, checkpoint_every=2,
                          device="cpu")
    assert st["chunks"] == st_ref["chunks"]     # started over
    assert not ck.exists()
    assert (tmp_path / "o.flac").read_bytes() == ref.read_bytes()


def test_finalize_degrades_to_wav_without_encoder(tmp_path, monkeypatch,
                                                  capsys):
    """A checkpointed run whose final FLAC transcode cannot encode keeps
    the completed audio as a WAV with the hint, and clears the checkpoint."""
    from tomatis_tpu_torch.native import build
    x = _signal(4.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR)
    out, ck = tmp_path / "out.flac", tmp_path / "ck.npz"
    monkeypatch.setenv("TOMATIS_NO_NATIVE", "1")
    monkeypatch.setattr(build, "_CACHE", {})
    st = standard.process(ip, out, standard.StandardParams(),
                          frames_per_chunk=16, checkpoint_path=ck,
                          checkpoint_every=4, device="cpu")
    text = capsys.readouterr().out
    assert "kept the completed audio as WAV" in text
    assert "cli.main convert -i" in text
    assert not out.exists() and not ck.exists()
    assert st["out_path"] == str(tmp_path / "out.wav")
    assert not (tmp_path / "out.flac.part.wav").exists()
    y, rsr = audio.read(st["out_path"])
    assert rsr == SR and len(y) == len(x)


def test_wav_reopen_and_csv_resume(tmp_path):
    from tomatis_tpu_torch.io.wav import WavWriter
    from tomatis_tpu_torch.utils.stateio import StateCsvWriter
    x = _signal(0.1)
    p = tmp_path / "s.wav"
    w = WavWriter(p, SR, 2, "PCM_24")
    w.write(x)
    w._f.flush()        # a killed writer: bytes on disk, header says 0
    w2 = WavWriter.reopen(p, 3000)
    w2.write(x[3000:])
    w2.close()
    w._f.close()
    np.testing.assert_allclose(audio.read(p)[0], x, atol=2.0 ** -23)
    with pytest.raises(ValueError, match="checkpoint"):
        WavWriter.reopen(p, len(x) + 1)
    cp = tmp_path / "s.csv"
    log = {"levels": np.arange(6, dtype=np.float32),
           "states": np.array([1, 1, 2, 2, 1, 1])}
    a = StateCsvWriter(cp, SR, 10 ** 6)
    a.on_frames(0, np.arange(6) * 100, log)
    a.close()
    whole = cp.read_text()
    b = StateCsvWriter(cp, SR, 10 ** 6, resume_at_frame=4)
    assert len(cp.read_text().splitlines()) <= 5
    b.on_frames(4, np.arange(4, 6) * 100,
                {k: v[4:] for k, v in log.items()})
    b.close()
    assert cp.read_text() == whole


def test_checkpoint_manager_roundtrip(tmp_path):
    ck = CheckpointManager(tmp_path / "c.npz", {"a": 1}, every_chunks=0)
    assert ck.every == 1 and ck.load() is None
    ck.maybe_save({"x": np.arange(3), "__scalars__": {"frame0": 7}})
    got = ck.load()
    assert got["x"].tolist() == [0, 1, 2]
    assert got["__meta__"]["scalars"] == {"frame0": 7}
    with pytest.raises(ValueError, match="different parameters"):
        CheckpointManager(tmp_path / "c.npz", {"a": 2}).load()
    ck.clear()
    assert ck.load() is None
