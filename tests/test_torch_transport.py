"""The port's link transports: the cases of tests/test_transport.py on the
port (CPU), pcm24 against f32 (1 LSB), the refusal of the reference's
single-file "wire" transport, and the wire codec's rice-out policy and
pack, which only the wire batch (parallel/batch.py) uses."""
import numpy as np
import pytest
import torch

from tests.oracle import refdsp
from tomatis_tpu.io import audio as jaudio
from tomatis_tpu_torch.engine import streaming as S
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.models.standard import (StandardParams, process,
                                               process_array)
from tomatis_tpu_torch.parallel import batch

torch.set_num_threads(2)
SR = 48000


def _signal(seconds, sr=SR, amp=0.3):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.004 + amp * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t)
               + 0.5 * np.sin(2 * np.pi * 2500 * t))
    return np.clip(np.stack([x, 0.85 * x], 1), -1, 1).astype(np.float32)


def test_pcm24_transport_matches_f32(tmp_path):
    x = _signal(2.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    p = StandardParams(require_48k_stereo=False)
    op = tmp_path / "out.wav"   # PCM_24 -> pcm24 transport
    st = process(ip, op, p, frames_per_chunk=64, device="cpu")
    assert st["transport"] == "pcm24"
    y_file, _ = audio.read(op)
    y_mem, _ = process_array(x, SR, p, frames_per_chunk=64, device="cpu")
    # identical up to one PCM_24 LSB
    assert np.max(np.abs(y_file - y_mem)) <= 1.5 / 8388608.0


@pytest.mark.parametrize("transport", ["pcm24"])
def test_pcm24_transport_clamp_path(tmp_path, transport):
    """Hot signal forces the per-flush clamp through the int decode path;
    must match the oracle within quantisation tolerance."""
    x = np.clip(_signal(8.0) * 4.0, -1, 1).astype(np.float32)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    p = StandardParams(require_48k_stereo=False)
    op = tmp_path / "out.wav"
    process(ip, op, p, frames_per_chunk=64, device="cpu",
            transport=transport)
    y_file, _ = audio.read(op)
    y_ref, _, _ = refdsp.process_standard_loop(x, SR)
    assert np.max(np.abs(y_file)) <= 0.999 + 1e-6
    assert np.max(np.abs(y_file - y_ref)) < 3e-4


def test_pcm24_transport_output_gain(tmp_path):
    x = _signal(1.0, amp=0.02)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    p = StandardParams(require_48k_stereo=False, output_gain_db=6.0)
    op = tmp_path / "out_pcm24.wav"
    process(ip, op, p, device="cpu", transport="pcm24")
    y_file, _ = audio.read(op)
    y_ref, _, _ = refdsp.process_standard_loop(x, SR, output_gain_db=6.0)
    assert np.max(np.abs(y_file - y_ref)) < 3e-4


def test_process_transport_param(tmp_path):
    """process(transport=...) forces the link transport; f32 within 1
    PCM_24 LSB of pcm24; auto is pcm24 on the port."""
    x = _signal(2.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    p = StandardParams(require_48k_stereo=False)
    outs, stats = {}, {}
    for tr in ("pcm24", "f32", "auto"):
        op = tmp_path / f"out_{tr}.wav"
        stats[tr] = process(ip, op, p, frames_per_chunk=64, transport=tr,
                            device="cpu")
        outs[tr], _ = audio.read(op)
    np.testing.assert_array_equal(outs["auto"], outs["pcm24"])
    assert np.max(np.abs(outs["f32"] - outs["pcm24"])) <= 1.5 / 8388608.0
    assert [stats[t]["transport"] for t in ("pcm24", "f32", "auto")] \
        == ["pcm24", "f32", "pcm24"]
    with pytest.raises(ValueError, match="transport"):
        process_array(x, SR, p, device="cpu", transport="wire")


@pytest.mark.parametrize("transport", ["bogus", "wire"])
def test_invalid_transport_rejected_before_output_touch(tmp_path,
                                                        transport):
    """A bad transport name must raise before the output file is opened
    (opening would truncate a pre-existing output); the reference's
    single-file "wire" is one."""
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(0.5), SR, subtype="FLOAT")
    op = tmp_path / "out.wav"
    op.write_bytes(b"precious bytes")
    p = StandardParams(require_48k_stereo=False)
    with pytest.raises(ValueError, match="transport"):
        process(ip, op, p, transport=transport, device="cpu")
    assert op.read_bytes() == b"precious bytes"


def test_wire_rice_out_modes_identical_output(tmp_path, monkeypatch):
    """The rice-out policy is a LINK optimisation only: the wire batch
    with rice forced on and off writes byte-identical files (the host
    decoder reads the mode per block), over fewer link bytes."""
    ins = []
    for i in range(2):
        ip = tmp_path / f"in{i}.wav"
        audio.write(ip, _signal(2.0 - 0.5 * i), SR, subtype="PCM_24")
        ins.append(ip)
    p = StandardParams(require_48k_stereo=False)
    monkeypatch.setattr(batch, "_link_mbps", lambda dev: 100.0)
    outs, link = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", mode)
        d = tmp_path / f"out_{mode}"
        d.mkdir()
        stats = batch.process_batch(
            [(ip, d / ip.name) for ip in ins], p, frames_per_chunk=64,
            device="cpu")
        assert all(s["failed"] is None for s in stats)
        assert batch.LAST_TIMINGS["transport"] == "wire"
        outs[mode] = [(d / ip.name).read_bytes() for ip in ins]
        link[mode] = batch.LAST_WIRE["out_used"]
    assert outs["0"] == outs["1"]
    assert 0 < link["1"] < link["0"]


def test_resolve_rice_out_env_force(monkeypatch):
    """TOMATIS_WIRE_RICE_OUT=0/1 forces the policy without probing the
    link; 'auto' falls back to the memoised choice, and on a CPU device
    (no link to probe) to the module default."""
    monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", "1")
    assert batch.resolve_rice_out() is True
    monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", "0")
    assert batch.resolve_rice_out() is False
    monkeypatch.delenv("TOMATIS_WIRE_RICE_OUT")
    monkeypatch.setattr(batch, "_RICE_OUT_MEMO", {})
    assert batch.resolve_rice_out("cpu") is batch.WIRE_RICE_OUT
    assert "choice" not in batch._RICE_OUT_MEMO
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.probe_d2h_mbps(device="cpu")
    batch._RICE_OUT_MEMO["choice"] = True      # pretend a probe already ran
    assert batch.resolve_rice_out("cpu") is True


def test_wire_chunk_step_packs_the_pcm24_bytes():
    """One chunk step: batch._pack_pcm24 of the pcm24 step's bytes (the
    wire batch's output pack, here with rice) decodes back to those very
    bytes."""
    from tomatis_tpu_torch.io import wirecodec
    p = StandardParams(require_48k_stereo=False, n_fft=512, hop=256)
    ctl = standard.build_controller(p, SR, "cpu")
    x = torch.from_numpy(_signal(0.5))
    eng = S.ChunkedStftEngine(512, 256, 2, 16, device="cpu")
    fn = eng.make_chunk_fn(ctl, transport="pcm24")
    ot, wt = eng.zero_tails()
    pcm = fn(x[:eng.chunk_input_len], 13, ctl.init_carry(), ot, wt,
             ctl.params(), torch.tensor(1.5))[0]
    words, used = batch._pack_pcm24(pcm, 2, True)
    assert 0 < int(used) < pcm.numel() // 4
    got = wirecodec.decode_pcm24(
        words.numpy()[:int(used)].view(np.uint8), eng.emit_full, 2)
    np.testing.assert_array_equal(got, pcm.numpy())


def test_checkpoint_fingerprint_holds_resolved_transport(tmp_path):
    """A checkpoint taken under one payload format must not resume under
    another: the resolved transport is part of the fingerprint (auto and
    pcm24 resolve alike and share one)."""
    from tomatis_tpu_torch.engine.checkpoint import CheckpointManager
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(1.0), SR, subtype="PCM_24")
    p = StandardParams(require_48k_stereo=False)
    seen = []
    orig = CheckpointManager.__init__

    def spy(self, path, config, every):
        seen.append(config["transport"])
        orig(self, path, config, every)

    mp = pytest.MonkeyPatch()
    mp.setattr(CheckpointManager, "__init__", spy)
    try:
        for tr in ("auto", "pcm24", "f32"):
            process(ip, tmp_path / f"o_{tr}.wav", p, frames_per_chunk=8,
                    checkpoint_path=tmp_path / "ck.npz", checkpoint_every=2,
                    transport=tr, device="cpu")
    finally:
        mp.undo()
    assert seen == ["pcm24", "pcm24", "f32"]
    assert (tmp_path / "o_pcm24.wav").read_bytes() == \
        (tmp_path / "o_auto.wav").read_bytes()


def test_convert_cli_int24_copy(tmp_path, capsys):
    """convert copies <=24-bit sources as integers: FLAC -> WAV -> FLAC
    keeps every sample and says which path it took; a FLOAT target goes
    through float32."""
    from tomatis_tpu_torch.cli import main as cli_main
    rng = np.random.default_rng(8)
    v = rng.integers(-8388608, 8388608, (5000, 2)).astype(np.int32)
    x = v.astype(np.float32) / np.float32(8388608.0)
    f0, w1, f2, w3 = (tmp_path / n for n in
                      ("a.flac", "b.wav", "c.flac", "d.wav"))
    audio.write(f0, x, SR, subtype="PCM_24")
    assert cli_main.main(["convert", "-i", str(f0), "-o", str(w1)]) == 0
    assert "raw 24-bit copy" in capsys.readouterr().out
    assert cli_main.main(["convert", "-i", str(w1), "-o", str(f2)]) == 0
    assert f2.read_bytes() == f0.read_bytes()
    with audio.AudioFile(w1, "r") as fin:
        assert fin.int24_readable
        np.testing.assert_array_equal(fin.read_int24(), v)
    assert cli_main.main(["convert", "-i", str(f0), "-o", str(w3),
                          "--subtype", "FLOAT"]) == 0
    assert "(float32)" in capsys.readouterr().out
    np.testing.assert_array_equal(audio.read(w3)[0], x)
    with audio.AudioFile(w3, "r") as fin:
        assert not fin.int24_readable


@pytest.mark.parametrize("subtype,container", [
    ("PCM_24", "wav"), ("PCM_16", "wav"), ("PCM_24", "flac"),
    ("PCM_16", "flac")])
def test_read_int24_matches_reference(tmp_path, subtype, container):
    """read_int24 of every reader == the JAX package's, == the float read
    times 2^23, seeks included; the pure FLAC decoder alike."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((7000, 2)) * 0.2).astype(np.float32)
    path = tmp_path / f"x.{container}"
    audio.write(path, x, SR, subtype=subtype)
    with audio.AudioFile(path, "r") as f, jaudio.AudioFile(path, "r") as jf:
        assert f.int24_readable and jf.int24_readable
        a, b = f.read_int24(3000), jf.read_int24(3000)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and a.shape == (3000, 2)
        f.seek(100)
        tail = f.read_int24()
        assert tail.shape == (6900, 2)
    y, _ = audio.read(path)
    np.testing.assert_array_equal(
        np.concatenate([a, tail[2900:]]).astype(np.float32) / 8388608.0, y)
    if container == "flac":
        from tomatis_tpu_torch.io.flac_py import PureFlacReader
        r = PureFlacReader(str(path))
        assert r.int24_readable
        np.testing.assert_array_equal(r.read_int24(3000), a)
