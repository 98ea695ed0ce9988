"""Port's host side: WAV I/O, transports, flush plan, CLI, refusals."""
import json

import numpy as np
import pytest
import torch

from tomatis_tpu.engine import streaming as jstreaming
from tomatis_tpu.io import audio as jaudio
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.engine import streaming
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.utils import pcm
from tomatis_tpu_torch.utils.stateio import read_state_csv

torch.set_num_threads(2)


def _tone(seconds=1.5, sr=48000, ch=2):
    t = np.arange(int(seconds * sr)) / sr
    env = 0.003 + 0.1 * (t > seconds / 2)
    x = env * np.sin(2 * np.pi * 700 * t)
    return np.stack([x] * ch, 1).astype(np.float32)


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_wav_roundtrip_matches_reference(tmp_path, subtype):
    x = _tone(0.2)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    audio.write(a, x, 48000, subtype=subtype)
    jaudio.write(b, x, 48000, subtype=subtype)
    assert a.read_bytes() == b.read_bytes()
    y, sr = audio.read(a)
    meta = audio.info(a)
    assert sr == 48000 and meta.subtype == subtype and meta.frames == len(x)
    yj, _ = jaudio.read(b, frames=100, start=50)
    np.testing.assert_array_equal(audio.read(a, frames=100, start=50)[0], yj)
    np.testing.assert_allclose(y, x, atol=2.0 ** -15)


def test_flac_is_refused(tmp_path):
    with pytest.raises(ValueError, match="FLAC is not yet ported"):
        audio.AudioFile(tmp_path / "o.flac", "w", samplerate=48000,
                        channels=2)
    assert not (tmp_path / "o.flac").exists()
    ip = tmp_path / "in.wav"
    audio.write(ip, _tone(0.5), 48000)
    with pytest.raises(ValueError, match="FLAC"):
        standard.process(ip, tmp_path / "o.flac", device="cpu")
    assert not (tmp_path / "o.flac").exists()
    assert not (tmp_path / "o.wav").exists()


def test_pcm24_converters():
    v = np.array([-8388608, -1, 0, 1, 8388607, 12345], np.int32)
    assert pcm.i32_from_le24(pcm.le24_from_i32(v)).tolist() == v.tolist()


def test_resolve_transport():
    assert streaming.resolve_transport("auto", True) == ("pcm24", True)
    assert streaming.resolve_transport("auto", False) == ("f32", False)
    assert streaming.resolve_transport("f32", True) == ("f32", False)
    with pytest.raises(ValueError, match="not yet ported"):
        streaming.resolve_transport("wire", True)
    with pytest.raises(ValueError):
        streaming.resolve_transport("pcm24", False)
    with pytest.raises(ValueError):
        streaming.resolve_transport("bogus", True)


@pytest.mark.parametrize("total,n_fft,hop", [
    (0, 4096, 2048), (1000, 4096, 2048), (48000 * 13 + 7, 4096, 2048),
    (48000 * 11, 4096, 1024), (300000, 1024, 512)])
def test_flush_plan_matches_reference(total, n_fft, hop):
    a = streaming.flush_plan(total, n_fft, hop)
    b = jstreaming.flush_plan(total, n_fft, hop)
    assert (a.cuts, a.pad, a.pad_end, a.n_frames, a.total) == \
        (b.cuts, b.pad, b.pad_end, b.n_frames, b.total)


def test_checkpoint_is_refused(tmp_path):
    ip = tmp_path / "in.wav"
    audio.write(ip, _tone(0.5), 48000)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        standard.process(ip, tmp_path / "o.wav", checkpoint_path="ck.npz",
                         device="cpu")


def test_all_invalid_chunk_freezes_carries():
    """A chunk with no valid frames keeps every carry as it was."""
    eng = streaming.ChunkedStftEngine(256, 128, 2, 8, device="cpu")
    ctl = standard.build_controller(
        standard.StandardParams(n_fft=256, hop=128), 48000, device="cpu")
    fn = eng.make_chunk_fn(ctl, transport="pcm24")
    carry = torch.tensor(3, dtype=torch.int32)
    ot, wt = torch.ones((128, 2)), torch.full((128,), 0.5)
    sig = torch.ones((eng.chunk_input_len, 2)) * 0.1
    _, aux, _, c2, ot2, wt2 = fn(sig, 0, carry, ot, wt, ctl.params(),
                                 torch.tensor(1.0))
    assert c2 is carry and ot2 is ot and wt2 is wt
    assert aux.shape == (3, eng.aux_width)
    _, _, _, c3, ot3, _ = fn(sig, 8, carry, ot, wt, ctl.params(),
                             torch.tensor(1.0))
    assert ot3.shape == ot.shape and not torch.equal(ot3, ot)


def test_floor8_norm_matches_reference_shape():
    eng = streaming.ChunkedStftEngine(256, 128, 1, 4, device="cpu")
    ctl = standard.build_controller(
        standard.StandardParams(n_fft=256, hop=128), 48000, device="cpu")
    with pytest.raises(ValueError):
        eng.make_chunk_fn(ctl, norm="bogus")
    fn = eng.make_chunk_fn(ctl, norm="floor8")
    ot, wt = eng.zero_tails()
    sig = torch.zeros((eng.chunk_input_len, 1))
    emit, _, out, *_ = fn(sig, 4, ctl.init_carry(), ot, wt, ctl.params(),
                          torch.tensor(1.0))
    assert out is None and emit.shape == (eng.emit_full, 1)
    assert torch.all(torch.isfinite(emit))


def test_cli_process_on_cpu(tmp_path, capsys):
    ip, op, cp = tmp_path / "in.wav", tmp_path / "out.wav", tmp_path / "s.csv"
    x = _tone(1.5)
    audio.write(ip, x, 48000, subtype="PCM_24")
    rc = cli_main.main(["process", "-i", str(ip), "-o", str(op),
                        "--state_csv", str(cp), "--device", "cpu",
                        "--frames_per_chunk", "16",
                        "--profile_dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "realtime on cpu" in out
    assert (tmp_path / "prof" / "trace.json").exists()
    meta = audio.info(op)
    assert meta.frames == len(x) and meta.subtype == "PCM_24"
    side = json.loads((tmp_path / "out.wav.params.json").read_text())
    assert side["tool"] == "process" and side["threshold_dbfs"] == -40.0
    csvd = read_state_csv(cp)
    assert set(csvd["state"]) == {"C1", "C2"}
    # the checkpoint flag is refused with an error exit
    assert cli_main.main(["process", "-i", str(ip), "-o", str(op),
                          "--device", "cpu", "--checkpoint", "c.npz"]) == 1
    assert cli_main.main(["nope"]) == 2
    assert cli_main.main([]) == 0
