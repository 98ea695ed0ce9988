"""Port's host side: WAV and FLAC I/O, transports, flush plan, CLI,
checkpoint flag, the wire transport by name, validate on its output."""
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
    """The name is from when a .flac path was refused; the same calls now
    succeed: a FLAC handle opens for write, and process() writes FLAC."""
    with audio.AudioFile(tmp_path / "o.flac", "w", samplerate=48000,
                         channels=2) as f:
        assert f.format == "FLAC" and f.supports_raw
    assert (tmp_path / "o.flac").exists()
    ip = tmp_path / "in.wav"
    x = _tone(0.5)
    audio.write(ip, x, 48000)
    st = standard.process(ip, tmp_path / "o.flac", device="cpu")
    assert st["out_path"] == str(tmp_path / "o.flac")
    assert not (tmp_path / "o.wav").exists()
    meta = audio.info(tmp_path / "o.flac")
    assert (meta.format, meta.subtype, meta.frames) == \
        ("FLAC", "PCM_24", len(x))
    # the same samples as the WAV run of the same input
    standard.process(ip, tmp_path / "w.wav", device="cpu")
    np.testing.assert_array_equal(audio.read(tmp_path / "o.flac")[0],
                                  audio.read(tmp_path / "w.wav")[0])
    with pytest.raises(ValueError, match="unsupported audio format"):
        audio.AudioFile(tmp_path / "o.mp3", "w", samplerate=48000,
                        channels=2)


def test_pcm24_converters():
    v = np.array([-8388608, -1, 0, 1, 8388607, 12345], np.int32)
    assert pcm.i32_from_le24(pcm.le24_from_i32(v)).tolist() == v.tolist()


def test_resolve_transport():
    assert streaming.resolve_transport("auto", True) == ("pcm24", True)
    assert streaming.resolve_transport("auto", False) == ("f32", False)
    assert streaming.resolve_transport("f32", True) == ("f32", False)
    assert streaming.resolve_transport("pcm24", True) == ("pcm24", True)
    with pytest.raises(ValueError, match="raw PCM_24"):
        streaming.resolve_transport("pcm24", False)
    for tr in ("bogus", "wire"):
        for raw in (True, False):
            with pytest.raises(ValueError, match="unknown transport"):
                streaming.resolve_transport(tr, raw)


@pytest.mark.parametrize("total,n_fft,hop", [
    (0, 4096, 2048), (1000, 4096, 2048), (48000 * 13 + 7, 4096, 2048),
    (48000 * 11, 4096, 1024), (300000, 1024, 512)])
def test_flush_plan_matches_reference(total, n_fft, hop):
    a = streaming.flush_plan(total, n_fft, hop)
    b = jstreaming.flush_plan(total, n_fft, hop)
    assert (a.cuts, a.pad, a.pad_end, a.n_frames, a.total) == \
        (b.cuts, b.pad, b.pad_end, b.n_frames, b.total)


def test_checkpoint_is_refused(tmp_path):
    """The name is from when checkpoint_path was refused; the same call
    now runs, leaves no checkpoint, and writes the uncheckpointed bytes."""
    ip = tmp_path / "in.wav"
    audio.write(ip, _tone(0.5), 48000)
    ck = tmp_path / "ck.npz"
    st = standard.process(ip, tmp_path / "o.wav", checkpoint_path=ck,
                          checkpoint_every=1, frames_per_chunk=4,
                          device="cpu")
    assert st["chunks"] > 2 and not ck.exists()
    standard.process(ip, tmp_path / "ref.wav", frames_per_chunk=4,
                     device="cpu")
    assert (tmp_path / "o.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()


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
    # the checkpoint flag runs (FLAC in and out) and leaves no checkpoint
    fi, fo, ck = tmp_path / "in.flac", tmp_path / "o.flac", tmp_path / "c.npz"
    audio.write(fi, x, 48000)
    assert cli_main.main(["process", "-i", str(fi), "-o", str(fo),
                          "--device", "cpu", "--checkpoint", str(ck),
                          "--checkpoint_every", "1",
                          "--frames_per_chunk", "16"]) == 0
    assert not ck.exists() and audio.info(fo).frames == len(x)
    np.testing.assert_array_equal(audio.read(fo)[0], audio.read(op)[0])
    # the reference's single-file wire transport and an unknown one are
    # refused by the parser (exit 2) before the output is touched
    before = fo.read_bytes()
    with pytest.raises(SystemExit) as refused:
        cli_main.main(["process", "-i", str(fi), "-o", str(fo),
                       "--device", "cpu", "--transport", "wire",
                       "--frames_per_chunk", "16"])
    assert refused.value.code == 2
    assert fo.read_bytes() == before
    with pytest.raises(SystemExit):
        cli_main.main(["process", "-i", str(fi), "-o", str(fo),
                       "--device", "cpu", "--transport", "bogus"])
    assert fo.read_bytes() == before
    assert cli_main.main(["nope"]) == 2
    assert cli_main.main([]) == 0


def test_reference_validate_passes_on_port_output(tmp_path, capsys):
    """The JAX package's `validate`, with no parameter flags, on a FLAC the
    port processed on CPU and the sidecar the port's CLI wrote: exit 0.
    The signal is broadband noise with a loud middle 3 s (the conditional
    spectrum needs broadband content; the quiet floor sits above the
    -60 dBFS stable-frame cutoff, the loud part low enough that +15 dB
    keeps the peak under 0.98)."""
    from tomatis_tpu.cli import validate as j_validate
    rng = np.random.default_rng(11)
    n = 8 * 48000
    amp = np.full(n, 0.005)
    amp[int(2.5 * 48000):int(5.5 * 48000)] = 0.05
    x = np.clip(0.4 * rng.standard_normal((n, 2)) * amp[:, None],
                -0.98, 0.98).astype(np.float32)
    ip, op, cp = (str(tmp_path / f) for f in ("in.flac", "out.flac", "s.csv"))
    audio.write(ip, x, 48000, subtype="PCM_24")
    assert cli_main.main(["process", "-i", ip, "-o", op, "--state_csv", cp,
                          "--gate_ui", "50", "--gate_mode", "log_percent",
                          "--device", "cpu"]) == 0
    side = json.loads(open(op + ".params.json").read())
    assert side["gate_scale"] == 0.0 and side["gate_offset"] == -40.0
    rc = j_validate.main(["-i", ip, "-o", op, "--state_csv", cp,
                          "--out_csv", str(tmp_path / "spec.csv"),
                          "--out_png", str(tmp_path / "spec.png")])
    assert rc == 0, capsys.readouterr().out[-3000:]
