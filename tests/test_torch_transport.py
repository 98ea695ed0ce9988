"""The port's link transports: the cases of tests/test_transport.py on the
port (CPU), the wire transport against pcm24 (the same bytes) and f32
(1 LSB), and the whole path: process(..., transport="wire") on the
port against the JAX package's process on the same WAV (PCM_24 payload
within 4 LSB, the summation-order bound of ROADMAP section 3; state
column equal) and against the port's own pcm24 run (bytes equal)."""
import dataclasses

import numpy as np
import pytest
import torch

from tests.oracle import refdsp
from tomatis_tpu.io import audio as jaudio
from tomatis_tpu.models import standard as jstd
from tomatis_tpu.utils.stateio import read_state_csv as j_read_state_csv
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.engine import streaming as S
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard, xfade
from tomatis_tpu_torch.models.standard import (StandardParams, process,
                                               process_array)
from tomatis_tpu_torch.utils.pcm import i32_from_le24
from tomatis_tpu_torch.utils.stateio import read_state_csv

torch.set_num_threads(2)
SR = 48000


def _signal(seconds, sr=SR, amp=0.3):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.004 + amp * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t)
               + 0.5 * np.sin(2 * np.pi * 2500 * t))
    return np.clip(np.stack([x, 0.85 * x], 1), -1, 1).astype(np.float32)


def _payload(path):
    return np.frombuffer(open(path, "rb").read()[44:], np.uint8)


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


@pytest.mark.parametrize("transport", ["pcm24", "wire"])
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
    outs = {}
    for tr in ("pcm24", "wire"):
        op = tmp_path / f"out_{tr}.wav"
        process(ip, op, p, device="cpu", transport=tr)
        outs[tr] = op.read_bytes()
        y_file, _ = audio.read(op)
        y_ref, _, _ = refdsp.process_standard_loop(x, SR,
                                                   output_gain_db=6.0)
        assert np.max(np.abs(y_file - y_ref)) < 3e-4
    assert outs["pcm24"] == outs["wire"]


def test_process_transport_param(tmp_path):
    """process(transport=...) forces the link transport; wire and pcm24
    must be byte-identical, f32 within 1 PCM_24 LSB of them; auto is
    pcm24 on the port."""
    x = _signal(2.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    p = StandardParams(require_48k_stereo=False)
    outs, stats = {}, {}
    for tr in ("wire", "pcm24", "f32", "auto"):
        op = tmp_path / f"out_{tr}.wav"
        stats[tr] = process(ip, op, p, frames_per_chunk=64, transport=tr,
                            device="cpu")
        outs[tr], _ = audio.read(op)
    np.testing.assert_array_equal(outs["wire"], outs["pcm24"])
    np.testing.assert_array_equal(outs["auto"], outs["pcm24"])
    assert np.max(np.abs(outs["f32"] - outs["pcm24"])) <= 1.5 / 8388608.0
    assert [stats[t]["transport"] for t in ("wire", "pcm24", "f32", "auto")] \
        == ["wire", "pcm24", "f32", "pcm24"]
    # the wire stream really was shorter than the PCM_24 payload it carries
    assert 0 < stats["wire"]["wire"]["out_bytes"] < outs["wire"].size * 3
    assert stats["pcm24"]["wire"]["out_bytes"] == 0


def test_invalid_transport_rejected_before_output_touch(tmp_path):
    """A bad transport name must raise before the output file is opened
    (opening would truncate a pre-existing output)."""
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(0.5), SR, subtype="FLOAT")
    op = tmp_path / "out.wav"
    op.write_bytes(b"precious bytes")
    p = StandardParams(require_48k_stereo=False)
    with pytest.raises(ValueError, match="transport"):
        process(ip, op, p, transport="bogus", device="cpu")
    assert op.read_bytes() == b"precious bytes"


def test_pcm24_transport_skips_input_codec(tmp_path):
    """--transport pcm24/f32 exist to bypass the wire codec; the input
    side must not wire-encode either. A FLOAT source that is not
    PCM_24-exact ships raw on the wire transport too."""
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(1.0), SR, subtype="PCM_24")
    p = StandardParams(require_48k_stereo=False)
    for tr, expect_wire in (("pcm24", False), ("f32", False),
                            ("wire", True)):
        stats = process(ip, tmp_path / f"o_{tr}.wav", p,
                        frames_per_chunk=16, transport=tr, device="cpu")
        has_wire_in = stats["wire"]["in_bytes"] > 0
        assert has_wire_in == expect_wire, (tr, stats["wire"])
        assert stats["wire"]["in_raw_chunks"] == 0
    fp = tmp_path / "in_f.wav"
    audio.write(fp, _signal(1.0) + np.float32(1.1e-8), SR, subtype="FLOAT")
    stats = process(fp, tmp_path / "o_f.wav", p, frames_per_chunk=16,
                    transport="wire", device="cpu")
    assert stats["wire"]["in_raw_chunks"] == stats["chunks"] > 0


def test_wire_rice_out_modes_identical_output(tmp_path, monkeypatch):
    """The rice-out policy is a LINK optimisation only: chunk steps built
    with rice on and off must produce byte-identical PCM_24 output (the
    host decoder reads the mode per block), over fewer link bytes."""
    x = _signal(2.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    p = StandardParams(require_48k_stereo=False)
    outs, link = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", mode)
        op = tmp_path / f"out_{mode}.wav"
        st = process(ip, op, p, frames_per_chunk=64, transport="wire",
                     device="cpu")
        outs[mode] = op.read_bytes()
        link[mode] = st["wire"]["out_bytes"]
    assert outs["0"] == outs["1"]
    assert 0 < link["1"] < link["0"]


def test_resolve_rice_out_env_force(monkeypatch):
    """TOMATIS_WIRE_RICE_OUT=0/1 forces the policy without probing the
    link; 'auto' falls back to the memoised choice, and on a CPU device
    (no link to probe) to the module default."""
    monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", "1")
    assert S.resolve_rice_out() is True
    monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", "0")
    assert S.resolve_rice_out() is False
    monkeypatch.delenv("TOMATIS_WIRE_RICE_OUT")
    monkeypatch.setattr(S, "_RICE_OUT_MEMO", {})
    assert S.resolve_rice_out("cpu") is S.WIRE_RICE_OUT
    assert "choice" not in S._RICE_OUT_MEMO
    with pytest.raises(RuntimeError, match="CUDA"):
        S.probe_d2h_mbps(device="cpu")
    S._RICE_OUT_MEMO["choice"] = True      # pretend a probe already ran
    assert S.resolve_rice_out("cpu") is True


def _run_transport(sig, transport, wire_input, fpc=16):
    p = StandardParams(require_48k_stereo=False)
    eng = S.ChunkedStftEngine(p.n_fft, p.hop, 2, frames_per_chunk=fpc,
                              device="cpu")
    r = S.StreamRunner(eng, standard.build_controller(p, SR, "cpu"),
                       len(sig), transport=transport, wire_input=wire_input)
    outs = []
    stats = r.run(sig, on_audio=outs.append)
    return np.concatenate([o.reshape(-1) for o in outs]), stats


def test_wire_transport_matches_pcm24():
    """The wire transport must produce byte-identical output to pcm24: it
    is the same quantised PCM stream, compressed on the link."""
    rng = np.random.default_rng(3)
    t = np.arange(int(2.5 * SR)) / SR
    env = np.where((t > 0.8) & (t < 1.7), 0.05, 0.002)
    x = env * (np.sin(2 * np.pi * 1000 * t)
               + 0.5 * np.sin(2 * np.pi * 4000 * t)
               + 0.02 * rng.standard_normal(t.size))
    sig = np.stack([x, 0.9 * x], 1).astype(np.float32)
    sig = (np.rint(sig * 8388608) / 8388608).astype(np.float32)

    b_pcm, s_pcm = _run_transport(sig, "pcm24", False)
    b_wire, s_wire = _run_transport(sig, "wire", False)
    assert np.array_equal(b_pcm, b_wire)
    assert 0 < s_wire["wire"]["out_bytes"] < len(b_pcm), \
        "wire must actually compress this material"
    assert s_pcm["wire"] == dict(in_bytes=0, out_bytes=0, in_raw_chunks=0)

    b_wi, s_wi = _run_transport(sig, "wire", True)
    assert np.array_equal(b_pcm, b_wi), "wire input path changed output"
    assert s_wi["wire"]["in_bytes"] > 0

    # non-PCM_24-exact input must ship as float32, not be quantised
    _, s_f = _run_transport(sig + np.float32(1.1e-8), "wire", True)
    assert s_f["wire"]["in_raw_chunks"] > 0


def test_wire_transport_fullscale_noise_end_to_end():
    """Near-full-scale white noise: the +-15 dB boost saturates the device
    PCM_24 quantiser and trips the per-flush clamp (the float-ref
    re-encode, read from the writer thread): wire stays byte-identical to
    pcm24 through all of it."""
    rng = np.random.default_rng(11)
    sig = (rng.integers(-7500000, 7500000, (int(1.5 * SR), 2))
           .astype(np.float32) / 8388608.0)
    sig = (np.rint(sig * 8388608) / 8388608).astype(np.float32)
    b_pcm, _ = _run_transport(sig, "pcm24", False)
    b_wire, s_wire = _run_transport(sig, "wire", True)
    assert np.array_equal(b_pcm, b_wire)
    assert s_wire["wire"]["out_bytes"] > 0


def test_wire_chunk_step_packs_the_pcm24_bytes():
    """One chunk step: the wire payload decodes to the very bytes the
    pcm24 step returns, aux and carries equal."""
    from tomatis_tpu_torch.io import wirecodec
    p = StandardParams(require_48k_stereo=False, n_fft=512, hop=256)
    ctl = standard.build_controller(p, SR, "cpu")
    x = torch.from_numpy(_signal(0.5))
    res = {}
    for tr in ("pcm24", "wire"):
        eng = S.ChunkedStftEngine(512, 256, 2, 16, device="cpu")
        fn = eng.make_chunk_fn(ctl, transport=tr, rice_out=True)
        ot, wt = eng.zero_tails()
        res[tr] = fn(x[:eng.chunk_input_len], 13, ctl.init_carry(), ot, wt,
                     ctl.params(), torch.tensor(1.5))
    words, used = res["wire"][0]
    pcm = wirecodec.decode_pcm24(
        words.numpy()[:int(used)].view(np.uint8), eng.emit_full, 2)
    np.testing.assert_array_equal(pcm, res["pcm24"][0].numpy())
    for a, b in zip(res["wire"][1:], res["pcm24"][1:]):
        assert torch.equal(a, b)


def test_process_array_wire_transport():
    """process_array(transport="wire") returns the pcm24 transport's
    samples; the crossfade processor takes the transport too."""
    x = _signal(2.0)
    p = StandardParams(require_48k_stereo=False)
    y24, _ = process_array(x, SR, p, frames_per_chunk=32, device="cpu",
                           transport="pcm24")
    yw, st = process_array(x, SR, p, frames_per_chunk=32, device="cpu",
                           transport="wire")
    np.testing.assert_array_equal(yw, y24)
    assert st["wire"]["out_bytes"] > 0
    xp = xfade.XfadeParams(require_48k_stereo=False, xfade_ms=100.0)
    a, _ = xfade.process_array(x, SR, xp, frames_per_chunk=32, device="cpu",
                               transport="pcm24")
    b, stx = xfade.process_array(x, SR, xp, frames_per_chunk=32,
                                 device="cpu", transport="wire")
    np.testing.assert_array_equal(a, b)
    assert stx["wire"]["in_bytes"] == 0, "float arrays are not PCM_24-exact"


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
        for tr in ("auto", "pcm24", "wire", "f32"):
            process(ip, tmp_path / f"o_{tr}.wav", p, frames_per_chunk=8,
                    checkpoint_path=tmp_path / "ck.npz", checkpoint_every=2,
                    transport=tr, device="cpu")
    finally:
        mp.undo()
    assert seen == ["pcm24", "pcm24", "wire", "f32"]
    for tr in ("pcm24", "wire"):
        assert (tmp_path / f"o_{tr}.wav").read_bytes() == \
            (tmp_path / "o_auto.wav").read_bytes()


def test_process_wire_matches_jax_and_own_pcm24(tmp_path):
    """The whole path. The same PCM_24 WAV through the JAX package's
    process (its default transport: wire, rice by its own policy) and the
    port's process(transport="wire") with the parameters carried across:
    payload within 4 LSB (two FFTs round differently by a few float32
    ulps of the sample value), frame_idx / time_sec / state columns equal,
    levels to 1e-4 dB; and the port's wire file equals its pcm24 file byte
    for byte, state CSV included."""
    rng = np.random.default_rng(2)
    n = 3 * SR
    t = np.arange(n) / SR
    env = 0.004 + 0.25 * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t)
               + 0.5 * np.sin(2 * np.pi * 3000 * t))
    x = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(n)], 1)
    # peaks stay below the flush clamp: a clamped flush rescales by
    # 0.999/peak, and the two packages' peaks differ in their last bits
    x = (np.clip(x, -1, 1) * 0.25).astype(np.float32)
    ip = tmp_path / "in.wav"
    jaudio.write(ip, x, SR, subtype="PCM_24")
    jp = jstd.StandardParams()
    j_out, j_csv = tmp_path / "j.wav", tmp_path / "j.csv"
    jst = jstd.process(ip, j_out, jp, state_csv_path=j_csv,
                       frames_per_chunk=32)
    assert jst["wire"]["in_bytes"] > 0 and jst["wire"]["out_bytes"] > 0

    p = convert.standard_params_from_dict(dataclasses.asdict(jp))
    jctl = jstd.build_controller(jp, SR)
    table, ton, toff = (np.asarray(v) for v in jctl.params())
    ctl = convert.controller_from_reference(table, ton, toff,
                                            jctl.delay_frames, device="cpu")
    files = {}
    for tr in ("wire", "pcm24"):
        out, csv = tmp_path / f"t_{tr}.wav", tmp_path / f"t_{tr}.csv"
        st = standard.process(ip, out, p, state_csv_path=csv,
                              frames_per_chunk=32, device="cpu",
                              controller=ctl, transport=tr)
        assert st["transport"] == tr and st["producer"] == "thread"
        files[tr] = (out.read_bytes(), csv.read_bytes())
    assert files["wire"] == files["pcm24"]
    assert st["wire"] == dict(in_bytes=0, out_bytes=0, in_raw_chunks=0)

    a, b = _payload(tmp_path / "t_wire.wav"), _payload(j_out)
    assert a.size == b.size == len(x) * 2 * 3
    assert np.max(np.abs(i32_from_le24(a) - i32_from_le24(b))) <= 4
    c = read_state_csv(tmp_path / "t_wire.csv")
    cj = j_read_state_csv(j_csv)
    for th in (float(ton), float(toff)):
        assert np.min(np.abs(cj["level_dbfs"] - th)) >= 0.01, th
    np.testing.assert_array_equal(c["frame_idx"], cj["frame_idx"])
    np.testing.assert_array_equal(c["time_sec"], cj["time_sec"])
    np.testing.assert_array_equal(c["state"], cj["state"])
    np.testing.assert_allclose(c["level_dbfs"], cj["level_dbfs"], atol=1e-4)
    assert set(c["state"]) == {"C1", "C2"}


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
