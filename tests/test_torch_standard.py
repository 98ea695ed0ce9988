"""The port's standard processor vs the JAX package's, end to end on CPU.

Both packages get the same numpy input and the same parameters (carried
across with tomatis_tpu_torch.convert). Torch and XLA sum frame levels in
different orders, so a frame whose level sits on Ton/Toff could flip the
gate; every signal here keeps each frame level at least 0.01 dB from both
thresholds, and the tests assert that margin.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tomatis_tpu.io import audio as jaudio
from tomatis_tpu.models import standard as jstd
from tomatis_tpu.utils.stateio import read_state_csv as j_read_state_csv
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.utils.stateio import read_state_csv

torch.set_num_threads(2)

SR = 48000
MARGIN_DB = 0.01


def _signal(seconds=3.0, sr=SR, seed=1):
    """Stereo tone mix with quiet/loud alternation exercising the gate."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.004 + 0.25 * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t) + 0.5 * np.sin(2 * np.pi * 3000 * t))
    x = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(n)], 1)
    return np.clip(x, -1, 1).astype(np.float32)


def _params(**kw):
    return jstd.StandardParams(require_48k_stereo=False, **kw)


def _port(jp: jstd.StandardParams, sr=SR):
    """(port params, port controller) carried across from the JAX ones."""
    p = convert.standard_params_from_dict(dataclasses.asdict(jp))
    jctl = jstd.build_controller(jp, sr)
    table, ton, toff = (np.asarray(v) for v in jctl.params())
    ctl = convert.controller_from_reference(table, ton, toff,
                                            jctl.delay_frames, device="cpu")
    return p, ctl, (float(ton), float(toff))


def _jax_run(x, jp, fpc):
    """JAX process_array plus its per-frame levels."""
    runner = jstd.make_runner(jp, SR, x.shape[1], len(x), fpc)
    outs, levels = [], []
    stats = runner.run(x, on_audio=outs.append,
                       on_frames=lambda f0, st, log: levels.append(
                           np.asarray(log["levels"])))
    y = np.concatenate(outs, 0) if outs else np.zeros_like(x)
    return y, stats, np.concatenate(levels) if levels else np.zeros(0)


def _assert_margin(levels, thresholds):
    for th in thresholds:
        assert np.min(np.abs(levels - th)) >= MARGIN_DB, th


def _check_parity(x, jp, fpc):
    y_j, st_j, levels = _jax_run(x, jp, fpc)
    p, ctl, ths = _port(jp)
    _assert_margin(levels, ths)
    y, st = standard.process_array(x, SR, p, frames_per_chunk=fpc,
                                   device="cpu", controller=ctl)
    assert y.shape == y_j.shape == x.shape
    assert np.max(np.abs(y - y_j)) <= 1e-5
    for k in ("n_frames", "c1_frames", "c2_frames"):
        assert st[k] == st_j[k], k
    return y, st


@pytest.mark.parametrize("seconds,fpc", [(2.0, 1024), (3.5, 37)])
def test_process_array_matches_jax(seconds, fpc):
    _, st = _check_parity(_signal(seconds), _params(), fpc)
    assert st["c1_frames"] > 0 and st["c2_frames"] > 0


def test_process_array_matches_jax_hop_quarter():
    """n_fft/hop = 4: the OLA tail spans 3 hop blocks (K=4 kernel path and
    the partial-final-chunk emit slicing)."""
    _check_parity(_signal(2.3), _params(n_fft=4096, hop=1024), 29)


def test_flush_clamp_matches_jax():
    """Peaks > 0.999 over a file longer than the 5 s flush threshold: the
    per-flush clamp on both packages, cut at the same boundaries."""
    x = np.clip(_signal(8.0) * 4.0, -1, 1).astype(np.float32)
    y, _ = _check_parity(x, _params(), 64)
    assert np.max(np.abs(y)) <= 0.999 + 1e-6


def test_silence_matches_jax():
    x = np.zeros((SR * 2, 2), np.float32)
    y, st = _check_parity(x, _params(), 16)
    assert np.all(np.isfinite(y)) and np.max(np.abs(y)) == 0.0
    assert st["c2_frames"] == 0


def test_pcm24_transport_within_one_lsb_of_f32():
    """The device quantise (pcm24) and the float path agree to 1 LSB,
    clamped flushes included."""
    x = np.clip(_signal(6.0) * 4.0, -1, 1).astype(np.float32)
    p = standard.StandardParams(require_48k_stereo=False)
    y32, _ = standard.process_array(x, SR, p, frames_per_chunk=64,
                                    device="cpu")
    y24, _ = standard.process_array(x, SR, p, frames_per_chunk=64,
                                    device="cpu", transport="pcm24")
    assert np.max(np.abs(y24 - y32)) <= 1.0 / 8388608 * 1.01


def _ramp_case():
    """Long enough at fpc 256 for the ramp schedule (64, 128, 256...)."""
    x = _signal(24.0, seed=4)
    return x, _params()


def test_ramp_schedule_matches_jax():
    x, jp = _ramp_case()
    p, ctl, _ = _port(jp)
    runner = standard.make_runner(p, SR, 2, len(x), 256, device="cpu",
                                  controller=ctl)
    assert runner._ramp
    assert [runner._chunk_F(f) for f in (0, 64, 192, 448)] == \
        [64, 128, 256, 256]
    _check_parity(x, jp, 256)


def test_process_wav_matches_jax(tmp_path):
    """process() on a WAV: the state CSV matches the JAX package's and the
    PCM_24 payload is within 1 LSB of JAX's pcm24 transport.

    The signal peaks well below full scale: the two FFTs (pocketfft here,
    XLA's in the reference) round differently by a few float32 ulps of the
    sample value, which near full scale reaches 4 LSB of PCM_24
    (4.8e-7), inside the 1e-5 float tolerance but not inside 1 LSB."""
    x = _signal(3.0, seed=2) * np.float32(0.25)
    ip = tmp_path / "in.wav"
    jaudio.write(ip, x, SR, subtype="PCM_24")
    jp = jstd.StandardParams()
    j_out, j_csv = tmp_path / "j.wav", tmp_path / "j.csv"
    jstd.process(ip, j_out, jp, state_csv_path=j_csv, frames_per_chunk=32,
                 transport="pcm24")
    p, ctl, ths = _port(jp)
    out, csv = tmp_path / "t.wav", tmp_path / "t.csv"
    st = standard.process(ip, out, p, state_csv_path=csv,
                          frames_per_chunk=32, device="cpu", controller=ctl)
    assert st["transport"] == "pcm24" and st["out_path"] == str(out)

    meta = audio.info(out)
    assert meta.subtype == "PCM_24" and meta.frames == len(x)
    a = np.frombuffer(open(out, "rb").read()[44:], np.uint8)
    b = np.frombuffer(open(j_out, "rb").read()[44:], np.uint8)
    assert a.size == b.size == len(x) * 2 * 3
    from tomatis_tpu_torch.utils.pcm import i32_from_le24
    assert np.max(np.abs(i32_from_le24(a) - i32_from_le24(b))) <= 1

    c, cj = read_state_csv(csv), j_read_state_csv(j_csv)
    _assert_margin(cj["level_dbfs"], ths)
    np.testing.assert_array_equal(c["frame_idx"], cj["frame_idx"])
    np.testing.assert_array_equal(c["time_sec"], cj["time_sec"])
    np.testing.assert_array_equal(c["state"], cj["state"])
    np.testing.assert_allclose(c["level_dbfs"], cj["level_dbfs"], atol=1e-4)


def test_convert_carries_parameters():
    jp = jstd.StandardParams(gate_ui=42.0, hysteresis_db=2.0, c1_low=9.0)
    p, ctl, (ton, toff) = _port(jp)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.threshold_dbfs() == jp.threshold_dbfs()
    jctl = jstd.build_controller(jp, SR)
    np.testing.assert_array_equal(ctl.table.numpy(),
                                  np.asarray(jctl.table))
    assert ctl.ton.dtype == torch.float32 and float(ctl.ton) == ton
    assert ctl.delay_frames == jctl.delay_frames
    # the port builds the same tables itself, to float32 rounding
    own = standard.build_controller(p, SR, device="cpu")
    np.testing.assert_allclose(own.table.numpy(), np.asarray(jctl.table),
                               rtol=1e-6)
    assert float(own.toff) == toff
    with pytest.raises(ValueError):
        convert.standard_params_from_dict({"nope": 1})
