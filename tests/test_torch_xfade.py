"""The port's crossfade processor vs the JAX package's, end to end on CPU.

Both packages get the same numpy input and the same controller numbers
(carried across with tomatis_tpu_torch.convert). As in
test_torch_standard.py, every signal keeps each frame level at least
0.01 dB from both thresholds, and the tests assert that margin: torch and
XLA sum the frame levels in different orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tomatis_tpu.io import audio as jaudio
from tomatis_tpu.models import xfade as jxf
from tomatis_tpu.utils.stateio import read_state_csv as j_read_state_csv
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard, xfade
from tomatis_tpu_torch.utils.stateio import read_state_csv

torch.set_num_threads(2)

SR = 48000
MARGIN_DB = 0.01
N_FFT, HOP, FPC = 512, 256, 16


def _signal(seconds=1.2, ch=2, seed=1):
    """Tone mix with quiet/loud alternation around the -40 dBFS gate."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.003 + 0.2 * (np.sin(2 * np.pi * 2.3 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t) + 0.5 * np.sin(2 * np.pi * 3000 * t))
    x = np.stack([x, 0.8 * x + 0.001 * rng.standard_normal(n)], 1)[:, :ch]
    return np.clip(x, -1, 1).astype(np.float32)


def _jparams(xfade_ms, **kw):
    kw.setdefault("n_fft", N_FFT)
    kw.setdefault("hop", HOP)
    return jxf.XfadeParams(gate_ui=60.0, xfade_ms=xfade_ms, up_delay_ms=20.0,
                           require_48k_stereo=False, **kw)


def _port(jp):
    """(port params, port controller, thresholds) carried across."""
    p = convert.xfade_params_from_dict(dataclasses.asdict(jp))
    jctl = jxf.build_controller(jp, SR)
    g1, g2, ton, toff, step = (np.asarray(v) for v in jctl.params())
    ctl = convert.xfade_controller_from_reference(
        g1, g2, ton, toff, step, jctl.delay_frames, device="cpu")
    return p, ctl, (float(ton), float(toff))


def _assert_margin(levels, thresholds):
    for th in thresholds:
        assert np.min(np.abs(np.asarray(levels) - th)) >= MARGIN_DB, th


def _jax_run(x, jp, fpc):
    runner = jxf.make_runner(jp, SR, x.shape[1], len(x), fpc)
    outs, logs = [], {"levels": [], "alpha": []}

    def on_frames(f0, starts, log):
        for k in logs:
            logs[k].append(np.asarray(log[k]))
    stats = runner.run(x, on_audio=outs.append, on_frames=on_frames)
    return (np.concatenate(outs, 0), stats,
            {k: np.concatenate(v) for k, v in logs.items()})


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("xfade_ms", [0.0, 100.0])
def test_process_array_matches_jax(ch, xfade_ms):
    x = _signal(ch=ch)
    jp = _jparams(xfade_ms)
    y_j, st_j, logs = _jax_run(x, jp, FPC)
    p, ctl, ths = _port(jp)
    _assert_margin(logs["levels"], ths)
    alphas = []
    runner = xfade.make_runner(p, SR, ch, len(x), FPC, device="cpu",
                               controller=ctl)
    outs = []
    st = runner.run(x, on_audio=outs.append,
                    on_frames=lambda f0, s, log: alphas.append(log["alpha"]))
    y = np.concatenate(outs, 0)
    assert y.shape == y_j.shape == x.shape
    assert np.max(np.abs(y - y_j)) <= 1e-5
    for k in ("n_frames", "c1_frames", "c2_frames"):
        assert st[k] == st_j[k], k
    assert st["c1_frames"] > 0 and st["c2_frames"] > 0
    a = np.concatenate(alphas)
    np.testing.assert_allclose(a, logs["alpha"], atol=1e-6)
    mid = np.any((a > 0) & (a < 1))
    assert mid == (xfade_ms > 0)       # 100 ms is 19 frames at hop 256
    # process_array is the same run
    y2, st2 = xfade.process_array(x, SR, p, frames_per_chunk=FPC,
                                  device="cpu", controller=ctl)
    np.testing.assert_array_equal(y2, y)
    assert {"runner_setup_s", "final_drain_s",
            "output_decode_s"} <= set(st2["timings"])


def test_own_controller_matches_reference_numbers():
    jp = _jparams(100.0)
    p, ctl, _ = _port(jp)
    own = xfade.build_controller(p, SR, device="cpu")
    assert p.xfade_frames(SR) == jp.xfade_frames(SR) == 19
    assert p.threshold_dbfs() == jp.threshold_dbfs() == -40.0
    assert own.delay_frames == ctl.delay_frames
    for a, b in zip(own.params(), ctl.params()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    assert float(own.alpha_step) == float(ctl.alpha_step)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    with pytest.raises(ValueError):
        convert.xfade_params_from_dict({"nope": 1})
    with pytest.raises(ValueError):
        convert.xfade_controller_from_reference(
            np.zeros(4), np.zeros(5), 0, 0, 1.0, 1, device="cpu")


@pytest.mark.parametrize("fpc", [16, 1024])
def test_hard_switch_equals_standard(fpc):
    """xfade_ms = 0 is alpha_step 1.0: the port's standard processor at
    the same linear threshold."""
    x = _signal(1.5)
    px = xfade.XfadeParams(gate_ui=60.0, xfade_ms=0.0, up_delay_ms=20.0,
                           n_fft=N_FFT, hop=HOP, require_48k_stereo=False)
    ps = standard.StandardParams(gate_ui=60.0, gate_mode="linear",
                                 up_delay_ms=20.0, n_fft=N_FFT, hop=HOP,
                                 require_48k_stereo=False)
    yx, stx = xfade.process_array(x, SR, px, frames_per_chunk=fpc,
                                  device="cpu")
    ys, sts = standard.process_array(x, SR, ps, frames_per_chunk=fpc,
                                     device="cpu")
    np.testing.assert_allclose(yx, ys, atol=1e-6)
    assert stx["c2_frames"] == sts["c2_frames"] > 0


def test_alpha_ramp_duration():
    """Alpha takes about xfade_frames frames to go from 0 to 1."""
    n = 2 * SR
    t = np.arange(n) / SR
    x = (np.where(t > 0.8, 0.3, 0.002) * np.sin(2 * np.pi * 700 * t))
    x = np.repeat(x[:, None], 2, 1).astype(np.float32)
    p = xfade.XfadeParams(gate_ui=60.0, xfade_ms=200.0, up_delay_ms=0.0,
                          require_48k_stereo=False)
    runner = xfade.make_runner(p, SR, 2, n, device="cpu")
    alphas = []
    runner.run(x, on_frames=lambda f0, st, log: alphas.extend(log["alpha"]))
    alphas = np.array(alphas)
    frac = np.flatnonzero((alphas > 0) & (alphas < 1))
    xf = p.xfade_frames(SR)
    assert xf == 5 and xf - 1 <= len(frac) <= xf


def test_process_file_matches_jax(tmp_path):
    """process() on a FLAC with the alpha CSV: frame_idx, time_sec and
    state equal the JAX package's; alpha (printed %.3f, so a tie can round
    either way) within 1e-3, level (%.2f) within 0.011; PCM_24 payload
    within 1 LSB at a quarter of full scale."""
    x = _signal(1.5, seed=2) * np.float32(0.25)
    ip = tmp_path / "in.flac"
    jaudio.write(ip, x, SR, subtype="PCM_24")
    jp = _jparams(100.0, gate_offset=-112.0)     # threshold -52 dBFS
    j_out, j_csv = tmp_path / "j.flac", tmp_path / "j.csv"
    jxf.process(ip, j_out, jp, state_csv_path=j_csv, frames_per_chunk=FPC,
                transport="pcm24")
    p, ctl, ths = _port(jp)
    out, csv = tmp_path / "t.flac", tmp_path / "t.csv"
    st = xfade.process(ip, out, p, state_csv_path=csv, frames_per_chunk=FPC,
                       device="cpu", controller=ctl)
    assert st["transport"] == "pcm24" and st["out_path"] == str(out)
    assert st["xfade_frames"] == 19 and st["device"] == "cpu"
    a, _ = audio.read(out)
    b, _ = jaudio.read(j_out)
    assert a.shape == b.shape == x.shape
    assert np.max(np.abs(a - b)) <= 1.0 / 8388608 * 1.01
    c, cj = read_state_csv(csv), j_read_state_csv(j_csv)
    assert open(csv).readline().strip() == \
        "frame_idx,time_sec,level_dbfs,state,alpha"
    np.testing.assert_array_equal(c["frame_idx"], cj["frame_idx"])
    np.testing.assert_array_equal(c["time_sec"], cj["time_sec"])
    np.testing.assert_array_equal(c["state"], cj["state"])
    np.testing.assert_allclose(c["alpha"], cj["alpha"], atol=1e-3)
    np.testing.assert_allclose(c["level_dbfs"], cj["level_dbfs"], atol=0.011)
    assert set(c["state"]) == {"C1", "C2"}
    assert np.any((c["alpha"] > 0) & (c["alpha"] < 1))


def test_cli_process_xfade_and_convert(tmp_path, capsys):
    import json
    x = _signal(1.5)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    ck, cp = tmp_path / "ck.npz", tmp_path / "s.csv"
    audio.write(ip, x, SR)
    rc = cli_main.main(["process-xfade", "-i", str(ip), "-o", str(op),
                        "--xfade_ms", "100", "--gate_ui", "60",
                        "--state_csv", str(cp), "--checkpoint", str(ck),
                        "--checkpoint_every", "2", "--device", "cpu",
                        "--frames_per_chunk", "16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "xfade: 3 frames" in out and "realtime on cpu" in out
    assert not ck.exists()
    assert not (tmp_path / "out.flac.part.wav").exists()
    meta = audio.info(op)
    assert (meta.format, meta.subtype, meta.frames) == \
        ("FLAC", "PCM_24", len(x))
    side = json.loads((tmp_path / "out.flac.params.json").read_text())
    assert side["tool"] == "process-xfade" and side["xfade_ms"] == 100.0
    assert "alpha" in read_state_csv(cp)
    # the reference's single-file wire transport is refused by the
    # parser (exit 2) before the output is touched
    before = op.read_bytes()
    with pytest.raises(SystemExit) as refused:
        cli_main.main(["process-xfade", "-i", str(ip), "-o", str(op),
                       "--xfade_ms", "100", "--gate_ui", "60",
                       "--device", "cpu", "--transport", "wire",
                       "--frames_per_chunk", "16"])
    assert refused.value.code == 2
    assert op.read_bytes() == before
    capsys.readouterr()
    # convert: FLAC -> WAV -> FLAC keeps every PCM_24 sample
    wp, fp = tmp_path / "c.wav", tmp_path / "c.flac"
    assert cli_main.main(["convert", "-i", str(op), "-o", str(wp)]) == 0
    assert cli_main.main(["convert", "-i", str(wp), "-o", str(fp)]) == 0
    assert "PCM_24" in capsys.readouterr().out
    np.testing.assert_array_equal(audio.read(fp)[0], audio.read(op)[0])
    assert fp.read_bytes() == op.read_bytes()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    x = np.zeros((4800, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        xfade.process_array(x, SR)
    with pytest.raises(RuntimeError, match="CUDA"):
        xfade.build_controller(xfade.XfadeParams(), SR)
