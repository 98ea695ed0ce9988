"""The port's adaptive processor (tomatis_tpu_torch/models/adaptive.py)
against the JAX package's on the same inputs, on the CPU.

Tolerances: frame_window equal; levels <= 1e-4 dB (float32 sums in
another order); threshold <= 1e-3 dB (a probe flips only if a level ties
with a threshold to the last bit; on these inputs none does and the
thresholds come out equal); gate states equal; alpha <= 1e-6 (the ramp
composes in another tree order); process_array <= 1e-5, and on the
stream's first and last hop <= 1e-5 + 2e-7/win[k]: the stream runs from
the first in-range frame's start to the last one's end, one frame alone
covers those hops, so a sample k from either end is z*win/win^2 =
z/win[k] and an irFFT error e comes out as e/win[k] (both packages, each
around the same true value). Inside the port the file
pipeline equals process_array bit for bit (same chunk shapes).
"""
import json
import os

import numpy as np
import pytest
import torch

from tomatis_tpu.models import adaptive as jad
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.io.wav import WavWriter
from tomatis_tpu_torch.models import adaptive as ad

torch.set_num_threads(2)

SR = 48000


def _signal(seconds=4.0, sr=SR, seed=3, ch=2):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.003 + 0.15 * (np.sin(2 * np.pi * 0.9 * t) > 0.2) \
        * (0.5 + 0.5 * np.sin(2 * np.pi * 0.23 * t) ** 2)
    x = env * (np.sin(2 * np.pi * 700 * t) + 0.3 * rng.standard_normal(n))
    cols = [x * (1.0 - 0.1 * c) for c in range(ch)]
    x = np.clip(np.stack(cols, 1), -1, 1)
    return (np.rint(x * 8388608) / 8388608).astype(np.float32)


def _pcm(path):
    y, _ = audio.read(path)
    return np.rint(y * 8388608).astype(np.int64)


def _bound(n: int, n_fft: int = 4096, hop: int = 2048, lsb: bool = False):
    """Per-sample tolerance [n, 1] between the two packages' outputs:
    1e-5 (4 LSB for PCM files), plus 2e-7/win[k] on the first and last hop
    of the stream (from the first in-range frame's start, `base`, to the
    last one's end), where one frame alone covers the samples."""
    b = np.full(n, 4.0 / 8388608 if lsb else 1e-5)
    k0, n_frames = ad.frame_window(n, n_fft, hop)
    base = k0 * hop - n_fft // 2
    end = base + (n_frames - 1) * hop + n_fft
    extra = 2e-7 / np.maximum(np.hanning(n_fft)[:hop], 1e-30)
    for k in range(1, hop):
        for pos in (base + k, end - 1 - k):
            if 0 <= pos < n:
                b[pos] += extra[k]
    return (b * 8388608 if lsb else b)[:, None]


@pytest.mark.parametrize("total", [0, 1, 100, 2047, 2048, 2049, 4096, 6000,
                                   48000, 48000 * 3 + 17])
@pytest.mark.parametrize("n_fft,hop", [(4096, 2048), (3072, 1024),
                                       (2048, 512)])
def test_frame_window_equal(total, n_fft, hop):
    assert ad.frame_window(total, n_fft, hop) == \
        jad.frame_window(total, n_fft, hop)


def test_params_carry_across():
    from dataclasses import asdict
    pj = jad.AdaptiveParams(target_c2=0.4, xfade_ms=300.0, hop=1024)
    pt = convert.adaptive_params_from_dict(asdict(pj))
    assert asdict(pt) == asdict(pj)
    for sr in (44100, 48000):
        assert pt.min_hold_frames(sr) == pj.min_hold_frames(sr)
        assert pt.xfade_frames(sr) == pj.xfade_frames(sr)
    assert asdict(ad.AdaptiveParams()) == asdict(jad.AdaptiveParams())
    with pytest.raises(ValueError):
        convert.adaptive_params_from_dict(dict(gate_ui=1.0))
    for peak in (0.0, 0.01, 0.5, 1.0):
        a, b = ad.atten_plan(pt, peak), jad.atten_plan(pj, peak)
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]


@pytest.mark.parametrize("ch,sr", [(2, 48000), (1, 44100)])
def test_levels_and_gate_plan(ch, sr):
    x = _signal(5.0, sr=sr, ch=ch) * 0.05
    pj, pt = jad.AdaptiveParams(), ad.AdaptiveParams()
    lv_j, valid_j = jad.compute_frame_levels(x, pj)
    lv_t, valid_t = ad.compute_frame_levels(x, pt, device="cpu")
    assert lv_t.shape == lv_j.shape and lv_t.dtype == np.float32
    assert np.abs(lv_t - lv_j).max() <= 1e-4          # dB
    np.testing.assert_array_equal(valid_t, valid_j)
    # a smaller levels chunk gives the same levels (per-frame math)
    lv_s, _ = ad.compute_frame_levels(x, pt, frames_per_chunk=16,
                                      device="cpu")
    np.testing.assert_allclose(lv_s, lv_t, atol=1e-5)

    H, X = pt.min_hold_frames(sr), pt.xfade_frames(sr)
    # the same levels into both searches: equal thresholds
    t_j = jad.find_optimal_threshold(lv_j, valid_j, 3.0, H, 0.5)
    t_t = ad.find_optimal_threshold(lv_j, valid_j, 3.0, H, 0.5,
                                    device="cpu")
    assert t_t == t_j
    # each package on its own levels: within 1e-3 dB
    plan_j = jad.gate_plan(lv_j, pj, H, X)
    plan_t = ad.gate_plan(lv_t, pt, H, X, device="cpu")
    assert abs(plan_t["optimal_t"] - plan_j["optimal_t"]) <= 1e-3
    np.testing.assert_array_equal(plan_t["states"], plan_j["states"])
    assert plan_t["states"].dtype == plan_j["states"].dtype
    assert np.abs(plan_t["alpha"] - plan_j["alpha"]).max() <= 1e-6
    assert plan_t["astep"] == plan_j["astep"]
    assert plan_t["short_runs"] == plan_j["short_runs"]
    assert plan_t["n_runs"] == plan_j["n_runs"]
    assert plan_t["run_stats"]["switch_count"] == \
        plan_j["run_stats"]["switch_count"]
    assert 0 < np.mean(plan_t["states"] == 2) < 1


def test_threshold_no_valid_levels():
    lv = np.full(20, -90.0, np.float32)
    valid = lv > -70.0
    assert ad.find_optimal_threshold(lv, valid, 3.0, 6, 0.5, device="cpu") \
        == jad.find_optimal_threshold(lv, valid, 3.0, 6, 0.5)


@pytest.mark.parametrize("ch,sr,seconds,fpc", [
    (2, 48000, 6.0, 32),      # partial last chunk
    (1, 44100, 4.0, 16),      # mono, another rate
    (2, 48000, 2048 * 64 / 48000, 32),   # F = 64: a final FULL chunk
])
def test_process_array_matches_reference(ch, sr, seconds, fpc):
    x = _signal(seconds, sr=sr, ch=ch)
    y_j, info_j = jad.process_array(x, sr, jad.AdaptiveParams(),
                                    frames_per_chunk=fpc)
    y_t, info_t = ad.process_array(x, sr, ad.AdaptiveParams(),
                                   frames_per_chunk=fpc, device="cpu")
    assert y_t.shape == y_j.shape and y_t.dtype == np.float32
    assert info_t["n_frames"] == info_j["n_frames"]
    if ch == 2 and fpc == 32 and seconds < 3:
        assert info_t["n_frames"] % fpc == 0
    assert np.all(np.abs(y_t - y_j) <= _bound(len(x)))
    assert np.abs(y_t - y_j)[2048:].max() <= 1e-5
    assert abs(info_t["optimal_threshold"]
               - info_j["optimal_threshold"]) <= 1e-3
    np.testing.assert_array_equal(info_t["states"], info_j["states"])
    assert np.abs(info_t["alpha"] - info_j["alpha"]).max() <= 1e-6
    assert np.abs(info_t["levels"] - info_j["levels"]).max() <= 1e-4
    for k in ("c2_ratio", "switch_count", "switches_per_min",
              "short_run_ratio", "atten_db", "min_hold_frames",
              "xfade_frames"):
        assert info_t[k] == pytest.approx(info_j[k], rel=1e-9), k
    assert set(info_t["timings"]) >= {"peak_scan_s", "levels_s",
                                      "threshold_search_s", "gate_ramp_s",
                                      "pass3_s", "restore_protect_s"}


def test_process_array_degenerate():
    x = np.zeros((100, 2), np.float32)
    y_t, info_t = ad.process_array(x, SR, device="cpu")
    y_j, info_j = jad.process_array(x, SR)
    np.testing.assert_array_equal(y_t, y_j)
    assert info_t["n_frames"] == info_j["n_frames"] == 0
    assert set(info_j) <= set(info_t)
    assert info_t["device"] == "cpu" and "levels_s" in info_t["timings"]


@pytest.mark.parametrize("ext", ["flac", "wav"])
def test_file_equals_array_and_reference(tmp_path, ext):
    """The bounded-memory file pipeline reproduces process_array bit for
    bit (same chunk shapes), and the JAX package's file to 4 LSB."""
    x = _signal(6.0)
    ip, op = tmp_path / f"in.{ext}", tmp_path / f"out.{ext}"
    audio.write(ip, x, SR, subtype="PCM_24")
    p = ad.AdaptiveParams()
    stats = ad.process(ip, op, p, state_csv_path=tmp_path / "s.csv",
                       frames_per_chunk=32, device="cpu")
    y_arr, info = ad.process_array(x, SR, p, frames_per_chunk=32,
                                   device="cpu")
    v_arr = np.clip(np.rint(y_arr * 8388608), -8388608, 8388607)
    np.testing.assert_array_equal(_pcm(op), v_arr.astype(np.int64))
    assert stats["n_frames"] == info["n_frames"]
    assert stats["optimal_threshold"] == info["optimal_threshold"]
    assert stats["switch_count"] == info["switch_count"]
    assert stats["out_path"] == str(op)
    assert not os.path.exists(str(op) + ".stage.wav")

    oj = tmp_path / f"ref.{ext}"
    stats_j = jad.process(ip, oj, jad.AdaptiveParams(),
                          state_csv_path=tmp_path / "sj.csv",
                          frames_per_chunk=32)
    assert np.all(np.abs(_pcm(op) - _pcm(oj)) <= _bound(len(x), lsb=True))
    for k in ("n_frames", "c2_ratio", "switch_count", "atten_db", "sr",
              "total", "params"):
        assert stats[k] == stats_j[k], k
    assert set(stats_j) <= set(stats)
    # state CSV: same columns, same states, levels and alpha to their
    # printed 4 decimals +- 1 in the last place
    rows_t = open(tmp_path / "s.csv").read().strip().splitlines()
    rows_j = open(tmp_path / "sj.csv").read().strip().splitlines()
    assert rows_t[0] == rows_j[0] == \
        "frame_idx,time_sec,level_dbfs,state,alpha"
    assert len(rows_t) == len(rows_j) == stats["n_frames"] + 1
    for a, b in zip(rows_t[1:], rows_j[1:]):
        a, b = a.split(","), b.split(",")
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        assert abs(float(a[2]) - float(b[2])) <= 2e-4
        assert abs(float(a[4]) - float(b[4])) <= 1e-4


def test_mono_and_anyrate_file(tmp_path):
    sr = 44100
    x = _signal(3.0, sr=sr, ch=1)
    ip, op, cp = tmp_path / "i.wav", tmp_path / "o.wav", tmp_path / "s.csv"
    audio.write(ip, x, sr, subtype="PCM_16")
    stats = ad.process(ip, op, ad.AdaptiveParams(), state_csv_path=cp,
                       frames_per_chunk=16, device="cpu")
    meta = audio.info(op)
    assert (meta.frames, meta.channels, meta.samplerate) == (len(x), 1, sr)
    oj = tmp_path / "j.wav"
    stats_j = jad.process(ip, oj, jad.AdaptiveParams(), frames_per_chunk=16)
    assert np.all(np.abs(_pcm(op) - _pcm(oj)) <= _bound(len(x), lsb=True))
    assert stats["n_frames"] == stats_j["n_frames"]
    lines = open(cp).read().strip().splitlines()
    assert len(lines) == stats["n_frames"] + 1
    first = lines[1].split(",")
    assert first[0] == "1"
    np.testing.assert_allclose(float(first[1]), 2048 / sr, atol=1e-6)


def test_peak_protect_is_one_global_rescale(tmp_path):
    x = np.clip(_signal(4.0, seed=9) * 4.0, -1, 1).astype(np.float32)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    x_disk, _ = audio.read(ip)    # +1.0 samples clamp to 8388607/2^23
    ad.process(ip, op, ad.AdaptiveParams(), frames_per_chunk=32,
               device="cpu")
    y_arr, _ = ad.process_array(x_disk, SR, ad.AdaptiveParams(),
                                frames_per_chunk=32, device="cpu")
    y_j, _ = jad.process_array(x_disk, SR, jad.AdaptiveParams(),
                               frames_per_chunk=32)
    v = _pcm(op)
    np.testing.assert_array_equal(
        v, np.clip(np.rint(y_arr * 8388608), -8388608, 8388607)
        .astype(np.int64))
    assert np.abs(v).max() <= 0.999 * 8388608 + 1
    assert np.abs(v).max() >= 0.998 * 8388608      # the rescale happened
    assert np.all(np.abs(y_arr - y_j) <= _bound(len(x)))


def test_nondividing_hop_file_equals_array(tmp_path):
    """hop that does not divide n_fft//2 (k0*hop > pad)."""
    x = _signal(3.0, seed=5)
    ip, op = tmp_path / "in.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    p = ad.AdaptiveParams(n_fft=3072, hop=1024)   # pad=1536, k0*hop=2048
    stats = ad.process(ip, op, p, frames_per_chunk=32, device="cpu")
    y_arr, info = ad.process_array(x, SR, p, frames_per_chunk=32,
                                   device="cpu")
    np.testing.assert_array_equal(
        _pcm(op), np.clip(np.rint(y_arr * 8388608), -8388608, 8388607)
        .astype(np.int64))
    assert stats["optimal_threshold"] == info["optimal_threshold"]
    y_j, _ = jad.process_array(x, SR, jad.AdaptiveParams(n_fft=3072,
                                                         hop=1024),
                               frames_per_chunk=32)
    assert np.all(np.abs(y_arr - y_j) <= _bound(len(x), 3072, 1024))


class _Bomb(Exception):
    pass


def _arm(monkeypatch, after: int):
    orig_write = WavWriter.write
    calls = {"n": 0}

    def bomb(self, data):
        if self.subtype == "FLOAT":   # only the pass-3 staging writer
            calls["n"] += 1
            if calls["n"] > after:
                raise _Bomb()
        return orig_write(self, data)
    monkeypatch.setattr(WavWriter, "write", bomb)
    return calls


@pytest.mark.parametrize("seconds", [8.0, 2048 * 96 / 48000])
def test_resume_after_interrupt(tmp_path, monkeypatch, seconds):
    """Kill pass 3 mid-stream; the checkpointed resume completes with
    bytes equal to an uninterrupted run's (a partial and a full last
    chunk)."""
    x = _signal(seconds, seed=21)
    ip = tmp_path / "in.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    p = ad.AdaptiveParams()
    ref = tmp_path / "ref.flac"
    ad.process(ip, ref, p, state_csv_path=tmp_path / "ref.csv",
               frames_per_chunk=16, device="cpu")
    out, ck = tmp_path / "out.flac", tmp_path / "ck.npz"
    kw = dict(state_csv_path=tmp_path / "out.csv", frames_per_chunk=16,
              checkpoint_path=ck, checkpoint_every=2, device="cpu")
    with monkeypatch.context() as m:
        calls = _arm(m, 4)
        with pytest.raises(_Bomb):
            ad.process(ip, out, p, **kw)
        assert calls["n"] > 4
    assert ck.exists() and os.path.exists(str(out) + ".stage.wav")
    ad.process(ip, out, p, **kw)
    assert not ck.exists()
    assert not os.path.exists(str(out) + ".stage.wav")
    assert open(out, "rb").read() == open(ref, "rb").read()
    assert open(tmp_path / "out.csv").read() == \
        open(tmp_path / "ref.csv").read()


def test_checkpoint_has_the_reference_keys(tmp_path, monkeypatch):
    """An adaptive checkpoint of the port against one the JAX package
    writes for the same call: the same keys, scalars and fingerprint."""
    from tomatis_tpu.io.wav import WavWriter as JWavWriter
    x = _signal(8.0, seed=21)
    ip = tmp_path / "in.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    got = {}
    for name, mod, writer, kw in (("torch", ad, WavWriter,
                                   dict(device="cpu")),
                                  ("jax", jad, JWavWriter, {})):
        ck = tmp_path / f"{name}.npz"
        orig = writer.write
        calls = {"n": 0}

        def bomb(self, data, _orig=orig, _calls=calls):
            if self.subtype == "FLOAT":
                _calls["n"] += 1
                if _calls["n"] > 6:
                    raise _Bomb()
            return _orig(self, data)
        with monkeypatch.context() as m:
            m.setattr(writer, "write", bomb)
            with pytest.raises(_Bomb):
                mod.process(ip, tmp_path / "o.flac", mod.AdaptiveParams(),
                            frames_per_chunk=16, checkpoint_path=ck,
                            checkpoint_every=2, **kw)
        with np.load(ck, allow_pickle=False) as z:
            got[name] = (sorted(z.files), json.loads(str(z["meta"])),
                         {k: z[k] for k in ("out_tail", "w_tail")})
        os.remove(str(tmp_path / "o.flac") + ".stage.wav")
    (files_t, meta_t, arr_t), (files_j, meta_j, arr_j) = \
        got["torch"], got["jax"]
    assert files_t == files_j
    assert meta_t["config"] == meta_j["config"]
    assert set(meta_t["scalars"]) == set(meta_j["scalars"]) == \
        {"f0", "abs_written", "peak"}
    assert meta_t["scalars"]["f0"] == meta_j["scalars"]["f0"]
    assert meta_t["scalars"]["abs_written"] == \
        meta_j["scalars"]["abs_written"]
    assert meta_t["scalars"]["peak"] == pytest.approx(
        meta_j["scalars"]["peak"], rel=1e-5)
    for k in arr_t:
        assert arr_t[k].shape == arr_j[k].shape
        assert arr_t[k].dtype == arr_j[k].dtype
        np.testing.assert_allclose(arr_t[k], arr_j[k], atol=1e-5)


def test_stale_checkpoint_without_stage_starts_over(tmp_path, monkeypatch):
    x = _signal(8.0, seed=21)
    ip = tmp_path / "in.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    out, ck = tmp_path / "out.flac", tmp_path / "ck.npz"
    kw = dict(frames_per_chunk=16, checkpoint_path=ck, checkpoint_every=2,
              device="cpu")
    with monkeypatch.context() as m:
        _arm(m, 6)
        with pytest.raises(_Bomb):
            ad.process(ip, out, ad.AdaptiveParams(), **kw)
    os.remove(str(out) + ".stage.wav")
    ad.process(ip, out, ad.AdaptiveParams(), **kw)
    ref = tmp_path / "ref.flac"
    ad.process(ip, ref, ad.AdaptiveParams(), frames_per_chunk=16,
               device="cpu")
    assert open(out, "rb").read() == open(ref, "rb").read()
    assert not ck.exists()


def test_degenerate_short_file_writes_csv(tmp_path):
    x = np.zeros((100, 2), np.float32)   # shorter than one frame
    ip, op = tmp_path / "tiny.flac", tmp_path / "out.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    stats = ad.process(ip, op, ad.AdaptiveParams(),
                       state_csv_path=tmp_path / "s.csv", device="cpu")
    stats_j = jad.process(ip, tmp_path / "j.flac", jad.AdaptiveParams(),
                          state_csv_path=tmp_path / "sj.csv")
    assert stats["n_frames"] == 0
    assert stats["device"] == "cpu" and "wall_s" in stats["timings"]
    for k in stats_j:
        if k != "out_path":
            assert stats[k] == stats_j[k], k
    assert open(tmp_path / "s.csv").read() == open(tmp_path / "sj.csv").read()
    np.testing.assert_array_equal(_pcm(op), _pcm(tmp_path / "j.flac"))


def test_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    x = _signal(1.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    with pytest.raises(RuntimeError, match="CUDA"):
        ad.process_array(x, SR)
    with pytest.raises(RuntimeError, match="CUDA"):
        ad.process(ip, tmp_path / "o.wav")
    with pytest.raises(RuntimeError, match="CUDA"):
        ad.compute_frame_levels(x, ad.AdaptiveParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        ad.gate_plan(np.zeros(8, np.float32), ad.AdaptiveParams(), 6, 12)
    assert not os.path.exists(tmp_path / "o.wav")
