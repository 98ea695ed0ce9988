"""The port's EQ appliers (tomatis_tpu_torch/models/eq.py) against the JAX
package's on the same files, on the CPU.

Tolerances. The curve functions are numpy on both sides: bit-equal. The
stream's floats differ by FFT summation order only: interior |d| <= 1e-5
(read back from PCM_24, so within 4 LSB = 4.8e-7 of each other, the bound
of ROADMAP section 3). The stream is uncropped, so on its first and last
hop the normaliser is the bare window square and the output is z/win: an
error e of the irFFT output z becomes e/win[k], k samples from the end,
and both packages blow up and may saturate in PCM_24 there. The edges
(one hop at each end) are therefore held to 4 LSB + 1e-7/win[k], or to
the same saturated value. Files that start and end with a frame of
digital silence have zero edges, as real programme material does.
"""
import csv
import os

import numpy as np
import pytest
import torch

from tomatis_tpu.models import eq as jeq
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import eq, standard

torch.set_num_threads(2)

SR = 48000
N_FFT, HOP = 4096, 2048
LSB = 1.0 / 8388608.0


def _signal(seconds=3.0, seed=5, amp=0.1, silent_edges=True):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = amp * (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 3100 * t)
               + 0.1 * rng.standard_normal(n))
    x = np.clip(np.stack([x, 0.8 * x], 1), -1, 1)
    if silent_edges:
        x[:N_FFT] = 0.0
        x[-2 * N_FFT:] = 0.0
    return (np.rint(x * 8388608) / 8388608).astype(np.float32)  # PCM_24-exact


def _eq_csv(path, boost=0.0):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["freq_hz", "delta_db_raw", "delta_db_smooth"])
        for fr in np.geomspace(20, 20000, 48):
            w.writerow([fr, 0.0, boost + 4.0 * np.sin(np.log10(fr) * 2.0)])
    return path


def _diff_csv(path):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["freq_hz", "delta_db_base_minus_cand"])
        for fr in np.geomspace(20, 20000, 64):
            w.writerow([fr, 3.0 * np.sin(fr / 800.0)])
    return path


def _pcm(path):
    y, _ = audio.read(path)
    return np.rint(y * 8388608).astype(np.int64)


# ---------------------------------------------------------------------------
# curve construction: numpy on both sides, bit-equal
# ---------------------------------------------------------------------------

def test_curve_functions_bit_equal(tmp_path):
    ecsv = _eq_csv(tmp_path / "eq.csv")
    f_j, d_j = jeq.load_eq_csv(ecsv)
    f_t, d_t = eq.load_eq_csv(ecsv)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(d_t, d_j)
    for sr, n_fft in ((48000, 4096), (44100, 2048)):
        np.testing.assert_array_equal(
            eq.build_gain_per_bin(sr, n_fft, f_t, d_t),
            jeq.build_gain_per_bin(sr, n_fft, f_j, d_j))
    rng = np.random.default_rng(1)
    rf = np.geomspace(10, 24000, 300)
    rd = rng.normal(0, 5, 300)
    for win in (21, 41, 61):
        np.testing.assert_array_equal(eq.smooth_on_logfreq(rf, rd, win),
                                      jeq.smooth_on_logfreq(rf, rd, win))
    freqs = np.fft.rfftfreq(N_FFT, 1 / SR)
    for a, b in zip(eq.build_eq_from_residual(freqs, rf, rd),
                    jeq.build_eq_from_residual(freqs, rf, rd)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(eq.build_eq_from_residual_safe(freqs, rf, rd),
                    jeq.build_eq_from_residual_safe(freqs, rf, rd)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("col", ["delta_db_base_minus_cand", "delta_db"])
def test_load_residual_csv_equals_pandas_reader(tmp_path, col):
    """The csv-module reader against the reference's pandas one, with the
    legacy column fallback and np.savetxt's float formatting."""
    p = tmp_path / "d.csv"
    freqs = np.fft.rfftfreq(512, 1 / SR)
    d = np.random.default_rng(2).normal(0, 3, len(freqs))
    np.savetxt(p, np.stack([freqs, d], 1), delimiter=",",
               header="freq_hz," + col, comments="")
    f_j, d_j = jeq.load_residual_csv(p)
    f_t, d_t = eq.load_residual_csv(p)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert f_t.dtype == np.float32 and d_t.dtype == np.float32


def test_gain_bins_carry_across():
    g = jeq.build_gain_per_bin(SR, N_FFT, np.array([100., 1000.], np.float32),
                               np.array([-3., 3.], np.float32))
    out = convert.eq_gain_bins_from_reference(g, N_FFT)
    np.testing.assert_array_equal(out, g)
    with pytest.raises(ValueError):
        convert.eq_gain_bins_from_reference(g[:-1], N_FFT)


# ---------------------------------------------------------------------------
# the appliers, file to file
# ---------------------------------------------------------------------------

def _same_stream(pj, pt, res_j, res_t, edge=0):
    """Length, frame count and samples of two rendered files."""
    vj, vt = _pcm(pj), _pcm(pt)
    assert len(vt) == len(vj)
    assert res_t["n_frames"] == res_j["n_frames"]
    F = res_t["n_frames"]
    assert len(vt) == (F * HOP + N_FFT - HOP if F else 0)
    inner = slice(edge, len(vt) - edge) if edge else slice(None)
    d = np.abs(vt[inner] - vj[inner])
    assert d.max() <= 4, d.max()                  # 4 LSB (ROADMAP section 3)
    assert d.max() * LSB <= 1e-5
    return vj, vt


@pytest.mark.parametrize("ext", ["wav", "flac"])
@pytest.mark.parametrize("seconds,fpc", [(3.0, 8), (2.0, 64)])
def test_apply_eq_matches_reference(tmp_path, ext, seconds, fpc):
    """pad on; (3 s, 8): F = 71 does not divide; (2 s, 64): one partial
    chunk."""
    x = _signal(seconds)
    ip = tmp_path / f"in.{ext}"
    audio.write(ip, x, SR, subtype="PCM_24")
    ecsv = _eq_csv(tmp_path / "eq.csv")
    pj, pt = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    res_j = jeq.apply_eq(ip, pj, ecsv, frames_per_chunk=fpc)
    res_t = eq.apply_eq(ip, pt, ecsv, frames_per_chunk=fpc, device="cpu")
    assert res_t["out_path"] == str(pt) and res_j["out_path"] == str(pj)
    assert res_t["transport"] == "pcm24"
    assert res_t["gain_protected_path"] is None
    _same_stream(pj, pt, res_j, res_t)
    # the peak comes from the pre-quantisation floats on both sides
    np.testing.assert_allclose(res_t["peak_seen"], res_j["peak_seen"],
                               rtol=1e-5)


def test_apply_eq_dividing_frames_writes_tail_piece(tmp_path):
    """F % frames_per_chunk == 0: the stream's tail comes from the carry
    after the loop (the host's y/(w + 1e-12) piece)."""
    n = 15 * HOP + N_FFT - 2 * (N_FFT // 2)      # pad on: F = 16
    x = _signal(n / SR)
    assert len(x) == n
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    ecsv = _eq_csv(tmp_path / "eq.csv")
    pj, pt = tmp_path / "j.wav", tmp_path / "t.wav"
    res_j = jeq.apply_eq(ip, pj, ecsv, frames_per_chunk=8)
    res_t = eq.apply_eq(ip, pt, ecsv, frames_per_chunk=8, device="cpu")
    assert res_t["n_frames"] == 16
    _same_stream(pj, pt, res_j, res_t)


def test_apply_eq_f32_transport_equals_pcm24(tmp_path, monkeypatch):
    """A sink that takes no raw bytes (a float WAV) gets the float
    readback on both packages: floats <= 1e-5 of the reference's f32 path,
    and within 1 LSB of the port's own device-packed PCM_24 render."""
    from tomatis_tpu.io import audio as jaudio
    from tomatis_tpu.models import standard as jstandard
    x = _signal(2.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    g = eq.build_gain_per_bin(SR, N_FFT, np.array([50., 5000.], np.float32),
                              np.array([2., -2.], np.float32))
    kw = dict(pad_len=2048, frames_per_chunk=8)
    ra = eq.apply_gain_stream(ip, tmp_path / "a.wav", g, device="cpu", **kw)

    def float_sink(mod):
        def opener(out_path, sr, ch, *_):
            return (mod.AudioFile(str(out_path), "w", samplerate=sr,
                                  channels=ch, subtype="FLOAT"),
                    str(out_path), None, None, None)
        return opener

    monkeypatch.setattr(eq, "open_checkpointed_sink", float_sink(audio))
    monkeypatch.setattr(jstandard, "open_checkpointed_sink",
                        float_sink(jaudio))
    rb = eq.apply_gain_stream(ip, tmp_path / "b.wav", g, device="cpu", **kw)
    rj = jeq.apply_gain_stream(ip, tmp_path / "j.wav", g, **kw)
    assert (ra["transport"], rb["transport"]) == ("pcm24", "f32")
    assert rb["n_frames"] == rj["n_frames"]
    yb, _ = audio.read(tmp_path / "b.wav")
    yj, _ = audio.read(tmp_path / "j.wav")
    assert yb.shape == yj.shape
    assert np.abs(yb - yj).max() <= 1e-5
    np.testing.assert_allclose(rb["peak_seen"], rj["peak_seen"], rtol=1e-5)
    d = np.abs(_pcm(tmp_path / "a.wav") - _pcm(tmp_path / "b.wav"))
    assert d.max() <= 1
    np.testing.assert_allclose(ra["peak_seen"], rb["peak_seen"], rtol=1e-6)


def test_apply_eq_gain_protect_file(tmp_path):
    x = _signal(2.0, amp=0.5)    # silent edges: the peak is the interior's
    ip = tmp_path / "in.flac"
    audio.write(ip, x, SR, subtype="PCM_24")
    ecsv = _eq_csv(tmp_path / "eq.csv", boost=9.0)
    pj, pt = tmp_path / "j.flac", tmp_path / "t.flac"
    res_j = jeq.apply_eq(ip, pj, ecsv, frames_per_chunk=16)
    res_t = eq.apply_eq(ip, pt, ecsv, frames_per_chunk=16, device="cpu")
    assert res_j["peak_seen"] > 0.99
    np.testing.assert_allclose(res_t["peak_seen"], res_j["peak_seen"],
                               rtol=1e-5)
    assert res_t["gain_protected_path"] == str(tmp_path / "t_gp.flac")
    np.testing.assert_allclose(res_t["gain_protect_scale"],
                               res_j["gain_protect_scale"], rtol=1e-5)
    gj = _pcm(res_j["gain_protected_path"])
    gt = _pcm(res_t["gain_protected_path"])
    assert len(gt) == len(gj)
    # the main render saturates where it clips, on both sides alike; the
    # rescaled copy of it is within 4 LSB + the scale's 1e-5
    assert np.abs(gt - gj).max() <= 4 + 1e-5 * 8388608 * 0.99
    assert np.abs(gt).max() <= 0.99 * 8388608 + 1


@pytest.mark.parametrize("safe", [False, True])
def test_apply_residual_eq_matches_reference(tmp_path, safe):
    x = _signal(2.5, silent_edges=False)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    dcsv = _diff_csv(tmp_path / "diff.csv")
    pj, pt = tmp_path / "j.wav", tmp_path / "t.wav"
    res_j = jeq.apply_residual_eq(ip, pj, dcsv, safe=safe,
                                  frames_per_chunk=8)
    res_t = eq.apply_residual_eq(ip, pt, dcsv, safe=safe,
                                 frames_per_chunk=8, device="cpu")
    np.testing.assert_array_equal(res_t["eq_db"], res_j["eq_db"])
    vj, vt = _same_stream(pj, pt, res_j, res_t, edge=HOP)
    # no pad and signal up to both ends: z/win on the edge hops
    win = np.hanning(N_FFT)[:HOP]
    bound = 4 + 8388608 * 1e-7 / np.maximum(win, 1e-30)
    n = len(vt)
    for a, b, bd in ((vj[:HOP], vt[:HOP], bound),
                     (vj[n - HOP:], vt[n - HOP:], bound[::-1])):
        sat = (np.abs(a) >= 8388607) | (np.abs(b) >= 8388607)
        assert np.all(np.sign(a[sat]) == np.sign(b[sat]))
        assert np.all((np.abs(a - b) <= bd[:, None]) | sat)
    assert np.abs(vt[:HOP]).max() > 4e6      # the blow-up is really there
    assert res_t["peak_seen"] > 0 and res_j["peak_seen"] > 0


def test_apply_residual_eq_requires_stereo(tmp_path):
    ip = tmp_path / "m.wav"
    audio.write(ip, _signal(1.0)[:, :1], SR, subtype="PCM_24")
    with pytest.raises(ValueError, match="stereo"):
        eq.apply_residual_eq(ip, tmp_path / "o.wav",
                             _diff_csv(tmp_path / "d.csv"), device="cpu")


def test_apply_gain_stream_rate_check_and_empty(tmp_path):
    ip = tmp_path / "m.wav"
    audio.write(ip, _signal(1.0), 44100, subtype="PCM_24")
    g = np.ones(N_FFT // 2 + 1, np.float32)
    with pytest.raises(ValueError, match="48kHz"):
        eq.apply_gain_stream(ip, tmp_path / "o.wav", g, device="cpu")
    # shorter than one frame, no pad: no frame, an empty file
    tiny = tmp_path / "tiny.wav"
    audio.write(tiny, _signal(1.0)[:1000], SR, subtype="PCM_24")
    res = eq.apply_gain_stream(tiny, tmp_path / "e.wav", g, device="cpu")
    assert res["n_frames"] == 0 and res["peak_seen"] == 0.0
    assert audio.info(tmp_path / "e.wav").frames == 0


def test_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(1.0), SR, subtype="PCM_24")
    g = np.ones(N_FFT // 2 + 1, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        eq.apply_gain_stream(ip, tmp_path / "o.wav", g)
    with pytest.raises(RuntimeError, match="CUDA"):
        eq.apply_eq(ip, tmp_path / "o.wav", _eq_csv(tmp_path / "e.csv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        eq.apply_residual_eq(ip, tmp_path / "o.wav",
                             _diff_csv(tmp_path / "d.csv"))
    assert not os.path.exists(tmp_path / "o.wav")


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

class _Bomb(Exception):
    pass


def _arm(monkeypatch, after: int):
    calls = {"n": 0}
    orig_raw = standard._RawWav.write_raw

    def bomb(self, data):
        calls["n"] += 1
        if calls["n"] > after:
            raise _Bomb()
        return orig_raw(self, data)
    monkeypatch.setattr(standard._RawWav, "write_raw", bomb)
    return calls


@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_resume_after_interrupt(tmp_path, monkeypatch, ext):
    """Interrupt the stream after 5 chunks, rerun the same call: bytes
    equal an uninterrupted run's, peak_seen too, nothing left behind."""
    x = _signal(5.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    ecsv = _eq_csv(tmp_path / "eq.csv")
    ref = tmp_path / f"ref.{ext}"
    res_ref = eq.apply_eq(ip, ref, ecsv, frames_per_chunk=8, device="cpu")
    out = tmp_path / f"out.{ext}"
    ck = tmp_path / "ck.npz"
    kw = dict(frames_per_chunk=8, checkpoint_path=ck, checkpoint_every=2,
              device="cpu")
    with monkeypatch.context() as m:
        calls = _arm(m, 5)
        with pytest.raises(_Bomb):
            eq.apply_eq(ip, out, ecsv, **kw)
        assert calls["n"] > 5
    assert ck.exists()
    res = eq.apply_eq(ip, out, ecsv, **kw)
    assert not ck.exists()
    assert not os.path.exists(str(out) + ".part.wav")
    assert open(out, "rb").read() == open(ref, "rb").read()
    assert res["peak_seen"] == res_ref["peak_seen"]
    assert res["n_frames"] == res_ref["n_frames"]


def test_checkpoint_has_the_reference_keys(tmp_path, monkeypatch):
    """An eq_gain_stream checkpoint of the port against one the JAX
    package writes for the same call: the same array keys, scalars and
    fingerprint (so either names the same run)."""
    x = _signal(5.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    g = jeq.build_gain_per_bin(SR, N_FFT, np.array([50., 5000.], np.float32),
                               np.array([2., -2.], np.float32))
    metas = {}
    for name, mod, raw_cls, kw in (
            ("torch", eq, standard._RawWav, dict(device="cpu")),
            ("jax", jeq, __import__("tomatis_tpu.models.standard",
                                    fromlist=["_RawWav"])._RawWav, {})):
        ck = tmp_path / f"{name}.npz"
        calls = {"n": 0}
        orig = raw_cls.write_raw

        def bomb(self, data, _orig=orig, _calls=calls):
            _calls["n"] += 1
            if _calls["n"] > 5:
                raise _Bomb()
            return _orig(self, data)
        with monkeypatch.context() as m:
            m.setattr(raw_cls, "write_raw", bomb)
            with pytest.raises(_Bomb):
                mod.apply_gain_stream(ip, tmp_path / "o.wav", g,
                                      pad_len=2048, frames_per_chunk=8,
                                      checkpoint_path=ck, checkpoint_every=2,
                                      **kw)
        with np.load(ck, allow_pickle=False) as z:
            import json
            metas[name] = (sorted(z.files), json.loads(str(z["meta"])),
                           {k: z[k] for k in ("out_tail", "w_tail")})
        os.remove(tmp_path / "o.wav")
    files_t, meta_t, arr_t = metas["torch"]
    files_j, meta_j, arr_j = metas["jax"]
    assert files_t == files_j
    assert meta_t["config"] == meta_j["config"]
    assert set(meta_t["scalars"]) == set(meta_j["scalars"])
    assert meta_t["scalars"]["next_f0"] == meta_j["scalars"]["next_f0"]
    assert (meta_t["scalars"]["audio_samples_written"]
            == meta_j["scalars"]["audio_samples_written"])
    for k in arr_t:
        assert arr_t[k].shape == arr_j[k].shape
        assert arr_t[k].dtype == arr_j[k].dtype
        np.testing.assert_allclose(arr_t[k], arr_j[k], atol=1e-5)


def test_changed_curve_refuses_the_checkpoint(tmp_path, monkeypatch):
    x = _signal(5.0)
    ip = tmp_path / "in.wav"
    audio.write(ip, x, SR, subtype="PCM_24")
    ck = tmp_path / "ck.npz"
    out = tmp_path / "o.wav"
    with monkeypatch.context() as m:
        _arm(m, 5)
        with pytest.raises(_Bomb):
            eq.apply_eq(ip, out, _eq_csv(tmp_path / "a.csv"),
                        frames_per_chunk=8, checkpoint_path=ck,
                        checkpoint_every=2, device="cpu")
    with pytest.raises(ValueError, match="different parameters"):
        eq.apply_eq(ip, out, _eq_csv(tmp_path / "b.csv", boost=1.0),
                    frames_per_chunk=8, checkpoint_path=ck,
                    checkpoint_every=2, device="cpu")
