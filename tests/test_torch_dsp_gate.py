"""Port's DSP, STFT and gate primitives vs the JAX package's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomatis_tpu.ops import dsp as jdsp, gate as jgate, stft as jstft
from tomatis_tpu_torch.ops import dsp, gate, stft

torch.set_num_threads(2)


def test_frame_levels_dbfs_matches_jax():
    rng = np.random.default_rng(0)
    scale = np.array([1e-6, 1e-3, 0.05, 0.5], np.float32)[:, None, None]
    frames = (rng.standard_normal((4, 512, 2)) * scale).astype(np.float32)
    ref = np.asarray(jdsp.frame_levels_dbfs(jnp.asarray(frames)))
    got = dsp.frame_levels_dbfs(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)
    zeros = dsp.frame_levels_dbfs(torch.zeros((2, 64, 2))).numpy()
    np.testing.assert_allclose(zeros, np.asarray(jdsp.frame_levels_dbfs(
        jnp.zeros((2, 64, 2)))), atol=1e-4)


def test_rms_and_power_mono_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 256, 2)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        dsp.rms_dbfs(dsp.power_mono(torch.from_numpy(x))).numpy(),
        np.asarray(jdsp.rms_dbfs(jdsp.power_mono(jnp.asarray(x)))),
        atol=1e-4)


@pytest.mark.parametrize("lo,hi", [(15.0, -15.0), (-15.0, 15.0),
                                   (5.0, 5.0), (0.0, -7.5)])
def test_tilt_gain_numpy_branch_exact(lo, hi):
    freqs = jstft.rfft_freqs(4096, 48000)
    ref = jdsp.build_tilt_gain_db(freqs, 1000.0, 12.0, lo, hi)
    got = dsp.build_tilt_gain_db(freqs, 1000.0, 12.0, lo, hi)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # the tensor branch agrees with the numpy branch
    t = dsp.build_tilt_gain_db(torch.from_numpy(freqs), 1000.0, 12.0, lo, hi)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), ref, atol=1e-5)


def test_db_to_lin_and_gate_maps():
    db = np.linspace(-20, 20, 41).astype(np.float32)
    np.testing.assert_allclose(dsp.db_to_lin(db).numpy(),
                               np.asarray(jdsp.db_to_lin(db)), rtol=1e-6)
    assert dsp.db_to_lin(db).dtype == torch.float32
    assert dsp.gate_ui_to_dbfs_log_percent(50.0) == \
        jdsp.gate_ui_to_dbfs_log_percent(50.0)
    assert dsp.gate_ui_to_dbfs(40.0, 0.5, -70) == \
        jdsp.gate_ui_to_dbfs(40.0, 0.5, -70)
    assert dsp.tilt_platform_freqs(1000, 12, 15, -15) == \
        jdsp.tilt_platform_freqs(1000, 12, 15, -15)


def test_hann_windows():
    np.testing.assert_array_equal(stft.hann_symmetric(64),
                                  jstft.hann_symmetric(64))
    np.testing.assert_array_equal(stft.hann_periodic(64),
                                  jstft.hann_periodic(64))
    # the processors' window is symmetric, unlike torch's default
    assert not np.allclose(stft.hann_symmetric(64),
                           torch.hann_window(64).numpy())


def _levels(F, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-60, -20, F).astype(np.float32)


@pytest.mark.parametrize("F,D,init,n_valid", [
    (257, 6, None, 257),
    (100, 6, 3, 100),       # carried-in state mid run count
    (64, 6, 7, 40),         # carried-in C2, trailing invalid frames
    (33, 0, 1, 20),         # no up delay
    (1, 4, 2, 1),
])
def test_gate_updelay_matches_jax(F, D, init, n_valid):
    levels = _levels(F, F + D)
    ton, toff = np.float32(-38.5), np.float32(-41.5)
    valid = np.arange(F) < n_valid
    j_init = None if init is None else jnp.int32(init)
    js, jf = jgate.gate_updelay(jnp.asarray(levels), jnp.float32(ton),
                                jnp.float32(toff), D, init_state=j_init,
                                valid=jnp.asarray(valid))
    ts, tf = gate.gate_updelay(
        torch.from_numpy(levels), torch.tensor(ton), torch.tensor(toff), D,
        init_state=None if init is None else torch.tensor(init,
                                                          dtype=torch.int32),
        valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # invalid trailing frames are identity: the carry is the last valid one
    assert int(tf[-1]) == int(tf[n_valid - 1])
    # and the sequential scans agree on the valid prefix
    ss, sseq = jgate.gate_updelay_scan(jnp.asarray(levels[:n_valid]),
                                       jnp.float32(ton), jnp.float32(toff),
                                       D, init_state=j_init)
    ps, pseq = gate.gate_updelay_scan(torch.from_numpy(levels[:n_valid]),
                                      ton, toff, D, init_state=init)
    np.testing.assert_array_equal(ts.numpy()[:n_valid], np.asarray(ss))
    np.testing.assert_array_equal(tf.numpy()[:n_valid], np.asarray(sseq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(ss))
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(sseq))


def test_updelay_frames_matches_jax():
    for samples, hop in [(12000, 2048), (0, 512), (4096, 2048), (1, 7)]:
        assert gate.updelay_frames(samples, hop) == \
            jgate.updelay_frames(samples, hop)


@pytest.mark.parametrize("n_fft,hop", [(256, 128), (512, 128), (300, 100)])
def test_frame_signal_matches_jax(n_fft, hop):
    rng = np.random.default_rng(n_fft)
    F = 9
    x = rng.standard_normal(((F - 1) * hop + n_fft + 17, 2)).astype(np.float32)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(x), n_fft, hop, F))
    got = stft.frame_signal(torch.from_numpy(x), n_fft, hop, F).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    lv_ref = np.asarray(jstft.frame_levels_chunk(jnp.asarray(x), n_fft, hop,
                                                 F))
    lv = stft.frame_levels_chunk(torch.from_numpy(x), n_fft, hop, F).numpy()
    np.testing.assert_allclose(lv, lv_ref, atol=1e-4)


@pytest.mark.parametrize("per_frame", [True, False])
def test_apply_gain_bank_matches_jax(per_frame):
    rng = np.random.default_rng(3)
    F, C, n_fft = 6, 2, 512
    frames = rng.standard_normal((F, C, n_fft)).astype(np.float32)
    win = jstft.hann_symmetric(n_fft)
    shape = (F, n_fft // 2 + 1) if per_frame else (n_fft // 2 + 1,)
    gains = rng.uniform(0.1, 5.0, shape).astype(np.float32)
    ref = np.asarray(jstft.apply_gain_bank(jnp.asarray(frames),
                                           jnp.asarray(win),
                                           jnp.asarray(gains)))
    got = stft.apply_gain_bank(torch.from_numpy(frames),
                               torch.from_numpy(win),
                               torch.from_numpy(gains))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_num_frames_and_pad_end():
    for n in (0, 100, 4096, 4097, 48000, 123457):
        assert stft.num_frames(n, 4096, 2048) == jstft.num_frames(n, 4096,
                                                                  2048)
        assert stft.pad_end(n, 4096, 1024) == jstft.pad_end(n, 4096, 1024)
