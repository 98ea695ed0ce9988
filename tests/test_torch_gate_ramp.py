"""The port's min-hold gate, alpha ramp, tilt index and the crossfade,
alpha-track and static controllers against the JAX package's, on CPU.

Inputs come from a numpy seed and go through both packages. The gates
compose integer tables, so states and carries are compared for equality.
The alpha ramp is a float scan: jax.lax.associative_scan and the port's
log-step doubling compose the +-step sums in different tree orders, so
mid-ramp values are held to 1e-6 and saturated values to exactly 0 and 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomatis_tpu.models import controllers as jctl
from tomatis_tpu.ops import dsp as jdsp
from tomatis_tpu.ops import gate as jgate
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.models import controllers as ctl
from tomatis_tpu_torch.ops import dsp, gate

torch.set_num_threads(2)

TON, TOFF = np.float32(-38.5), np.float32(-41.5)


def _levels(F, seed):
    """Levels hovering around the thresholds, with runs on either side."""
    rng = np.random.default_rng(seed)
    base = np.repeat(rng.choice([-50.0, -40.0, -30.0], size=F // 4 + 1), 4)[:F]
    return (base + rng.normal(0, 1.5, F)).astype(np.float32)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("H", [0, 1, 5])
@pytest.mark.parametrize("F,n_valid,init", [
    (64, 64, None), (57, 40, None), (64, 64, 3), (1, 1, None), (33, 20, 0)])
def test_gate_minhold_matches_jax(H, F, n_valid, init):
    if init is not None:
        init = min(init, 2 * (H + 1) - 1)
    levels = _levels(F, 100 * H + F)
    valid = np.arange(F) < n_valid
    j_init = None if init is None else jnp.int32(init)
    js, jf = jgate.gate_minhold(jnp.asarray(levels), jnp.float32(TON),
                                jnp.float32(TOFF), H, init_state=j_init,
                                valid=jnp.asarray(valid))
    ts, tf = gate.gate_minhold(
        _t(levels), _t(TON), _t(TOFF), H,
        init_state=None if init is None else _t(init, torch.int32),
        valid=_t(valid))
    assert ts.dtype == tf.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tf[-1]) == int(tf[n_valid - 1])   # invalid frames: identity
    # the sequential forms of both packages agree on the valid prefix
    ss, sseq = jgate.gate_minhold_scan(jnp.asarray(levels[:n_valid]),
                                       jnp.float32(TON), jnp.float32(TOFF),
                                       H, init_state=j_init)
    ps, pseq = gate.gate_minhold_scan(_t(levels[:n_valid]), TON, TOFF, H,
                                      init_state=init)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(ss))
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(sseq))
    np.testing.assert_array_equal(ts.numpy()[:n_valid], ps.numpy())
    np.testing.assert_array_equal(tf.numpy()[:n_valid], pseq.numpy())


@pytest.mark.parametrize("H", [0, 1, 5])
def test_gate_minhold_chunk_split_hands_over_carry(H):
    levels = _levels(96, 7 + H)
    whole_s, whole_f = gate.gate_minhold(_t(levels), _t(TON), _t(TOFF), H)
    a_s, a_f = gate.gate_minhold(_t(levels[:41]), _t(TON), _t(TOFF), H)
    b_s, b_f = gate.gate_minhold(_t(levels[41:]), _t(TON), _t(TOFF), H,
                                 init_state=a_f[-1])
    assert torch.equal(torch.cat([a_s, b_s]), whole_s)
    assert torch.equal(torch.cat([a_f, b_f]), whole_f)
    assert len(set(whole_s.tolist())) == 2     # the gate did switch
    # a switch is held for at least H frames
    runs = gate.state_run_stats(whole_s)["run_lengths"]
    assert np.all(runs[1:-1] >= max(H, 1))


def test_minhold_tables_width_and_initial_carry():
    """S = 2*(H+1), not D+2; the default carry is H (switch at once)."""
    H = 5
    levels = _t(np.array([-30.0, -30.0, -50.0], np.float32))
    tables = gate.minhold_tables(levels, _t(TON), _t(TOFF), H)
    assert tables.shape == (3, 2 * (H + 1))
    states, final = gate.gate_minhold(levels, _t(TON), _t(TOFF), H)
    assert states.tolist() == [2, 2, 2] and final.tolist() == [6, 7, 8]
    states0, _ = gate.gate_minhold(levels, _t(TON), _t(TOFF), H,
                                   init_state=0)
    assert states0.tolist() == [1, 1, 1]


def _targets(F, seed):
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 2, F // 5 + 1), 5)[:F].astype(np.float32)


def _assert_alpha(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    sat = (ref == 0.0) | (ref == 1.0)
    np.testing.assert_array_equal(got[sat], ref[sat])


@pytest.mark.parametrize("step", [1.0, 0.2, 1.0 / 3.0, 1.0 / 7.0, 0.0625])
@pytest.mark.parametrize("F,n_valid,alpha0", [
    (80, 80, 0.0), (64, 50, 0.4), (1, 1, 1.0), (37, 37, 0.999)])
def test_alpha_ramp_matches_jax(step, F, n_valid, alpha0):
    tg = _targets(F, int(step * 1000) + F)
    valid = np.arange(F) < n_valid
    ref = jgate.alpha_ramp(jnp.asarray(tg), jnp.float32(step),
                           jnp.float32(alpha0), valid=jnp.asarray(valid))
    got = gate.alpha_ramp(_t(tg), _t(np.float32(step)),
                          _t(np.float32(alpha0)), valid=_t(valid))
    _assert_alpha(got.numpy(), ref)
    assert float(got[-1]) == float(got[n_valid - 1])
    # against the plain loop
    cur, loop = np.float32(alpha0), []
    for t in tg[:n_valid]:
        d = t - cur
        cur = np.float32(t) if abs(d) <= step else \
            np.float32(cur + np.float32(step) * np.sign(d))
        loop.append(cur)
    np.testing.assert_allclose(got.numpy()[:n_valid], loop, atol=1e-6)


def test_alpha_ramp_split_across_chunks():
    tg = _targets(120, 5)
    step = np.float32(1.0 / 6.0)
    whole = gate.alpha_ramp(_t(tg), step, 0.0)
    a = gate.alpha_ramp(_t(tg[:47]), step, 0.0)
    b = gate.alpha_ramp(_t(tg[47:]), step, a[-1])
    ref = jgate.alpha_ramp(jnp.asarray(tg), jnp.float32(step),
                           jnp.float32(0.0))
    _assert_alpha(torch.cat([a, b]).numpy(), ref)
    _assert_alpha(whole.numpy(), ref)
    assert np.any((whole.numpy() > 0) & (whole.numpy() < 1))
    assert np.all(np.isfinite(whole.numpy()))


def test_alpha_ramp_snap_first_matches_jax():
    for F in (1, 2, 31):
        tg = _targets(F, F)[::-1].copy()
        ref = jgate.alpha_ramp_snap_first(jnp.asarray(tg), 0.25)
        got = gate.alpha_ramp_snap_first(_t(tg), 0.25)
        _assert_alpha(got.numpy(), ref)
        assert float(got[0]) == float(tg[0])


def test_state_run_stats_matches_jax():
    for states in ([], [1], [1, 1, 2, 2, 2, 1, 2]):
        a = gate.state_run_stats(_t(np.array(states, np.int32)))
        b = jgate.state_run_stats(np.array(states, np.int32))
        assert a["c2_ratio"] == b["c2_ratio"]
        assert a["switch_count"] == b["switch_count"]
        np.testing.assert_array_equal(a["run_lengths"], b["run_lengths"])


def test_tilt_index_db_matches_jax():
    rng = np.random.default_rng(9)
    freqs = np.fft.rfftfreq(1024, 1 / 48000).astype(np.float32)
    spec = rng.uniform(0.0, 2.0, (3, len(freqs))).astype(np.float32)
    ref = np.asarray(jdsp.tilt_index_db(jnp.asarray(spec), freqs))
    got = dsp.tilt_index_db(_t(spec), freqs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


BINS = 129


def _curves(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-15, 15, BINS).astype(np.float32),
            rng.uniform(-15, 15, BINS).astype(np.float32))


def _np_params(c):
    return [np.asarray(v) for v in c.params()]


@pytest.mark.parametrize("xfade_frames,n_valid", [(1, 48), (5, 48), (9, 30)])
def test_xfade_controller_step_matches_jax(xfade_frames, n_valid):
    g1, g2 = _curves(xfade_frames)
    jc = jctl.GateXfadeController(g1, g2, float(TON), float(TOFF), 2,
                                  xfade_frames)
    tc = convert.xfade_controller_from_reference(
        *_np_params(jc), jc.delay_frames, device="cpu")
    assert tc.LOG_KEYS == jc.LOG_KEYS == ("states", "alpha")
    assert float(tc.alpha_step) == float(np.float32(jc.alpha_step))
    own = ctl.GateXfadeController(g1, g2, float(TON), float(TOFF), 2,
                                  xfade_frames)
    assert float(own.alpha_step) == float(tc.alpha_step)
    F = 48
    valid = np.arange(F) < n_valid
    jcarry, tcarry = jc.init_carry(), tc.init_carry()
    assert tcarry[0].dtype == torch.int32 and tcarry[1].dtype == torch.float32
    seen_mid = False
    for k in range(3):      # three chunks, the carry handed over
        levels = _levels(F, 31 * k + xfade_frames)
        jg, jlog, jcarry = jc.step(jnp.asarray(levels), jnp.asarray(valid),
                                   jcarry, jc.params())
        tg, tlog, tcarry = tc.step(_t(levels), _t(valid), tcarry,
                                   tc.params())
        assert tg.dtype == torch.float32 and tg.shape == (F, BINS)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        np.testing.assert_array_equal(tlog["states"].numpy(),
                                      np.asarray(jlog["states"]))
        _assert_alpha(tlog["alpha"].numpy(), jlog["alpha"])
        assert int(tcarry[0]) == int(jcarry[0])
        assert abs(float(tcarry[1]) - float(jcarry[1])) <= 1e-6
        a = tlog["alpha"].numpy()
        seen_mid |= bool(np.any((a > 0) & (a < 1)))
    assert seen_mid == (xfade_frames > 1)


def test_alpha_gain_controller_step_matches_jax():
    g1, g2 = _curves(3)
    rng = np.random.default_rng(4)
    F, total = 16, 40           # the last chunk is partial: 16, 16, 8
    alphas = rng.uniform(0, 1, total).astype(np.float32)
    jc = jctl.AlphaGainController(g1, g2, alphas)
    tc = ctl.AlphaGainController(g1, g2, alphas)
    jcarry, tcarry = jc.init_carry(), tc.init_carry()
    levels = np.zeros(F, np.float32)
    valid = np.ones(F, bool)
    for _ in range(3):
        jg, jlog, jcarry = jc.step(jnp.asarray(levels), jnp.asarray(valid),
                                   jcarry, jc.params())
        tg, tlog, tcarry = tc.step(_t(levels), _t(valid), tcarry,
                                   tc.params())
        # the window past the end of the track is clamped, as dynamic_slice
        np.testing.assert_array_equal(tlog["alpha"].numpy(),
                                      np.asarray(jlog["alpha"]))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        assert int(tcarry) == int(jcarry)
    assert tcarry.dtype == torch.int32 and int(tcarry) == 3 * F
    short = ctl.AlphaGainController(g1, g2, alphas[:5])
    with pytest.raises(ValueError, match="shorter than a chunk"):
        short.step(_t(levels), _t(valid), short.init_carry(), short.params())


def test_static_gain_controller_step_matches_jax():
    gain = np.random.default_rng(6).uniform(0.1, 4, BINS).astype(np.float32)
    jc, tc = jctl.StaticGainController(gain), ctl.StaticGainController(gain)
    F = 12
    levels, valid = np.zeros(F, np.float32), np.ones(F, bool)
    jg, jlog, jcarry = jc.step(jnp.asarray(levels), jnp.asarray(valid),
                               jc.init_carry(), jc.params())
    tg, tlog, tcarry = tc.step(_t(levels), _t(valid), tc.init_carry(),
                               tc.params())
    assert tc.LOG_KEYS == jc.LOG_KEYS == () and tlog == jlog == {}
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(tcarry) == int(jcarry) == 0
