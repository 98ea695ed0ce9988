"""The port's sharded processor (tomatis_tpu_torch/parallel/sharded.py,
parallel/stream.py, cli/process_sharded.py) on meshes of CPU devices
([cpu]*n, the counterpart of the 8 virtual XLA devices of
tests/conftest.py), against the port's unsharded scans and single-device
processors and against the JAX package's sharded code on those 8 devices.

Tolerances: gate states and carries exact (integer table composition);
the alpha ramp within 1 ulp of 1.0 (RAMP_ULP: the clip-affine maps
compose in another tree order); sharded_process_step's emit within 1e-5
of JAX's where two frames cover a sample, and within 1e-5 + 1e-6/win[k]
where one frame alone does (the stream's first hop and the hop after the
last valid frame: an FFT rounding e comes out as e/win[k] there;
ROADMAP.md §3); process_sharded's standard PCM and state
CSV equal to the port's single-device `process`, and within 4 PCM_24 LSB
of JAX's process_sharded (the standing FFT difference of ROADMAP.md §3);
xfade and adaptive within 1 LSB of the port's single-device runs on under
1% of samples; resumed runs equal to uninterrupted ones byte for byte.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tomatis_tpu.parallel import sharded as jsh
from tomatis_tpu.parallel import stream as jstream
from tomatis_tpu.models import standard as jstd
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.cli import process_sharded as ps
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import adaptive, standard, xfade
from tomatis_tpu_torch.ops import dsp, gate, stft
from tomatis_tpu_torch.parallel import sharded, stream
from tomatis_tpu_torch.parallel.stream import (process_sharded,
                                               process_sharded_adaptive)

torch.set_num_threads(2)

SR = 48000
N_FFT, HOP = 1024, 512
TON, TOFF = -38.5, -41.5
DELAY = 2
LSB = 4
RAMP_ULP = float(np.spacing(np.float32(1.0)))
CPU8 = ["cpu"] * 8


def _cpu(n):
    return [torch.device("cpu")] * n


# ---------------------------------------------------------------------------
# the block-composed scans
# ---------------------------------------------------------------------------

def _levels(F, seed):
    """Levels that cross the hysteresis band in runs, with a tail of
    invalid frames."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.choice([-50.0, -30.0], size=F),
                     rng.integers(2, 9, size=F))[:F]
    lv = (runs + rng.normal(0, 2, F)).astype(np.float32)
    valid = np.arange(F) < F - 5
    return lv, valid


def _jax_scan(kind, n, lv, valid, s0, **kw):
    """JAX's _sharded_* inside its shard_map over n of the 8 devices."""
    mesh = jsh.make_mesh(devices=jax.devices()[:n], data=1)
    if kind == "updelay":
        def fn(x, v, s):
            return jsh._sharded_gate_updelay(x, TON, TOFF, kw["D"], s, v)
    elif kind == "minhold":
        def fn(x, v, s):
            return jsh._sharded_gate_minhold(x, TON, TOFF, kw["H"], s, v)
    else:
        def fn(x, v, s):
            return jsh._sharded_alpha_ramp(x, jnp.float32(kw["step"]), s, v)
    sm = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("seq"), P("seq"), P()),
                           out_specs=(P("seq"), P()), check_vma=False))
    a, b = sm(jnp.asarray(lv), jnp.asarray(valid), s0)
    return np.asarray(a), np.asarray(b)


def _split(x, n, dtype=None):
    t = torch.from_numpy(np.asarray(x) if dtype is None
                         else np.asarray(x, dtype))
    return list(t.chunk(n))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_gate_updelay_equals_unsharded_and_jax(n):
    F, D = 24 * n, 3
    lv, valid = _levels(F, seed=n)
    s0 = 1
    states, carry = sharded._sharded_gate_updelay(
        _split(lv, n), TON, TOFF, D, torch.tensor(s0, dtype=torch.int32),
        _split(valid, n))
    ref_states, seq = gate.gate_updelay(
        torch.from_numpy(lv), TON, TOFF, D, init_state=s0,
        valid=torch.from_numpy(valid))
    got = torch.cat(states)
    assert torch.equal(got, ref_states) and int(carry) == int(seq[-1])
    j_states, j_carry = _jax_scan("updelay", n, lv, valid,
                                  jnp.int32(s0), D=D)
    np.testing.assert_array_equal(got.numpy(), j_states)
    assert int(carry) == int(j_carry)
    assert set(got.tolist()) == {1, 2}


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_gate_minhold_equals_unsharded_and_jax(n):
    F, H = 22 * n, 4
    lv, valid = _levels(F, seed=10 + n)
    s0 = H                       # the stream start: may switch at once
    states, carry = sharded._sharded_gate_minhold(
        _split(lv, n), TON, TOFF, H, torch.tensor(s0, dtype=torch.int32),
        _split(valid, n))
    ref_states, seq = gate.gate_minhold(
        torch.from_numpy(lv), TON, TOFF, H, init_state=s0,
        valid=torch.from_numpy(valid))
    got = torch.cat(states)
    assert torch.equal(got, ref_states) and int(carry) == int(seq[-1])
    j_states, j_carry = _jax_scan("minhold", n, lv, valid,
                                  jnp.int32(s0), H=H)
    np.testing.assert_array_equal(got.numpy(), j_states)
    assert int(carry) == int(j_carry)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_alpha_ramp_within_an_ulp_of_unsharded_and_jax(n):
    F, step, alpha0 = 26 * n, 1.0 / 3.0, 0.3
    lv, valid = _levels(F, seed=20 + n)
    targets = (lv > -40).astype(np.float32)
    alphas, final = sharded._sharded_alpha_ramp(
        _split(targets, n), step, torch.tensor(alpha0), _split(valid, n))
    got = torch.cat(alphas).numpy()
    ref = gate.alpha_ramp(torch.from_numpy(targets), step, alpha0,
                          valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RAMP_ULP)
    assert abs(float(final) - float(ref[-1])) <= RAMP_ULP
    j_alpha, j_final = _jax_scan("ramp", n, targets, valid,
                                 jnp.float32(alpha0), step=step)
    np.testing.assert_allclose(got, j_alpha, rtol=0, atol=RAMP_ULP)
    assert abs(float(final) - float(j_final)) <= RAMP_ULP
    assert np.any((got > 0) & (got < 1)) and np.any(got == 1.0)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _batch(B=4, frames=64, seed=0):
    rng = np.random.default_rng(seed)
    n = (frames - 1) * HOP + N_FFT
    t = np.arange(n) / SR
    sigs = []
    for b in range(B):
        env = np.where(np.sin(2 * np.pi * (0.5 + 0.3 * b) * t + b) > 0,
                       0.3, 0.004)
        x = env * np.sin(2 * np.pi * (400 + 100 * b) * t)
        x = x + 1e-3 * rng.standard_normal(n)
        sigs.append(np.stack([x, 0.9 * x], 1).astype(np.float32))
    return np.stack(sigs)


def _gains():
    freqs = stft.rfft_freqs(N_FFT, SR)
    return [dsp.db_to_lin(dsp.build_tilt_gain_db(
        freqs, 1000., 12., lo, -lo)).numpy() for lo in (15., -15.)]


def _edge_bound(F, n_valid):
    """1e-5, plus 1e-6/win[k] where one frame alone covers a sample: the
    stream's first hop and the hop after its last valid frame, where the
    output is z*win[k]/win[k]**2 (w = win[k]**2 there). The frames of
    _batch reach 1.7 after the +15 dB gain: 1e-6 is 2e-7 at that scale."""
    win2 = torch.from_numpy(stft.hann_symmetric(N_FFT)) ** 2
    mask = (torch.arange(F) < n_valid).to(torch.float32)
    w = stft.overlap_add(win2[None, None, :] * mask[:, None, None],
                         HOP)[:F * HOP, 0].double().numpy()
    return (1e-5 + 1e-6 / np.sqrt(np.maximum(w, 1e-60)))[:, None]


def test_sharded_process_step_matches_jax_on_a_2x4_mesh():
    mesh = sharded.make_mesh(data=2, devices=CPU8)
    assert mesh.shape == {"data": 2, "seq": 4}
    B, F = 4, 64
    F_loc = F // 4
    sigs = _batch(B, F)
    g1, g2 = _gains()
    step = sharded.sharded_process_step(mesh, N_FFT, HOP, F_loc, 2, TON,
                                        TOFF, DELAY, g1, g2)
    s0 = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    n_valid = torch.tensor([F, F, F - 9, F - 30], dtype=torch.int32)
    emit, states, carry = step(sharded.frame_batch(sigs, N_FFT, HOP, F),
                               s0, n_valid)
    jstep = jsh.sharded_process_step(jsh.make_mesh(8, data=2), N_FFT, HOP,
                                     F_loc, 2, TON, TOFF, DELAY, g1, g2)
    j_emit, j_states, j_carry = jstep(
        jsh.frame_batch(sigs, N_FFT, HOP, F), jnp.asarray(s0.numpy()),
        jnp.asarray(n_valid.numpy()))
    np.testing.assert_array_equal(states.numpy(), np.asarray(j_states))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(j_carry))
    d = np.abs(emit.numpy() - np.asarray(j_emit))
    for b in range(B):
        assert np.all(d[b] <= _edge_bound(F, int(n_valid[b]))), b
    assert emit.shape == (B, F * HOP, 2)
    assert set(np.unique(states.numpy())) == {1, 2}


def test_sharded_step_equals_one_shard_step():
    """The halo and the scans: 8 shards give one shard's emit, states and
    carry (K = 2: every output sample is the same sums)."""
    B, F = 1, 64
    sigs = _batch(B, F, seed=3)
    g1, g2 = _gains()
    frames = sharded.frame_batch(sigs, N_FFT, HOP, F)
    outs = []
    for n in (1, 8):
        mesh = sharded.make_mesh(devices=_cpu(n), data=1)
        step = sharded.sharded_process_step(mesh, N_FFT, HOP, F // n, 2, TON,
                                            TOFF, DELAY, g1, g2)
        outs.append(step(frames, torch.zeros(1, dtype=torch.int32),
                         torch.full((1,), F, dtype=torch.int32)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_halo_receives_zeros_plus_carry_and_aliases_nothing():
    rng = np.random.default_rng(4)
    F_loc, C, n = 3, 2, 2
    tail = N_FFT - HOP
    ys = [torch.from_numpy(rng.standard_normal((F_loc, C, N_FFT))
                           .astype(np.float32)) for _ in range(n)]
    masks = [torch.ones(F_loc), torch.ones(F_loc)]
    win2 = torch.from_numpy(stft.hann_symmetric(N_FFT)) ** 2
    in_ty = torch.from_numpy(rng.standard_normal((tail, C))
                             .astype(np.float32))
    in_tw = torch.from_numpy(rng.uniform(0.2, 1, tail).astype(np.float32))
    keep = [t.clone() for t in ys + [in_ty, in_tw]]
    out = sharded._ola_halo_emit(ys, win2, masks, HOP, F_loc, in_ty, in_tw)
    ola = [stft.overlap_add(y, HOP) for y in ys]
    w = stft.window_ola(win2, F_loc, HOP)
    # shard 0 received zeros plus the carried tails
    ref0 = (ola[0][:F_loc * HOP].clone(), w[:F_loc * HOP].clone())
    ref0[0][:tail] += in_ty
    ref0[1][:tail] += in_tw
    assert torch.equal(out[0][0], ref0[0] / (ref0[1][:, None] + 1e-12))
    # shard 1 received shard 0's raw tail, and nothing of the carry
    ref1 = (ola[1][:F_loc * HOP].clone(), w[:F_loc * HOP].clone())
    ref1[0][:tail] += ola[0][F_loc * HOP:]
    ref1[1][:tail] += w[F_loc * HOP:]
    assert torch.equal(out[1][0], ref1[0] / (ref1[1][:, None] + 1e-12))
    # each shard's returned tails are its own raw sums
    for i in range(n):
        assert torch.equal(out[i][1], ola[i][F_loc * HOP:])
        assert torch.equal(out[i][2], w[F_loc * HOP:])
    # the inputs are untouched, and no two outputs share storage with each
    # other or with an input, though every shard sits on the one device
    for a, b in zip(keep, ys + [in_ty, in_tw]):
        assert torch.equal(a, b)
    ptrs = [t.untyped_storage().data_ptr() for o in out for t in o]
    ptrs_out = {t.untyped_storage().data_ptr() for o in out for t in o[:1]}
    assert len(ptrs_out) == n
    assert not set(ptrs) & {t.untyped_storage().data_ptr()
                            for t in ys + [in_ty, in_tw]}


def test_mesh_without_a_card_raises_and_factors():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh(n_devices=2)
    assert sharded.make_mesh(devices=_cpu(6)).shape == {"data": 2, "seq": 3}
    assert sharded.make_mesh(devices=_cpu(3)).shape == {"data": 1, "seq": 3}
    with pytest.raises(ValueError, match="factor"):
        sharded.make_mesh(devices=_cpu(3), data=2)
    with pytest.raises(ValueError, match="empty"):
        sharded.make_mesh(devices=[])


def test_sharded_rejects_undersized_shards():
    with pytest.raises(ValueError, match="frames_per_shard"):
        sharded.check_halo_span(n_fft=4096, hop=512, frames_per_shard=4)
    sharded.check_halo_span(n_fft=4096, hop=512, frames_per_shard=7)
    mesh = sharded.make_mesh(devices=_cpu(2), data=1)
    for make in (sharded.sharded_stream_step,
                 sharded.sharded_process_step):
        with pytest.raises(ValueError, match="frames_per_shard"):
            make(mesh, 4096, 512, 4, 2, ton=-40.0, toff=-43.0,
                 delay_frames=0, g1_lin=np.ones(2049, np.float32),
                 g2_lin=np.ones(2049, np.float32))
    with pytest.raises(ValueError, match="frames_per_shard"):
        sharded.sharded_adaptive_stream_step(
            mesh, 4096, 512, 4, 2, -40.0, -43.0, 3, 0.2,
            np.zeros(2049, np.float32), np.zeros(2049, np.float32))


# ---------------------------------------------------------------------------
# the file driver
# ---------------------------------------------------------------------------

def _file(tmp_path, seconds, seed, f1, f2, rate, name="in.wav"):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    env = 0.002 + 0.06 * (np.sin(2 * np.pi * rate * t) > 0)
    x = env * (np.sin(2 * np.pi * f1 * t) + 0.4 * np.sin(2 * np.pi * f2 * t)
               + 0.02 * rng.standard_normal(t.size))
    ip = tmp_path / name
    audio.write(ip, np.stack([x, 0.9 * x], 1).astype(np.float32), SR,
                subtype="PCM_24")
    return ip


def _pcm(path):
    y, _ = audio.read(path)
    return np.rint(y * 8388608.0).astype(np.int64)


def _same(a, b) -> bool:
    return open(a, "rb").read() == open(b, "rb").read()


STANDARD_KEYS = {"n_frames", "c1_frames", "c2_frames", "c1_ratio",
                 "c2_ratio", "mesh", "frames_per_shard", "variant", "sr",
                 "channels", "total", "out_path", "threshold_dbfs",
                 "wall_seconds", "realtime_factor"}
ADAPTIVE_KEYS = {"n_frames", "optimal_threshold", "c2_ratio", "switch_count",
                 "switches_per_min", "short_run_ratio", "atten_db",
                 "min_hold_frames", "xfade_frames", "mesh",
                 "frames_per_shard", "variant", "params", "sr", "channels",
                 "total", "out_path", "wall_seconds", "realtime_factor"}


def test_process_sharded_equals_single_device_and_jax(tmp_path):
    ip = _file(tmp_path, 7.3, 5, 800, 3500, 0.4)
    p = standard.StandardParams(require_48k_stereo=False, n_fft=N_FFT,
                                hop=HOP)
    ref = tmp_path / "ref.wav"
    standard.process(ip, ref, p, state_csv_path=tmp_path / "ref.csv",
                     frames_per_chunk=64, device="cpu")
    shd = tmp_path / "shd.wav"
    st = process_sharded(ip, shd, p, frames_per_shard=23,
                         state_csv_path=tmp_path / "shd.csv", devices=CPU8)
    assert st["mesh"] == {"data": 1, "seq": 8}
    assert _same(shd, ref) and _same(tmp_path / "shd.csv",
                                     tmp_path / "ref.csv")
    assert st["c1_frames"] > 0 and st["c2_frames"] > 0
    jp = jstd.StandardParams(require_48k_stereo=False, n_fft=N_FFT, hop=HOP)
    jst = jstream.process_sharded(ip, tmp_path / "jax.wav", jp,
                                  n_devices=8, frames_per_shard=23,
                                  state_csv_path=tmp_path / "jax.csv")
    assert np.abs(_pcm(shd) - _pcm(tmp_path / "jax.wav")).max() <= LSB
    for k in ("n_frames", "c1_frames", "c2_frames", "mesh",
              "frames_per_shard", "total"):
        assert st[k] == jst[k], k
    assert set(st) - {"timings"} == set(jst) == STANDARD_KEYS
    rows = open(tmp_path / "shd.csv").read().splitlines()
    jrows = open(tmp_path / "jax.csv").read().splitlines()
    assert len(rows) == len(jrows) and rows[0] == jrows[0]
    for a, b in zip(rows[1:], jrows[1:]):
        ca, cb = a.split(","), b.split(",")
        assert ca[0] == cb[0] and ca[1] == cb[1] and ca[3] == cb[3]
        assert abs(float(ca[2]) - float(cb[2])) <= 1e-4


def test_process_sharded_xfade_within_an_lsb_of_single_device(tmp_path):
    ip = _file(tmp_path, 6.2, 8, 700, 3000, 0.5)
    p = xfade.XfadeParams(require_48k_stereo=False, n_fft=N_FFT, hop=HOP,
                          gate_offset=-80.0, xfade_ms=120.0)
    ref = tmp_path / "ref.wav"
    xfade.process(ip, ref, p, state_csv_path=tmp_path / "ref.csv",
                  frames_per_chunk=64, device="cpu")
    shd = tmp_path / "shd.wav"
    st = process_sharded(ip, shd, p, frames_per_shard=19,
                         state_csv_path=tmp_path / "shd.csv",
                         variant="xfade", devices=CPU8)
    assert st["variant"] == "xfade" and st["mesh"]["seq"] == 8
    assert set(st) - {"timings"} == STANDARD_KEYS
    d = np.abs(_pcm(shd) - _pcm(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    ref_rows = open(tmp_path / "ref.csv").read().splitlines()
    shd_rows = open(tmp_path / "shd.csv").read().splitlines()
    assert len(ref_rows) == len(shd_rows)
    for a, b in zip(ref_rows[1:], shd_rows[1:]):
        ca, cb = a.split(","), b.split(",")
        assert ca[:4] == cb[:4]                     # idx/time/level/state
        assert abs(float(ca[4]) - float(cb[4])) <= 0.001   # alpha %.3f
    alpha = np.array([float(r.split(",")[4]) for r in shd_rows[1:]])
    assert np.any((alpha > 0) & (alpha < 1))


def test_process_sharded_adaptive_within_an_lsb_of_single_device(tmp_path):
    ip = _file(tmp_path, 6.7, 11, 600, 2800, 0.45)
    p = adaptive.AdaptiveParams(n_fft=N_FFT, hop=HOP, min_hold_ms=80.0,
                                xfade_ms=120.0)
    ref = tmp_path / "ref.wav"
    ri = adaptive.process(ip, ref, p, state_csv_path=tmp_path / "ref.csv",
                          frames_per_chunk=64, device="cpu")
    shd = tmp_path / "shd.wav"
    st = process_sharded_adaptive(ip, shd, p, frames_per_shard=21,
                                  state_csv_path=tmp_path / "shd.csv",
                                  devices=CPU8)
    assert st["mesh"]["seq"] == 8 and st["variant"] == "adaptive"
    assert set(st) == ADAPTIVE_KEYS
    for k in ("optimal_threshold", "atten_db", "switch_count", "c2_ratio"):
        assert st[k] == ri[k], k
    d = np.abs(_pcm(shd) - _pcm(ref))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert _same(tmp_path / "shd.csv", tmp_path / "ref.csv")
    assert 0.0 < st["c2_ratio"] < 1.0 and st["switch_count"] > 0


class _Stop(Exception):
    pass


@pytest.mark.parametrize("variant", ["standard", "adaptive"])
def test_resume_is_byte_equal_and_another_mesh_is_refused(tmp_path,
                                                          monkeypatch,
                                                          variant):
    """Stopped after its second snapshot (after two super-chunks), the run
    resumes to the uninterrupted run's bytes; a rerun on a 4-shard mesh
    is refused, the checkpoint's fingerprint holding n_seq."""
    ip = _file(tmp_path, 7.3, 5, 800, 3500, 0.4)
    if variant == "standard":
        p = standard.StandardParams(require_48k_stereo=False, n_fft=N_FFT,
                                    hop=HOP)

        def run(out, devices, **kw):
            return process_sharded(ip, out, p, frames_per_shard=23,
                                   devices=devices,
                                   state_csv_path=str(out) + ".csv", **kw)
    else:
        p = adaptive.AdaptiveParams(n_fft=N_FFT, hop=HOP,
                                    min_hold_ms=80.0, xfade_ms=120.0)

        def run(out, devices, **kw):
            return process_sharded_adaptive(
                ip, out, p, frames_per_shard=23, devices=devices,
                state_csv_path=str(out) + ".csv", **kw)
    whole = tmp_path / "whole.wav"
    run(whole, CPU8)
    ck = tmp_path / "ck.npz"
    out = tmp_path / "out.wav"
    saves = [0]
    save = stream.CheckpointManager.maybe_save

    def stop_after_two(self, state, force=False):
        r = save(self, state, force)
        saves[0] += int(r)
        if saves[0] == 2:
            raise _Stop()
        return r

    monkeypatch.setattr(stream.CheckpointManager, "maybe_save",
                        stop_after_two)
    with pytest.raises(_Stop):
        run(out, CPU8, checkpoint_path=ck, checkpoint_every=1)
    monkeypatch.setattr(stream.CheckpointManager, "maybe_save", save)
    assert ck.exists()
    with pytest.raises(ValueError, match="different parameters"):
        run(out, _cpu(4), checkpoint_path=ck, checkpoint_every=1)
    run(out, CPU8, checkpoint_path=ck, checkpoint_every=1)
    assert not ck.exists()
    assert _same(out, whole)
    assert _same(str(out) + ".csv", str(whole) + ".csv")


def test_process_sharded_rejects_data_gt_1(tmp_path):
    ip = tmp_path / "in.wav"
    audio.write(ip, np.zeros((SR // 4, 2), np.float32), SR,
                subtype="PCM_24")
    with pytest.raises(ValueError, match="data must be 1"):
        process_sharded(ip, tmp_path / "out.wav",
                        standard.StandardParams(require_48k_stereo=False,
                                                n_fft=256, hop=128),
                        data=2, frames_per_shard=8, devices=_cpu(4))
    with pytest.raises(ValueError, match="nope"):
        process_sharded(ip, tmp_path / "out.wav", variant="nope",
                        devices=_cpu(2))


def test_process_sharded_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    ip = tmp_path / "in.wav"
    audio.write(ip, np.zeros((SR // 4, 2), np.float32), SR,
                subtype="PCM_24")
    with pytest.raises(RuntimeError, match="CUDA"):
        process_sharded(ip, tmp_path / "out.wav")
    with pytest.raises(RuntimeError, match="CUDA"):
        process_sharded_adaptive(ip, tmp_path / "out.wav", n_devices=2)
    assert not (tmp_path / "out.wav").exists()


def test_process_sharded_cli_all_variants(tmp_path, capsys):
    """The CLI runs every variant on a CPU mesh; the standard one writes
    `process`'s bytes; without a card and with no --device it fails and
    writes nothing."""
    t = np.arange(int(1.5 * SR)) / SR
    env = 0.002 + 0.06 * (np.sin(2 * np.pi * 0.9 * t) > 0)
    x = (env * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    ip = tmp_path / "in.wav"
    audio.write(ip, np.stack([x, x], 1), SR, subtype="PCM_24")
    for variant in ("standard", "xfade", "adaptive"):
        op = tmp_path / f"out_{variant}.wav"
        rc = cli_main.main(["process-sharded", "-i", str(ip), "-o", str(op),
                            "--variant", variant, "--devices", "2",
                            "--allow_any_rate", "--device", "cpu"])
        assert rc == 0, f"{variant}: rc={rc}"
        assert "mesh: data=1 seq=2" in capsys.readouterr().out
        y, _ = audio.read(op)
        assert y.shape == (len(x), 2)
    ref = tmp_path / "ref.wav"
    assert cli_main.main(["process", "-i", str(ip), "-o", str(ref),
                          "--allow_any_rate", "--device", "cpu"]) == 0
    assert _same(ref, tmp_path / "out_standard.wav")
    # explicit non-linear gate mapping on the xfade variant prints the
    # linear-only note
    rc = ps.main(["-i", str(ip), "-o", str(tmp_path / "o2.wav"),
                  "--variant", "xfade", "--devices", "2", "--device", "cpu",
                  "--allow_any_rate", "--gate_mode", "log_percent"])
    assert rc == 0
    assert "LINEAR" in capsys.readouterr().out
    if not torch.cuda.is_available():
        capsys.readouterr()
        rc = ps.main(["-i", str(ip), "-o", str(tmp_path / "o3.wav"),
                      "--allow_any_rate"])
        assert rc == 1 and "CUDA" in capsys.readouterr().out
        assert not (tmp_path / "o3.wav").exists()
