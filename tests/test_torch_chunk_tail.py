"""The fused chunk tail (window, mask, overlap-add, normaliser, tails,
divide, PCM_24 pack) of the port's chunk step.

- The port's chunk step against the JAX package's
  (ChunkedStftEngine.make_chunk_fn) on the same numpy inputs.
- chunk_tail_plain against the unfused composition it stands for, exactly.
- A Python emulation of the CUDA kernel's index math (tiles, 4-sample lane
  groups, frame bounds, interleaved stores, PCM byte offsets, per-tile
  peaks) against chunk_tail_plain, bit for bit.
- The batched chunk tail (a lane axis): chunk_tail_batched_plain against
  chunk_tail_plain lane by lane with the freeze rule, and an emulation of
  the batched kernel's lane offsets on flat buffers, bit for bit.
The kernels themselves run against their plain versions in the jax-free
tests/test_torch_cuda_kernels.py, where a card exists.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomatis_tpu.engine import streaming as jstreaming
from tomatis_tpu.models import standard as jstd
from tomatis_tpu_torch import convert
from tomatis_tpu_torch.engine import streaming
from tomatis_tpu_torch.ops import cuda_ola, stft
from tomatis_tpu_torch.ops.dsp import EPS
from tomatis_tpu_torch.utils.pcm import i32_from_le24

torch.set_num_threads(2)

SR = 48000
HOP = 128
F = 8
MARGIN_DB = 0.01
# The tolerances of tests/test_torch_standard.py: floats within 1e-5, PCM_24
# within 1 LSB, levels within 1e-4 dB, gate states exact. Torch and XLA run
# different FFTs and sum levels in different orders.
ATOL, LEVEL_ATOL, LSB = 1e-5, 1e-4, 1


def _window(n_fft):
    """A raised Hann window (never below 0.6): with np.hanning the
    normaliser w falls to ~1e-9 at the frame edges, and emit = acc/w turns
    the two FFTs' last-ulp differences into large absolute errors there."""
    return (0.6 + 0.4 * np.hanning(n_fft)).astype(np.float32)


def _chunk_inputs(k, C, seed):
    """Chunk signal alternating k loud and k quiet hop blocks (0.03 and
    0.002 times noise, about -30 and -54 dBFS) around the default -40 dBFS
    gate, so the gate switches at every k; and random carried tails."""
    rng = np.random.default_rng(seed)
    n_fft = k * HOP
    n_blocks = F + k - 1
    amp = np.where(np.arange(n_blocks) // k % 2 == 0, 0.03, 0.002)
    sig = (np.repeat(amp, HOP)[:, None]
           * rng.standard_normal((n_blocks * HOP, C))).astype(np.float32)
    tail = n_fft - HOP
    out_tail = (0.01 * rng.standard_normal((tail, C))).astype(np.float32)
    w_tail = rng.uniform(0.3, 1.0, tail).astype(np.float32)
    return sig, out_tail, w_tail


def _controllers(n_fft):
    jp = jstd.StandardParams(require_48k_stereo=False, n_fft=n_fft, hop=HOP,
                             up_delay_ms=0.0)
    jctl = jstd.build_controller(jp, SR)
    table, ton, toff = (np.asarray(v) for v in jctl.params())
    ctl = convert.controller_from_reference(table, ton, toff,
                                            jctl.delay_frames, device="cpu")
    return jctl, ctl, (float(ton), float(toff))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("n_valid", [F, F // 2 + 1, 0],
                         ids=["full", "partial", "empty"])
@pytest.mark.parametrize("norm", ["eps", "floor8"])
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_chunk_fn_matches_jax(transport, norm, n_valid, k, C):
    n_fft = k * HOP
    sig, out_tail, w_tail = _chunk_inputs(k, C, seed=100 * k + C)
    jctl, ctl, ths = _controllers(n_fft)
    gain = np.float32(0.5)
    win = _window(n_fft)

    jeng = jstreaming.ChunkedStftEngine(n_fft, HOP, C, F, window=win)
    jfn = jeng.make_chunk_fn(jctl, transport=transport, norm=norm)
    jres = jfn(jnp.asarray(sig), n_valid, jctl.init_carry(),
               jnp.asarray(out_tail), jnp.asarray(w_tail), jctl.params(),
               jnp.float32(gain))
    jctl_c, jot, jwt = (np.asarray(v) for v in jres[-3:])

    eng = streaming.ChunkedStftEngine(n_fft, HOP, C, F, window=win,
                                      device="cpu")
    fn = eng.make_chunk_fn(ctl, transport=transport, norm=norm)
    ot, wt = torch.from_numpy(out_tail), torch.from_numpy(w_tail)
    carry = ctl.init_carry()
    payload, aux, out, c2, ot2, wt2 = fn(
        torch.from_numpy(sig), n_valid, carry, ot, wt, ctl.params(),
        torch.tensor(gain))
    aux = aux.numpy()

    if transport == "f32":
        jemit, jaux = jeng.unpack_f32(np.asarray(jres[0]))
        assert out is None and payload.shape == jemit.shape
        np.testing.assert_allclose(payload.numpy(), jemit, atol=ATOL)
    else:
        jpcm, jaux = jeng.unpack_pcm24(np.asarray(jres[0]))
        jout = np.asarray(jres[1])
        assert payload.dtype == torch.uint8 and payload.shape == jpcm.shape
        np.testing.assert_allclose(out.numpy(), jout, atol=ATOL)
        assert np.max(np.abs(i32_from_le24(payload.numpy())
                             - i32_from_le24(jpcm))) <= LSB
        np.testing.assert_allclose(aux[-1], jaux[-1], atol=ATOL)   # peaks
    assert aux.shape == jaux.shape
    levels = jaux[0, :F]
    for th in ths:
        assert np.min(np.abs(levels - th)) >= MARGIN_DB, th
    np.testing.assert_allclose(aux[0], jaux[0], atol=LEVEL_ATOL)
    np.testing.assert_array_equal(aux[1], jaux[1])                  # states
    if n_valid == F:
        assert set(aux[1, :F]) == {1.0, 2.0}

    assert int(c2) == int(jctl_c)
    np.testing.assert_allclose(ot2.numpy(), jot, atol=ATOL)
    np.testing.assert_allclose(wt2.numpy(), jwt, atol=ATOL)
    if n_valid == 0:
        # an empty chunk freezes every carry
        assert c2 is carry and ot2 is ot and wt2 is wt


# -- chunk_tail_plain vs the unfused composition ----------------------------

def _unfused(frames, win, gains, n_valid, out_tail, w_tail, gain_lin, norm,
             transport, hop):
    """The chunk step's tail composed of separate passes: windowed gain
    bank, mask, stft.overlap_add of the frames and of the window square,
    tail adds, divide and, for pcm24, gain, peaks and the PCM_24 bytes."""
    F_ = frames.shape[0]
    win2 = win * win
    tail = out_tail.shape[0]
    mask = (torch.arange(F_) < n_valid).to(torch.float32)
    y = stft.apply_gain_bank(frames, win, gains) * mask[:, None, None]
    ola = stft.overlap_add(y, hop)
    w = stft.overlap_add(win2[None, None, :] * mask[:, None, None], hop)[:, 0]
    ola[:tail] += out_tail
    w[:tail] += w_tail
    if norm == "floor8":
        emit = ola / torch.clamp(w[:, None], min=1e-8)
    else:
        emit = ola / (w[:, None] + EPS)
    carries = (ola[F_ * hop:].clone(), w[F_ * hop:].clone())
    if transport == "f32":
        return (emit, None, None) + carries
    out = emit * gain_lin
    peaks = out.abs().reshape(-1, hop * out.shape[1]).amax(dim=1)
    v = torch.clamp(torch.round(out * 8388608.0),
                    -8388608, 8388607).to(torch.int32)
    pcm = v.view(torch.uint8).reshape(-1, 4)[:, :3].reshape(-1)
    return (out, peaks, pcm) + carries


@pytest.mark.parametrize("k,C,n_valid", [(2, 2, 9), (2, 1, 4), (3, 2, 0),
                                         (4, 1, 9), (4, 2, 5)])
@pytest.mark.parametrize("norm", ["eps", "floor8"])
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_plain_equals_unfused_composition(transport, norm, k, C, n_valid):
    hop, F_ = 64, 9
    n_fft = k * hop
    rng = np.random.default_rng(k * 10 + C)
    frames = torch.from_numpy(
        rng.standard_normal((F_, C, n_fft)).astype(np.float32))
    gains = torch.from_numpy(
        rng.uniform(0.1, 4.0, (F_, n_fft // 2 + 1)).astype(np.float32))
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32))
    tail = n_fft - hop
    out_tail = torch.from_numpy(
        rng.standard_normal((tail, C)).astype(np.float32))
    w_tail = torch.from_numpy(rng.uniform(0, 1, tail).astype(np.float32))
    gain = torch.tensor(0.8)
    ref = _unfused(frames, win, gains, n_valid, out_tail, w_tail, gain,
                   norm, transport, hop)
    z = stft.gain_bank_irfft(frames, win, gains)
    got = cuda_ola.chunk_tail_plain(z, win, win * win, n_valid, out_tail,
                                    w_tail, gain, norm=norm,
                                    transport=transport)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert g.dtype == r.dtype and torch.equal(g, r)


# -- the kernel's index math, emulated ----------------------------------------

def _pack4(u):
    """The kernel's pack4: four 24-bit samples -> three little-endian words."""
    m = 0xFFFFFFFF
    return [(u[0] & 0xFFFFFF) | ((u[1] << 24) & m),
            ((u[1] >> 8) & 0xFFFF) | ((u[2] << 16) & m),
            ((u[2] >> 16) & 0xFF) | ((u[3] << 8) & m)]


def _emulate_kernel(z, win, win2, n_valid, out_tail, w_tail, gain, norm,
                    transport, threads, freeze=False):
    """csrc/ola.cu's chunk_tail_kernel in Python, on flat float32 buffers.

    Block t owns hop tile t; thread tid walks the tile's groups
    s0 = V*tid, V*(tid + threads), ... of V samples (V = 4 when
    hop % 4 == 0 and C <= 2, else the scalar loop, V = 1); frames t-i for
    i in [max(0, t-F+1), min(K-1, t)]. freeze: the carries take the input
    tails (the batched kernel's lane with n_valid == 0). Counts the writes
    of every output element, which must be exactly one."""
    f32 = np.float32
    F_, C, n_fft = z.shape
    tail = w_tail.shape[0]
    hop = n_fft - tail
    K = n_fft // hop
    W = F_ + K - 1
    Fh = F_ * hop
    pcm24 = transport == "pcm24"
    V = 4 if hop % 4 == 0 and C <= 2 else 1
    zf, otf = z.reshape(-1), out_tail.reshape(-1)
    out = np.zeros(W * hop * C, f32)
    pcm = np.zeros(W * hop * C * 3, np.uint8)
    ola_c, w_c = np.zeros(tail * C, f32), np.zeros(tail, f32)
    peaks = np.zeros(W, f32)
    n_out, n_pcm = np.zeros(out.size, int), np.zeros(pcm.size, int)
    n_oc, n_wc = np.zeros(ola_c.size, int), np.zeros(w_c.size, int)
    for t in range(W):                                  # blockIdx.x
        i_lo, i_hi = max(0, t - F_ + 1), min(K - 1, t)
        block_pk = f32(0)
        for tid in range(threads):                      # threadIdx.x
            for s0 in range(V * tid, hop, V * threads):
                n0 = t * hop + s0
                acc = np.zeros((C, V), f32)
                w = np.zeros(V, f32)
                for i in range(i_lo, i_hi + 1):
                    f, off = t - i, i * hop + s0
                    m = f32(1.0 if f < n_valid else 0.0)
                    w = w + win2[off:off + V] * m
                    for c in range(C):
                        base = (f * C + c) * n_fft + off
                        acc[c] = acc[c] + (zf[base:base + V]
                                           * win[off:off + V]) * m
                # span element e: sample e // C, channel e % C
                if n0 < tail:
                    w = w + w_tail[n0:n0 + V]
                    for e in range(V * C):
                        acc[e % C, e // C] += otf[n0 * C + e]
                if n0 >= Fh:
                    r = n0 - Fh
                    w_c[r:r + V] = w_tail[r:r + V] if freeze else w
                    n_wc[r:r + V] += 1
                    for e in range(V * C):
                        ola_c[r * C + e] = (otf[r * C + e] if freeze
                                            else acc[e % C, e // C])
                        n_oc[r * C + e] += 1
                if norm == "eps":
                    x = acc / (w + f32(EPS))
                else:
                    x = acc / np.where(w < f32(1e-8), f32(1e-8), w)
                if pcm24:
                    x = x * f32(gain)
                for e in range(V * C):
                    out[n0 * C + e] = x[e % C, e // C]
                    n_out[n0 * C + e] += 1
                if not pcm24:
                    continue
                block_pk = max(block_pk, np.max(np.abs(x)))
                q = np.clip(np.rint(x * f32(8388608.0)), -8388608, 8388607)
                u = [int(q[e % C, e // C]) & 0xFFFFFFFF for e in range(V * C)]
                if V == 4:
                    words = [w_ for g in range(C) for w_ in _pack4(u[4 * g:])]
                    raw = struct.pack(f"<{3 * C}I", *words)
                else:
                    raw = b"".join(struct.pack("<I", v)[:3] for v in u)
                b0 = n0 * C * 3
                pcm[b0:b0 + len(raw)] = np.frombuffer(raw, np.uint8)
                n_pcm[b0:b0 + len(raw)] += 1
        peaks[t] = block_pk
    for n in (n_out, n_oc, n_wc) + ((n_pcm,) if pcm24 else ()):
        assert np.all(n == 1)
    res = (out.reshape(W * hop, C), peaks if pcm24 else None,
           pcm if pcm24 else None, ola_c.reshape(tail, C), w_c)
    return res, V


@pytest.mark.parametrize("F_,C,n_fft,hop,norm", [
    (5, 2, 16, 8, "eps"),       # K=2, 4-sample groups, 2 groups per tile
    (4, 1, 24, 8, "floor8"),    # K=3, C=1
    (3, 2, 32, 8, "eps"),       # K=4, F < K
    (4, 2, 12, 6, "floor8"),    # hop % 4 != 0: the scalar loop
    (3, 3, 16, 8, "eps"),       # C=3: the scalar loop
])
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_kernel_index_math_emulation(F_, C, n_fft, hop, norm, transport):
    rng = np.random.default_rng(F_ * 100 + n_fft)
    z = (3 * rng.standard_normal((F_, C, n_fft))).astype(np.float32)
    win = rng.uniform(0, 1, n_fft).astype(np.float32)
    win2 = win * win
    tail = n_fft - hop
    out_tail = rng.standard_normal((tail, C)).astype(np.float32)
    w_tail = rng.uniform(0, 1, tail).astype(np.float32)
    w_tail[::5] = 0.0
    gain = np.float32(0.7)
    n_valid = F_ - 1
    got, V = _emulate_kernel(z, win, win2, n_valid, out_tail, w_tail, gain,
                             norm, transport, threads=2)
    assert V == (4 if hop % 4 == 0 and C <= 2 else 1)
    ref = cuda_ola.chunk_tail_plain(
        torch.from_numpy(z), torch.from_numpy(win), torch.from_numpy(win2),
        n_valid, torch.from_numpy(out_tail), torch.from_numpy(w_tail),
        torch.tensor(gain), norm=norm, transport=transport)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            r = r.numpy()
            assert g.shape == r.shape and g.dtype == r.dtype
            # bit for bit: compare the raw bytes
            np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))


# -- the batched chunk tail ---------------------------------------------------

def _batched_inputs(B, F_, C, n_fft, hop, seed):
    rng = np.random.default_rng(seed)
    tail = n_fft - hop
    z = (3 * rng.standard_normal((B, F_, C, n_fft))).astype(np.float32)
    win = rng.uniform(0, 1, n_fft).astype(np.float32)
    out_tail = rng.standard_normal((B, tail, C)).astype(np.float32)
    w_tail = rng.uniform(0, 1, (B, tail)).astype(np.float32)
    w_tail[:, ::5] = 0.0
    return z, win, win * win, out_tail, w_tail, np.float32(0.7)


@pytest.mark.parametrize("F_,C,n_fft,hop,n_valid", [
    (5, 2, 16, 8, [5, 0, 3, -2]),   # full, frozen, partial, negative
    (4, 1, 24, 8, [0, 9]),          # K=3, C=1, n_valid past F
    (3, 2, 32, 8, [0]),             # F < K-1: carry and tail overlap
])
@pytest.mark.parametrize("norm", ["eps", "floor8"])
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_batched_plain_is_per_lane_plain_with_freeze(transport, norm, F_, C,
                                                     n_fft, hop, n_valid):
    B = len(n_valid)
    z, win, win2, ot, wt, gain = (
        torch.from_numpy(np.asarray(a)) for a in
        _batched_inputs(B, F_, C, n_fft, hop, seed=F_ * 7 + C))
    nv = torch.tensor(n_valid, dtype=torch.int32)
    got = cuda_ola.chunk_tail_batched_plain(z, win, win2, nv, ot, wt, gain,
                                            norm=norm, transport=transport)
    for b, n in enumerate(n_valid):
        ref = cuda_ola.chunk_tail_plain(z[b], win, win2, n, ot[b], wt[b],
                                        gain, norm=norm, transport=transport)
        if n <= 0:    # a lane with no valid frame freezes its carries
            ref = ref[:3] + (ot[b], wt[b])
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.dtype == r.dtype and torch.equal(g[b], r)


def _emulate_batched(z, win, win2, n_valid, out_tail, w_tail, gain, norm,
                     transport, threads):
    """The batched entry in Python: lane b (blockIdx.y) takes its slices
    of flat [B, ...] buffers at select_lane's offsets, clamps its n_valid
    to [0, F] and freezes at 0; then the tile loop of _emulate_kernel.
    Every element of every flat output is written exactly once."""
    B, F_, C, n_fft = z.shape
    tail = w_tail.shape[1]
    hop = n_fft - tail
    W = F_ + n_fft // hop - 1
    L = W * hop
    pcm24 = transport == "pcm24"
    flats = dict(out=np.zeros(B * L * C, np.float32),
                 peaks=np.zeros(B * W, np.float32),
                 pcm=np.zeros(B * L * C * 3, np.uint8),
                 ola_c=np.zeros(B * tail * C, np.float32),
                 w_c=np.zeros(B * tail, np.float32))
    counts = {k: np.zeros(v.size, int) for k, v in flats.items()}
    zf, otf, wtf = z.reshape(-1), out_tail.reshape(-1), w_tail.reshape(-1)
    for b in range(B):                                   # blockIdx.y
        nv = min(max(int(n_valid[b]), 0), F_)
        zb = zf[b * F_ * C * n_fft:(b + 1) * F_ * C * n_fft]
        otb = otf[b * tail * C:(b + 1) * tail * C]
        wtb = wtf[b * tail:(b + 1) * tail]
        res, _ = _emulate_kernel(zb.reshape(F_, C, n_fft), win, win2, nv,
                                 otb.reshape(tail, C), wtb, gain, norm,
                                 transport, threads, freeze=nv == 0)
        offs = dict(out=b * L * C, peaks=b * W, pcm=b * L * C * 3,
                    ola_c=b * tail * C, w_c=b * tail)
        for k, v in zip(("out", "peaks", "pcm", "ola_c", "w_c"), res):
            if v is None:
                continue
            v = v.reshape(-1)
            flats[k][offs[k]:offs[k] + v.size] = v
            counts[k][offs[k]:offs[k] + v.size] += 1
    for k, n in counts.items():
        if pcm24 or k not in ("peaks", "pcm"):
            assert np.all(n == 1), k
    return (flats["out"].reshape(B, L, C),
            flats["peaks"].reshape(B, W) if pcm24 else None,
            flats["pcm"].reshape(B, -1) if pcm24 else None,
            flats["ola_c"].reshape(B, tail, C), flats["w_c"].reshape(B, tail))


@pytest.mark.parametrize("F_,C,n_fft,hop,norm,n_valid", [
    (5, 2, 16, 8, "eps", [5, 0, 2]),        # 4-sample groups, a frozen lane
    (4, 1, 24, 8, "floor8", [0, 9]),        # K=3, C=1, clamped n_valid
    (3, 2, 32, 8, "eps", [0, 3]),           # F < K-1
    (4, 2, 12, 6, "floor8", [-1, 3]),       # hop % 4 != 0: the scalar loop
    (3, 3, 16, 8, "eps", [2, 0]),           # C=3: the scalar loop
])
@pytest.mark.parametrize("transport", ["f32", "pcm24"])
def test_batched_kernel_index_math_emulation(F_, C, n_fft, hop, norm,
                                             n_valid, transport):
    B = len(n_valid)
    z, win, win2, ot, wt, gain = _batched_inputs(B, F_, C, n_fft, hop,
                                                 seed=B * 100 + n_fft)
    got = _emulate_batched(z, win, win2, n_valid, ot, wt, gain, norm,
                           transport, threads=2)
    ref = cuda_ola.chunk_tail_batched_plain(
        *(torch.from_numpy(np.asarray(a)) for a in (z, win, win2)),
        torch.tensor(n_valid, dtype=torch.int32), torch.from_numpy(ot),
        torch.from_numpy(wt), torch.tensor(gain), norm=norm,
        transport=transport)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            r = r.numpy()
            assert g.shape == r.shape and g.dtype == r.dtype
            np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))


# -- the wrapper's contract on the CPU ----------------------------------------

def _tail_args(F_=4, C=2, n_fft=16, hop=8, dev="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((F_, C, n_fft), generator=g)
    win = torch.rand((n_fft,), generator=g)
    tail = n_fft - hop
    args = (z, win, win * win, F_, torch.randn((tail, C), generator=g),
            torch.rand((tail,), generator=g), torch.tensor(0.9))
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def test_chunk_tail_cuda_refuses_what_it_cannot_launch():
    args = _tail_args()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ola.chunk_tail_cuda(*args, transport="pcm24")
    with pytest.raises(TypeError, match="float32"):
        cuda_ola.chunk_tail_cuda(args[0].double(), *args[1:])
    z_nc = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ola.chunk_tail_cuda(z_nc, *args[1:])
    for bad in (dict(norm="nope"), dict(transport="wire")):
        with pytest.raises(ValueError):
            cuda_ola.chunk_tail_plain(*args, **bad)
        with pytest.raises(ValueError):
            cuda_ola.chunk_tail_cuda(*args, **bad)
    with pytest.raises(ValueError):      # hop = n_fft - tail must divide n_fft
        cuda_ola.chunk_tail_plain(args[0], args[1], args[2], 4,
                                  torch.zeros((5, 2)), torch.zeros(5),
                                  args[6])
