"""Wire codec of the port against the JAX package's and the numpy oracle.

From numpy-seeded int32 inputs, pack_device of the port (torch ops, CPU
tensors) == pack_device of the JAX package (jit on the CPU) == encode_np,
word for word, rice on and off; unpack_device both ways; csrc/wire.cpp's
output == native/wire.cpp's; corrupt-header and garbage rejection as in
tests/test_wire.py. Tolerance: exact (an integer codec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomatis_tpu.io import wirecodec as jwirecodec
from tomatis_tpu.ops import wire as jwire
from tomatis_tpu_torch.io import wirecodec
from tomatis_tpu_torch.ops import wire

# two intra-op threads: the suite runs several workers side by side, and
# torch ops called from the stream's helper threads each bring a pool
torch.set_num_threads(2)
_JPACK = jax.jit(jwire.pack_device, static_argnums=(1, 2, 3))
_JUNPACK = jax.jit(jwire.unpack_device, static_argnums=(1, 2, 3))


def _program(n, rng, amp=3e5):
    t = np.arange(n)
    x = (amp * np.sin(2 * np.pi * 440 * t / 48000)
         + amp / 15 * rng.standard_normal(n)).astype(np.int64)
    L = np.clip(x, -8388608, 8388607).astype(np.int32)
    R = np.clip(0.9 * x, -8388608, 8388607).astype(np.int32)
    return np.stack([L, R], 1)


def _three_way_signals():
    """The input classes held against BOTH packages (each costs an XLA
    compile per shape, so the list is short)."""
    rng = np.random.default_rng(42)
    yield "program", _program(5000, rng)
    yield "silence", np.zeros((1000, 2), np.int32)
    yield "fullscale_noise", rng.integers(
        -8388608, 8388608, (3000, 2)).astype(np.int32)
    yield "16bit_sourced", (rng.integers(-32768, 32768, (2000, 2))
                            .astype(np.int32) << 8)
    yield "mono", np.clip(1e4 * rng.standard_normal(700),
                          -8e6, 8e6).astype(np.int32)[:, None]
    yield "n_not_multiple_of_256", _program(1283, rng, amp=2e6)
    yield "one_block_exact", _program(256, rng)
    gap = np.clip(3e6 * rng.standard_normal((2048, 2)),
                  -8388608, 8388607).astype(np.int32)
    gap[:256] = 0
    gap[512:1024] = 0
    gap[1792:] = 0
    yield "gappy_blocks", gap


def _oracle_signals():
    """More shapes, held against the numpy oracle alone (no compile)."""
    rng = np.random.default_rng(43)
    yield "tiny", rng.integers(-100, 100, (5, 2)).astype(np.int32)
    yield "extremes", np.array([[8388607, -8388608]] * 300, np.int32)
    yield "minus_one", np.full((600, 2), -1, np.int32)
    ramp = (np.arange(2000) * 1000 % 16777216 - 8388608).astype(np.int32)
    yield "ramp", np.stack([ramp, -ramp], 1)
    quiet = (50 * np.sin(2 * np.pi * 300 * np.arange(4000) / 48000)) \
        .astype(np.int32)
    yield "quiet_identical_lr", np.stack([quiet, quiet], 1)
    for k in range(6):
        nn = int(rng.integers(1, 3000))
        cc = int(rng.integers(1, 3))
        amp = 10 ** rng.uniform(0, 7)
        yield f"fuzz{k}", np.clip(amp * rng.standard_normal((nn, cc)),
                                  -8388608, 8388607).astype(np.int32)
    for nn in (255, 257, 511, 512, 513):
        big = np.clip(3e6 * rng.standard_normal((nn, 2)),
                      -8388608, 8388607).astype(np.int32)
        big[-1] = 8388607          # large step right at the block edge
        yield f"blockedge{nn}", big
    yield "wasted_mixed", np.stack(
        [rng.integers(-8388608, 8388608, 1500),
         rng.integers(-2048, 2048, 1500) << 12], 1).astype(np.int32)
    yield "wasted_mono", (rng.integers(-512, 512, 900)
                          .astype(np.int32) << 10)[:, None]
    yield "wasted_k23", np.stack([np.full(600, 8388607, np.int32),
                                  np.full(600, -8388608, np.int32)], 1)
    yield "three_channels", np.clip(
        1e5 * rng.standard_normal((700, 3)), -8e6, 8e6).astype(np.int32)


def _word_pad(buf):
    return np.concatenate([buf, np.zeros((-len(buf)) % 4, np.uint8)])


def _port_pack(v, rice):
    n, ch = v.shape
    words, used = wire.pack_device(torch.from_numpy(v), n, ch, rice)
    assert words.dtype == torch.int32 and used.dtype == torch.int32
    assert words.numel() == wire.max_words(n, ch)
    return words.numpy().view(np.uint32), int(used)


def _check_port_against_oracle(v, rice):
    n, ch = v.shape
    buf = wire.encode_np(v, rice=rice)
    buf0 = wire.encode_np(v, rice=rice, wasted=False)
    words, used = _port_pack(v, rice)
    assert used * 4 == len(buf0)
    assert np.array_equal(words[:used].view(np.uint8), buf0)
    assert not words[used:].any(), "padding beyond used words must be zero"
    # the rice-enabled decoder handles either stream; the rice-free one
    # is only contracted for rice-free streams. A uint8 and an int32
    # buffer decode alike.
    expect = v.astype(np.float32) / np.float32(8388608.0)
    for src in (buf, buf0):
        b = _word_pad(src)
        for dec_rice in ((True,) if rice else (True, False)):
            for tb in (torch.from_numpy(b),
                       torch.from_numpy(b.view(np.int32))):
                f = wire.unpack_device(tb, n, ch, dec_rice)
                assert f.dtype == torch.float32
                assert np.array_equal(f.numpy(), expect)
    return buf, buf0, words, used


@pytest.mark.parametrize("rice", [True, False], ids=["rice", "maxw"])
@pytest.mark.parametrize("name,v", list(_three_way_signals()))
def test_pack_unpack_three_way_parity(name, v, rice):
    """port == JAX package == numpy oracle, word for word."""
    n, ch = v.shape
    # the port's numpy half is a copy: same bytes as the reference's
    assert np.array_equal(wire.encode_np(v, rice=rice),
                          jwire.encode_np(v, rice=rice))
    buf, buf0, words, used = _check_port_against_oracle(v, rice)
    assert np.array_equal(wire.decode_np(buf), v)

    jwords, jused = _JPACK(jnp.asarray(v), n, ch, rice)
    jwords, jused = np.asarray(jwords), int(jused)
    assert used == jused
    assert np.array_equal(words, jwords), "whole buffer, zero tail included"

    # unpack both ways: each package decodes the other's device stream
    expect = v.astype(np.float32) / np.float32(8388608.0)
    f_port = wire.unpack_device(
        torch.from_numpy(jwords.view(np.int32).copy()), n, ch, rice)
    assert np.array_equal(f_port.numpy(), expect)
    f_jax = _JUNPACK(jnp.asarray(words), n, ch, rice)
    assert np.array_equal(np.asarray(f_jax), expect)
    # and the host-encoded (wasted-bits) stream decodes alike on both
    b = _word_pad(buf)
    assert np.array_equal(
        np.asarray(_JUNPACK(jnp.asarray(b), n, ch, True)),
        wire.unpack_device(torch.from_numpy(b), n, ch, True).numpy())


@pytest.mark.parametrize("rice", [True, False], ids=["rice", "maxw"])
@pytest.mark.parametrize("name,v", list(_oracle_signals()))
def test_pack_unpack_against_oracle(name, v, rice):
    _check_port_against_oracle(v, rice)


@pytest.mark.parametrize("rice", [True, False], ids=["rice", "maxw"])
@pytest.mark.parametrize(
    "name,v", list(_three_way_signals()) + list(_oracle_signals())[:6])
def test_native_codec_matches_reference_build(name, v, rice):
    """csrc/wire.cpp (the port's build) == native/wire.cpp (the JAX
    package's) == numpy, on encode and on both decoders."""
    assert wirecodec.available() and jwirecodec.available()
    n, ch = v.shape
    buf = wire.encode_np(v, rice=rice)
    cbuf = wirecodec.encode_i32(v, rice=rice)
    assert np.array_equal(cbuf, jwirecodec.encode_i32(v, rice=rice))
    assert np.array_equal(cbuf, buf), "C++ encode must match numpy"
    words, used = _port_pack(v, rice)
    dev_stream = words[:used].view(np.uint8)
    for src in (buf, dev_stream):
        assert np.array_equal(wirecodec.decode_i32(src, n, ch), v)
        pcm = wirecodec.decode_pcm24(src, n, ch)
        assert np.array_equal(pcm, jwirecodec.decode_pcm24(src, n, ch))
        assert np.array_equal(pcm, wire.le24_from_i32(v.reshape(-1)))


def test_native_lib_builds():
    assert wirecodec.available(), \
        "the native wire codec must build here (g++ present)"


def test_numpy_fallback_without_compiler(monkeypatch):
    """TOMATIS_NO_NATIVE with empty caches acts out a machine without a
    compiler: the numpy implementation takes over, same bytes."""
    from tomatis_tpu_torch.native import build
    rng = np.random.default_rng(5)
    v = _program(3000, rng)
    x = v.astype(np.float32) / np.float32(8388608.0)
    native = wirecodec.encode_i32(v)
    monkeypatch.setenv("TOMATIS_NO_NATIVE", "1")
    monkeypatch.setattr(wirecodec, "_LIB", None)
    monkeypatch.setattr(wirecodec, "_LIB_TRIED", False)
    monkeypatch.setattr(build, "_CACHE", {})
    assert not wirecodec.available()
    assert np.array_equal(wirecodec.encode_i32(v), native)
    assert np.array_equal(wirecodec.encode_f32(x), native)
    assert wirecodec.encode_f32(x + np.float32(1e-8)) is None
    assert np.array_equal(wirecodec.decode_i32(native, 3000, 2), v)
    assert np.array_equal(wirecodec.decode_pcm24(native, 3000, 2),
                          wire.le24_from_i32(v.reshape(-1)))


def test_encode_f32_exactness_gate():
    rng = np.random.default_rng(1)
    v = rng.integers(-8388608, 8388608, (2048, 2)).astype(np.int32)
    x = v.astype(np.float32) / 8388608.0
    buf = wirecodec.encode_f32(x)
    assert buf is not None
    assert np.array_equal(wirecodec.decode_i32(buf, 2048, 2), v)
    # non-PCM_24 floats must be rejected, not silently quantised
    assert wirecodec.encode_f32(x + np.float32(1e-8)) is None
    assert wirecodec.encode_f32(np.full((16, 2), 1.0, np.float32)) is None


def test_encode_f32_rejects_nonfinite():
    x = np.zeros((512, 2), np.float32)
    x[3, 0] = np.nan
    x[9, 1] = np.inf
    x[11, 0] = -np.inf
    assert wirecodec.encode_f32(x) is None
    for v in (8388607 / 8388608.0, -1.0):
        full = np.full((64, 2), v, np.float32)
        assert wirecodec.encode_f32(full) is not None


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        wire.decode_np(np.zeros(64, np.uint8))
    with pytest.raises(RuntimeError):
        wirecodec.decode_i32(np.zeros(64, np.uint8), 16, 2)
    # the device decoder refuses what it cannot index, by shape alone
    with pytest.raises(ValueError, match="shorter than"):
        wire.unpack_device(torch.zeros(4, dtype=torch.int32), 1024, 2)
    with pytest.raises(ValueError, match="whole words"):
        wire.unpack_device(torch.zeros(30, dtype=torch.uint8), 4, 1)
    with pytest.raises(ValueError, match="int32"):
        wire.pack_device(torch.zeros((8, 2)), 8, 2)


def _corruptions():
    """Header corruptions every decoder must reject cleanly (no crash,
    no silent garbage): each yields (name, mutate(buf) -> bad buf)."""
    def set_flag_byte(buf, byteoff, val):
        b = buf.copy()
        b[byteoff] = val
        return b

    # header word 3 = flags at bytes 12..15: ch | order<<8 | ms<<16 | raw<<17
    yield "order_200", lambda b: set_flag_byte(b, 13, 200)
    yield "midside_on_mono", lambda b: set_flag_byte(b, 14, 1)
    yield "truncated", lambda b: b[:max(24, len(b) - 8)]

    def raw_too_short(b):
        bb = b.copy()
        bb[14] = bb[14] | 2            # raw flag (bit 17 = byte14 bit1)
        return bb[:40]
    yield "raw_truncated", raw_too_short


@pytest.mark.parametrize("name,mutate", list(_corruptions()))
def test_decoders_reject_corrupt_headers(name, mutate):
    """numpy fallback and native C++ both reject the same corrupt buffers
    with a clean error; the device decoder, which cannot raise on data,
    stays in range and returns the expected shape."""
    v = (1000 * np.sin(np.arange(900) / 7)).astype(np.int32)[:, None]
    good = wire.encode_np(v)
    assert np.array_equal(wire.decode_np(good), v)
    bad = mutate(good)
    with pytest.raises(ValueError):
        wire.decode_np(bad)
    with pytest.raises(RuntimeError):
        wirecodec.decode_i32(bad, len(v), 1)
    b = _word_pad(bad)
    if len(b) >= 4 * wire.header_words(len(v), 1):
        f = wire.unpack_device(torch.from_numpy(b), len(v), 1, True)
        assert tuple(f.shape) == (len(v), 1)


def test_wasted_bits_malformed_k_rejected():
    """Hostile k fields (k>23, or k1 set on mono) are rejected by both
    host decoders and clamped by the device decoder."""
    v = np.arange(-300, 300, dtype=np.int32)[:, None] * 2
    a = wire.encode_np(v, rice=True)
    n, ch = 600, 1
    for bad_flags in ((25 << 18), (1 << 23)):   # k0=25 / k1 on mono
        corr = a.copy()
        w = corr[:20].view(np.uint32)
        w[3] = np.uint32(int(w[3]) | bad_flags)
        with pytest.raises(ValueError):
            wire.decode_np(corr)
        with pytest.raises(RuntimeError):
            wirecodec.decode_i32(corr, n, ch)
        f = wire.unpack_device(torch.from_numpy(_word_pad(corr)), n, ch,
                               True)
        assert tuple(f.shape) == (n, ch)


def test_malformed_overflow_stream_np_cpp_device_parity():
    """A descriptor-valid stream whose residuals overflow int32 during
    predictor restore decodes IDENTICALLY in numpy (int32 wrap), C++
    (unsigned wrap) and on the device (int32 cumsum wrap)."""
    n, ch = 256, 1
    H = wire.header_words(n, ch)
    used = H + 8 * 30                     # one block, noct=30, no rice
    hdr = np.zeros(5, np.uint32)
    hdr[0] = wire.MAGIC
    hdr[1] = n
    hdr[2] = 1
    hdr[3] = ch | (4 << 8)                # order=4: four cumsum passes
    hdr[4] = used
    desc = np.zeros((H - 5) * 4, np.uint8)
    desc[0] = 30                          # noct=30, rice bit clear
    body = np.full(8 * 30, 0xFFFFFFFF, np.uint32)
    buf = np.concatenate([hdr.view(np.uint8), desc, body.view(np.uint8)])

    ref = wire.decode_np(buf)
    assert ref.shape == (n, ch)
    np.testing.assert_array_equal(wirecodec.decode_i32(buf, n, ch), ref)
    dev = wire.unpack_device(torch.from_numpy(buf), n, ch, False)
    np.testing.assert_array_equal(
        dev.numpy(), ref.astype(np.float32) / np.float32(8388608.0))


def test_native_raw_escape_negative_samples():
    rng = np.random.default_rng(7)
    v = rng.integers(-8388608, 8388608, (2048, 2)).astype(np.int32)
    buf = wire.encode_np(v)
    flags = buf[12:16].view(np.uint32)[0]
    assert (flags >> 17) & 1 == 1, "full-scale noise must hit raw escape"
    assert np.array_equal(wire.decode_np(buf), v)
    assert np.array_equal(wirecodec.decode_i32(buf, len(v), 2), v)
    words, used = _port_pack(v, True)
    assert (int(words[3]) >> 17) & 1 == 1 and used == wire.raw_words(2048, 2)


def test_compression_and_wasted_bits_savings():
    rng = np.random.default_rng(7)
    sr = 48000
    t = np.arange(4 * sr) / sr
    x = 0.05 * (np.sin(2 * np.pi * 440 * t)
                + 0.4 * np.sin(2 * np.pi * 3100 * t)
                + 0.05 * rng.standard_normal(t.size))
    v = np.rint(np.stack([x, 0.9 * x], 1) * 8388608).astype(np.int32)
    buf = wire.encode_np(v)
    assert len(buf) / (v.size * 3) < 0.85
    _, used = _port_pack(v, True)
    _, used0 = _port_pack(v, False)
    assert used < used0 < wire.raw_words(*v.shape), "rice saves link bytes"
    v16 = (rng.integers(-32768, 32768, (4000, 2)) << 8).astype(np.int32)
    a = wire.encode_np(v16, rice=True)
    a0 = wire.encode_np(v16, rice=True, wasted=False)
    assert len(a) <= 0.75 * len(a0), (len(a), len(a0))
    flags = int(a[:20].view(np.uint32)[3])
    k0, k1, ms = (flags >> 18) & 31, (flags >> 23) & 31, (flags >> 16) & 1
    assert (k0, k1) == ((7, 8) if ms else (8, 8)), (k0, k1, ms)


def test_size_functions_match_reference():
    for n, ch in ((1, 1), (255, 2), (256, 2), (257, 1), (2_099_200, 2)):
        for fn in ("n_blocks", "header_words", "raw_words", "max_words"):
            args = (n,) if fn == "n_blocks" else (n, ch)
            assert getattr(wire, fn)(*args) == getattr(jwire, fn)(*args)
    assert (wire.MAGIC, wire.B, wire._WMAX, wire._KMAX, wire._UWMAX) == \
        (jwire.MAGIC, jwire.B, jwire._WMAX, jwire._KMAX, jwire._UWMAX)
