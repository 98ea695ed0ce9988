"""The port's native FLAC reader (csrc/flac.cpp, which reads its bits a
64-bit word at a time) against the port's pure decoder (io/flac_py.py),
bit for bit.

Hand-built streams (tests/test_flac_spec.py's builders, written from the
format specification) cover every subframe type, residual coding, channel
assignment, sample size and block-size code the reader takes, and the
malformed frames it must refuse; files from the port's encoder cover
truncation, damage, and a 60 s programme read in pieces of every size.
"""
import numpy as np
import pytest

from tests.test_flac_spec import (BW, crc8, crc16, fixed_residual, frame,
                                  rice_residual, streaminfo, sub_constant,
                                  sub_fixed, sub_lpc, sub_verbatim, utf8_num,
                                  zigzag)
from tomatis_tpu_torch.io import flac as flac_mod
from tomatis_tpu_torch.io.flac_py import PureFlacReader

SR = 48000


# ---------------------------------------------------------------------------
# builders beyond tests/test_flac_spec.py's
# ---------------------------------------------------------------------------

_SS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def frame_coded(num, bsize, bps, ch_asgn, build_subframes, bs_code=7,
                ss_code=None):
    """test_flac_spec.frame with the block size as an 8-bit (code 6) or
    16-bit (code 7) field and the sample size as any code (0: from
    STREAMINFO)."""
    bw = BW()
    bw.bits(0x3FFE, 14)
    bw.bits(0, 1)
    bw.bits(0, 1)
    bw.bits(bs_code, 4)
    bw.bits(0, 4)
    bw.bits(ch_asgn, 4)
    bw.bits(_SS_CODE[bps] if ss_code is None else ss_code, 3)
    bw.bits(0, 1)
    utf8_num(bw, num)
    bw.bits(bsize - 1, 8 if bs_code == 6 else 16)
    bw.align()
    bw.bits(crc8(bytes(bw.bytes)), 8)
    cbps = {8: [bps, bps + 1], 9: [bps + 1, bps], 10: [bps, bps + 1]}.get(
        ch_asgn, [bps] * (ch_asgn + 1))
    build_subframes(bw, cbps)
    bw.align()
    bw.bits(crc16(bytes(bw.bytes)), 16)
    return bytes(bw.bytes)


def rice_partitions(bw, res, order, bsize, params):
    """Residual coding method 1 (5-bit parameters) over len(params)
    partitions; a parameter is a Rice k, or ("raw", n) for an escaped
    partition of n-bit values."""
    po = len(params).bit_length() - 1
    assert 1 << po == len(params)
    bw.bits(1, 2)
    bw.bits(po, 4)
    idx = 0
    for p, k in enumerate(params):
        cnt = (bsize >> po) - (order if p == 0 else 0)
        part = [int(v) for v in res[idx:idx + cnt]]
        idx += cnt
        if isinstance(k, tuple):
            bw.bits(0x1F, 5)
            bw.bits(k[1], 5)
            for v in part:
                bw.sbits(v, k[1])
            continue
        bw.bits(k, 5)
        for v in part:
            u = zigzag(v)
            bw.unary(u >> k)
            if k:
                bw.bits(u & ((1 << k) - 1), k)
    assert idx == len(res)


def sub_fixed_parts(bw, samples, order, ebps, params):
    bw.bits(0, 1)
    bw.bits(8 + order, 6)
    bw.bits(0, 1)
    for v in samples[:order]:
        bw.sbits(int(v), ebps)
    rice_partitions(bw, fixed_residual(samples, order), order, len(samples),
                    params)


def sub_lpc_res(bw, warm, coefs, shift, ebps, res, k, wasted=0, prec=15):
    """An LPC subframe of these warm-up samples and residuals (method 1,
    one partition), `wasted` bits shifted out of ebps."""
    bw.bits(0, 1)
    bw.bits(32 + len(coefs) - 1, 6)
    if wasted:
        bw.bits(1, 1)
        bw.unary(wasted - 1)
    else:
        bw.bits(0, 1)
    for v in warm:
        bw.sbits(int(v), ebps - wasted)
    bw.bits(prec - 1, 4)
    bw.bits(shift, 5)
    for c in coefs:
        bw.sbits(int(c), prec)
    rice_partitions(bw, res, len(coefs), len(coefs) + len(res), [k])


def _lpc_residual(samples, coefs, shift):
    s = [int(v) for v in samples]
    order = len(coefs)
    return [s[i] - (sum(coefs[j] * s[i - 1 - j] for j in range(order))
                    >> shift) for i in range(order, len(s))]


def sub_lpc_of(bw, samples, coefs, shift, ebps, wasted=0):
    """An LPC subframe that restores to these samples."""
    s = [int(v) >> wasted for v in samples]
    res = _lpc_residual(s, coefs, shift)
    sub_lpc_res(bw, s[:len(coefs)], coefs, shift, ebps, res, _k(res), wasted)


def _k(res):
    """A Rice parameter near the best for these residuals (method 0)."""
    m = float(np.mean(np.abs(np.asarray(res, np.float64)))) + 1.0
    return int(min(14, max(0, np.floor(np.log2(m)))))


def _walk(rng, n, step, start=0):
    return start + np.cumsum(rng.integers(-step, step + 1, n))


def _stream(bps, channels, frames, expected, block, total=None):
    n = sum(len(e) for e in expected)
    return (b"fLaC" + streaminfo(SR, channels, bps, n if total is None
                                 else total, block) + b"".join(frames),
            np.concatenate(expected).astype(np.int64))


# ---------------------------------------------------------------------------
# streams that decode: name -> (FLAC bytes, expected int samples [n, ch])
# ---------------------------------------------------------------------------

def case_constant(rng):
    B = 64
    L, R = np.full(B, -123456), np.full(B, 77)

    def f(bw, cbps):
        sub_constant(bw, -123456, cbps[0])
        sub_constant(bw, 77, cbps[1])
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([L, R], 1)], B)


def case_verbatim_wasted(rng):
    B = 48
    L = rng.integers(-30000, 30000, B) << 5          # 5 wasted bits
    R = rng.integers(-2 ** 23, 2 ** 23, B)

    def f(bw, cbps):
        sub_verbatim(bw, L, cbps[0], wasted=5)
        sub_verbatim(bw, R, cbps[1])
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([L, R], 1)], B)


def _case_fixed(order):
    def build(rng):
        B = 96
        x = _walk(rng, B, 400)
        for _ in range(order - 1):
            x = np.cumsum(x) // 16
        y = _walk(rng, B, 3000, start=-5000)

        def f(bw, cbps):
            sub_fixed(bw, x, order, cbps[0],
                      k=_k(fixed_residual(x, order)))
            sub_fixed(bw, y, order, cbps[1],
                      k=_k(fixed_residual(y, order)))
        return _stream(24, 2, [frame(0, B, 24, 1, f)],
                       [np.stack([x, y], 1)], B)
    return build


def _case_lpc(order):
    def build(rng):
        B = 128
        t = np.arange(B)
        x = (3000 * np.sin(2 * np.pi * t / 23) + rng.integers(-200, 200, B))
        x = x.astype(np.int64)
        coefs = [int(c) for c in rng.integers(-16384, 16384, order)]
        coefs[0] = 16383                         # the widest 15-bit value
        shift = 14 + order.bit_length()

        def f(bw, cbps):
            sub_lpc(bw, x, coefs=coefs, shift=shift, prec=15, ebps=cbps[0],
                    k=_k(_lpc_residual(x, coefs, shift)))
        return _stream(24, 1, [frame(0, B, 24, 0, f)], [x[:, None]], B)
    return build


def _coefs(rng, order):
    c = [int(v) for v in rng.integers(-3000, 3000, order)]
    c[0] = 9000
    return c


def case_lpc_pairs(rng):
    """Both channels LPC: orders 12 and 3, 8 and 8 on mid/side, 32 and 2,
    5 and 11 with wasted bits on one; each with its own shift."""
    B = 192
    t = np.arange(B)
    frames, expected = [], []
    for num, (oa, ob, asgn, wasted) in enumerate([(12, 3, 1, 0),
                                                   (8, 8, 10, 0),
                                                   (32, 2, 1, 0),
                                                   (5, 11, 1, 4)]):
        L = (20000 * np.sin(2 * np.pi * t / (17 + num))
             + rng.integers(-500, 500, B)).astype(np.int64)
        R = (L * 2) // 3 + rng.integers(-900, 900, B)
        R = (R >> wasted) << wasted
        a, b = (L, R) if asgn == 1 else ((L + R) >> 1, L - R)
        ca, cb = _coefs(rng, oa), _coefs(rng, ob)

        def f(bw, cbps, a=a, b=b, ca=ca, cb=cb, wasted=wasted):
            sub_lpc_of(bw, a, ca, 13, cbps[0])
            sub_lpc_of(bw, b, cb, 14 + len(cb) % 3, cbps[1], wasted)
        frames.append(frame(num, B, 24, asgn, f))
        expected.append(np.stack([L, R], 1))
    return _stream(24, 2, frames, expected, B)


def case_lpc_wrap(rng):
    """Predictions that overflow 32 bits: each step wraps as a two's
    complement int32 (no samples to hold it to but the pure decoder's)."""
    B = 64

    def f(bw, cbps):
        for c in range(2):
            warm = [2 ** 23 - 1, -2 ** 23, 2 ** 23 - 5]
            res = [int(v) for v in rng.integers(-2 ** 22, 2 ** 22, B - 3)]
            sub_lpc_res(bw, warm, [16383, -16384, 16000 - c], c, cbps[c],
                        res, 21)
    blob, _ = _stream(24, 2, [frame(0, B, 24, 1, f)], [np.zeros((B, 2))], B)
    return blob, None


def case_escape_raw0(rng):
    """Escaped partitions of 0-bit values: the residuals are all zero."""
    B = 64
    x = 1000 + 37 * np.arange(B)                 # order-2 residuals are 0

    def f(bw, cbps):
        sub_fixed(bw, x, 2, cbps[0], k=0, escape=True)  # raw width 18
        sub_fixed_parts(bw, x, 2, cbps[0], [("raw", 0)] * 4)
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([x, x], 1)], B)


def case_escape_wide(rng):
    """Escaped partitions of 31-bit values beside Rice ones."""
    B = 128
    x = rng.integers(-2 ** 23, 2 ** 23, B)
    y = _walk(rng, B, 50)

    def f(bw, cbps):
        sub_fixed_parts(bw, x, 0, cbps[0], [("raw", 31), 22, ("raw", 25),
                                            ("raw", 31)])
        sub_fixed_parts(bw, y, 1, cbps[1], [6, ("raw", 31)])
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([x, y], 1)], B)


def case_partitions(rng):
    """Partition orders 4 and 1, parameters 0 to 30."""
    B = 256
    x = _walk(rng, B, 2000)
    y = rng.integers(-2 ** 20, 2 ** 20, B)

    def f(bw, cbps):
        sub_fixed_parts(bw, x, 1, cbps[0], [10, 0, 30, 11, 12, 9, 14, 17,
                                            10, 11, 12, 13, 25, 10, 11, 12])
        sub_fixed_parts(bw, y, 2, cbps[1], [22, 23])
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([x, y], 1)], B)


def case_long_quotients(rng):
    """Quotients longer than a 57-bit word (k = 0 on residuals of
    hundreds) and ones that straddle its end (k = 18 on 24-bit noise)."""
    B = 160
    x = _walk(rng, B, 300)
    y = rng.integers(-2 ** 23, 2 ** 23, B)

    def f(bw, cbps):
        sub_fixed_parts(bw, x, 1, cbps[0], [0, 0])
        sub_fixed_parts(bw, y, 0, cbps[1], [18, 17, 19, 16])
    return _stream(24, 2, [frame(0, B, 24, 1, f)], [np.stack([x, y], 1)], B)


def _case_stereo(ch_asgn):
    def build(rng):
        B = 96
        L = _walk(rng, B, 5000)
        R = (L * 3) // 4 + rng.integers(-300, 300, B)
        S = L - R
        first, second = {8: (L, S), 9: (S, R), 10: ((L + R) >> 1, S)}[ch_asgn]

        def f(bw, cbps):
            sub_fixed(bw, first, 2, cbps[0],
                      k=_k(fixed_residual(first, 2)), method=1)
            sub_fixed(bw, second, 1, cbps[1],
                      k=_k(fixed_residual(second, 1)))
        return _stream(24, 2, [frame(0, B, 24, ch_asgn, f)],
                       [np.stack([L, R], 1)], B)
    return build


def case_mono16(rng):
    B = 64
    x = (1000 * np.sin(np.arange(B))).astype(np.int64)

    def f(bw, cbps):
        sub_fixed(bw, x, 2, cbps[0], k=8)
    return _stream(16, 1, [frame(0, B, 16, 0, f)], [x[:, None]], B)


def case_bits12(rng):
    """12-bit stereo, the sample size in the frame header (code 2)."""
    B = 80
    L = rng.integers(-2048, 2048, B)
    R = np.clip(_walk(rng, B, 40), -2048, 2047)

    def f(bw, cbps):
        sub_verbatim(bw, L, cbps[0])
        sub_fixed(bw, R, 1, cbps[1], k=4)
    return _stream(12, 2, [frame_coded(0, B, 12, 1, f)],
                   [np.stack([L, R], 1)], B)


def case_bits20(rng):
    """20-bit mid/side, the sample size from STREAMINFO (code 0)."""
    B = 80
    L = np.clip(_walk(rng, B, 9000), -2 ** 19, 2 ** 19 - 1)
    R = L // 2 + rng.integers(-4000, 4000, B)

    def f(bw, cbps):
        sub_fixed(bw, (L + R) >> 1, 1, cbps[0], k=12)
        sub_fixed(bw, L - R, 0, cbps[1], k=12)
    return _stream(20, 2, [frame_coded(0, B, 20, 10, f, ss_code=0)],
                   [np.stack([L, R], 1)], B)


def _case_blocksize_code(code):
    def build(rng):
        sizes = [200, 17] if code == 6 else [4000, 1000]
        frames, expected = [], []
        for num, B in enumerate(sizes):
            x = _walk(rng, B, 700)

            def f(bw, cbps, x=x):
                sub_fixed(bw, x, 1, cbps[0], k=_k(fixed_residual(x, 1)))
            frames.append(frame_coded(num, B, 24, 0, f, bs_code=code))
            expected.append(x[:, None])
        return _stream(24, 1, frames, expected, max(sizes))
    return build


def case_streamed_length(rng):
    """STREAMINFO's total_samples 0 (a streamed encode): the reader counts
    the frames at open."""
    B = 64
    frames, expected = [], []
    for num in range(3):
        x = _walk(rng, B, 900)

        def f(bw, cbps, x=x):
            sub_fixed(bw, x, 1, cbps[0], k=_k(fixed_residual(x, 1)))
        frames.append(frame(num, B, 24, 0, f))
        expected.append(x[:, None])
    return _stream(24, 1, frames, expected, B, total=0)


CASES = {
    "constant": case_constant,
    "verbatim_wasted": case_verbatim_wasted,
    **{f"fixed{o}": _case_fixed(o) for o in range(5)},
    **{f"lpc{o}": _case_lpc(o) for o in (1, 2, 5, 8, 12, 13, 32)},
    "lpc_pairs": case_lpc_pairs,
    "lpc_wrap": case_lpc_wrap,
    "escape_raw0": case_escape_raw0,
    "escape_wide": case_escape_wide,
    "partitions": case_partitions,
    "long_quotients": case_long_quotients,
    "left_side": _case_stereo(8),
    "side_right": _case_stereo(9),
    "mid_side": _case_stereo(10),
    "mono16": case_mono16,
    "bits12": case_bits12,
    "bits20": case_bits20,
    "blocksize_code6": _case_blocksize_code(6),
    "blocksize_code7": _case_blocksize_code(7),
    "streamed_length": case_streamed_length,
}


def _readers(path):
    nat = flac_mod._NativeFlacReader(path)
    pure = PureFlacReader(path)
    assert (nat.samplerate, nat.channels, nat.bits, nat.frames) == \
        (pure.samplerate, pure.channels, pure.bits, pure.frames)
    return nat, pure


def _native_ints(reader, n=-1):
    return reader.read_int24(n).astype(np.int64) >> (24 - reader.bits)


@pytest.mark.parametrize("name", list(CASES))
def test_native_equals_pure_bit_for_bit(tmp_path, name):
    blob, expected = CASES[name](np.random.default_rng(sorted(CASES)
                                                       .index(name)))
    p = tmp_path / f"{name}.flac"
    p.write_bytes(blob)
    nat, pure = _readers(p)
    got = _native_ints(nat)
    np.testing.assert_array_equal(got, pure.read_int_raw(-1))
    if expected is not None:
        assert nat.frames == len(expected)
        np.testing.assert_array_equal(got, expected)
    else:
        assert len(got) == nat.frames


# ---------------------------------------------------------------------------
# malformed frames: the reader returns the frames before them
# ---------------------------------------------------------------------------

def _good_frame(rng, num, B=16):
    x = _walk(rng, B, 100)

    def f(bw, cbps):
        sub_fixed(bw, x, 1, cbps[0], k=_k(fixed_residual(x, 1)))
    return frame(num, B, 24, 0, f), x[:, None]


def _bad_lpc_order(bw, cbps):
    bw.bits(0, 1)
    bw.bits(32 + 31, 6)                  # LPC order 32 on a 16-sample block
    bw.bits(0, 1)
    for _ in range(32):
        bw.sbits(1, cbps[0])
    bw.bits(11, 4)
    bw.bits(0, 5)
    for _ in range(32):
        bw.sbits(1, 12)
    rice_residual(bw, [], 32, 16, k=0)


def _bad_fixed_order(bw, cbps):
    bw.bits(0, 1)
    bw.bits(8 + 4, 6)                    # FIXED order 4 on a 3-sample block
    bw.bits(0, 1)
    for _ in range(4):
        bw.sbits(1, cbps[0])
    rice_residual(bw, [], 4, 3, k=0)


def _bad_wasted(bw, cbps):
    bw.bits(0, 1)
    bw.bits(1, 6)
    bw.bits(1, 1)
    bw.unary(30)                         # 31 wasted bits of 24
    for _ in range(16):
        bw.sbits(0, 1)


def _bad_precision(bw, cbps):
    bw.bits(0, 1)
    bw.bits(32 + 1, 6)                   # LPC order 2
    bw.bits(0, 1)
    bw.sbits(5, cbps[0])
    bw.sbits(6, cbps[0])
    bw.bits(15, 4)                       # precision code 15: invalid
    bw.bits(0, 5)
    bw.sbits(1, 16)
    bw.sbits(1, 16)
    rice_residual(bw, [0] * 14, 2, 16, k=0)


BAD = {"lpc_order_over_blocksize": (_bad_lpc_order, 16),
       "fixed_order_over_blocksize": (_bad_fixed_order, 3),
       "wasted_bits_overflow": (_bad_wasted, 16),
       "precision_code_15": (_bad_precision, 16)}


@pytest.mark.parametrize("name", list(BAD) + ["bad_sync", "truncated"])
def test_malformed_frame_ends_the_read(tmp_path, name):
    """Two good frames, then the bad one, then a good one: both readers
    return the first two frames and nothing of the rest."""
    rng = np.random.default_rng(len(name))
    f0, x0 = _good_frame(rng, 0)
    f1, x1 = _good_frame(rng, 1)
    f3, _ = _good_frame(rng, 3)
    if name in BAD:
        build, B = BAD[name]
        bad = frame(2, B, 24, 0, build)
    else:
        bad, _ = _good_frame(rng, 2)
        if name == "bad_sync":
            bad = bytes([bad[0], bad[1] ^ 0x04]) + bad[2:]
        else:
            f3, bad = b"", bad[:len(bad) // 2]
    blob = b"fLaC" + streaminfo(SR, 1, 24, 64, 16) + f0 + f1 + bad + f3
    p = tmp_path / "bad.flac"
    p.write_bytes(blob)
    nat, pure = _readers(p)
    got = _native_ints(nat)
    np.testing.assert_array_equal(got, pure.read_int_raw(-1))
    np.testing.assert_array_equal(got, np.concatenate([x0, x1]))
    assert _native_ints(nat).shape == (0, 1)      # and stays at the fault


# ---------------------------------------------------------------------------
# files from the port's encoder
# ---------------------------------------------------------------------------

def programme(seconds, seed=0):
    """Stereo tones plus noise in passages of 2-5 s that alternate between
    a quiet and a loud level, as the benchmark's traffic is made."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = np.empty(n, np.float32)
    pos, loud = 0, False
    while pos < n:
        m = int(rng.uniform(2, 5) * SR)
        env[pos:pos + m] = 0.35 if loud else 0.02
        pos, loud = pos + m, not loud
    tone = (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 1000 * t)
            + 0.25 * np.sin(2 * np.pi * 4000 * t))
    x = np.stack([tone, 0.8 * tone], 1) + 0.3 * rng.standard_normal((n, 2))
    return np.clip(env[:, None] * x, -1, 1).astype(np.float32)


def _written(path, seconds, seed):
    """Write a programme with the port's encoder; its samples as ints."""
    x = programme(seconds, seed)
    with flac_mod.FlacWriter(path, SR, 2, "PCM_24") as w:
        w.write(x)
    s = float(1 << 23)
    return np.clip(np.rint(x * s), -s, s - 1).astype(np.int64)


def _frame_ends(path):
    """Byte offset after each frame, and its samples, by the pure reader."""
    pure = PureFlacReader(path)
    ends, lens = [], []
    while True:
        frm = pure._decode_frame()
        if frm is None:
            return np.asarray(ends), np.asarray(lens)
        ends.append(pure._byte_pos)
        lens.append(len(frm))


@pytest.fixture(scope="module")
def short_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("flac") / "short.flac"
    ints = _written(p, 1.5, seed=3)
    ends, lens = _frame_ends(p)
    assert lens.sum() == len(ints) and len(ends) > 10
    return p, ints, ends, lens


_rng_cuts = np.random.default_rng(20)


@pytest.mark.parametrize("back", list(range(1, 65))
                         + [int(b) for b in _rng_cuts.integers(65, 150000,
                                                               12)])
def test_truncated_file_returns_the_frames_before_the_cut(tmp_path,
                                                          short_file, back):
    """A file cut `back` bytes before its end (past the metadata) reads as
    exactly the frames that end at or before the cut."""
    p, ints, ends, lens = short_file
    blob = p.read_bytes()
    cut = max(len(blob) - back, int(ends[0]) - 300)
    q = tmp_path / "cut.flac"
    q.write_bytes(blob[:cut])
    want = int(lens[ends <= cut].sum())
    nat = flac_mod._NativeFlacReader(q)
    got = _native_ints(nat)
    np.testing.assert_array_equal(got, ints[:want])


@pytest.mark.parametrize("damage", ["zeros", "ff"])
@pytest.mark.parametrize("where", [0.2, 0.5, 0.83])
def test_damaged_file_reads_within_bounds(tmp_path, short_file, damage,
                                          where):
    """A 32-byte window of zeros or one 0xFF byte mid-file: the frames
    before the damaged one read as written, the read stops at a frame's
    end, and no more samples come back than the file holds (CRCs are not
    checked, so a damaged frame may also decode to other samples)."""
    p, ints, ends, lens = short_file
    blob = bytearray(p.read_bytes())
    off = int(ends[0] + where * (len(blob) - ends[0]))
    if damage == "zeros":
        blob[off:off + 32] = bytes(32)
    else:
        blob[off] = 0xFF
    q = tmp_path / "damaged.flac"
    q.write_bytes(bytes(blob))
    nat = flac_mod._NativeFlacReader(q)
    got = _native_ints(nat)
    intact = int(lens[ends <= off].sum())
    assert intact <= len(got) <= len(ints)
    assert len(got) in set(np.cumsum(lens).tolist())
    np.testing.assert_array_equal(got[:intact], ints[:intact])


@pytest.fixture(scope="module")
def minute_file(tmp_path_factory):
    """A 60 s stereo PCM_24 programme from the port's encoder, its
    samples, and the pure decoder's reading of it."""
    p = tmp_path_factory.mktemp("flac") / "minute.flac"
    ints = _written(p, 60, seed=11)
    pure = PureFlacReader(p).read_int_raw(-1)
    np.testing.assert_array_equal(pure, ints)
    return p, ints


@pytest.mark.parametrize("size", [2 ** 21, 65536, 4095, 4097])
def test_minute_read_in_pieces(minute_file, size):
    p, ints = minute_file
    nat = flac_mod._NativeFlacReader(p)
    pieces = []
    while True:
        piece = _native_ints(nat, size)
        pieces.append(piece)
        if len(piece) < size:
            break
    assert nat.tell() == len(ints)
    np.testing.assert_array_equal(np.concatenate(pieces), ints)


@pytest.mark.parametrize("start", [4096 * 351 + 1234, 2 ** 21 + 7,
                                   60 * SR - 5000])
def test_minute_seek_mid_frame(minute_file, start):
    p, ints = minute_file
    nat = flac_mod._NativeFlacReader(p)
    assert nat.seek(start) == start
    got = _native_ints(nat, 9000)
    np.testing.assert_array_equal(got, ints[start:start + 9000])
