"""Wire codec: lossless PCM_24 compression for the host<->device link,
port of tomatis_tpu/ops/wire.py.

The codec cuts the bytes of both link directions with a lossless scheme
chosen so that both endpoints can run their half efficiently:

- residuals from the best FIXED predictor of order 0..4 (k-fold first
  difference). Restore is k cumulative sums, embarrassingly parallel, so
  the device can decode the host-encoded input with cumsum calls instead
  of a sequential IIR (a general LPC would serialise).
- optional mid/side decorrelation (FLAC-style, integer-exact).
- per-256-sample-block fixed bit-width storage in BIT-PLANE layout (see
  below): block b stores w[b] planes of 8 words each, so blocks are
  word-aligned and the whole pack/unpack is a dense 32x32 bit transpose
  (5 masked-shift vector ops) plus ONE octet-granularity row gather, with
  no per-sample scatter/gather anywhere.
- a raw PCM_24 escape when packing would exceed raw size.
- a per-block RICE mode when it beats the fixed width: the per-sample
  Rice code (parameter k) is SPLIT into a dense k-bit remainder field
  stored in the same bit-plane layout, plus a separate unary stream
  (terminator bitmap), so the device side never packs variable-length
  codes: remainders ride the dense transpose, quotients one bounded
  scatter-add of terminator bits, and decode recovers quotients from
  popcount prefix sums.
- FLAC-style WASTED BITS, per stream channel: when every sample of a
  (post-decorrelation) channel shares k trailing zero bits (16-bit-sourced
  PCM_24 material has k=8 everywhere) the channel is stored right-shifted
  by k and the decoder shifts back after the prediction cumsums. k rides
  the flags word, so a k=0 stream is byte-identical to the format without
  it. Host encoders always detect it (one OR-reduce per channel); the
  device-side pack never emits it (processed audio is quantised from
  floats, where common trailing zeros are measure-zero).

The same format runs in three implementations that must agree bit for
bit: numpy (oracle + fallback, this file, a copy of the reference's),
C++ (csrc/wire.cpp, the production host side, a copy too), and torch ops
on a tensor of any device (pack_device / unpack_device below, the
production device side). torch is imported inside those two functions
only, so the numpy half imports no torch.

What the device half does NOT carry over from the reference: the 1 MB
output pages and 64 KB tail buckets (they bound the count of compiled
XLA executables; eager torch has none), the caller-supplied padded tail
of unpack_device (the same reason) and the used-words count riding two
float halves of the aux array (a denormal-flush work-around of the TPU).
pack_device returns ``used`` as an int32 tensor; the stream runner reads
it in its one small readback and copies ``words[:used]``. Words are
carried as int32 (torch has few uint32 operators): same bits, and every
right shift of a value that may have bit 31 set is masked to a logical
one. The data-dependent switches (winning predictor, raw escape, restore
order) are computed branch-free with index_select / where, so neither
function synchronises with the host.

Layout (little-endian u32 words):
    word 0   magic 0x54574333 ('TWC3')
    word 1   n samples per channel
    word 2   K = ceil(n / 256) blocks per channel
    word 3   flags = channels | order << 8 | midside << 16 | raw << 17
             | k0 << 18 | k1 << 23 (k0/k1: wasted bits of stream
             channel 0/1, 0..23; defined for ch <= 2, else must be 0;
             always 0 when raw)
    word 4   used_words (total length of the stream, in u32 words)
    desc:    ceil(2*ch*K / 4) words: TWO bytes per block, channel-major.
             byte0 = rice << 7 | width (rice: remainder width k 0..24;
             maxw: plane width w in {0, 4..30}); byte1 = unary word
             count uw (rice: 8..64, else 0). Block plane length =
             8*(byte0 & 0x7F) words; unary length = byte1 words.
    planes:  ALL blocks' plane regions, channel-major, concatenated:
             8*(byte0 & 0x7F) words per block ("octets" of 8 words),
             so the region stays octet-aligned for the device's wide
             row gathers. maxw block: w planes of the residual, two's
             complement truncated to w bits; plane o, word j, bit i =
             bit o of sample 32j + (31-i) (the bit-reversed lane order
             is the natural output of the masked-shift transpose; all
             three implementations share it). rice block: k planes of
             zigzag(residual) & (2^k - 1). w/k = 0: block omitted.
    unary:   ALL rice blocks' unary regions, channel-major,
             concatenated after the planes: uw words per rice block.
             Bit p of a block's region (word p>>5, bit p&31, LSB-first)
             set iff p terminates a sample's quotient run; all 256
             samples emit codes (pad positions encode zigzag 0), so a
             region holds exactly 256 set bits and sample i's quotient
             is q_i = p_i - p_{i-1} - 1 over the ascending terminator
             positions. Residual = unzigzag((q << k) | remainder).
    raw:     ceil(n*ch*3 / 4) words of interleaved sample-major
             little-endian 24-bit PCM (no desc region).

Per-block mode decision (identical in all three implementations):
    w = max-width as before; w == 0 -> empty maxw block. Else scan
    k = 0..min(w-1, 24) ascending: U_k = 256 + sum(zigzag >> k) over all
    256 positions; k is valid iff U_k <= 2048 (uw <= 64, bounding the
    device buffers); cost_k = 8k + ceil(U_k / 32) words, first strict
    minimum wins. Rice iff some k is valid and its cost < 8w. Every
    block therefore uses <= 8*w <= 240 words, so the worst-case buffer
    bound is unchanged from the fixed-width format.
"""
from __future__ import annotations


import numpy as np

MAGIC = 0x54574333
B = 256               # samples per width block
_WMAX = 30            # side channel at order 4 needs up to 25+4+1 bits
_KMAX = 24            # rice remainder width cap
_UWMAX = 64           # rice unary region cap (words)


# ---------------------------------------------------------------------------
# Shared helpers (numpy)
# ---------------------------------------------------------------------------

def n_blocks(n: int) -> int:
    return -(-n // B)


def header_words(n: int, ch: int) -> int:
    """Words before the bitstreams in the packed layout (header + the
    2-byte-per-block desc region)."""
    return 5 + (2 * ch * n_blocks(n) + 3) // 4


def raw_words(n: int, ch: int) -> int:
    return 5 + (n * ch * 3 + 3) // 4


def max_words(n: int, ch: int) -> int:
    """Static worst-case buffer size (packed layout cap; the raw escape
    guarantees used_words <= raw_words, but the packed layout is what the
    fixed-size device buffer must be able to hold)."""
    return header_words(n, ch) + 8 * _WMAX * ch * n_blocks(n)


# byte-level PCM_24 converters live in utils.pcm; re-exported here because
# the wire format is their main consumer
from tomatis_tpu_torch.utils.pcm import i32_from_le24, le24_from_i32  # noqa: E402,F401


def _midside_fwd_np(v: np.ndarray) -> np.ndarray:
    L = v[:, 0]
    R = v[:, 1]
    return np.stack([(L + R) >> 1, L - R], 1)


def _midside_inv_np(v: np.ndarray) -> np.ndarray:
    m = v[:, 0]
    s = v[:, 1]
    L = m + ((s + (s & 1)) >> 1)
    return np.stack([L, L - s], 1)


def _diff_np(x: np.ndarray) -> np.ndarray:
    """First difference along axis 1 with implicit leading zero."""
    r = x.copy()
    r[:, 1:] -= x[:, :-1]
    return r


def _widths_np(r: np.ndarray) -> np.ndarray:
    """Per-block bit widths for residuals r [ch, n] -> [ch, K] (u8)."""
    ch, n = r.shape
    K = n_blocks(n)
    pad = K * B - n
    rp = np.pad(r, ((0, 0), (0, pad))).reshape(ch, K, B)
    u = (rp ^ (rp >> 31)).astype(np.uint32)   # NB: maps -1 -> 0 (1 bit)
    umax = u.max(axis=2)
    bits = np.frexp(umax.astype(np.float64))[1]  # exact for ints < 2^53
    w = np.maximum(4, bits + 1)
    anynz = (rp != 0).any(axis=2)
    return np.where(anynz, w, 0).astype(np.uint8)


def _bit_transpose32_np(x: np.ndarray) -> np.ndarray:
    """Masked-shift 32x32 bit transpose over the last axis (len 32, u32).

    Involution. Output y[..., l] bit i == x[..., 31-i] bit (31-l) - the
    orientation the wire stream layout is defined around."""
    x = x.astype(np.uint32)
    m = np.uint32(0x0000FFFF)
    j = 16
    while j:
        shp = x.shape[:-1]
        y = x.reshape(shp + (32 // (2 * j), 2, j))
        a = y[..., 0, :]
        b = y[..., 1, :]
        t = (a ^ (b >> np.uint32(j))) & m
        x = np.stack([a ^ t, b ^ (t << np.uint32(j))],
                     axis=-2).reshape(shp + (32,))
        j >>= 1
        m = m ^ (m << np.uint32(j))
    return x


def _planes_fwd_np(z: np.ndarray) -> np.ndarray:
    """Masked residuals z [T, 256] u32 -> plane octets [T, 30, 8] u32.

    planes[t, o, j] = plane o of samples 32j..32j+31 of block t (bit i =
    bit o of sample 32j+31-i)."""
    T = z.shape[0]
    X = _bit_transpose32_np(z.reshape(T, 8, 32))     # [t, j, l]
    # plane o lives in transform lane 31-o; reverse lanes, swap (j, o)
    return np.swapaxes(X[:, :, ::-1], 1, 2)[:, :_WMAX, :]


def _planes_inv_np(planes: np.ndarray) -> np.ndarray:
    """Plane octets [T, 30, 8] u32 -> residual values [T, 256] u32
    (masked to each block's width; callers sign-extend)."""
    T = planes.shape[0]
    Xr = np.zeros((T, 32, 8), np.uint32)
    Xr[:, :_WMAX] = planes
    X = np.swapaxes(Xr, 1, 2)[:, :, ::-1]            # [t, j, l]
    return _bit_transpose32_np(X).reshape(T, 256)


# ---------------------------------------------------------------------------
# numpy encoder / decoder (oracle + host fallback)
# ---------------------------------------------------------------------------

def _rice_plan_np(rp: np.ndarray, wflat: np.ndarray):
    """Per-block mode decision on blocked residuals rp [T, B] int32 with
    max-widths wflat [T]. Returns (rice [T] bool, k [T], uw [T], words [T])
    — the format's deterministic k search (ascending, first strict min)."""
    T = rp.shape[0]
    r64 = rp.astype(np.int64)
    zz = ((r64 << 1) ^ (r64 >> 63)).astype(np.int64)      # zigzag < 2^w
    ks = np.arange(_KMAX + 1, dtype=np.int64)
    qs = (zz[:, None, :] >> ks[None, :, None]).sum(axis=2)  # [T, K+1]
    U = B + qs
    uw = -(-U // 32)
    valid = (ks[None, :] < wflat[:, None]) & (U <= 8 * B)
    cost = np.where(valid, 8 * ks[None, :] + uw, 1 << 30)
    kbest = np.argmin(cost, axis=1)                       # first minimum
    cbest = cost[np.arange(T), kbest]
    rice = (wflat > 0) & (cbest < 8 * wflat)
    k = np.where(rice, kbest, 0).astype(np.int64)
    uwb = np.where(rice, uw[np.arange(T), kbest], 0).astype(np.int64)
    words = np.where(rice, cbest, 8 * wflat).astype(np.int64)
    return rice, k, uwb, words


def _unary_words_np(zz_row: np.ndarray, k: int, uw: int) -> np.ndarray:
    """Unary terminator words (LSB-first bits) for one rice block."""
    q = zz_row >> k
    p = np.cumsum(q + 1) - 1
    bits = np.zeros(uw * 32, np.uint8)
    bits[p] = 1
    return (bits.reshape(uw, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)


def _wasted_bits_np(xT: np.ndarray) -> np.ndarray:
    """Per-channel wasted-bit counts of a [ch, n] int32 array: the
    trailing zero bits shared by EVERY sample (tz of the OR), capped at
    23; 0 for all-zero channels and for ch > 2 (format limit)."""
    ch = xT.shape[0]
    if ch > 2 or xT.shape[1] == 0:
        return np.zeros(ch, np.int32)
    acc = np.bitwise_or.reduce(xT.astype(np.uint32), axis=1)
    out = np.zeros(ch, np.int32)
    for c in range(ch):
        a = int(acc[c])
        out[c] = min((a & -a).bit_length() - 1, 23) if a else 0
    return out


def encode_np(v: np.ndarray, rice: bool = True,
              wasted: bool = True) -> np.ndarray:
    """int32 PCM_24 samples [n, ch] -> packed uint8 array (exact size).

    rice=False disables the per-block Rice mode (every block stored at
    its fixed max width — still a valid TWC3 stream, ~4% larger on
    program material). The engine's input direction runs rice-free: the
    device half of rice (unary select/scatter) costs more device time
    than the bytes it saves cost a PCIe copy. All three implementations
    accept the same switch and stay bit-identical for either setting.

    wasted=False disables wasted-bits detection (then bit-identical to
    pack_device, which never emits it — see the module docstring).
    """
    v = np.ascontiguousarray(v, np.int32)
    if v.ndim == 1:
        v = v[:, None]
    n, ch = v.shape
    K = n_blocks(n)
    H = header_words(n, ch)

    variants = [v.T]                       # [ch, n] channel-major
    if ch == 2:
        variants.append(_midside_fwd_np(v).T)
    best = None
    for ms, x0 in enumerate(variants):
        kbits = _wasted_bits_np(x0) if wasted \
            else np.zeros(ch, np.int32)
        r = x0 >> kbits[:, None]           # exact: common trailing zeros
        for o in range(5):
            w = _widths_np(r)
            total = H + 8 * int(w.sum(dtype=np.int64))
            if best is None or total < best[0]:
                best = (total, o, ms, w, r.copy(), kbits)
            r = _diff_np(r)
    _, order, ms, w, r, kbits = best

    wflat = w.reshape(-1).astype(np.int64)           # [T = ch*K]
    pad = K * B - n
    rp = np.pad(r, ((0, 0), (0, pad))).reshape(ch * K, B)
    if rice:
        rice_f, kb, uwb, bwords = _rice_plan_np(rp, wflat)
    else:
        rice_f = np.zeros(ch * K, bool)
        kb = uwb = np.zeros(ch * K, np.int64)
        bwords = 8 * wflat
    total = H + int(bwords.sum())

    RW = raw_words(n, ch)
    if total >= RW:
        out = np.zeros(RW * 4, np.uint8)
        _put_header(out, n, K, ch, 0, 1, RW)
        flat = v.reshape(-1)
        out[20:20 + flat.size * 3] = le24_from_i32(flat)
        return out

    out = np.zeros(total * 4, np.uint8)
    k0 = int(kbits[0])
    k1 = int(kbits[1]) if ch == 2 else 0
    _put_header(out, n, K, ch,
                (order << 8) | (ms << 16) | (k0 << 18) | (k1 << 23),
                0, total)
    T = ch * K
    desc = np.zeros(2 * T, np.uint8)
    noct = np.where(rice_f, kb, wflat)
    desc[0::2] = (rice_f.astype(np.uint8) << 7) | noct.astype(np.uint8)
    desc[1::2] = uwb
    out[20:20 + 2 * T] = desc

    r64 = rp.astype(np.int64)
    zz = ((r64 << 1) ^ (r64 >> 63)).astype(np.int64)
    mask = np.where(noct > 0, (np.int64(1) << noct) - 1, 0)
    zsel = np.where(rice_f[:, None], zz, r64) & mask[:, None]
    planes = _planes_fwd_np(zsel.astype(np.uint32))  # [T, 30, 8]

    words = out.view(np.uint32)
    pos = H
    for t in range(T):
        no = int(noct[t])
        if no:
            words[pos:pos + 8 * no] = planes[t, :no].reshape(-1)
            pos += 8 * no
    for t in range(T):
        if rice_f[t]:
            uw = int(uwb[t])
            words[pos:pos + uw] = _unary_words_np(zz[t], int(kb[t]), uw)
            pos += uw
    return out


def _put_header(out: np.ndarray, n, K, ch, flaghi, raw, used):
    hdr = np.array([MAGIC, n, K, ch | flaghi | (raw << 17), used], np.uint32)
    out[:20] = hdr.view(np.uint8)


def decode_np(buf: np.ndarray) -> np.ndarray:
    """packed uint8 array -> int32 PCM samples [n, ch]."""
    buf = np.ascontiguousarray(buf, np.uint8)
    hdr = buf[:20].view(np.uint32)
    if hdr[0] != MAGIC:
        raise ValueError(f"bad wire magic {hdr[0]:#x}")
    n = int(hdr[1])
    K = int(hdr[2])
    flags = int(hdr[3])
    ch = flags & 0xFF
    order = (flags >> 8) & 0xFF
    ms = (flags >> 16) & 1
    raw = (flags >> 17) & 1
    k0 = (flags >> 18) & 31
    k1 = (flags >> 23) & 31
    used = int(hdr[4])
    if raw:
        if buf.size < 20 + n * ch * 3:
            raise ValueError(f"malformed wire buffer: raw payload needs "
                             f"{20 + n * ch * 3} bytes, have {buf.size}")
        return i32_from_le24(buf[20:20 + n * ch * 3]).reshape(n, ch)

    H = header_words(n, ch)
    if used < 5 or used * 4 > buf.size:   # used counts whole u32 words
        raise ValueError(f"malformed wire buffer: used={used} words vs "
                         f"{buf.size} bytes")
    if K != n_blocks(n) or ch < 1:
        raise ValueError(f"malformed wire buffer: K={K} for n={n}, "
                         f"ch={ch}")
    if order > 4:
        raise ValueError(f"malformed wire buffer: order={order} > 4")
    if ms and ch != 2:
        raise ValueError(f"malformed wire buffer: midside with ch={ch}")
    if k0 > 23 or k1 > 23 or (ch > 2 and (k0 or k1)) \
            or (ch == 1 and k1):
        raise ValueError(f"malformed wire buffer: wasted bits "
                         f"k0={k0} k1={k1} for ch={ch}")
    T = ch * K
    desc = buf[20:20 + 2 * T]
    rice = (desc[0::2] >> 7).astype(bool)
    noct = (desc[0::2] & 0x7F).astype(np.int64)
    uw = desc[1::2].astype(np.int64)
    if (noct > _WMAX).any() or (rice & (noct > _KMAX)).any():
        raise ValueError("malformed wire buffer: block width out of range")
    if (uw > _UWMAX).any() or (~rice & (uw != 0)).any() \
            or (rice & (uw < 8)).any():
        raise ValueError("malformed wire buffer: bad unary word count")
    total = int((8 * noct + uw).sum())
    if used != H + total:
        raise ValueError(f"malformed wire buffer: used={used} != "
                         f"H+sum(block words)={H + total}")
    words = buf[:used * 4].view(np.uint32)
    planes = np.zeros((T, _WMAX, 8), np.uint32)
    S = int(noct.sum())
    src_t = np.repeat(np.arange(T), noct)
    src_p = np.arange(S) - np.repeat(np.cumsum(noct) - noct, noct)
    planes[src_t, src_p] = words[H:H + 8 * S].reshape(S, 8)
    ustarts = H + 8 * S + np.cumsum(uw) - uw         # unary region offsets
    z = _planes_inv_np(planes)                       # [T, 256] u32

    r = np.zeros((T, B), np.int64)
    # maxw blocks: two's-complement sign extension by width
    mb = ~rice
    wb = noct[:, None]
    sb = np.where(wb > 0, np.int64(1) << np.maximum(wb - 1, 0), 0) \
        .astype(np.uint32)
    sv = (z ^ sb).astype(np.int64) - sb.astype(np.int64)
    r[mb] = np.where(wb[mb] == 0, 0, sv[mb])
    # rice blocks: quotients from the unary terminator bitmaps
    for t in np.nonzero(rice)[0]:
        k = int(noct[t])
        s = int(ustarts[t])
        un = words[s:s + int(uw[t])]
        bits = ((un[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
                & 1).reshape(-1)
        p = np.nonzero(bits)[0]
        if len(p) != B:
            raise ValueError("malformed wire buffer: unary region must "
                             f"hold {B} terminators, found {len(p)}")
        q = np.diff(np.concatenate([[-1], p])) - 1
        u = (q.astype(np.int64) << k) | z[t].astype(np.int64)
        r[t] = (u >> 1) ^ -(u & 1)
    r = r.astype(np.int32).reshape(ch, K * B)[:, :n]
    for _ in range(order):
        r = np.cumsum(r, axis=1, dtype=np.int32)
    if k0 or k1:   # undo wasted-bits strip (before the ms inverse)
        kv = np.array([k0, k1][:ch], np.int32)[:, None]
        r = np.left_shift(r, kv)
    v = r.T
    if ms:
        v = _midside_inv_np(v)
    return np.ascontiguousarray(v)


# ---------------------------------------------------------------------------
# torch device implementations (a tensor of any device; no host sync)
# ---------------------------------------------------------------------------

def _bit_transpose32_t(x):
    """Masked-shift 32x32 bit transpose (last axis, len 32) of int32
    words. Each mask clears the top j bits, so the arithmetic right shift
    of a word with bit 31 set reads as a logical one."""
    import torch
    m = 0x0000FFFF
    j = 16
    while j:
        shp = x.shape[:-1]
        y = x.reshape(shp + (32 // (2 * j), 2, j))
        a = y[..., 0, :]
        b = y[..., 1, :]
        t = (a ^ (b >> j)) & m
        x = torch.stack([a ^ t, b ^ (t << j)], dim=-2).reshape(shp + (32,))
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF
    return x


def _popcount32_t(x):
    """Set bits of each element of an int64 tensor holding values
    < 2^32 (torch has no population count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pack_device(v, n: int, ch: int, rice: bool = True):
    """Device-side encoder: v int32 [n, ch] tensor -> (words int32
    [max_words(n, ch)] holding the stream's u32 words bit for bit, used
    int32 0-d tensor). Zero beyond used words; ``words.view(torch.uint8)``
    is the byte stream.

    Mirrors encode_np(v, wasted=False) exactly, including the variant
    tie-break (first minimum over [lr o0..o4, ms o0..o4]) and the raw
    escape. rice is a STATIC switch: rice=False runs none of the rice
    code and emits all-maxw streams, bit-identical to
    encode_np(v, rice=False, wasted=False).
    """
    import torch

    if tuple(v.shape) != (n, ch) or v.dtype != torch.int32:
        raise ValueError(f"pack_device takes int32 [{n}, {ch}], got "
                         f"{v.dtype} {tuple(v.shape)}")
    dev = v.device
    i32 = torch.int32
    K = n_blocks(n)
    H = header_words(n, ch)
    RW = raw_words(n, ch)
    M = max_words(n, ch)
    pad = K * B - n
    T = ch * K
    S_max = 8 * _WMAX * T                            # M - H stream words

    def blocked(x):                                  # [ch, n] -> [ch, K, B]
        return torch.nn.functional.pad(x, (0, pad)).reshape(ch, K, B)

    variants = [blocked(v.t())]
    if ch == 2:
        L, R = v[:, 0], v[:, 1]
        variants.append(blocked(torch.stack([(L + R) >> 1, L - R])))

    # Candidate residuals and widths for all (variant, order) pairs in
    # the BLOCKED layout with a cross-block diff carry. The candidates
    # stay in one buffer so that the winner is one index_select by a
    # device index (no host sync, no data-dependent branch).
    thresh = 1 << torch.arange(3, _WMAX - 1, dtype=i32, device=dev)
    in_range = (torch.arange(K * B, device=dev).reshape(K, B) < n)[None]
    cand = torch.empty((5 * len(variants), ch, K, B), dtype=i32, device=dev)
    all_w, all_tot = [], []
    for vi, cur in enumerate(variants):
        for o in range(5):
            cand[5 * vi + o] = cur
            u = cur ^ (cur >> 31)                    # >= 0; maps -1 -> 0
            umax = u.amax(dim=2)                     # [ch, K]
            w = 4 + (umax[:, :, None] >= thresh).sum(dim=2)
            w = torch.where((cur != 0).any(dim=2), w, 0)
            all_w.append(w)
            all_tot.append(H + 8 * w.sum())
            if o < 4:
                # blocked first difference: shift within blocks, carry the
                # previous block's last sample; keep the pad region zero
                prev = torch.cat([torch.zeros((ch, 1), dtype=i32, device=dev),
                                  cur[:, :-1, -1]], 1)
                shifted = torch.cat([prev[:, :, None], cur[:, :, :-1]], 2)
                cur = torch.where(in_range, cur - shifted, 0)
    totals = torch.stack(all_tot)
    bi = torch.argmin(totals).reshape(1)             # first minimum
    order = bi[0] % 5
    ms = bi[0] // 5
    rp = cand.index_select(0, bi).reshape(T, B)      # winning residual
    wflat = torch.stack(all_w).index_select(0, bi).reshape(T)   # int64
    del cand

    # ---- per-block mode decision (the format's deterministic k scan) ----
    # zigzag; |r| < 2^29 when w <= 30, so the int32 shift cannot wrap and
    # zz is non-negative
    zz = (rp << 1) ^ (rp >> 31)
    if rice:
        costs, Us = [], []
        for k in range(_KMAX + 1):
            # summands capped at 8192: any capped element already exceeds
            # the 2048-bit region limit, so the validity verdict (and, for
            # valid k, the exact sum) is unchanged
            U = B + torch.clamp(zz >> k, max=8192).sum(dim=1)
            valid = (k < wflat) & (U <= 8 * B)
            costs.append(torch.where(valid, 8 * k + (U + 31) // 32,
                                     1 << 30))
            Us.append(U)
        costs = torch.stack(costs, 1)                # [T, 25]
        kbest = torch.argmin(costs, dim=1)           # first minimum
        cbest = costs.gather(1, kbest[:, None])[:, 0]
        rice_b = (wflat > 0) & (cbest < 8 * wflat)
        kb = torch.where(rice_b, kbest, 0)
        Ub = torch.stack(Us, 1).gather(1, kbest[:, None])[:, 0]
        uwb = torch.where(rice_b, (Ub + 31) // 32, 0)
        noct = torch.where(rice_b, kb, wflat)
    else:
        rice_b = torch.zeros(T, dtype=torch.bool, device=dev)
        kb = uwb = torch.zeros(T, dtype=torch.int64, device=dev)
        noct = wflat
    bwords = 8 * noct + uwb                          # [T] int64
    total = H + bwords.sum()

    use_raw = total >= RW
    used = torch.where(use_raw, RW, total).to(i32)
    flags = torch.where(use_raw, ch | (1 << 17),
                        ch | (order << 8) | (ms << 16))
    hdr = torch.stack([torch.full_like(flags, MAGIC),
                       torch.full_like(flags, n), torch.full_like(flags, K),
                       flags, used.to(torch.int64)]).to(i32)

    # ---- bit-plane transform + compaction (the packed body) ----
    # Per block: 5 masked-shift rounds turn 256 masked residuals into noct
    # 8-word planes; rice blocks emit their unary terminator words (one
    # bounded index_add) into the separate trailing unary region;
    # compaction is a gather driven by a cummax scan over the pieces at
    # fixed source strides.
    PW = 8 * _WMAX                                   # 240 words
    tt = torch.arange(T, device=dev)
    noct32 = noct.to(i32)
    mask = torch.where(noct32 > 0, (1 << noct32) - 1, 0)
    zsel = torch.where(rice_b[:, None], zz, rp) & mask[:, None]
    X = _bit_transpose32_t(zsel.reshape(T, 8, 32))   # [t, j, l]
    planes = X.flip(-1).transpose(1, 2)[:, :_WMAX]   # [t, o, j]

    if rice:
        # unary terminator bitmap per rice block: positions p_i =
        # cumsum(q+1)-1 < 2048 for rice blocks; everything else lands in
        # the spare slot. The bits of one word are disjoint, so add is or.
        q = (zz >> kb[:, None].to(i32)).to(torch.int64)
        p = torch.cumsum(q + 1, dim=1) - 1
        widx = p >> 5
        dest = torch.where(rice_b[:, None] & (widx < _UWMAX),
                           tt[:, None] * _UWMAX + widx, T * _UWMAX)
        unary = torch.zeros(T * _UWMAX + 1, dtype=i32, device=dev)
        unary.index_add_(0, dest.reshape(-1),
                         (torch.ones_like(p, dtype=i32)
                          << (p & 31).to(i32)).reshape(-1))
        unary[-1] = 0                                # the spare slot
        region_flat = torch.cat([planes.reshape(-1), unary])
        # pieces in OUTPUT order: all blocks' plane regions, then all
        # rice blocks' unary regions (the separated TWC3 layout)
        plen = torch.cat([8 * noct, uwb])            # [2T]
        psrc = torch.cat([PW * tt, PW * T + _UWMAX * tt])
        pdst = torch.cumsum(plen, 0) - plen
        corr = psrc - pdst       # nondecreasing: lengths <= src strides
        S_tot = plen.sum()
        marks = torch.zeros(S_max + 1, dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, torch.where(plen > 0, pdst, S_max), corr,
                              "amax")
        corr_s = torch.cummax(marks[:S_max], 0).values
        s = torch.arange(S_max, device=dev)
        idx = torch.where(s < S_tot, s + corr_s, region_flat.numel() - 1)
        stream = region_flat[idx]                    # [S_max]
    else:
        # Without rice every piece is 8*noct words at an 8-aligned source
        # offset (PW*t) and an 8-aligned destination, so compact 8-word
        # ROWS: an eighth of the gather's elements.
        R_max = _WMAX * T                            # S_max // 8
        rows = torch.cat([planes.reshape(R_max, 8),
                          torch.zeros((1, 8), dtype=i32, device=dev)])
        prow_dst = torch.cumsum(noct, 0) - noct
        corr_r = _WMAX * tt - prow_dst               # == word corr // 8
        rows_tot = noct.sum()
        marks = torch.zeros(R_max + 1, dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, torch.where(noct > 0, prow_dst, R_max),
                              corr_r, "amax")
        corr_s = torch.cummax(marks[:R_max], 0).values
        rr = torch.arange(R_max, device=dev)
        idxr = torch.where(rr < rows_tot, rr + corr_s, R_max)
        stream = rows[idxr].reshape(S_max)

    # block descriptors: two bytes per block, read back as LE words
    d8 = torch.zeros((H - 5) * 4, dtype=torch.uint8, device=dev)
    d8[0:2 * T:2] = ((rice_b.to(i32) << 7) | noct32).to(torch.uint8)
    d8[1:2 * T:2] = uwb.to(torch.uint8)
    packed_body = torch.cat([d8.view(i32), stream])  # [M - 5]

    # ---- the raw escape: interleaved LE 24-bit PCM, no desc region ----
    pcm = v.reshape(-1).clone().view(torch.uint8).reshape(-1, 4)[:, :3] \
        .reshape(-1)
    pcm = torch.nn.functional.pad(pcm, (0, (M - 5) * 4 - pcm.numel()))
    body = torch.where(use_raw, pcm.view(i32), packed_body)
    return torch.cat([hdr, body]), used


def unpack_device(buf, n: int, ch: int, rice: bool = True):
    """Device-side decoder: buf uint8 [>= used bytes, a multiple of 4] or
    int32 words -> float32 [n, ch] (PCM_24 scale v / 2^23). The order,
    mid/side, wasted-bits and raw flags are data; all handled with where.

    rice is a STATIC switch: rice=False runs none of the unary-region
    decode and is only correct for streams encoded with rice disabled
    (all-maxw blocks). The engine pairs encoder and decoder settings; the
    general host decoders accept either stream.

    A corrupt stream never indexes out of range (widths and offsets are
    clamped); what it decodes to is unspecified."""
    import torch

    i32, i64 = torch.int32, torch.int64
    K = n_blocks(n)
    H = header_words(n, ch)
    T = ch * K
    if buf.dtype == i32:
        words = buf.reshape(-1)
    elif buf.dtype == torch.uint8 and buf.numel() % 4 == 0:
        words = buf.reshape(-1).view(i32)
    else:
        raise ValueError("unpack_device takes int32 words or uint8 bytes "
                         "in whole words")
    W = words.numel()
    if W < H:
        raise ValueError(f"wire buffer of {W} words is shorter than the "
                         f"{H}-word header of n={n}, ch={ch}")
    dev = words.device
    flags = words[3]
    order = (flags >> 8) & 0xFF
    ms = (flags >> 16) & 1
    raw = (flags >> 17) & 1
    # wasted-bits counts (clamped: a corrupt stream must not produce an
    # out-of-range shift)
    k0 = torch.clamp((flags >> 18) & 31, max=23)
    k1 = torch.clamp((flags >> 23) & 31, max=23)

    # ---- packed stream ----
    desc = words[5:H].view(torch.uint8)[:2 * T].reshape(T, 2).to(i64)
    b0, b1 = desc[:, 0], desc[:, 1]
    rice_b = b0 >> 7
    noct = torch.clamp(b0 & 0x7F, max=_WMAX)         # corrupt widths: clamp
    uw = torch.clamp(torch.where(rice_b == 1, b1, 0), max=_UWMAX)
    # plane rows of 8 words; row nrows is a zero row for every plane a
    # block does not store and for offsets beyond the buffer
    nrows = (W - H) // 8
    rows = torch.cat([words[H:H + 8 * nrows].reshape(nrows, 8),
                      torch.zeros((1, 8), dtype=i32, device=dev)])
    prow = torch.cumsum(noct, 0) - noct
    o = torch.arange(_WMAX, device=dev)[None, :]
    ridx = torch.where(o < noct[:, None],
                       torch.clamp(prow[:, None] + o, max=nrows), nrows)
    planes = rows[ridx]                              # [T, 30, 8]
    Xr = torch.cat([planes,
                    torch.zeros((T, 32 - _WMAX, 8), dtype=i32, device=dev)],
                   1)
    X = Xr.transpose(1, 2).flip(-1)                  # [t, j, l]
    z = _bit_transpose32_t(X).reshape(T, B)          # < 2^30, non-negative
    wb = noct[:, None].to(i32)
    # maxw blocks: two's-complement sign extension by width
    sb = torch.where(wb > 0, 1 << torch.clamp(wb - 1, min=0), 0)
    r = torch.where(wb == 0, 0, (z ^ sb) - sb)

    if rice:
        # rice blocks: quotients from the unary terminator bitmaps via
        # popcount prefix sums, no sequential bit walking
        ustart = H + 8 * noct.sum() + torch.cumsum(uw, 0) - uw
        j = torch.arange(_UWMAX, device=dev)[None, :]
        wz = torch.cat([words, torch.zeros(1, dtype=i32, device=dev)])
        uidx = torch.where(j < uw[:, None],
                           torch.clamp(ustart[:, None] + j, max=W), W)
        uwin = wz[uidx].to(i64) & 0xFFFFFFFF         # [T, 64]
        pop = _popcount32_t(uwin)
        cum = torch.cumsum(pop, dim=1)               # [T, 64]
        i = torch.arange(B, device=dev)[None, :].expand(T, B).contiguous()
        # word holding terminator i = #{j : cum[j] <= i}
        Wi = torch.clamp(torch.searchsorted(cum, i, right=True),
                         max=_UWMAX - 1)
        m = i - (cum - pop).gather(1, Wi)
        xw = uwin.gather(1, Wi)                      # [T, 256]
        # select the m-th set bit of xw: binary search on prefix popcounts
        lo = torch.zeros_like(m)
        for step in (16, 8, 4, 2, 1):
            c = lo + step
            cnt = _popcount32_t(xw & ((1 << c) - 1))
            lo = torch.where(cnt <= m, c, lo)
        p = 32 * Wi + lo
        pprev = torch.cat([torch.full((T, 1), -1, dtype=i64, device=dev),
                           p[:, :-1]], 1)
        qd = p - pprev - 1
        u = ((qd << torch.clamp(wb, max=_KMAX)) | z) & 0xFFFFFFFF
        r_rice = ((u >> 1) ^ -(u & 1)).to(i32)
        r = torch.where((rice_b == 1)[:, None], r_rice, r)
    x = r.reshape(ch, K * B)[:, :n]
    # restore the predictor: `order` cumulative sums (int32 wrap), the
    # count chosen by where
    for o_ in range(1, 5):
        x = torch.where(order >= o_, torch.cumsum(x, dim=1, dtype=i32), x)
    if ch <= 2:   # undo the wasted-bits strip (before the ms inverse)
        kv = torch.stack([k0, k1])[:ch]
        x = x << kv[:, None]
    vT = x.t()                                       # [n, ch]
    if ch == 2:
        mid, sch = vT[:, 0], vT[:, 1]
        L = mid + ((sch + (sch & 1)) >> 1)
        vT = torch.where(ms == 1, torch.stack([L, L - sch], 1), vT)

    # ---- raw escape ----
    nb = n * ch * 3
    rb = words.view(torch.uint8)[20:20 + nb]
    if rb.numel() < nb:      # a packed stream shorter than raw PCM_24
        rb = torch.nn.functional.pad(rb, (0, nb - rb.numel()))
    rb = rb.reshape(-1, 3)
    vraw = (rb[:, 0].to(i32) | (rb[:, 1].to(i32) << 8)
            | (rb[:, 2].view(torch.int8).to(i32) << 16)).reshape(n, ch)

    vfin = torch.where(raw == 1, vraw, vT)
    return vfin.to(torch.float32) / 8388608.0
