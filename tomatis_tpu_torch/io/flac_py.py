"""Pure-Python FLAC decoder — the no-compiler fallback for io.flac (a copy
of tomatis_tpu/io/flac_py.py; the port imports nothing of the JAX package).

Mirrors the subset of the format the native codec implements
(csrc/flac.cpp, written from the FLAC spec): STREAMINFO,
fixed/variable blocking, constant/verbatim/fixed/LPC subframes, both Rice
partition methods with escapes, wasted bits, and all four stereo modes.
CRCs are trusted (not verified), exactly as in the native decoder.

This path exists so a machine without g++ can still *read* FLAC (decode
is needed to even inspect inputs); encode has no pure fallback — writers
fall back to WAV at the model layer (models/standard.py) like the
reference does when soundfile lacks FLAC (ref src/process_tomatis.py:
241-251). Expect roughly 1-3 s of decode time per minute of 48 kHz
stereo audio — correctness over speed.
"""
from __future__ import annotations

import numpy as np


class _BitReader:
    """MSB-first bit reader over bytes with a Python-int accumulator."""

    __slots__ = ("data", "nbytes", "byte", "acc", "nacc", "error")

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.nbytes = len(data)
        self.byte = byte_pos
        self.acc = 0
        self.nacc = 0
        self.error = False

    def _fill(self, need: int):
        while self.nacc < need:
            if self.byte >= self.nbytes:
                self.error = True
                self.acc <<= 8
                self.nacc += 8
                continue
            self.acc = (self.acc << 8) | self.data[self.byte]
            self.byte += 1
            self.nacc += 8

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        self.nacc -= n
        v = self.acc >> self.nacc
        self.acc &= (1 << self.nacc) - 1
        return v

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        q = 0
        while True:
            self._fill(1)
            if self.error:
                return q
            if self.nacc == 0 or self.acc == 0:
                # all buffered bits are zeros: consume them in one step
                q += self.nacc
                self.nacc = 0
                continue
            # position of the highest set bit in the accumulator
            top = self.acc.bit_length()
            q += self.nacc - top
            self.nacc = top - 1
            self.acc &= (1 << self.nacc) - 1
            return q

    def align(self):
        drop = self.nacc & 7
        self.nacc -= drop
        self.acc &= (1 << self.nacc) - 1

    def bit_pos(self) -> int:
        return self.byte * 8 - self.nacc


def _utf8_decode(br: _BitReader):
    b0 = br.bits(8)
    if b0 < 0x80:
        return b0
    extra = 0
    mask = 0x40
    while b0 & mask:
        extra += 1
        mask >>= 1
    if extra == 0 or extra > 6:
        br.error = True
        return 0
    v = b0 & (mask - 1)
    for _ in range(extra):
        c = br.bits(8)
        if (c & 0xC0) != 0x80:
            br.error = True
            return 0
        v = (v << 6) | (c & 0x3F)
    return v


_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608}


def _wrap32(x: np.ndarray) -> np.ndarray:
    """Two's-complement wrap to int32 (malformed residuals may overflow;
    valid files never wrap — same convention as the native decoder)."""
    return (x & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)


class PureFlacReader:
    """Drop-in replacement for the native FlacReader (read side only)."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self._stream = f.read()
        if self._stream[:4] != b"fLaC":
            raise ValueError(f"not a FLAC file: {path}")
        pos = 4
        have_si = False
        last = False
        while not last:
            if pos + 4 > len(self._stream):
                raise ValueError("truncated FLAC metadata")
            hdr = self._stream[pos:pos + 4]
            last = bool(hdr[0] & 0x80)
            btype = hdr[0] & 0x7F
            blen = (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
            body = self._stream[pos + 4:pos + 4 + blen]
            if len(body) < blen:
                raise ValueError("truncated FLAC metadata block")
            if btype == 0:   # STREAMINFO
                if blen < 34:
                    raise ValueError("short STREAMINFO")
                self._max_block = (body[2] << 8) | body[3]
                self.samplerate = (body[10] << 12) | (body[11] << 4) \
                    | (body[12] >> 4)
                self.channels = ((body[12] >> 1) & 0x7) + 1
                self.bits = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
                total = body[13] & 0x0F          # 36-bit total_samples
                for k in range(14, 18):
                    total = (total << 8) | body[k]
                self.frames = int(total)
                have_si = True
            pos += 4 + blen
        if not have_si:
            raise ValueError("FLAC stream without STREAMINFO")
        self.subtype = f"PCM_{self.bits}"
        self._frames_start = pos
        self._byte_pos = pos
        self._pos = 0          # absolute sample position of the cursor
        self._pend = np.zeros((0, self.channels), np.int32)
        if self.frames == 0:
            # unknown-length stream (STREAMINFO total_samples=0, legal for
            # streamed encodes): count by decoding once, like the native
            # reader counts at open
            n = 0
            while True:
                frm = self._decode_frame()
                if frm is None:
                    break
                n += len(frm)
            self.frames = n
            self._byte_pos = self._frames_start

    # -- frame decode ------------------------------------------------------

    def _decode_frame(self):
        """Decode the next frame at self._byte_pos.
        Returns interleaved int32 [bsize, ch] or None at stream end."""
        if self._byte_pos + 5 >= len(self._stream):
            return None
        br = _BitReader(self._stream, self._byte_pos)
        if br.bits(14) != 0x3FFE or br.error:
            return None
        br.bits(1)
        br.bits(1)                    # blocking strategy (frame number unused
        bs_bits = br.bits(4)          # for sequential reads)
        sr_bits = br.bits(4)
        ch_asgn = br.bits(4)
        ss_bits = br.bits(3)
        br.bits(1)
        _utf8_decode(br)
        if bs_bits in _BLOCK_SIZES:
            bsize = _BLOCK_SIZES[bs_bits]
        elif bs_bits == 6:
            bsize = br.bits(8) + 1
        elif bs_bits == 7:
            bsize = br.bits(16) + 1
        elif bs_bits >= 8:
            bsize = 256 << (bs_bits - 8)
        else:
            return None
        if sr_bits == 12:
            br.bits(8)
        elif sr_bits in (13, 14):
            br.bits(16)
        fbps = {0: self.bits, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24,
                7: 32}.get(ss_bits)
        if fbps is None:
            return None
        br.bits(8)                    # header CRC-8 (trusted)

        side = -1
        if ch_asgn <= 7:
            nch = ch_asgn + 1
        elif ch_asgn == 8:
            nch, side = 2, 1          # left/side
        elif ch_asgn == 9:
            nch, side = 2, 0          # side/right
        elif ch_asgn == 10:
            nch, side = 2, 1          # mid/side
        else:
            return None
        if nch != self.channels:
            return None

        chans = []
        for c in range(nch):
            cbps = fbps + (1 if side == c else 0)
            ch = self._decode_subframe(br, bsize, cbps)
            if ch is None or br.error:
                return None
            chans.append(ch)
        br.align()
        br.bits(16)                   # frame CRC-16 (trusted)
        if br.error:
            return None

        a = np.asarray(chans[0], np.int64)
        if nch == 2:
            b = np.asarray(chans[1], np.int64)
            if ch_asgn == 8:          # R = L - S
                chans = [a, a - b]
            elif ch_asgn == 9:        # L = S + R
                chans = [a + b, b]
            elif ch_asgn == 10:       # mid/side
                mid = (a << 1) | (b & 1)
                chans = [(mid + b) >> 1, (mid - b) >> 1]
            else:
                chans = [a, b]
        else:
            chans = [np.asarray(c, np.int64) for c in chans]
        out = np.stack([_wrap32(c) for c in chans], axis=1)
        self._byte_pos = (br.bit_pos() + 7) // 8
        return out

    def _decode_subframe(self, br: _BitReader, bsize: int, cbps: int):
        if br.bits(1) != 0:
            return None
        stype = br.bits(6)
        wasted = 0
        if br.bits(1):
            wasted = br.unary() + 1
        if wasted >= cbps or wasted >= 32:
            return None
        ebps = cbps - wasted

        if stype == 0:                          # CONSTANT
            out = np.full(bsize, br.sbits(ebps), np.int64)
        elif stype == 1:                        # VERBATIM
            out = np.fromiter((br.sbits(ebps) for _ in range(bsize)),
                              np.int64, bsize)
        elif 8 <= stype <= 12:                  # FIXED
            order = stype - 8
            if order > bsize:
                return None
            warm = [br.sbits(ebps) for _ in range(order)]
            res = self._decode_residual(br, bsize, order)
            if res is None:
                return None
            # repeated prefix sums restore the order-k fixed predictor:
            # seed position k with the k-th leading difference of the
            # warmup, then integrate one difference level per pass.
            # Mod-2^32 addition is associative, so wrapping once at the
            # end equals the native decoder's per-step uint32 wrap.
            lead = []
            w = np.asarray(warm, np.int64)
            for _ in range(order):
                lead.append(int(w[0]))
                w = np.diff(w)
            out = np.concatenate([np.asarray(lead, np.int64), res])
            for p in range(order):
                s = order - 1 - p
                out[s:] = np.cumsum(out[s:])
        elif stype >= 32:                       # LPC
            order = (stype & 0x1F) + 1
            if order > bsize:
                return None
            warm = [br.sbits(ebps) for _ in range(order)]
            prec = br.bits(4) + 1
            if prec == 16:
                return None
            shift = br.bits(5)
            coef = [br.sbits(prec) for _ in range(order)]
            res = self._decode_residual(br, bsize, order)
            if res is None:
                return None
            x = warm + [0] * (bsize - order)
            rl = res.tolist()
            if cbps <= 32:
                # per-step uint32 wrap, byte-identical to the native
                # decoder's 32-bit LPC path (conforming streams never
                # overflow int32 here; crafted ones must wrap the same
                # way on both decoders)
                mask = 0xFFFFFFFF
                for i in range(order, bsize):
                    p = 0
                    for j in range(order):
                        p += coef[j] * x[i - 1 - j]
                    v = (rl[i - order] + (p >> shift)) & mask
                    x[i] = v - (1 << 32) if v >= (1 << 31) else v
            else:
                # 33-bit side channel of a 32-bit stream: this decoder
                # is the EXACT path (flac.cpp declines bps>24), so the
                # prediction must not wrap — true side values need 33
                # bits and every later sample feeds off earlier ones
                for i in range(order, bsize):
                    p = 0
                    for j in range(order):
                        p += coef[j] * x[i - 1 - j]
                    x[i] = rl[i - order] + (p >> shift)
            out = np.asarray(x, np.int64)
        else:
            return None
        if wasted:
            if cbps <= 32:
                out = (out << wasted) & 0xFFFFFFFF
                out = np.where(out >= 1 << 31, out - (1 << 32), out)
            else:
                out = out << wasted   # 33-bit side channel: no wrap
        return out

    def _decode_residual(self, br: _BitReader, bsize: int, order: int):
        method = br.bits(2)
        if method > 1:
            return None
        pbits = 4 if method == 0 else 5
        esc = 0xF if method == 0 else 0x1F
        po = br.bits(4)
        parts = 1 << po
        if bsize % parts or (bsize >> po) < order:
            return None
        vals = []
        for p in range(parts):
            cnt = (bsize >> po) - (order if p == 0 else 0)
            k = br.bits(pbits)
            if k == esc:
                raw = br.bits(5)
                vals.extend(br.sbits(raw) if raw else 0
                            for _ in range(cnt))
            else:
                for _ in range(cnt):
                    q = br.unary()
                    zz = (q << k) | (br.bits(k) if k else 0)
                    vals.append((zz >> 1) ^ -(zz & 1))
            if br.error:
                return None
        return np.asarray(vals, np.int64)

    # -- reader surface (same as the native FlacReader) --------------------

    def read(self, n_frames: int = -1) -> np.ndarray:
        v = self.read_int_raw(n_frames)
        return v.astype(np.float32) / float(1 << (self.bits - 1))

    def read_int_raw(self, n_frames: int = -1) -> np.ndarray:
        if n_frames < 0:
            n_frames = max(0, self.frames - self._pos)
        chunks = []
        got = 0
        while got < n_frames:
            if len(self._pend):
                take = min(len(self._pend), n_frames - got)
                chunks.append(self._pend[:take])
                self._pend = self._pend[take:]
                got += take
                continue
            frm = self._decode_frame()
            if frm is None:
                break
            self._pend = frm
        self._pos += got
        if not chunks:
            return np.zeros((0, self.channels), np.int32)
        return np.concatenate(chunks, 0)

    @property
    def int24_readable(self) -> bool:
        return self.bits <= 24

    def read_int24(self, n_frames: int = -1) -> np.ndarray:
        v = self.read_int_raw(n_frames)
        if self.bits != 24:
            v = v << (24 - self.bits)
        return v

    def seek(self, frame: int) -> int:
        frame = max(0, min(frame, self.frames))
        if frame < self._pos:
            # restart and skip forward (no SEEKTABLE use in the fallback)
            self._byte_pos = self._frames_start
            self._pos = 0
            self._pend = np.zeros((0, self.channels), np.int32)
        skip = frame - self._pos
        if skip:
            self.read_int_raw(skip)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self):
        self._stream = b""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
