// Wire codec - C++ host side of the host<->device lossless PCM link format.
//
// A copy of tomatis_tpu/native/wire.cpp. Format spec and rationale:
// ops/wire.py of this package (the numpy oracle and the torch device
// implementation live there). This file is the production
// host-side encoder (input path: host packs, device unpacks) and decoder
// (output path: device packs, host unpacks). All three implementations are
// bit-exact for encode (same variant tie-break) and cross-decodable.
//
// Exported C ABI (ctypes-bound by io/wirecodec.py):
//   twire_encode_f32(x, n, ch, out, cap, rice) -> used bytes; -1 if the
//       floats are not exactly PCM_24 (caller falls back to raw f32
//       transport); -2 if cap is too small. rice=0 -> all-maxw stream.
//   twire_encode_i32(v, n, ch, out, cap, rice) -> used bytes; -2 if cap
//       small.
//   twire_decode(in, nbytes, out_i32, n, ch) -> 0 ok / negative error.
//   twire_decode_pcm24(in, nbytes, out_u8, n, ch) -> 0 ok / negative error.
//   twire_max_bytes(n, ch) -> worst-case packed size.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr uint32_t MAGIC = 0x54574333u;
constexpr int B = 256;
constexpr int KMAX = 24;     // rice remainder width cap
constexpr int UWMAX = 64;    // rice unary region cap (words)

// Hacker's-Delight 32x32 bit-matrix transpose: out[l] bit i ==
// in[31-i] bit (31-l) -- the orientation the TWC2 stream layout is
// defined around (ops/wire.py). Involution.
inline void transpose32(uint32_t A[32]) {
    uint32_t m = 0x0000FFFFu, t;
    for (int j = 16; j != 0; j >>= 1, m ^= (m << j)) {
        for (int k = 0; k < 32; k = (k + j + 1) & ~j) {
            t = (A[k] ^ (A[k + j] >> j)) & m;
            A[k] ^= t;
            A[k + j] ^= (t << j);
        }
    }
}

inline long n_blocks(long n) { return (n + B - 1) / B; }
inline long header_words(long n, int ch) {
    return 5 + (2 * ch * n_blocks(n) + 3) / 4;
}
inline long raw_words(long n, int ch) { return 5 + (n * ch * 3 + 3) / 4; }

inline int width_of(uint32_t umax, bool anynz) {
    if (!anynz) return 0;
    if (umax == 0) return 4;
    int bits = 32 - __builtin_clz(umax);
    return bits + 1 < 4 ? 4 : bits + 1;
}

// Block widths for ALL five predictor orders of a channel: five
// vectorizable passes (per-order block max/or reduction + one shifted
// subtract into a ping-pong scratch). An earlier one-pass version
// derived all orders from carried previous diffs — 5x less memory
// traffic but a loop-carried scalar chain the compiler cannot
// vectorize; the pass-per-order form runs ~2.5x faster with
// -march=native on AVX2/AVX-512 hosts despite touching more memory.
void block_widths_all_orders(const int32_t* x, long n,
                             uint8_t* w_out /* [5][K] */, long K,
                             long* totals /* [5] */,
                             int32_t* s1 /* scratch [n] */,
                             int32_t* s2 /* scratch [n] */) {
    const int32_t* cur = x;
    for (int o = 0; o < 5; o++) {
        for (long b = 0; b < K; b++) {
            long lo = b * B, hi = lo + B < n ? lo + B : n;
            uint32_t umax = 0, orall = 0;
            for (long i = lo; i < hi; i++) {
                int32_t v = cur[i];
                orall |= (uint32_t)v;
                uint32_t u = (uint32_t)(v ^ (v >> 31));
                if (u > umax) umax = u;
            }
            int w = width_of(umax, orall != 0);
            w_out[(size_t)o * K + b] = (uint8_t)w;
            totals[o] += 8L * w;
        }
        if (o < 4) {
            int32_t* dst = (o == 0) ? s1 : (cur == s1 ? s2 : s1);
            dst[0] = cur[0];
            for (long i = 1; i < n; i++) dst[i] = cur[i] - cur[i - 1];
            cur = dst;
        }
    }
}

// Wasted bits of one channel: trailing zeros shared by EVERY sample
// (tz of the OR), capped at 23; 0 for all-zero channels.
inline int wasted_bits_of(const int32_t* x, long n) {
    uint32_t acc = 0;
    for (long i = 0; i < n; i++) acc |= (uint32_t)x[i];
    if (!acc) return 0;
    int k = __builtin_ctz(acc);
    return k > 23 ? 23 : k;
}

void diff_inplace(int32_t* r, long n) {
    int32_t prev = 0;
    for (long i = 0; i < n; i++) {
        int32_t cur = r[i];
        r[i] = cur - prev;
        prev = cur;
    }
}

// Per-block mode decision (the format's deterministic k scan, see
// ops/wire.py): residuals r[0..cnt) (pad positions are implicit zeros),
// max-width w. Returns true when rice wins, filling k/uw.
bool rice_plan(const int32_t* r, long cnt, int w, int* k_out, int* uw_out) {
    if (w == 0) return false;
    uint64_t qs[KMAX + 1] = {0};
    int kmax = w - 1 < KMAX ? w - 1 : KMAX;
    for (long i = 0; i < cnt; i++) {
        uint32_t zz = ((uint32_t)r[i] << 1) ^ (uint32_t)(r[i] >> 31);
        for (int k = 0; k <= kmax; k++) qs[k] += zz >> k;
    }
    long best = 8L * w;
    int bk = -1, buw = 0;
    for (int k = 0; k <= kmax; k++) {   // ascending: first strict minimum
        uint64_t U = (uint64_t)B + qs[k];
        if (U > 8u * B) continue;
        long uw = (long)((U + 31) / 32);
        long cost = 8L * k + uw;
        if (cost < best) { best = cost; bk = k; buw = (int)uw; }
    }
    if (bk < 0) return false;
    *k_out = bk;
    *uw_out = buw;
    return true;
}

// rice=0 disables the per-block Rice mode (all-maxw stream, still valid
// TWC3); must match the device decoder's static rice setting — see
// ops/wire.py.
long encode_core(const int32_t* v, long n, int ch, uint8_t* out, long cap,
                 int rice) {
    long K = n_blocks(n);
    long H = header_words(n, ch);
    long RW = raw_words(n, ch);

    // channel-major copies for both channel mappings. Uninitialized
    // buffers (every element is written below) and ONE fused pass for
    // the stereo case: the interleaved input is read once, emitting
    // L/R/mid/side together — the separate lr + ms passes each paid a
    // strided 17 MB read of the same source.
    std::unique_ptr<int32_t[]> lr(new int32_t[(size_t)ch * n]), msv;
    int n_var = 1;
    if (ch == 2) {
        msv.reset(new int32_t[(size_t)2 * n]);
        int32_t* l0 = lr.get();
        int32_t* r0 = lr.get() + n;
        int32_t* m0 = msv.get();
        int32_t* s0 = msv.get() + n;
        for (long i = 0; i < n; i++) {
            int32_t L = v[i * 2], R = v[i * 2 + 1];
            l0[i] = L;
            r0[i] = R;
            m0[i] = (L + R) >> 1;
            s0[i] = L - R;
        }
        n_var = 2;
    } else {
        for (int c = 0; c < ch; c++)
            for (long i = 0; i < n; i++)
                lr[(size_t)c * n + i] = v[i * ch + c];
    }
    // wasted-bits strip, per variant channel (format limit: ch <= 2);
    // exact — shifting out shared trailing zeros commutes with the
    // diffs and the widths below see the stripped values
    int kvar[2][2] = {{0, 0}, {0, 0}};
    if (ch <= 2) {
        for (int msx = 0; msx < n_var; msx++) {
            int32_t* x0 = msx ? msv.get() : lr.get();
            for (int c = 0; c < ch; c++) {
                int k = wasted_bits_of(x0 + (size_t)c * n, n);
                kvar[msx][c] = k;
                if (k)
                    for (long i = 0; i < n; i++)
                        x0[(size_t)c * n + i] >>= k;
            }
        }
    }

    long best_total = -1;
    int best_o = 0, best_ms = 0;
    std::vector<uint8_t> bw((size_t)ch * K);
    std::unique_ptr<int32_t[]> r(new int32_t[(size_t)ch * n]);
    // width-pass ping-pong scratch, uninitialized (fully overwritten)
    std::unique_ptr<int32_t[]> scr1(new int32_t[n]), scr2(new int32_t[n]);
    // all-order widths per variant, vectorized pass per order
    std::vector<uint8_t> wall((size_t)n_var * ch * 5 * K);
    for (int ms = 0; ms < n_var; ms++) {
        const int32_t* x0 = ms ? msv.get() : lr.get();
        long totals[5] = {H, H, H, H, H};
        for (int c = 0; c < ch; c++)
            block_widths_all_orders(
                x0 + (size_t)c * n, n,
                wall.data() + ((size_t)ms * ch + c) * 5 * K, K, totals,
                scr1.get(), scr2.get());
        for (int o = 0; o < 5; o++) {
            if (best_total < 0 || totals[o] < best_total) {
                best_total = totals[o];
                best_o = o;
                best_ms = ms;
            }
        }
    }
    // tie-break parity with the numpy/XLA encoders: first minimum over
    // the [lr o0..o4, ms o0..o4] ordering (the loop above already scans
    // in that order and keeps strict '<', so best_o/best_ms match)
    for (int c = 0; c < ch; c++)
        std::memcpy(bw.data() + (size_t)c * K,
                    wall.data() + ((size_t)best_ms * ch + c) * 5 * K
                        + (size_t)best_o * K,
                    (size_t)K);

    // rebuild the winning residual, then the per-block rice plans (the
    // raw-escape comparison uses the TRUE total, post-rice)
    const int32_t* x0 = best_ms ? msv.get() : lr.get();
    std::memcpy(r.get(), x0, (size_t)ch * n * 4);
    for (int o = 0; o < best_o; o++)
        for (int c = 0; c < ch; c++)
            diff_inplace(r.get() + (size_t)c * n, n);

    long T = (long)ch * K;
    std::vector<uint8_t> rice_f(T), kk(T), uws(T);
    long total = H, S_oct = 0;   // S_oct: total plane octets
    for (int c = 0; c < ch; c++) {
        const int32_t* rc = r.get() + (size_t)c * n;
        for (long b = 0; b < K; b++) {
            long t = (long)c * K + b;
            long lo = b * B, hi = lo + B < n ? lo + B : n;
            int w_ = bw[t];
            int k_ = 0, uw_ = 0;
            bool use_rice = rice
                && rice_plan(rc + lo, hi - lo, w_, &k_, &uw_);
            rice_f[t] = use_rice;
            kk[t] = (uint8_t)k_;
            uws[t] = (uint8_t)uw_;
            S_oct += use_rice ? k_ : w_;
            total += use_rice ? 8L * k_ + uw_ : 8L * w_;
        }
    }

    if (total >= RW) {   // raw escape
        if (cap < RW * 4) return -2;
        std::memset(out, 0, (size_t)RW * 4);
        uint32_t hdr[5] = {MAGIC, (uint32_t)n, (uint32_t)K,
                           (uint32_t)ch | (1u << 17), (uint32_t)RW};
        std::memcpy(out, hdr, 20);
        uint8_t* p = out + 20;
        for (long i = 0; i < n * ch; i++) {
            uint32_t u = (uint32_t)v[i];
            p[0] = u & 0xFF; p[1] = (u >> 8) & 0xFF; p[2] = (u >> 16) & 0xFF;
            p += 3;
        }
        return RW * 4;
    }

    if (cap < total * 4) return -2;
    std::memset(out, 0, (size_t)total * 4);
    uint32_t k0 = (uint32_t)kvar[best_ms][0];
    uint32_t k1 = ch == 2 ? (uint32_t)kvar[best_ms][1] : 0u;
    uint32_t hdr[5] = {MAGIC, (uint32_t)n, (uint32_t)K,
                       (uint32_t)ch | ((uint32_t)best_o << 8)
                           | ((uint32_t)best_ms << 16)
                           | (k0 << 18) | (k1 << 23),
                       (uint32_t)total};
    std::memcpy(out, hdr, 20);
    for (long t = 0; t < T; t++) {
        out[20 + 2 * t] = (uint8_t)((rice_f[t] ? 0x80 : 0)
                                    | (rice_f[t] ? kk[t] : bw[t]));
        out[20 + 2 * t + 1] = rice_f[t] ? uws[t] : 0;
    }

    // stream, separated regions: FIRST all blocks' plane regions (per
    // block, 8 transposed 32-sample groups emit the first noct planes;
    // octet o, word j = group j's transform lane 31-o; rice blocks store
    // zigzag remainders), THEN all rice blocks' unary terminator words
    // (bit p = word p>>5 bit p&31, LSB-first)
    uint32_t* words = reinterpret_cast<uint32_t*>(out);
    long ppos = H;                // plane region cursor
    long upos = H + 8 * S_oct;    // unary region cursor
    for (int c = 0; c < ch; c++) {
        const int32_t* rc = r.get() + (size_t)c * n;
        for (long b = 0; b < K; b++) {
            long t = (long)c * K + b;
            bool ur = rice_f[t];
            int noct = ur ? kk[t] : bw[t];
            long lo = b * B, hi = lo + B < n ? lo + B : n;
            if (noct) {
                uint32_t mask = (1u << noct) - 1;   // noct <= 30
                // all 8 transposed groups first, then plane rows in
                // OUTPUT order: the o-major write loop is sequential in
                // the stream (the j-major form scattered at stride 8
                // words); full blocks skip the per-sample bounds check
                // so the gather+zigzag vectorizes
                uint32_t Aall[8][32];
                bool full = hi - lo == B;
                for (int j = 0; j < 8; j++) {
                    uint32_t* A = Aall[j];
                    const int32_t* src = rc + lo + 32 * j;
                    if (full && ur) {
                        for (int k = 0; k < 32; k++) {
                            int32_t rv = src[k];
                            A[k] = (((uint32_t)rv << 1)
                                    ^ (uint32_t)(rv >> 31)) & mask;
                        }
                    } else if (full) {
                        for (int k = 0; k < 32; k++)
                            A[k] = (uint32_t)src[k] & mask;
                    } else {
                        for (int k = 0; k < 32; k++) {
                            long i = lo + 32 * j + k;
                            uint32_t val = 0;
                            if (i < hi) {
                                int32_t rv = rc[i];
                                val = ur ? (((uint32_t)rv << 1)
                                            ^ (uint32_t)(rv >> 31))
                                         : (uint32_t)rv;
                            }
                            A[k] = val & mask;
                        }
                    }
                    transpose32(A);
                }
                for (int o = 0; o < noct; o++) {
                    uint32_t* w8 = words + ppos + 8 * o;
                    for (int j = 0; j < 8; j++) w8[j] = Aall[j][31 - o];
                }
                ppos += 8L * noct;
            }
            if (ur) {
                int k_ = kk[t];
                long p = -1;
                for (int i = 0; i < B; i++) {
                    long li = lo + i;
                    uint32_t zz = 0;
                    if (li < hi) {
                        int32_t rv = rc[li];
                        zz = ((uint32_t)rv << 1) ^ (uint32_t)(rv >> 31);
                    }
                    p += (long)(zz >> k_) + 1;
                    words[upos + (p >> 5)] |= 1u << (p & 31);
                }
                upos += uws[t];
            }
        }
    }
    return total * 4;
}

int decode_core(const uint8_t* in, long nbytes, long n, int ch,
                std::vector<int32_t>& out) {
    if (nbytes < 20) return -1;
    uint32_t hdr[5];
    std::memcpy(hdr, in, 20);
    if (hdr[0] != MAGIC) return -1;
    if ((long)hdr[1] != n || (int)(hdr[3] & 0xFF) != ch) return -3;
    long K = (long)hdr[2];
    if (K != n_blocks(n)) return -3;
    int order = (hdr[3] >> 8) & 0xFF;
    int ms = (hdr[3] >> 16) & 1;
    int raw = (hdr[3] >> 17) & 1;
    int kw[2] = {(int)((hdr[3] >> 18) & 31), (int)((hdr[3] >> 23) & 31)};
    long used = (long)hdr[4];
    if (order > 4 || used * 4 > nbytes) return -4;  // used is word-aligned
    if (ms && ch != 2) return -4;
    if (!raw && (kw[0] > 23 || kw[1] > 23
                 || (ch > 2 && (kw[0] || kw[1]))
                 || (ch == 1 && kw[1]))) return -4;

    out.resize((size_t)n * ch);
    if (raw) {
        if (nbytes < 20 + n * ch * 3) return -4;
        const uint8_t* p = in + 20;
        for (long i = 0; i < n * ch; i++) {
            uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
                         | ((uint32_t)p[2] << 16);
            out[i] = (int32_t)(v << 8) >> 8;  // sign-extend 24 -> 32 sans UB
            p += 3;
        }
        return 0;
    }

    long H = header_words(n, ch);
    if (nbytes < H * 4) return -4;
    const uint8_t* desc = in + 20;
    long T = (long)ch * K;
    long S = 0, S_oct = 0;   // total stream words / plane octets
    for (long t = 0; t < T; t++) {
        int rice = desc[2 * t] >> 7;
        int noct = desc[2 * t] & 0x7F;
        int uw = desc[2 * t + 1];
        if (noct > 30 || (rice && noct > KMAX)) return -5;
        if (rice ? (uw < 8 || uw > UWMAX) : (uw != 0)) return -5;
        S += 8L * noct + uw;
        S_oct += noct;
    }
    if (used != H + S) return -4;  // stream length must match descriptors
    // word view of the stream: in place when 4-aligned (numpy buffers
    // are), one copy otherwise — the copy was ~20% of decode time
    std::vector<uint32_t> wcopy;
    const uint32_t* words;
    if (((uintptr_t)in & 3u) == 0) {
        words = reinterpret_cast<const uint32_t*>(in);
    } else {
        wcopy.resize((size_t)used);
        std::memcpy(wcopy.data(), in, (size_t)(used * 4));
        words = wcopy.data();
    }
    std::unique_ptr<int32_t[]> r(new int32_t[n]);
    int32_t rem[B];
    long ppos = H;                // plane region cursor
    long upos = H + 8 * S_oct;    // unary region cursor
    for (int c = 0; c < ch; c++) {
        for (long b = 0; b < K; b++) {
            long t = (long)c * K + b;
            int rice = desc[2 * t] >> 7;
            int noct = desc[2 * t] & 0x7F;
            int uw = desc[2 * t + 1];
            long lo = b * B, hi = lo + B < n ? lo + B : n;
            if (!rice && !noct) {
                for (long i = lo; i < hi; i++) r[i] = 0;
                continue;
            }
            // planes region: noct octets of transposed values
            for (int j = 0; j < 8; j++) {
                uint32_t A[32] = {0};
                for (int o = 0; o < noct; o++)
                    A[31 - o] = words[ppos + 8 * o + j];
                transpose32(A);
                for (int k = 0; k < 32; k++) {
                    int i = 32 * j + k;
                    if (rice) {
                        rem[i] = (int32_t)A[k];        // masked zigzag low
                    } else if (lo + i < hi) {
                        r[lo + i] = noct
                            ? (int32_t)(A[k] << (32 - noct)) >> (32 - noct)
                            : 0;
                    }
                }
            }
            ppos += 8L * noct;
            if (rice) {
                const uint32_t* un = words + upos;
                long bp = 0, prev = -1;
                for (int i = 0; i < B; i++) {
                    while (true) {
                        if (bp >= (long)uw * 32) return -6;  // missing bits
                        uint32_t wv = un[bp >> 5] >> (bp & 31);
                        if (wv == 0) { bp = (bp & ~31L) + 32; continue; }
                        bp += __builtin_ctz(wv);
                        break;
                    }
                    uint32_t q = (uint32_t)(bp - prev - 1);
                    prev = bp;
                    bp++;
                    if (lo + i < hi) {
                        uint32_t zz = (q << noct) | (uint32_t)rem[i];
                        r[lo + i] = (int32_t)((zz >> 1) ^ (~(zz & 1) + 1));
                    }
                }
                upos += uw;
            }
        }
        // unsigned accumulation: descriptor-valid malformed streams may
        // overflow, and the two's-complement wrap is well-defined (and
        // matches decode_np's int32 wrap); valid streams never wrap
        for (int o = 0; o < order; o++) {
            uint32_t acc = 0;
            for (long i = 0; i < n; i++) {
                acc += (uint32_t)r[i];
                r[i] = (int32_t)acc;
            }
        }
        // undo the wasted-bits strip (unsigned shift: well-defined even
        // on descriptor-valid hostile streams; before the ms inverse)
        int kc = ch <= 2 ? kw[c] : 0;
        if (kc)
            for (long i = 0; i < n; i++)
                r[i] = (int32_t)((uint32_t)r[i] << kc);
        for (long i = 0; i < n; i++) out[i * ch + c] = r[i];
    }
    if (ms && ch == 2) {
        for (long i = 0; i < n; i++) {
            int32_t m = out[i * 2], s = out[i * 2 + 1];
            int32_t t = (int32_t)((uint32_t)s + (uint32_t)(s & 1));
            int32_t L = (int32_t)((uint32_t)m + (uint32_t)(t >> 1));
            out[i * 2] = L;
            out[i * 2 + 1] = (int32_t)((uint32_t)L - (uint32_t)s);
        }
    }
    return 0;
}

}  // namespace

extern "C" {

long twire_max_bytes(long n, int ch) {
    // packed-layout worst case, matching ops/wire.py max_words (the raw
    // escape keeps used_words <= raw_words, which is always smaller)
    return (header_words(n, ch) + 8L * 30 * ch * n_blocks(n)) * 4;
}

long twire_encode_i32(const int32_t* v, long n, int ch, uint8_t* out,
                      long cap, int rice) {
    return encode_core(v, n, ch, out, cap, rice);
}

long twire_encode_f32(const float* x, long n, int ch, uint8_t* out,
                      long cap, int rice) {
    std::vector<int32_t> v((size_t)n * ch);
    for (long i = 0; i < n * ch; i++) {
        float f = x[i] * 8388608.0f;
        // reject non-finite and out-of-range BEFORE the int cast: a NaN
        // or huge float (hostile FLOAT-subtype input) through
        // (int32_t)(f) is undefined behavior
        if (!(f >= -8388608.0f && f <= 8388608.0f)) return -1;
        int32_t q = (int32_t)(f >= 0 ? f + 0.5f : f - 0.5f);
        if (q < -8388608 || q > 8388607
            || (float)q / 8388608.0f != x[i]) return -1;  // not PCM_24-exact
        v[i] = q;
    }
    return encode_core(v.data(), n, ch, out, cap, rice);
}

int twire_decode(const uint8_t* in, long nbytes, int32_t* out, long n,
                 int ch) {
    std::vector<int32_t> buf;
    int rc = decode_core(in, nbytes, n, ch, buf);
    if (rc) return rc;
    std::memcpy(out, buf.data(), (size_t)n * ch * 4);
    return 0;
}

int twire_decode_pcm24(const uint8_t* in, long nbytes, uint8_t* out, long n,
                       int ch) {
    std::vector<int32_t> buf;
    int rc = decode_core(in, nbytes, n, ch, buf);
    if (rc) return rc;
    uint8_t* p = out;
    for (long i = 0; i < n * ch; i++) {
        uint32_t u = (uint32_t)buf[i];
        p[0] = u & 0xFF; p[1] = (u >> 8) & 0xFF; p[2] = (u >> 16) & 0xFF;
        p += 3;
    }
    return 0;
}

}  // extern "C"
