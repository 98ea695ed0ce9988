// FLAC codec (decode + encode), C++17, no external dependencies.
//
// The reference project reads/writes FLAC via libsndfile (soundfile); this
// image has neither, so the framework ships its own codec, exposed through
// a minimal C ABI consumed by ctypes (tomatis_tpu/io/flac.py).
//
// Decoder: full subset used by FLAC encoders in the wild — CONSTANT,
// VERBATIM, FIXED(0-4), LPC(1-32) subframes; partitioned Rice residuals
// (methods 0/4-bit and 1/5-bit incl. escapes); wasted bits; stereo
// decorrelation L/S, R/S, M/S; 4-24-bit samples (32-bit streams need a
// 33-bit side channel and are declined at open — the pure-Python
// fallback decoder handles them exactly). It reads its bits a 64-bit word
// at a time: a Rice quotient is a count of leading zeros, an LPC restore
// is specialised by order, and in an AVX2 build a stereo frame's two LPC
// restores run side by side.
// Encoder: FIXED predictors (orders 0-4) and LPC (Levinson-Durbin, orders
// 1-12 selected by prediction-error bits estimate) per subframe, VERBATIM
// fallback for incompressible blocks, mid/side channel assignment search,
// partitioned Rice residuals (order 0..6 scored bottom-up), block size
// 4096, correct CRC-8/CRC-16, MD5 left zero (= unknown, legal). A frame's
// bytes are a function of its samples and frame number alone, so a write
// of two or more full blocks makes them on several threads (a budget for
// the process, its usable CPUs) and writes them in order: the file's bytes
// are those of the one-thread encoder. A frame is made in one thread's
// reused scratch: the CRCs from tables (CRC-16 eight bytes a step), the
// channel costs of every stereo assignment and of every fixed order in one
// pass each, the LPC autocorrelation's lags in one pass over the block with
// each lag's sum rounded as a pass per lag rounds it, the LPC residual
// specialised by order, and the bits written a 64-bit word at a time.
// Every stage computes what a pass per lag, per order and per channel
// computes, so the bytes stay those of the JAX package's encoder
// (tomatis_tpu/native/flac.cpp).
//
// Build: g++ -O2 -shared -fPIC -pthread flac.cpp -o libtomatisflac.so

#include <sched.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- CRC
// From tables made from the polynomials at compile time: CRC-8 (0x07) a
// byte at a time, CRC-16 (0x8005) eight bytes a step (slicing by 8:
// t16[s][b] is byte b's CRC followed by s zero bytes, so a step's eight
// lookups XOR to the CRC of the register and the eight bytes).
struct CrcTables {
    uint8_t t8[256] = {};
    uint16_t t16[8][256] = {};
    constexpr CrcTables() {
        for (int b = 0; b < 256; b++) {
            uint8_t c = (uint8_t)b;
            uint16_t d = (uint16_t)(b << 8);
            for (int k = 0; k < 8; k++) {
                c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
                d = (d & 0x8000) ? (uint16_t)((d << 1) ^ 0x8005) : (uint16_t)(d << 1);
            }
            t8[b] = c;
            t16[0][b] = d;
        }
        for (int s = 1; s < 8; s++)
            for (int b = 0; b < 256; b++) {
                uint16_t p = t16[s - 1][b];
                t16[s][b] = (uint16_t)(p << 8) ^ t16[0][p >> 8];
            }
    }
};
constexpr CrcTables CRC;

uint8_t crc8(const uint8_t* d, size_t n) {
    uint8_t c = 0;
    for (size_t i = 0; i < n; i++) c = CRC.t8[c ^ d[i]];
    return c;
}
uint16_t crc16(const uint8_t* d, size_t n) {
    const auto& t = CRC.t16;
    uint16_t c = 0;
    for (; n >= 8; n -= 8, d += 8)
        c = t[7][d[0] ^ (c >> 8)] ^ t[6][d[1] ^ (c & 0xFF)] ^ t[5][d[2]] ^
            t[4][d[3]] ^ t[3][d[4]] ^ t[2][d[5]] ^ t[1][d[6]] ^ t[0][d[7]];
    for (; n; n--, d++) c = (uint16_t)(c << 8) ^ t[0][(c >> 8) ^ *d];
    return c;
}

// ---------------------------------------------------------------- bit reader
// MSB first, a 64-bit word at a time: a read loads the eight bytes from the
// byte that holds `pos` (unaligned, big-endian) and shifts out pos & 7, so
// one load holds at least 57 valid bits. The stream is followed by PAD zero
// bytes, so every load that the readers below make while `pos` is within
// `limit` stays in bounds and finds zeros past it. A read that would pass
// `limit` sets `error` and leaves `pos` where it was.
constexpr size_t PAD = 16;
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "load_be64 swaps a little-endian load");

inline uint64_t load_be64(const uint8_t* p) {
    uint64_t w;
    memcpy(&w, p, 8);
    return __builtin_bswap64(w);
}

inline uint64_t load_bits(const uint8_t* data, size_t pos) {
    return load_be64(data + (pos >> 3)) << (pos & 7);
}

struct BitReader {
    const uint8_t* data = nullptr;
    size_t limit = 0;    // the stream's end (bits)
    size_t pos = 0;      // bit position
    bool error = false;

    uint32_t bits(int n) {  // n <= 32
        if (pos + n > limit) { error = true; return 0; }
        uint64_t w = load_bits(data, pos);
        pos += n;
        return (uint32_t)((w >> 1) >> (63 - n));  // 0 at n == 0
    }
    int32_t sbits(int n) {  // n <= 32 (the `~0u << n` is UB at n >= 32)
        uint32_t v = bits(n);
        if (n == 0) return 0;
        if (n >= 32) return (int32_t)v;
        if (v & (1u << (n - 1))) return (int32_t)(v | (~0u << n));
        return (int32_t)v;
    }
    uint32_t unary() {  // the zeros before the next 1, which it consumes
        uint32_t q = 0;
        while (pos < limit) {
            uint64_t w = load_bits(data, pos);
            if (w) {  // the 1 lies before limit: the pad is zeros
                int z = __builtin_clzll(w);
                pos += z + 1;
                return q + z;
            }
            q += 57;
            pos += 57;
        }
        error = true;
        pos = limit;
        return q;
    }
    void align() { pos = (pos + 7) & ~(size_t)7; }
};

// ---------------------------------------------------------------- bit writer
// MSB first. The bits not yet stored are the top `used` (< 8 between puts)
// of `acc`, zeros below them; a put adds its bits under them, stores the
// eight bytes of `acc` where the stream has got to and moves on by the whole
// bytes, with no branch on the bit count. The buffer is kept from frame to
// frame, with room for an 8-byte store past the stream's end.
struct BitState {
    size_t len = 0;      // whole bytes stored
    uint64_t acc = 0;
    int used = 0;

    // the n low bits of v, v < 2^n, 1 <= n <= 56, into out (room for len + 8)
    void put(uint8_t* out, uint64_t v, int n) {
        acc |= v << (64 - used - n);
        used += n;
        uint64_t be = __builtin_bswap64(acc);
        memcpy(out + len, &be, 8);
        len += used >> 3;
        acc <<= used & ~7;
        used &= 7;
    }
};

struct BitWriter {
    std::vector<uint8_t> buf = std::vector<uint8_t>(1 << 16);
    BitState st;

    void reset() { st = BitState(); }
    uint8_t* bytes() { return buf.data(); }
    size_t len() const { return st.len; }
    // room for puts that move on by `bytes` more and the last one's store
    void reserve(size_t bytes) {
        if (st.len + bytes + 8 > buf.size())
            buf.resize(std::max(2 * buf.size(), st.len + bytes + 8));
    }

    void put(uint64_t v, int n) {  // v < 2^n, 1 <= n <= 56
        reserve(0);
        st.put(buf.data(), v, n);
    }
    void bits(uint32_t v, int n) {  // 1 <= n <= 32; v's bits above n ignored
        put(v & (uint32_t)((1ull << n) - 1), n);
    }
    void sbits(int32_t v, int n) { bits((uint32_t)v, n); }
    void align() {  // zeros to a byte boundary
        if (st.used) put(0, 8 - st.used);
    }
};

// ---------------------------------------------------------------- UTF-8 coded numbers
// v's bytes into out (at most 7); returns their count
int utf8_encode(uint64_t v, uint8_t* out) {
    if (v < 0x80) { out[0] = (uint8_t)v; return 1; }
    int bytes;
    if (v < 0x800) bytes = 2;
    else if (v < 0x10000) bytes = 3;
    else if (v < 0x200000) bytes = 4;
    else if (v < 0x4000000) bytes = 5;
    else if (v < 0x80000000ull) bytes = 6;
    else bytes = 7;
    static const uint8_t lead[8] = {0, 0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE};
    out[0] = (uint8_t)(lead[bytes] | (v >> (6 * (bytes - 1))));
    for (int i = bytes - 2, k = 1; i >= 0; i--, k++)
        out[k] = (uint8_t)(0x80 | ((v >> (6 * i)) & 0x3F));
    return bytes;
}

bool utf8_decode(BitReader& br, uint64_t* out) {
    uint32_t b0 = br.bits(8);
    if (br.error) return false;
    int extra = 0;
    uint64_t v;
    if ((b0 & 0x80) == 0) { *out = b0; return true; }
    else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
    else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
    else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
    else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
    else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
    else if (b0 == 0xFE) { extra = 6; v = 0; }
    else return false;
    for (int i = 0; i < extra; i++) {
        uint32_t b = br.bits(8);
        if (br.error || (b & 0xC0) != 0x80) return false;
        v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return true;
}

// ---------------------------------------------------------------- decoder
// The LPC restore with the predictor's order fixed at compile time, so the
// inner sum unrolls; int64 sums, and the two's-complement wrap of malformed
// residuals is well-defined (valid files never wrap).
template <uint32_t ORDER>
void restore_lpc_n(const int32_t* coef, int shift, uint32_t n, int32_t* x) {
    int64_t c[ORDER];
    for (uint32_t j = 0; j < ORDER; j++) c[j] = coef[j];
    for (uint32_t i = ORDER; i < n; i++) {
        // the newest sample last: the products of the older ones need not
        // wait for it
        int64_t p = 0;
        for (uint32_t j = ORDER - 1; j > 0; j--) p += c[j] * x[i - 1 - j];
        p += c[0] * x[i - 1];
        x[i] = (int32_t)((uint32_t)x[i] + (uint32_t)(p >> shift));
    }
}

void restore_lpc(uint32_t order, const int32_t* coef, int shift, uint32_t n,
                 int32_t* x) {
    switch (order) {  // the orders 1-12 that encoders emit
        case 1: return restore_lpc_n<1>(coef, shift, n, x);
        case 2: return restore_lpc_n<2>(coef, shift, n, x);
        case 3: return restore_lpc_n<3>(coef, shift, n, x);
        case 4: return restore_lpc_n<4>(coef, shift, n, x);
        case 5: return restore_lpc_n<5>(coef, shift, n, x);
        case 6: return restore_lpc_n<6>(coef, shift, n, x);
        case 7: return restore_lpc_n<7>(coef, shift, n, x);
        case 8: return restore_lpc_n<8>(coef, shift, n, x);
        case 9: return restore_lpc_n<9>(coef, shift, n, x);
        case 10: return restore_lpc_n<10>(coef, shift, n, x);
        case 11: return restore_lpc_n<11>(coef, shift, n, x);
        case 12: return restore_lpc_n<12>(coef, shift, n, x);
    }
    for (uint32_t i = order; i < n; i++) {
        int64_t p = 0;
        for (uint32_t j = 0; j < order; j++)
            p += (int64_t)coef[j] * x[i - 1 - j];
        x[i] = (int32_t)((uint32_t)x[i] + (uint32_t)(p >> shift));
    }
}

// An LPC subframe's predictor, from its header to its restore.
struct Lpc {
    uint32_t order = 0;  // 0: not an LPC subframe
    int shift = 0;
    int32_t coef[32];
};

#if defined(__AVX2__)
// The LPC restores of a frame's two channels side by side, one per 64-bit
// lane, both at order ORDER: a product is a pmuldq (signed 32 x 32 -> 64
// bits), the sums int64, the arithmetic shift a logical one of the sum
// offset by 2^63, and a sample the low 32 bits of its lane, so that each
// lane computes what restore_lpc_n computes.
template <uint32_t ORDER>
void restore_lpc2_n(const int32_t* ca, const int32_t* cb, int sa, int sb,
                    uint32_t n, int32_t* xa, int32_t* xb) {
    __m128i c[ORDER], h[ORDER];  // h[j]: the samples i - 1 - j
    for (uint32_t j = 0; j < ORDER; j++) {
        c[j] = _mm_set_epi64x(cb[j], ca[j]);
        h[j] = _mm_set_epi64x(xb[ORDER - 1 - j], xa[ORDER - 1 - j]);
    }
    const __m128i bias = _mm_set1_epi64x(INT64_MIN);
    const __m128i shift = _mm_set_epi64x(sb, sa);
    const __m128i unbias = _mm_set_epi64x((int64_t)(1ull << (63 - sb)),
                                          (int64_t)(1ull << (63 - sa)));
    for (uint32_t i = ORDER; i < n; i++) {
        __m128i p = _mm_setzero_si128();
        for (uint32_t j = ORDER - 1; j > 0; j--)
            p = _mm_add_epi64(p, _mm_mul_epi32(c[j], h[j]));
        p = _mm_add_epi64(p, _mm_mul_epi32(c[0], h[0]));
        __m128i q = _mm_sub_epi64(
            _mm_srlv_epi64(_mm_xor_si128(p, bias), shift), unbias);
        __m128i v = _mm_add_epi64(q, _mm_set_epi64x(xb[i], xa[i]));
        xa[i] = _mm_cvtsi128_si32(v);
        xb[i] = _mm_extract_epi32(v, 2);
        for (uint32_t j = ORDER - 1; j > 0; j--) h[j] = h[j - 1];
        h[0] = v;
    }
}
#endif

// The LPC restores of a frame's two channels. Where the build targets AVX2
// (native/build.py's -march=native on such a CPU) and both orders are 12
// or under, they run side by side at the higher order, the lower one's
// taps past its order zero, once its own samples up to that order are
// restored.
void restore_lpc_pair(const Lpc& a, const Lpc& b, uint32_t n, int32_t* xa,
                      int32_t* xb) {
#if defined(__AVX2__)
    uint32_t order = std::max(a.order, b.order);
    if (order <= 12) {
        int32_t ca[12] = {0}, cb[12] = {0};
        std::copy(a.coef, a.coef + a.order, ca);
        std::copy(b.coef, b.coef + b.order, cb);
        restore_lpc(a.order, a.coef, a.shift, order, xa);
        restore_lpc(b.order, b.coef, b.shift, order, xb);
        switch (order) {
            case 1: return restore_lpc2_n<1>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 2: return restore_lpc2_n<2>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 3: return restore_lpc2_n<3>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 4: return restore_lpc2_n<4>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 5: return restore_lpc2_n<5>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 6: return restore_lpc2_n<6>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 7: return restore_lpc2_n<7>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 8: return restore_lpc2_n<8>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 9: return restore_lpc2_n<9>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 10: return restore_lpc2_n<10>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 11: return restore_lpc2_n<11>(ca, cb, a.shift, b.shift, n, xa, xb);
            case 12: return restore_lpc2_n<12>(ca, cb, a.shift, b.shift, n, xa, xb);
        }
    }
#endif
    restore_lpc(a.order, a.coef, a.shift, n, xa);
    restore_lpc(b.order, b.coef, b.shift, n, xb);
}

void restore_fixed(uint32_t order, uint32_t n, int32_t* x) {
    // unsigned arithmetic: malformed residuals may overflow, and the
    // two's-complement wrap is well-defined (valid files never wrap)
    auto u = [&](uint32_t i) { return (uint32_t)x[i]; };
    switch (order) {
        case 0: break;
        case 1: for (uint32_t i = 1; i < n; i++) x[i] = (int32_t)(u(i) + u(i-1)); break;
        case 2: for (uint32_t i = 2; i < n; i++) x[i] = (int32_t)(u(i) + 2u*u(i-1) - u(i-2)); break;
        case 3: for (uint32_t i = 3; i < n; i++) x[i] = (int32_t)(u(i) + 3u*u(i-1) - 3u*u(i-2) + u(i-3)); break;
        case 4: for (uint32_t i = 4; i < n; i++) x[i] = (int32_t)(u(i) + 4u*u(i-1) - 6u*u(i-2) + 4u*u(i-3) - u(i-4)); break;
    }
}

// One Rice partition of cnt residuals with parameter k into out. The bits
// from br.pos on are held left-aligned in `buf`, the first `have` of them
// valid, and the bits after them start at byte `next`; each residual first
// tops `buf` up to 56 valid bits or more from a load at `next`, whose address
// is known a residual ahead, then takes its quotient with a count of leading
// zeros. A residual longer than the valid bits goes through br.
bool rice_partition(BitReader& br, uint32_t k, uint32_t cnt, int32_t* out) {
    const uint8_t* data = br.data;
    const size_t limit = br.limit;
    const uint8_t* next = data + (br.pos >> 3) + 7;
    uint32_t have = 56 - (uint32_t)(br.pos & 7);
    uint64_t buf = load_bits(data, br.pos);
    for (uint32_t i = 0; i < cnt; i++) {
        // bits of buf past `have` are zero or already the stream's, so
        // the OR leaves them as the stream has them
        buf |= load_be64(next) >> have;
        next += (63 - have) >> 3;
        have |= 56;
        uint32_t q, r;
        uint32_t q1 = buf ? (uint32_t)__builtin_clzll(buf) + 1 : 64;
        if (q1 + k <= have) {  // the 1 lies before limit: the pad is zeros
            q = q1 - 1;
            uint64_t w = buf << q1;
            r = (uint32_t)((w >> 1) >> (63 - k));  // 0 at k == 0
            buf = w << k;
            have -= q1 + k;
        } else {
            br.pos = (size_t)(next - data) * 8 - have;
            q = br.unary();
            r = br.bits((int)k);
            if (br.error) return false;
            next = data + (br.pos >> 3) + 7;
            have = 56 - (uint32_t)(br.pos & 7);
            buf = load_bits(data, br.pos);
        }
        if ((size_t)(next - data) * 8 - have > limit) {  // the remainder ran out
            br.error = true;
            return false;
        }
        uint32_t zz = (q << k) | r;
        out[i] = (int32_t)((zz >> 1) ^ (~(zz & 1) + 1));
    }
    br.pos = (size_t)(next - data) * 8 - have;
    return true;
}

struct FlacDecoder {
    FILE* f = nullptr;
    std::vector<uint8_t> stream;   // the whole file, then PAD zero bytes
    size_t nbytes = 0;             // the file's size
    size_t frames_off = 0;         // offset of first frame in `stream`
    // STREAMINFO
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t bps = 0;
    uint64_t total_samples = 0;
    uint32_t max_block = 0;
    struct SeekEntry { uint64_t sample, offset; };
    std::vector<SeekEntry> seektable;

    // the channels of the frame decode_frame decoded last, frame_len each
    std::vector<int32_t> chan[8];
    uint32_t frame_len = 0;

    // decode cursor
    size_t byte_pos = 0;           // into stream
    uint64_t next_sample = 0;      // absolute sample index of next decode
    std::vector<int32_t> pend;     // interleaved decoded-but-undelivered
    size_t pend_off = 0;

    ~FlacDecoder() {
        if (f) fclose(f);
    }

    bool open(const char* path) {
        f = fopen(path, "rb");
        if (!f) return false;
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        stream.resize((size_t)sz);
        if (fread(stream.data(), 1, (size_t)sz, f) != (size_t)sz) {
            fclose(f);       // destructor also covers this; be explicit
            f = nullptr;
            return false;
        }
        fclose(f);
        f = nullptr;
        if (sz < 42 || memcmp(stream.data(), "fLaC", 4) != 0) return false;
        size_t off = 4;
        bool last = false;
        bool have_si = false;
        while (!last) {
            if (off + 4 > stream.size()) return false;
            uint8_t hdr = stream[off];
            last = (hdr & 0x80) != 0;
            uint8_t type = hdr & 0x7F;
            uint32_t len = ((uint32_t)stream[off + 1] << 16) |
                           ((uint32_t)stream[off + 2] << 8) | stream[off + 3];
            off += 4;
            if (type == 0) {  // STREAMINFO
                if (len < 34 || off + 34 > stream.size()) return false;
                const uint8_t* p = stream.data() + off;
                max_block = ((uint32_t)p[2] << 8) | p[3];
                sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) | (p[12] >> 4);
                channels = ((p[12] >> 1) & 0x7) + 1;
                bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
                total_samples = ((uint64_t)(p[13] & 0x0F) << 32) |
                                ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                                ((uint64_t)p[16] << 8) | p[17];
                have_si = true;
            } else if (type == 3 && off + len <= stream.size()) {
                // SEEKTABLE: keep non-placeholder points (placeholder
                // sample number = all ones)
                for (uint32_t i = 0; i + 18 <= len; i += 18) {
                    const uint8_t* p = stream.data() + off + i;
                    uint64_t smp = 0, fo = 0;
                    for (int k = 0; k < 8; k++) smp = (smp << 8) | p[k];
                    for (int k = 0; k < 8; k++) fo = (fo << 8) | p[8 + k];
                    if (smp == ~0ull) continue;
                    seektable.push_back({smp, fo});
                }
            }
            off += len;
        }
        if (!have_si || off >= stream.size()) return false;
        // 32-bit streams need a 33-bit side channel; this decoder's
        // sample path is int32, so decline and let the caller fall back
        // to the pure-Python decoder (io/flac_py.py), which is exact
        if (bps > 24 || bps < 4) return false;
        nbytes = stream.size();
        stream.resize(nbytes + PAD, 0);
        frames_off = off;
        byte_pos = off;
        if (total_samples == 0) {
            // legal streamed encodes leave STREAMINFO total_samples = 0
            // (unknown length); every consumer here needs the length up
            // front (flush plans, output sizing), so count by decoding
            // one full pass, then rewind
            uint64_t start, counted = 0;
            while (decode_frame(&start)) counted += frame_len;
            total_samples = counted;
            byte_pos = frames_off;
            next_sample = 0;
            pend.clear();
            pend_off = 0;
        }
        return true;
    }

    // decode one frame at byte_pos into chan[0..channels), frame_len each
    bool decode_frame(uint64_t* frame_start) {
        if (byte_pos + 5 >= nbytes) return false;
        BitReader br{stream.data(), nbytes * 8, byte_pos * 8};
        uint32_t sync = br.bits(14);
        if (br.error || sync != 0x3FFE) return false;
        br.bits(1);                      // reserved
        uint32_t blocking = br.bits(1);  // 0 fixed, 1 variable
        uint32_t bs_bits = br.bits(4);
        uint32_t sr_bits = br.bits(4);
        uint32_t ch_asgn = br.bits(4);
        uint32_t ss_bits = br.bits(3);
        br.bits(1);                      // reserved
        uint64_t num;
        if (!utf8_decode(br, &num)) return false;

        uint32_t bsize = 0;
        switch (bs_bits) {
            case 1: bsize = 192; break;
            case 2: case 3: case 4: case 5: bsize = 576u << (bs_bits - 2); break;
            case 6: bsize = br.bits(8) + 1; break;
            case 7: bsize = br.bits(16) + 1; break;
            default:
                if (bs_bits >= 8) bsize = 256u << (bs_bits - 8);
                else return false;
        }
        switch (sr_bits) {  // consume inline sample-rate fields
            case 12: br.bits(8); break;
            case 13: case 14: br.bits(16); break;
            default: break;
        }
        uint32_t fbps = bps;
        switch (ss_bits) {
            case 0: break;  // from STREAMINFO
            case 1: fbps = 8; break;
            case 2: fbps = 12; break;
            case 4: fbps = 16; break;
            case 5: fbps = 20; break;
            case 6: fbps = 24; break;
            case 7: fbps = 32; break;
            default: return false;
        }
        br.bits(8);  // header CRC-8 (trusted)

        uint32_t nch = channels;
        int side = -1;  // which channel carries the side (+1 bit)
        if (ch_asgn <= 7) {
            nch = ch_asgn + 1;
        } else if (ch_asgn == 8) { nch = 2; side = 1; }   // L/S
        else if (ch_asgn == 9) { nch = 2; side = 0; }     // S/R
        else if (ch_asgn == 10) { nch = 2; side = 1; }    // M/S
        else return false;
        if (nch != channels) return false;

        Lpc lpc[8];
        uint32_t wasted[8];
        for (uint32_t c = 0; c < nch; c++) {
            uint32_t cbps = fbps + (side == (int)c ? 1 : 0);
            if (chan[c].size() < bsize) chan[c].resize(bsize);
            if (!decode_subframe(br, bsize, cbps, chan[c].data(), lpc[c],
                                 wasted[c]))
                return false;
        }
        br.align();
        br.bits(16);  // frame CRC-16 (trusted)
        if (br.error) return false;

        // the LPC restores, then the wasted bits
        if (nch == 2 && lpc[0].order && lpc[1].order) {
            restore_lpc_pair(lpc[0], lpc[1], bsize, chan[0].data(),
                             chan[1].data());
        } else {
            for (uint32_t c = 0; c < nch; c++)
                if (lpc[c].order)
                    restore_lpc(lpc[c].order, lpc[c].coef, lpc[c].shift,
                                bsize, chan[c].data());
        }
        for (uint32_t c = 0; c < nch; c++) {
            int32_t* x = chan[c].data();
            if (wasted[c])
                for (uint32_t i = 0; i < bsize; i++)
                    x[i] = (int32_t)((uint32_t)x[i] << wasted[c]);
        }

        // stereo decorrelation
        int32_t* a = chan[0].data();
        int32_t* b = nch > 1 ? chan[1].data() : nullptr;
        if (ch_asgn == 8) {        // left/side: R = L - S
            for (uint32_t i = 0; i < bsize; i++) b[i] = a[i] - b[i];
        } else if (ch_asgn == 9) { // side/right: L = S + R
            for (uint32_t i = 0; i < bsize; i++) a[i] = a[i] + b[i];
        } else if (ch_asgn == 10) {// mid/side
            for (uint32_t i = 0; i < bsize; i++) {
                int64_t mid = a[i];
                int64_t s = b[i];
                mid = (int64_t)(((uint64_t)mid << 1) | ((uint64_t)s & 1));
                a[i] = (int32_t)((mid + s) >> 1);
                b[i] = (int32_t)((mid - s) >> 1);
            }
        }

        frame_len = bsize;
        *frame_start = blocking ? num : num * max_block;
        byte_pos = (br.pos + 7) / 8;
        return true;
    }

    // the frame decode_frame decoded last, interleaved into dst
    void interleave(int32_t* dst) const {
        for (uint32_t i = 0; i < frame_len; i++)
            for (uint32_t c = 0; c < channels; c++)
                dst[(size_t)i * channels + c] = chan[c][i];
    }

    // the frame decode_frame decoded last, whole in pend from sample `skip`
    void pend_frame(uint64_t skip) {
        pend.resize((size_t)frame_len * channels);
        interleave(pend.data());
        pend_off = (size_t)skip * channels;
    }

    // One subframe into out, all but an LPC subframe's restore (which
    // decode_frame makes from `lpc`) and the `wasted` bits' shift.
    bool decode_subframe(BitReader& br, uint32_t bsize, uint32_t cbps,
                         int32_t* out, Lpc& lpc, uint32_t& wasted) {
        if (br.bits(1) != 0) return false;  // padding
        uint32_t type = br.bits(6);
        wasted = 0;
        if (br.bits(1)) wasted = br.unary() + 1;
        if (wasted >= cbps || wasted >= 32) return false;  // ebps underflow / UB shift
        uint32_t ebps = cbps - wasted;

        if (type == 0) {                     // CONSTANT
            int32_t v = br.sbits((int)ebps);
            for (uint32_t i = 0; i < bsize; i++) out[i] = v;
        } else if (type == 1) {              // VERBATIM
            for (uint32_t i = 0; i < bsize; i++) out[i] = br.sbits((int)ebps);
        } else if (type >= 8 && type <= 12) {  // FIXED
            uint32_t order = type - 8;
            if (order > bsize) return false;  // warmup would overflow out[bsize]
            for (uint32_t i = 0; i < order; i++) out[i] = br.sbits((int)ebps);
            if (!decode_residual(br, bsize, order, out)) return false;
            restore_fixed(order, bsize, out);
        } else if (type >= 32) {             // LPC
            uint32_t order = (type & 0x1F) + 1;
            if (order > bsize) return false;  // warmup would overflow out[bsize]
            for (uint32_t i = 0; i < order; i++) out[i] = br.sbits((int)ebps);
            uint32_t prec = br.bits(4) + 1;
            if (prec == 16) return false;  // 1111 invalid
            lpc.shift = (int)br.bits(5);
            for (uint32_t i = 0; i < order; i++) lpc.coef[i] = br.sbits((int)prec);
            if (!decode_residual(br, bsize, order, out)) return false;
            lpc.order = order;
        } else {
            return false;
        }
        return !br.error;
    }

    bool decode_residual(BitReader& br, uint32_t bsize, uint32_t order,
                         int32_t* out) {
        uint32_t method = br.bits(2);
        if (method > 1) return false;
        int pbits = method == 0 ? 4 : 5;
        uint32_t esc = method == 0 ? 0xF : 0x1F;
        uint32_t po = br.bits(4);
        uint32_t parts = 1u << po;
        if (bsize % parts || (bsize >> po) < order) return false;
        uint32_t idx = order;
        for (uint32_t p = 0; p < parts; p++) {
            uint32_t cnt = bsize >> po;
            if (p == 0) cnt -= order;
            uint32_t k = br.bits(pbits);
            if (br.error) return false;
            if (k == esc) {
                uint32_t raw = br.bits(5);
                for (uint32_t i = 0; i < cnt; i++) out[idx + i] = raw ? br.sbits((int)raw) : 0;
                if (br.error) return false;
            } else if (!rice_partition(br, k, cnt, out + idx)) {
                return false;
            }
            idx += cnt;
        }
        return idx == bsize;
    }

    // sequential read of n interleaved sample frames into dst; a frame
    // that fits whole goes straight there, the rest of one through pend
    long read(int32_t* dst, long want) {
        long got = 0;
        while (got < want) {
            if (pend_off < pend.size()) {
                size_t take = std::min((size_t)(want - got) * channels,
                                       pend.size() - pend_off);
                memcpy(dst + (size_t)got * channels, pend.data() + pend_off,
                       take * sizeof(int32_t));
                pend_off += take;
                got += (long)(take / channels);
                continue;
            }
            uint64_t start;
            if (!decode_frame(&start)) return got;
            next_sample = start + frame_len;
            if ((uint64_t)(want - got) >= frame_len) {
                interleave(dst + (size_t)got * channels);
                got += frame_len;
            } else {
                pend_frame(0);
            }
        }
        return got;
    }

    bool seek(uint64_t sample) {
        // jump via SEEKTABLE when present (largest point <= target),
        // then walk the remaining frames; without a table, walk from the
        // first frame (headers only carry their own start sample)
        byte_pos = frames_off;
        pend.clear();
        pend_off = 0;
        next_sample = 0;
        for (size_t i = seektable.size(); i-- > 0;) {
            if (seektable[i].sample <= sample
                && frames_off + seektable[i].offset < nbytes) {
                byte_pos = frames_off + (size_t)seektable[i].offset;
                next_sample = seektable[i].sample;
                break;
            }
        }
        while (true) {
            uint64_t start;
            if (!decode_frame(&start)) return sample == next_sample;
            uint64_t end = start + frame_len;
            if (sample < end) {
                pend_frame(sample - start);
                next_sample = end;
                return true;
            }
            next_sample = end;
        }
    }
};

// ------------------------------------------------------- encoder threads
// The encoders' helper threads come from one budget for the process: the
// CPUs of its affinity mask, less one for the caller. A write takes helpers
// only while the threads encoding pooled blocks, over every open encoder
// and callers included, stay within those CPUs, so writers running side by
// side never start more encoding threads than the host has CPUs; helpers
// freed by one writer go to the next call of any other.
int helper_budget() {
    static const int budget = [] {
        cpu_set_t set;
        int cpus = 0;
        if (sched_getaffinity(0, sizeof set, &set) == 0) cpus = CPU_COUNT(&set);
        if (cpus < 1) cpus = (int)std::thread::hardware_concurrency();
        return cpus > 1 ? cpus - 1 : 0;
    }();
    return budget;
}

std::atomic<int> g_encoding{0};     // callers and helpers of pooled writes
std::atomic<int> g_helpers{0};      // helpers alone
std::atomic<int> g_helpers_peak{0};

// The helpers of one write, held from the grant to the end of its scope.
// Helpers are counted into g_encoding before g_helpers and out of it after,
// so g_helpers never exceeds helper_budget().
struct HelperGrant {
    int helpers = 0;
    bool counted = false;

    explicit HelperGrant(int want) {
        if (want <= 0) return;
        counted = true;
        int cur = g_encoding.load();
        do {
            helpers = std::max(0, std::min(want, helper_budget() - cur));
        } while (!g_encoding.compare_exchange_weak(cur, cur + 1 + helpers));
        int now = g_helpers.fetch_add(helpers) + helpers;
        int peak = g_helpers_peak.load();
        while (now > peak && !g_helpers_peak.compare_exchange_weak(peak, now)) {
        }
    }

    // give back the helpers granted but not started
    void keep(size_t started) {
        int back = helpers - (int)started;
        g_helpers -= back;
        g_encoding -= back;
        helpers = (int)started;
    }

    ~HelperGrant() {
        if (!counted) return;
        g_helpers -= helpers;
        g_encoding -= 1 + helpers;
    }
};

// ---------------------------------------------------------------- encoder
// r + a * b rounded as the compiler contracts `r + a * b`: fused where the
// target has a fused multiply-add, as -ffp-contract=fast (g++'s default for
// C++) makes it, else a product and a sum
inline double mac(double r, double a, double b) {
#ifdef __FP_FAST_FMA
    return std::fma(a, b, r);
#else
    return r + a * b;
#endif
}

struct FlacEncoder {
    FILE* f = nullptr;
    uint32_t sample_rate, channels, bps;
    uint64_t total = 0;
    uint32_t frame_no = 0;
    static const uint32_t BLOCK = 4096;
    static const uint32_t SEEK_POINTS = 512;   // placeholders reserved
    std::vector<int32_t> pend;  // interleaved
    struct SeekPt { uint64_t sample, offset; uint16_t nsamples; };
    std::vector<SeekPt> seekpts;
    uint64_t next_seek_sample = 0;
    uint64_t seek_spacing = 0;                 // samples between points
    long frames_start = 0;

    bool open(const char* path, uint32_t sr, uint32_t ch, uint32_t b) {
        sample_rate = sr; channels = ch; bps = b;
        f = fopen(path, "wb");
        if (!f) return false;
        write_header(0);
        write_seektable();                     // placeholder table
        frames_start = ftell(f);
        seek_spacing = (uint64_t)sr * 10;      // one point per 10 s
        next_seek_sample = 0;
        return true;
    }

    // SEEKTABLE metadata block: SEEK_POINTS 18-byte points, placeholders
    // (sample = 0xFF..FF) until close() patches the recorded ones in
    void write_seektable() {
        uint32_t len = SEEK_POINTS * 18;
        uint8_t hdr[4] = {0x80 | 3, (uint8_t)(len >> 16),
                          (uint8_t)(len >> 8), (uint8_t)len};  // last block
        fwrite(hdr, 1, 4, f);
        std::vector<uint8_t> body(len, 0xFF);
        for (uint32_t i = 0; i < SEEK_POINTS; i++)  // placeholder: rest 0
            memset(body.data() + i * 18 + 8, 0, 10);
        size_t fill = seekpts.size() < SEEK_POINTS ? seekpts.size()
                                                   : SEEK_POINTS;
        for (size_t i = 0; i < fill; i++) {
            uint8_t* p = body.data() + i * 18;
            const SeekPt& s = seekpts[i];
            for (int k = 0; k < 8; k++) p[k] = (uint8_t)(s.sample >> (56 - 8 * k));
            for (int k = 0; k < 8; k++) p[8 + k] = (uint8_t)(s.offset >> (56 - 8 * k));
            p[16] = (uint8_t)(s.nsamples >> 8);
            p[17] = (uint8_t)s.nsamples;
        }
        fwrite(body.data(), 1, len, f);
    }

    void write_header(uint64_t total_samples) {
        uint8_t h[4 + 4 + 34];
        memcpy(h, "fLaC", 4);
        h[4] = 0x00;  // STREAMINFO, not last (SEEKTABLE follows)
        h[5] = 0; h[6] = 0; h[7] = 34;
        uint8_t* p = h + 8;
        memset(p, 0, 34);
        p[0] = BLOCK >> 8; p[1] = BLOCK & 0xFF;       // min block
        p[2] = BLOCK >> 8; p[3] = BLOCK & 0xFF;       // max block
        // min/max frame size unknown (0)
        p[10] = (uint8_t)(sample_rate >> 12);
        p[11] = (uint8_t)(sample_rate >> 4);
        p[12] = (uint8_t)(((sample_rate & 0xF) << 4) | (((channels - 1) & 7) << 1) |
                          (((bps - 1) >> 4) & 1));
        p[13] = (uint8_t)((((bps - 1) & 0xF) << 4) | ((total_samples >> 32) & 0xF));
        p[14] = (uint8_t)(total_samples >> 24);
        p[15] = (uint8_t)(total_samples >> 16);
        p[16] = (uint8_t)(total_samples >> 8);
        p[17] = (uint8_t)total_samples;
        // md5 zeros = unknown
        fwrite(h, 1, sizeof h, f);
    }

    // One call's samples: interleaved int32, or 3-byte little-endian
    // PCM_24 (b24) unpacked where they are encoded.
    struct Source {
        const int32_t* x;
        const uint8_t* b24;
        Source at(size_t i) const {
            return {x ? x + i : nullptr, b24 ? b24 + 3 * i : nullptr};
        }
    };

    static int32_t le24(const uint8_t* b) {
        return (int32_t)((uint32_t)b[0] << 8 | (uint32_t)b[1] << 16 |
                         (uint32_t)b[2] << 24) >> 8;
    }

    void append_pend(Source src, size_t n) {
        size_t at = pend.size();
        pend.resize(at + n);
        int32_t* out = pend.data() + at;
        if (src.x) memcpy(out, src.x, n * sizeof(int32_t));
        else for (size_t i = 0; i < n; i++) out[i] = le24(src.b24 + 3 * i);
    }

    // Encode n frames of src. The full blocks' bytes depend only on their
    // samples and frame numbers, so a call with two or more full blocks
    // makes them on the calling thread and on helper threads, then writes
    // them in block order; the seek points and the file position follow
    // the sequential encoder's exactly. Returns the number of blocks made
    // on more than one thread.
    long write(Source src, long n) {
        const size_t stride = (size_t)BLOCK * channels;
        const size_t navail = (size_t)n * channels;
        size_t off = 0;
        std::vector<Source> blocks;
        // top up a partial pending block first
        if (!pend.empty()) {
            off = std::min(navail, stride - pend.size());
            append_pend(src, off);
            if (pend.size() == stride) blocks.push_back({pend.data(), nullptr});
        }
        for (; navail - off >= stride; off += stride)
            blocks.push_back(src.at(off));
        long pooled = 0;
        if (!blocks.empty()) {
            std::vector<std::vector<uint8_t>> frames(blocks.size());
            pooled = make_frames(blocks, frames);
            for (auto& b : frames) {
                record_seekpoint(BLOCK);
                fwrite(b.data(), 1, b.size(), f);
                std::vector<uint8_t>().swap(b);
                frame_no++;
                total += BLOCK;
            }
        }
        if (pend.size() == stride) pend.clear();
        append_pend(src.at(off), navail - off);
        return pooled;
    }

    // frames[k] = the bytes of blocks[k], frame number frame_no + k. Two or
    // more blocks are shared among the calling thread and the helpers the
    // process-wide budget grants; returns the blocks made that way (0 when
    // no helper was granted).
    long make_frames(const std::vector<Source>& blocks,
                     std::vector<std::vector<uint8_t>>& frames) const {
        const long nb = (long)blocks.size();
        std::atomic<long> next{0};
        auto work = [&] {
            for (long k; (k = next.fetch_add(1)) < nb;)
                frame_bytes(blocks[k], BLOCK, frame_no + (uint32_t)k, frames[k]);
        };
        HelperGrant grant((int)std::min<long>(nb - 1, helper_budget()));
        std::vector<std::thread> pool;
        try {
            for (int t = 0; t < grant.helpers; t++) pool.emplace_back(work);
        } catch (const std::system_error&) {
            // a thread the system refused: the others and the caller
            // share the blocks
        }
        grant.keep(pool.size());
        work();
        for (auto& th : pool) th.join();
        return pool.empty() ? 0 : nb;
    }

    void close() {
        if (!f) return;
        if (!pend.empty()) {
            uint32_t n = (uint32_t)(pend.size() / channels);
            encode_frame(pend.data(), n);
            total += n;
            pend.clear();
        }
        fseek(f, 0, SEEK_SET);
        write_header(total);
        write_seektable();  // same size: patches the recorded points in
        fclose(f);
        f = nullptr;
    }

    void encode_frame(const int32_t* x, uint32_t bsize) {
        // `total` is still this frame's first sample (caller adds after)
        record_seekpoint(bsize);
        std::vector<uint8_t> b;
        frame_bytes({x, nullptr}, bsize, frame_no++, b);
        fwrite(b.data(), 1, b.size(), f);
    }

    void record_seekpoint(uint32_t bsize) {
        if (total >= next_seek_sample && seekpts.size() < SEEK_POINTS) {
            seekpts.push_back({total,
                               (uint64_t)(ftell(f) - frames_start),
                               (uint16_t)bsize});
            while (next_seek_sample <= total) next_seek_sample += seek_spacing;
        }
    }

    // A thread's working memory for frame_bytes, kept from frame to frame.
    struct Scratch {
        std::vector<int32_t> chan;  // the subframes' samples, one after another
        std::vector<int32_t> res;   // the LPC trial's residual, or the fixed one's
        std::vector<double> w;      // the Welch-windowed samples, reversed
        std::vector<double> welch;  // the Welch window of the last block size
        BitWriter bw;
    };

    // The bytes of one frame, into out: a function of its samples and its
    // number. The samples lie within bps bits (FlacWriter clips them), so a
    // side channel has 25 bits at most and every stage below is exact in
    // int32 (sums and LPC predictions in 64 bits).
    void frame_bytes(Source src, uint32_t bsize, uint32_t fno_value,
                     std::vector<uint8_t>& out) const {
        static thread_local Scratch s;
        s.chan.resize((size_t)bsize * channels);
        s.res.resize(bsize);
        s.w.resize(bsize + 4);
        int32_t* sub[8];
        uint32_t sub_bps[8];
        for (uint32_t c = 0; c < channels; c++) {
            sub[c] = s.chan.data() + (size_t)c * bsize;
            sub_bps[c] = bps;
            deinterleave(src, c, bsize, sub[c]);
        }
        uint32_t ch_asgn = channels - 1;  // independent
        if (channels == 2) ch_asgn = decorrelate(sub[0], sub[1], bsize, sub_bps);

        BitWriter& bw = s.bw;
        bw.reset();
        bw.bits(0x3FFE, 14);
        bw.bits(0, 1);
        bw.bits(0, 1);  // fixed blocking
        uint32_t bs_bits;
        bool bs16 = false;
        if (bsize == BLOCK) bs_bits = 12;           // 4096
        else { bs_bits = 7; bs16 = true; }          // 16-bit at end
        bw.bits(bs_bits, 4);
        bw.bits(0, 4);  // sample rate: from STREAMINFO
        bw.bits(ch_asgn, 4);
        uint32_t ss_bits = bps == 8 ? 1 : bps == 16 ? 4 : bps == 24 ? 6 : 7;
        bw.bits(ss_bits, 3);
        bw.bits(0, 1);
        uint8_t fno[8];
        int nfno = utf8_encode(fno_value, fno);
        for (int i = 0; i < nfno; i++) bw.bits(fno[i], 8);
        if (bs16) bw.bits(bsize - 1, 16);
        bw.align();
        bw.bits(crc8(bw.bytes(), bw.len()), 8);

        for (uint32_t c = 0; c < channels; c++)
            encode_subframe(bw, sub[c], sub_bps[c], bsize, s);
        bw.align();
        bw.bits(crc16(bw.bytes(), bw.len()), 16);
        out.assign(bw.bytes(), bw.bytes() + bw.len());
    }

    // channel c of the block's bsize frames into dst
    void deinterleave(Source src, uint32_t c, uint32_t bsize,
                      int32_t* dst) const {
        const size_t step = channels;
        if (src.x) {
            const int32_t* x = src.x + c;
            for (uint32_t i = 0; i < bsize; i++) dst[i] = x[i * step];
        } else {
            const uint8_t* b = src.b24 + 3 * c;
            for (uint32_t i = 0; i < bsize; i++) dst[i] = le24(b + 3 * i * step);
        }
    }

    // The stereo decorrelation search (the reference decoder takes 8 = L/S,
    // 9 = S/R, 10 = M/S): an assignment costs the sum of its two channels'
    // |second difference|, the four channels' sums from one pass over L and
    // R; the cheapest assignment's channels replace L and R. Returns the
    // assignment.
    uint32_t decorrelate(int32_t* l, int32_t* r, uint32_t bsize,
                         uint32_t* sub_bps) const {
        unsigned long long cl = 0, cr = 0, cm = 0, cs = 0;
        for (uint32_t i = 2; i < bsize; i++) {
            int32_t dl = l[i] - 2 * l[i - 1] + l[i - 2];
            int32_t dr = r[i] - 2 * r[i - 1] + r[i - 2];
            int32_t dm = ((l[i] + r[i]) >> 1) - 2 * ((l[i - 1] + r[i - 1]) >> 1)
                         + ((l[i - 2] + r[i - 2]) >> 1);
            int32_t ds = dl - dr;
            cl += (uint32_t)std::abs(dl);
            cr += (uint32_t)std::abs(dr);
            cm += (uint32_t)std::abs(dm);
            cs += (uint32_t)std::abs(ds);
        }
        unsigned long long best = cl + cr;
        uint32_t asgn = 1;
        if (cl + cs < best) { best = cl + cs; asgn = 8; }
        if (cs + cr < best) { best = cs + cr; asgn = 9; }
        if (cm + cs < best) { best = cm + cs; asgn = 10; }
        if (asgn == 8) {
            for (uint32_t i = 0; i < bsize; i++) r[i] = l[i] - r[i];
            sub_bps[1] = bps + 1;
        } else if (asgn == 9) {
            for (uint32_t i = 0; i < bsize; i++) l[i] = l[i] - r[i];
            sub_bps[0] = bps + 1;
        } else if (asgn == 10) {
            for (uint32_t i = 0; i < bsize; i++) {
                int32_t lv = l[i], rv = r[i];
                l[i] = (lv + rv) >> 1;
                r[i] = lv - rv;
            }
            sub_bps[1] = bps + 1;
        }
        return asgn;
    }

    // Levinson-Durbin LPC analysis (Welch-windowed autocorrelation).
    // Returns quantized coefficients + shift; order 0 means "LPC not
    // usable" for this block. The residual is the scratch's res.
    struct Lpc {
        int order = 0;
        int shift = 0;
        int32_t q[32];
        unsigned long long bits = ~0ull;  // estimated encoded subframe bits
    };
    static constexpr int LPC_MAX_ORDER = 12;

    // Estimated rice bits for n residuals with |.|-sum s (one partition,
    // same estimator encode_residual uses for partition-order scoring).
    static unsigned long long rice_bits_est(unsigned long long s, uint32_t n) {
        if (n == 0) return 0;
        int k = 0;
        while (k < 30 && ((unsigned long long)n << k) < 2 * s) k++;
        return (unsigned long long)n * (k + 1) + ((2 * s) >> k);
    }

    // The order-ORDER LPC residual of x into res[ORDER, n) and its
    // |.|-sum; false if a residual passes the int32 / 2 range. int32
    // products summed in int64, as restore_lpc_n restores them.
    template <int ORDER>
    static bool lpc_residual(const int32_t* x, uint32_t n, const int32_t* q,
                             int shift, int32_t* res, unsigned long long& cost) {
        int64_t c[ORDER];
        for (int j = 0; j < ORDER; j++) c[j] = q[j];
        unsigned long long sum = 0;
        bool bad = false;
        uint32_t i = ORDER;
#if defined(__AVX2__)
        // four residuals at a time, one per 64-bit lane: a product is a
        // pmuldq (signed 32 x 32 -> 64 bits), the arithmetic shift a logical
        // one of the sum offset by 2^63, |v| (v ^ s) - s with s its sign
        const __m256i zero = _mm256_setzero_si256();
        const __m256i bias = _mm256_set1_epi64x(INT64_MIN);
        const __m256i unbias = _mm256_set1_epi64x((int64_t)(1ull << (63 - shift)));
        const __m128i sh = _mm_cvtsi32_si128(shift);
        const __m256i hi = _mm256_set1_epi64x(INT32_MAX / 2);
        const __m256i lo = _mm256_set1_epi64x(INT32_MIN / 2);
        const __m256i low_halves = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
        __m256i cv[ORDER];
        for (int j = 0; j < ORDER; j++) cv[j] = _mm256_set1_epi64x(c[j]);
        __m256i out_of_range = zero, sums = zero;
        auto load4 = [](const int32_t* p) {
            return _mm256_cvtepi32_epi64(_mm_loadu_si128((const __m128i*)p));
        };
        for (; i + 4 <= n; i += 4) {
            __m256i p = zero;
            for (int j = 0; j < ORDER; j++)
                p = _mm256_add_epi64(p, _mm256_mul_epi32(cv[j], load4(x + i - 1 - j)));
            __m256i pred = _mm256_sub_epi64(
                _mm256_srl_epi64(_mm256_xor_si256(p, bias), sh), unbias);
            __m256i v = _mm256_sub_epi64(load4(x + i), pred);
            out_of_range = _mm256_or_si256(out_of_range, _mm256_or_si256(
                _mm256_cmpgt_epi64(v, hi), _mm256_cmpgt_epi64(lo, v)));
            _mm_storeu_si128((__m128i*)(res + i), _mm256_castsi256_si128(
                _mm256_permutevar8x32_epi32(v, low_halves)));
            __m256i sign = _mm256_cmpgt_epi64(zero, v);
            sums = _mm256_add_epi64(sums, _mm256_sub_epi64(_mm256_xor_si256(v, sign), sign));
        }
        bad = !_mm256_testz_si256(out_of_range, out_of_range);
        alignas(32) uint64_t lane[4];
        _mm256_store_si256((__m256i*)lane, sums);
        sum = lane[0] + lane[1] + lane[2] + lane[3];
#endif
        for (; i < n; i++) {
            int64_t p = 0;
            for (int j = 0; j < ORDER; j++) p += c[j] * x[i - 1 - j];
            int64_t v = x[i] - (p >> shift);
            bad |= v > INT32_MAX / 2 || v < INT32_MIN / 2;
            res[i] = (int32_t)v;
            sum += (unsigned long long)(v < 0 ? -v : v);
        }
        cost = sum;
        return !bad;
    }

    // Quantize a double coefficient set and compute the exact residual.
    // Returns false on quantization failure or residual overflow.
    static bool realize_lpc(const int32_t* x, uint32_t bsize,
                            const double* lpc, int order, uint32_t cbps,
                            Lpc& out, int32_t* res) {
        double maxc = 0;
        for (int j = 0; j < order; j++)
            if (std::abs(lpc[j]) > maxc) maxc = std::abs(lpc[j]);
        if (maxc <= 0) return false;
        int shift = 14;
        while (shift > 0 && maxc * (double)(1 << shift) > 16383.0) shift--;
        if (shift <= 0) return false;
        for (int j = 0; j < order; j++) {
            long long q = llround(lpc[j] * (double)(1 << shift));
            if (q > 16383) q = 16383;
            if (q < -16384) q = -16384;
            out.q[j] = (int32_t)q;
        }
        out.order = order;
        out.shift = shift;
        unsigned long long cost = 0;
        bool ok = false;
        switch (order) {
            case 1: ok = lpc_residual<1>(x, bsize, out.q, shift, res, cost); break;
            case 2: ok = lpc_residual<2>(x, bsize, out.q, shift, res, cost); break;
            case 3: ok = lpc_residual<3>(x, bsize, out.q, shift, res, cost); break;
            case 4: ok = lpc_residual<4>(x, bsize, out.q, shift, res, cost); break;
            case 5: ok = lpc_residual<5>(x, bsize, out.q, shift, res, cost); break;
            case 6: ok = lpc_residual<6>(x, bsize, out.q, shift, res, cost); break;
            case 7: ok = lpc_residual<7>(x, bsize, out.q, shift, res, cost); break;
            case 8: ok = lpc_residual<8>(x, bsize, out.q, shift, res, cost); break;
            case 9: ok = lpc_residual<9>(x, bsize, out.q, shift, res, cost); break;
            case 10: ok = lpc_residual<10>(x, bsize, out.q, shift, res, cost); break;
            case 11: ok = lpc_residual<11>(x, bsize, out.q, shift, res, cost); break;
            case 12: ok = lpc_residual<12>(x, bsize, out.q, shift, res, cost); break;
        }
        if (!ok) return false;
        out.bits = rice_bits_est(cost, bsize - order)
                   + (unsigned long long)order * (cbps + 15) + 17;
        return true;
    }

    // r[lag], lags 0-12 (13-15 padding), of the Welch-windowed block: r
    // holds 16 zeros. Each lag's sum adds the same products in the same
    // order (i rising from the lag) with the same rounding as a pass per
    // lag, `r[lag] += w[i] * w[i - lag]`, would; here all lags go in one
    // pass over i.
    static void autocorrelation(const int32_t* x, uint32_t bsize, Scratch& s,
                                double* r) {
        constexpr uint32_t max_order = LPC_MAX_ORDER;
        // the window, w[i] = x[i] * (1 - t*t), its second factor kept per
        // block size
        if (s.welch.size() != bsize) {
            s.welch.resize(bsize);
            for (uint32_t i = 0; i < bsize; i++) {
                double t = ((double)i - (bsize - 1) / 2.0) / ((bsize + 1) / 2.0);
                s.welch[i] = mac(1.0, -t, t);
            }
        }
        // the windowed samples newest first, wr[bsize - 1 - i] sample i's,
        // and zeros after: sample i's products with itself and the 12
        // samples before it pair it with the 16 values from its own place on
        double* wr = s.w.data();
        for (uint32_t i = 0; i < bsize; i++)
            wr[bsize - 1 - i] = (double)x[i] * s.welch[i];
        std::fill(wr + bsize, wr + bsize + 4, 0.0);
        for (uint32_t i = 0; i < max_order; i++) {
            const double* v = wr + (bsize - 1 - i);
            for (uint32_t lag = 0; lag <= i; lag++) r[lag] = mac(r[lag], v[0], v[lag]);
        }
        uint32_t i = max_order;
#if defined(__AVX2__) && defined(__FMA__)
        __m256d a0 = _mm256_loadu_pd(r), a1 = _mm256_loadu_pd(r + 4),
                a2 = _mm256_loadu_pd(r + 8), a3 = _mm256_loadu_pd(r + 12);
        for (; i < bsize; i++) {
            const double* v = wr + (bsize - 1 - i);
            __m256d wi = _mm256_broadcast_sd(v);
            a0 = _mm256_fmadd_pd(wi, _mm256_loadu_pd(v), a0);
            a1 = _mm256_fmadd_pd(wi, _mm256_loadu_pd(v + 4), a1);
            a2 = _mm256_fmadd_pd(wi, _mm256_loadu_pd(v + 8), a2);
            a3 = _mm256_fmadd_pd(wi, _mm256_loadu_pd(v + 12), a3);
        }
        _mm256_storeu_pd(r, a0);
        _mm256_storeu_pd(r + 4, a1);
        _mm256_storeu_pd(r + 8, a2);
        _mm256_storeu_pd(r + 12, a3);
#endif
        for (; i < bsize; i++) {
            const double* v = wr + (bsize - 1 - i);
            for (int lag = 0; lag < 16; lag++) r[lag] = mac(r[lag], v[0], v[lag]);
        }
    }

    static Lpc analyze_lpc(const int32_t* x, uint32_t bsize, uint32_t cbps,
                           Scratch& s) {
        constexpr int max_order = LPC_MAX_ORDER;
        Lpc out;
        if ((int)bsize <= max_order * 2) return out;
        double r[33] = {0};
        autocorrelation(x, bsize, s, r);
        if (r[0] <= 0) return out;
        // Levinson-Durbin with per-order snapshots + prediction error so a
        // bits estimate can pick the order (libFLAC-style order selection)
        double lpc[32] = {0}, tmp[32];
        double snap[32][32];
        double errs[33];
        double err = r[0];
        int order = 0;
        for (int m = 0; m < max_order; m++) {
            double acc = r[m + 1];
            for (int j = 0; j < m; j++) acc -= lpc[j] * r[m - j];
            double k = acc / err;
            for (int j = 0; j < m; j++) tmp[j] = lpc[j] - k * lpc[m - 1 - j];
            for (int j = 0; j < m; j++) lpc[j] = tmp[j];
            lpc[m] = k;
            err *= (1.0 - k * k);
            order = m + 1;
            for (int j = 0; j < order; j++) snap[m][j] = lpc[j];
            errs[m] = err > 0 ? err : 1e-9;
            if (err <= 0) break;
        }
        if (order == 0) return out;
        // estimated bits at order m: residual entropy (~1/2 log2 of the
        // prediction-error power per sample) + header (warmup + coeffs)
        int best_m = 0;
        double best_est = 1e300;
        for (int m = 0; m < order; m++) {
            double var = errs[m] / (double)bsize;
            double bps_est = var > 1e-9 ? 0.5 * std::log2(var) : 0.0;
            double est = (double)(bsize - (m + 1)) * (bps_est + 2.0)
                         + (double)(m + 1) * (double)(cbps + 15);
            if (est < best_est) { best_est = est; best_m = m; }
        }
        // realize the estimated best order only (realization is the O(n)
        // cost; the error-based estimate picks within ~1 order of optimal);
        // fall back one order if quantization/overflow rejects it
        for (int m = best_m; m >= 0 && m > best_m - 2; m--) {
            Lpc trial;
            if (!realize_lpc(x, bsize, snap[m], m + 1, cbps, trial,
                             s.res.data()))
                continue;
            out = trial;
            break;
        }
        return out;
    }

    // The order-o fixed predictor's residual at i >= o.
    static int32_t fixed_at(const int32_t* x, uint32_t i, int o) {
        switch (o) {
            case 0: return x[i];
            case 1: return x[i] - x[i - 1];
            case 2: return x[i] - 2 * x[i - 1] + x[i - 2];
            case 3: return x[i] - 3 * x[i - 1] + 3 * x[i - 2] - x[i - 3];
            default: return x[i] - 4 * x[i - 1] + 6 * x[i - 2] - 4 * x[i - 3] + x[i - 4];
        }
    }

    // cost[o]: the |.|-sum of the order-o fixed residual over [o, n), all
    // five orders in one pass (an order-4 residual of 25-bit samples is
    // under 2^29: none passes the int32 / 2 range the LPC residual checks)
    static void fixed_costs(const int32_t* x, uint32_t n,
                            unsigned long long* cost) {
        for (int o = 0; o < 5; o++) cost[o] = 0;
        for (uint32_t i = 0; i < n && i < 4; i++)
            for (int o = 0; o <= (int)i; o++)
                cost[o] += (uint32_t)std::abs(fixed_at(x, i, o));
        unsigned long long c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0;
        for (uint32_t i = 4; i < n; i++) {
            int32_t e1 = x[i] - x[i - 1], p1 = x[i - 1] - x[i - 2];
            int32_t p2 = x[i - 2] - x[i - 3], p3 = x[i - 3] - x[i - 4];
            int32_t e2 = e1 - p1, q2 = p1 - p2, r2 = p2 - p3;
            int32_t e3 = e2 - q2, q3 = q2 - r2;
            int32_t e4 = e3 - q3;
            c0 += (uint32_t)std::abs(x[i]);
            c1 += (uint32_t)std::abs(e1);
            c2 += (uint32_t)std::abs(e2);
            c3 += (uint32_t)std::abs(e3);
            c4 += (uint32_t)std::abs(e4);
        }
        cost[0] += c0; cost[1] += c1; cost[2] += c2; cost[3] += c3; cost[4] += c4;
    }

    template <int O>
    static void fixed_residual_n(const int32_t* x, uint32_t n, int32_t* res) {
        for (uint32_t i = O; i < n; i++) res[i] = fixed_at(x, i, O);
    }

    void encode_subframe(BitWriter& bw, const int32_t* ch, uint32_t cbps,
                         uint32_t bsize, Scratch& s) const {
        // constant?
        bool constant = true;
        for (uint32_t i = 1; i < bsize; i++) if (ch[i] != ch[0]) { constant = false; break; }
        if (constant) {
            bw.bits(0, 1); bw.bits(0, 6); bw.bits(0, 1);
            bw.sbits(ch[0], (int)cbps);
            return;
        }
        // pick fixed order 0..4 minimizing estimated rice bits
        int max_order = bsize > 4 ? 4 : (int)bsize - 1;
        unsigned long long cost[5];
        fixed_costs(ch, bsize, cost);
        int best_order = 0;
        unsigned long long best_bits = ~0ull;
        for (int o = 0; o <= max_order; o++) {
            unsigned long long bits = rice_bits_est(cost[o], bsize - o)
                                      + (unsigned long long)o * cbps;
            if (bits < best_bits) {
                best_bits = bits;
                best_order = o;
            }
        }
        // LPC beats the fixed predictors on most tonal material — but not
        // on near-silence the fixed predictors already push under ~2
        // bits/sample, so skip the O(order*n) analysis there
        Lpc lpc;
        if (best_bits > (unsigned long long)bsize * 2)
            lpc = analyze_lpc(ch, bsize, cbps, s);
        unsigned long long verbatim_bits = (unsigned long long)bsize * cbps;
        if (std::min(best_bits, lpc.bits) >= verbatim_bits) {
            bw.bits(0, 1); bw.bits(1, 6); bw.bits(0, 1);  // VERBATIM
            for (uint32_t i = 0; i < bsize; i++)
                bw.sbits(ch[i], (int)cbps);
            return;
        }
        if (lpc.order > 0 && lpc.bits < best_bits) {
            bw.bits(0, 1);
            bw.bits(32 | (uint32_t)(lpc.order - 1), 6);  // LPC
            bw.bits(0, 1);                                // no wasted bits
            for (int i = 0; i < lpc.order; i++)
                bw.sbits(ch[i], (int)cbps);
            bw.bits(15 - 1, 4);                           // precision = 15
            bw.bits((uint32_t)lpc.shift, 5);
            for (int j = 0; j < lpc.order; j++)
                bw.sbits(lpc.q[j], 15);
            encode_residual(bw, s.res.data(), lpc.order, bsize);
            return;
        }
        bw.bits(0, 1);
        bw.bits(8 + (uint32_t)best_order, 6);  // FIXED
        bw.bits(0, 1);                          // no wasted bits
        for (int i = 0; i < best_order; i++) bw.sbits(ch[i], (int)cbps);
        const int32_t* res = ch;                // order 0: the samples
        switch (best_order) {
            case 1: fixed_residual_n<1>(ch, bsize, s.res.data()); break;
            case 2: fixed_residual_n<2>(ch, bsize, s.res.data()); break;
            case 3: fixed_residual_n<3>(ch, bsize, s.res.data()); break;
            case 4: fixed_residual_n<4>(ch, bsize, s.res.data()); break;
        }
        if (best_order > 0) res = s.res.data();
        encode_residual(bw, res, best_order, bsize);
    }

    static int rice_k(unsigned long long sum, uint32_t n) {
        if (n == 0) return 0;
        int k = 0;
        // the count must widen before shifting: n<<k wraps uint32 for
        // high-entropy partitions (k ~ 20), pinning k at 30 and inflating
        // every noisy block by ~50%
        while (k < 30 && ((unsigned long long)n << k) < sum) k++;
        return k;
    }

    void encode_residual(BitWriter& bw, const int32_t* res, int order,
                         uint32_t bsize) const {
        // choose the partition order scoring estimated bits, with the
        // per-partition |residual| sums of every order built bottom-up: one
        // pass over the residual at the finest, then pairwise merges; order
        // po's partitions are sums[2^po .. 2^(po+1))
        int pmax = 0;
        while (pmax < 6 && !(bsize & ((2u << pmax) - 1))
               && (bsize >> (pmax + 1)) > (uint32_t)order)
            pmax++;
        unsigned long long sums[128];
        {
            uint32_t plen = bsize >> pmax;
            unsigned long long* fine = sums + (1u << pmax);
            for (uint32_t p = 0; p < (1u << pmax); p++) {
                uint32_t lo = p == 0 ? (uint32_t)order : p * plen;
                uint32_t hi = (p + 1) * plen;
                unsigned long long s = 0;
                for (uint32_t i = lo; i < hi; i++)
                    s += (uint32_t)std::abs(res[i]);
                fine[p] = s;
            }
            for (int po = pmax - 1; po >= 0; po--)
                for (uint32_t p = 0; p < (1u << po); p++)
                    sums[(1u << po) + p] = sums[(2u << po) + 2 * p]
                                           + sums[(2u << po) + 2 * p + 1];
        }
        int best_po = pmax;
        unsigned long long best_bits = ~0ull;
        for (int po = pmax; po >= 0; po--) {
            uint32_t parts = 1u << po;
            unsigned long long tb = 0;
            for (uint32_t p = 0; p < parts; p++) {
                uint32_t cnt = (bsize >> po) - (p == 0 ? order : 0);
                tb += 5ull + rice_bits_est(sums[parts + p], cnt);
            }
            if (tb < best_bits) { best_bits = tb; best_po = po; }
        }
        uint32_t po = (uint32_t)best_po;
        bw.bits(1, 2);   // method 1: 5-bit rice params (covers k up to 30)
        bw.bits(po, 4);
        uint32_t parts = 1u << po;
        uint32_t idx = order;
        for (uint32_t p = 0; p < parts; p++) {
            uint32_t cnt = (bsize >> po) - (p == 0 ? (uint32_t)order : 0);
            int k = rice_k(2 * sums[parts + p], cnt);
            bw.bits((uint32_t)k, 5);
            // a residual's zigzag value zz as q = zz >> k zeros, a 1, and
            // zz's k low bits (k <= 30): one put of q + 1 + k bits, into
            // room made for the partition's bits first, through a copy of
            // the writer's state that stays in registers
            const int32_t* v = res + idx;
            auto zigzag = [](int32_t r) {
                return ((uint32_t)r << 1) ^ (uint32_t)(r >> 31);
            };
            unsigned long long nbits = (unsigned long long)cnt * (k + 1);
            for (uint32_t i = 0; i < cnt; i++) nbits += zigzag(v[i]) >> k;
            bw.reserve(nbits / 8 + 1);
            uint8_t* out = bw.bytes();
            const uint64_t one = 1ull << k, low = one - 1;
            BitState st = bw.st;
            for (uint32_t i = 0; i < cnt; i++) {
                uint32_t zz = zigzag(v[i]);
                uint32_t q = zz >> k;
                for (; q + 1 + k > 56; q -= 32)  // rare: a long unary's zeros
                    st.put(out, 0, 32);
                st.put(out, one | (zz & low), (int)q + 1 + k);
            }
            bw.st = st;
            idx += cnt;
        }
    }
};

}  // namespace

// ---------------------------------------------------------------- C ABI
extern "C" {

struct FlacInfoC {
    int32_t sample_rate;
    int32_t channels;
    int32_t bits_per_sample;
    int64_t total_samples;
};

void* tflac_open_read(const char* path, FlacInfoC* info) {
    auto* d = new FlacDecoder();
    if (!d->open(path)) { delete d; return nullptr; }
    info->sample_rate = (int32_t)d->sample_rate;
    info->channels = (int32_t)d->channels;
    info->bits_per_sample = (int32_t)d->bps;
    info->total_samples = (int64_t)d->total_samples;
    return d;
}

long tflac_read(void* h, int32_t* dst, long max_frames) {
    return ((FlacDecoder*)h)->read(dst, max_frames);
}

int tflac_seek(void* h, long frame) {
    return ((FlacDecoder*)h)->seek((uint64_t)frame) ? 0 : -1;
}

void tflac_close_read(void* h) { delete (FlacDecoder*)h; }

void* tflac_open_write(const char* path, int sr, int ch, int bps) {
    // the encoder's sample-size code and side-channel width only handle
    // these depths; anything else would silently write corrupt frames
    if (bps != 8 && bps != 16 && bps != 24) return nullptr;
    if (ch < 1 || ch > 8 || sr <= 0) return nullptr;
    auto* e = new FlacEncoder();
    if (!e->open(path, (uint32_t)sr, (uint32_t)ch, (uint32_t)bps)) {
        delete e;
        return nullptr;
    }
    return e;
}

// Append n interleaved int32 frames; returns the blocks made on more than
// one thread.
long tflac_write(void* h, const int32_t* x, long n) {
    return ((FlacEncoder*)h)->write({x, nullptr}, n);
}

// The same from 3-byte little-endian PCM_24 samples (n frames).
long tflac_write_le24(void* h, const uint8_t* b, long n) {
    return ((FlacEncoder*)h)->write({nullptr, b}, n);
}

// The helper threads the encoders of this process may run at once.
int tflac_encoder_threads() { return helper_budget(); }

// The most helpers that ran at once since the last reset (for tests).
int tflac_helpers_peak(int reset) {
    return reset ? g_helpers_peak.exchange(0) : g_helpers_peak.load();
}

void tflac_close_write(void* h) {
    auto* e = (FlacEncoder*)h;
    e->close();
    delete e;
}

}  // extern "C"
