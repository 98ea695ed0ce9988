// The benchmark's frozen FLAC codec: a copy of the port's
// tomatis_tpu_torch/csrc/flac.cpp, kept here so that the benchmark's
// inputs and its reader of the port's outputs stay the same when the
// program's codec changes. Two changes from the copy: a frame's bytes are
// made by a function of its samples and frame number alone
// (FlacEncoder::frame_bytes), and tflac_encode_all encodes a whole buffer
// with that function on several threads, writing the same bytes as the
// sequential encoder. Loaded with ctypes by benchmark/reference/flaccodec.py.
//
// Decoder: full subset used by FLAC encoders in the wild — CONSTANT,
// VERBATIM, FIXED(0-4), LPC(1-32) subframes; partitioned Rice residuals
// (methods 0/4-bit and 1/5-bit incl. escapes); wasted bits; stereo
// decorrelation L/S, R/S, M/S; 4-24-bit samples (32-bit streams need a
// 33-bit side channel and are declined at open — the pure-Python
// fallback decoder handles them exactly).
// Encoder: FIXED predictors (orders 0-4) and LPC (Levinson-Durbin, orders
// 1-12 selected by prediction-error bits estimate) per subframe, VERBATIM
// fallback for incompressible blocks, mid/side channel assignment search,
// partitioned Rice residuals (order 0..6 scored bottom-up), block size
// 4096, correct CRC-8/CRC-16, MD5 left zero (= unknown, legal).
//
// Build: g++ -O2 -shared -fPIC -pthread flac.cpp -o libbenchflac.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC
uint8_t crc8(const uint8_t* d, size_t n) {
    uint8_t c = 0;
    for (size_t i = 0; i < n; i++) {
        c ^= d[i];
        for (int b = 0; b < 8; b++) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
    }
    return c;
}
uint16_t crc16(const uint8_t* d, size_t n) {
    uint16_t c = 0;
    for (size_t i = 0; i < n; i++) {
        c ^= (uint16_t)d[i] << 8;
        for (int b = 0; b < 8; b++) c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
    }
    return c;
}

// ---------------------------------------------------------------- bit reader
struct BitReader {
    const uint8_t* data = nullptr;
    size_t size = 0;     // bytes
    size_t pos = 0;      // bit position
    bool error = false;

    bool byte_aligned() const { return (pos & 7) == 0; }
    size_t byte_pos() const { return pos >> 3; }

    uint32_t bits(int n) {  // n <= 32
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            size_t byte = pos >> 3;
            if (byte >= size) { error = true; return 0; }
            v = (v << 1) | ((data[byte] >> (7 - (pos & 7))) & 1);
            pos++;
        }
        return v;
    }
    uint64_t bits64(int n) {
        uint64_t v = 0;
        if (n > 32) { v = bits(n - 32); return (v << 32) | bits(32); }
        return bits(n);
    }
    int32_t sbits(int n) {  // n <= 32 (the `~0u << n` is UB at n >= 32)
        uint32_t v = bits(n);
        if (n == 0) return 0;
        if (n >= 32) return (int32_t)v;
        if (v & (1u << (n - 1))) return (int32_t)(v | (~0u << n));
        return (int32_t)v;
    }
    uint32_t unary() {
        uint32_t q = 0;
        while (!error && bits(1) == 0) q++;
        return q;
    }
    void align() { pos = (pos + 7) & ~(size_t)7; }
};

// ---------------------------------------------------------------- bit writer
struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nacc = 0;

    BitWriter() { buf.reserve(1 << 16); }

    void bits(uint32_t v, int n) {
        acc = (acc << n) | (uint64_t)(v & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
        nacc += n;
        if (nacc >= 32) {  // flush four bytes at once
            uint32_t w = (uint32_t)(acc >> (nacc - 32));
            size_t s = buf.size();
            buf.resize(s + 4);
            buf[s] = (uint8_t)(w >> 24);
            buf[s + 1] = (uint8_t)(w >> 16);
            buf[s + 2] = (uint8_t)(w >> 8);
            buf[s + 3] = (uint8_t)w;
            nacc -= 32;
        }
    }
    void sbits(int32_t v, int n) { bits((uint32_t)v, n); }
    void unary(uint32_t q) {
        while (q >= 32) { bits(0, 32); q -= 32; }
        bits(1, (int)q + 1);  // q zeros then a 1
    }
    void align() {
        if (nacc & 7) bits(0, 8 - (nacc & 7));
        while (nacc >= 8) {  // drain whole bytes left in the accumulator
            buf.push_back((uint8_t)(acc >> (nacc - 8)));
            nacc -= 8;
        }
    }
};

// ---------------------------------------------------------------- UTF-8 coded numbers
void utf8_encode(uint64_t v, std::vector<uint8_t>& out) {
    if (v < 0x80) { out.push_back((uint8_t)v); return; }
    int bytes;
    if (v < 0x800) bytes = 2;
    else if (v < 0x10000) bytes = 3;
    else if (v < 0x200000) bytes = 4;
    else if (v < 0x4000000) bytes = 5;
    else if (v < 0x80000000ull) bytes = 6;
    else bytes = 7;
    static const uint8_t lead[8] = {0, 0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE};
    out.push_back((uint8_t)(lead[bytes] | (v >> (6 * (bytes - 1)))));
    for (int i = bytes - 2; i >= 0; i--)
        out.push_back((uint8_t)(0x80 | ((v >> (6 * i)) & 0x3F)));
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
struct FlacDecoder {
    FILE* f = nullptr;
    std::vector<uint8_t> stream;   // whole file after metadata (frames)
    size_t frames_off = 0;         // offset of first frame in `stream`
    // STREAMINFO
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t bps = 0;
    uint64_t total_samples = 0;
    uint32_t max_block = 0;
    struct SeekEntry { uint64_t sample, offset; };
    std::vector<SeekEntry> seektable;

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
        frames_off = off;
        byte_pos = off;
        if (total_samples == 0) {
            // legal streamed encodes leave STREAMINFO total_samples = 0
            // (unknown length); every consumer here needs the length up
            // front (flush plans, output sizing), so count by decoding
            // one full pass, then rewind
            std::vector<int32_t> tmp;
            uint64_t start, counted = 0;
            while (decode_frame(tmp, &start))
                counted += tmp.size() / (channels ? channels : 1);
            total_samples = counted;
            byte_pos = frames_off;
            next_sample = 0;
            pend.clear();
            pend_off = 0;
        }
        return true;
    }

    // decode one frame at byte_pos into interleaved samples
    bool decode_frame(std::vector<int32_t>& out, uint64_t* frame_start) {
        if (byte_pos + 5 >= stream.size()) return false;
        BitReader br{stream.data(), stream.size(), byte_pos * 8};
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

        std::vector<std::vector<int32_t>> chans(nch);
        for (uint32_t c = 0; c < nch; c++) {
            uint32_t cbps = fbps + (side == (int)c ? 1 : 0);
            if (!decode_subframe(br, bsize, cbps, chans[c])) return false;
        }
        br.align();
        br.bits(16);  // frame CRC-16 (trusted)
        if (br.error) return false;

        // stereo decorrelation
        if (ch_asgn == 8) {        // left/side: R = L - S
            for (uint32_t i = 0; i < bsize; i++) chans[1][i] = chans[0][i] - chans[1][i];
        } else if (ch_asgn == 9) { // side/right: L = S + R
            for (uint32_t i = 0; i < bsize; i++) chans[0][i] = chans[0][i] + chans[1][i];
        } else if (ch_asgn == 10) {// mid/side
            for (uint32_t i = 0; i < bsize; i++) {
                int64_t mid = chans[0][i];
                int64_t s = chans[1][i];
                mid = (int64_t)(((uint64_t)mid << 1) | ((uint64_t)s & 1));
                chans[0][i] = (int32_t)((mid + s) >> 1);
                chans[1][i] = (int32_t)((mid - s) >> 1);
            }
        }

        out.resize((size_t)bsize * nch);
        for (uint32_t i = 0; i < bsize; i++)
            for (uint32_t c = 0; c < nch; c++)
                out[(size_t)i * nch + c] = chans[c][i];

        *frame_start = blocking ? num : num * max_block;
        byte_pos = (br.pos + 7) / 8;
        return true;
    }

    bool decode_subframe(BitReader& br, uint32_t bsize, uint32_t cbps,
                         std::vector<int32_t>& out) {
        out.assign(bsize, 0);
        if (br.bits(1) != 0) return false;  // padding
        uint32_t type = br.bits(6);
        uint32_t wasted = 0;
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
            int shift = (int)br.bits(5);
            std::vector<int32_t> coef(order);
            for (uint32_t i = 0; i < order; i++) coef[i] = br.sbits((int)prec);
            if (!decode_residual(br, bsize, order, out)) return false;
            for (uint32_t i = order; i < bsize; i++) {
                int64_t p = 0;
                for (uint32_t j = 0; j < order; j++)
                    p += (int64_t)coef[j] * out[i - 1 - j];
                out[i] = (int32_t)((uint32_t)out[i]
                                   + (uint32_t)(p >> shift));
            }
        } else {
            return false;
        }
        if (wasted)
            for (uint32_t i = 0; i < bsize; i++) out[i] = (int32_t)((uint32_t)out[i] << wasted);
        return !br.error;
    }

    static void restore_fixed(uint32_t order, uint32_t n, std::vector<int32_t>& x) {
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

    bool decode_residual(BitReader& br, uint32_t bsize, uint32_t order,
                         std::vector<int32_t>& out) {
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
            if (k == esc) {
                uint32_t raw = br.bits(5);
                for (uint32_t i = 0; i < cnt; i++) out[idx++] = raw ? br.sbits((int)raw) : 0;
            } else {
                for (uint32_t i = 0; i < cnt; i++) {
                    uint32_t q = br.unary();
                    uint32_t r = k ? br.bits((int)k) : 0;
                    uint32_t zz = (q << k) | r;
                    out[idx++] = (int32_t)((zz >> 1) ^ (~(zz & 1) + 1));
                }
            }
            if (br.error) return false;
        }
        return idx == bsize;
    }

    // sequential read of n interleaved sample frames into dst
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
            std::vector<int32_t> frame;
            uint64_t start;
            if (!decode_frame(frame, &start)) return got;
            next_sample = start + frame.size() / channels;
            pend = std::move(frame);
            pend_off = 0;
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
                && frames_off + seektable[i].offset < stream.size()) {
                byte_pos = frames_off + (size_t)seektable[i].offset;
                next_sample = seektable[i].sample;
                break;
            }
        }
        while (true) {
            std::vector<int32_t> frame;
            uint64_t start;
            size_t save = byte_pos;
            if (!decode_frame(frame, &start)) return sample == next_sample;
            uint64_t end = start + frame.size() / channels;
            if (sample < end) {
                pend = std::move(frame);
                pend_off = (size_t)(sample - start) * channels;
                next_sample = end;
                return true;
            }
            next_sample = end;
            (void)save;
        }
    }
};

// ---------------------------------------------------------------- encoder
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

    void write(const int32_t* x, long n) {
        size_t stride = (size_t)BLOCK * channels;
        size_t navail = (size_t)n * channels;
        size_t off = 0;
        // top up a partial pending block first
        if (!pend.empty()) {
            size_t need = stride - pend.size();
            size_t take = navail < need ? navail : need;
            pend.insert(pend.end(), x, x + take);
            off += take;
            if (pend.size() == stride) {
                encode_frame(pend.data(), BLOCK);
                pend.clear();
                total += BLOCK;
            }
        }
        // encode full blocks straight from the caller's buffer
        while (navail - off >= stride) {
            encode_frame(x + off, BLOCK);
            off += stride;
            total += BLOCK;
        }
        pend.insert(pend.end(), x + off, x + navail);
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

    // cheap proxy for a channel's coding cost: sum |second difference|
    static unsigned long long diff2_cost(const std::vector<int64_t>& v) {
        unsigned long long c = 0;
        for (size_t i = 2; i < v.size(); i++) {
            long long d = v[i] - 2 * v[i - 1] + v[i - 2];
            c += (unsigned long long)(d < 0 ? -d : d);
        }
        return c;
    }

    void encode_frame(const int32_t* x, uint32_t bsize) {
        // `total` is still this frame's first sample (caller adds after)
        record_seekpoint(bsize);
        std::vector<uint8_t> b = frame_bytes(x, bsize, frame_no++);
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

    // The bytes of one frame: a function of its samples and its number.
    std::vector<uint8_t> frame_bytes(const int32_t* x, uint32_t bsize,
                                     uint32_t fno_value) const {
        // stereo decorrelation search (ref decoder supports 8=L/S, 9=S/R,
        // 10=M/S): pick the assignment with the cheapest residual proxy
        uint32_t ch_asgn = channels - 1;  // independent
        std::vector<std::vector<int64_t>> sub(channels);
        std::vector<uint32_t> sub_bps(channels, bps);
        if (channels == 2) {
            std::vector<int64_t> l(bsize), r(bsize), m(bsize), s(bsize);
            for (uint32_t i = 0; i < bsize; i++) {
                int64_t lv = x[(size_t)i * 2], rv = x[(size_t)i * 2 + 1];
                l[i] = lv; r[i] = rv;
                s[i] = lv - rv;
                m[i] = (lv + rv) >> 1;
            }
            unsigned long long cl = diff2_cost(l), cr = diff2_cost(r),
                               cm = diff2_cost(m), cs = diff2_cost(s);
            unsigned long long best = cl + cr;
            ch_asgn = 1;
            sub[0] = l; sub[1] = r;
            if (cl + cs < best) { best = cl + cs; ch_asgn = 8;
                sub[0] = l; sub[1] = s; }
            if (cs + cr < best) { best = cs + cr; ch_asgn = 9;
                sub[0] = s; sub[1] = r; }
            if (cm + cs < best) { best = cm + cs; ch_asgn = 10;
                sub[0] = std::move(m); sub[1] = std::move(s); }
            if (ch_asgn == 8 || ch_asgn == 10) sub_bps[1] = bps + 1;
            if (ch_asgn == 9) sub_bps[0] = bps + 1;
            if (ch_asgn == 1) { sub[0] = std::move(l); sub[1] = std::move(r); }
        } else {
            for (uint32_t c = 0; c < channels; c++) {
                sub[c].resize(bsize);
                for (uint32_t i = 0; i < bsize; i++)
                    sub[c][i] = x[(size_t)i * channels + c];
            }
        }

        BitWriter bw;
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
        std::vector<uint8_t> fno;
        utf8_encode(fno_value, fno);
        for (uint8_t b : fno) bw.bits(b, 8);
        if (bs16) bw.bits(bsize - 1, 16);
        bw.align();
        bw.bits(crc8(bw.buf.data(), bw.buf.size()), 8);

        for (uint32_t c = 0; c < channels; c++)
            encode_subframe(bw, sub[c], sub_bps[c], bsize);
        bw.align();
        uint16_t c16 = crc16(bw.buf.data(), bw.buf.size());
        bw.bits(c16, 16);
        bw.align();  // drain the CRC bytes out of the accumulator
        return std::move(bw.buf);
    }

    // Levinson-Durbin LPC analysis (Welch-windowed autocorrelation).
    // Returns quantized coefficients + shift; order 0 means "LPC not
    // usable" for this block.
    struct Lpc {
        int order = 0;
        int shift = 0;
        int32_t q[32];
        std::vector<int64_t> res;
        unsigned long long bits = ~0ull;  // estimated encoded subframe bits
    };

    // Estimated rice bits for n residuals with |.|-sum s (one partition,
    // same estimator encode_residual uses for partition-order scoring).
    static unsigned long long rice_bits_est(unsigned long long s, uint32_t n) {
        if (n == 0) return 0;
        int k = 0;
        while (k < 30 && ((unsigned long long)n << k) < 2 * s) k++;
        return (unsigned long long)n * (k + 1) + ((2 * s) >> k);
    }

    // Quantize a double coefficient set and compute the exact residual.
    // Returns false on quantization failure or residual overflow.
    static bool realize_lpc(const std::vector<int64_t>& x, uint32_t bsize,
                            const double* lpc, int order, uint32_t cbps,
                            Lpc& out) {
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
        out.res.assign(x.begin(), x.end());
        unsigned long long cost = 0;
        for (uint32_t i = order; i < bsize; i++) {
            long long p = 0;
            for (int j = 0; j < order; j++)
                p += (long long)out.q[j] * x[i - 1 - j];
            long long v = x[i] - (p >> shift);
            if (v > INT32_MAX / 2 || v < INT32_MIN / 2) return false;
            out.res[i] = v;
            cost += (unsigned long long)(v < 0 ? -v : v);
        }
        out.bits = rice_bits_est(cost, bsize - order)
                   + (unsigned long long)order * (cbps + 15) + 17;
        return true;
    }

    static Lpc analyze_lpc(const std::vector<int64_t>& x, uint32_t bsize,
                           int max_order, uint32_t cbps) {
        Lpc out;
        if ((int)bsize <= max_order * 2) return out;
        // windowed autocorrelation
        std::vector<double> w(bsize);
        for (uint32_t i = 0; i < bsize; i++) {
            double t = ((double)i - (bsize - 1) / 2.0) / ((bsize + 1) / 2.0);
            w[i] = (double)x[i] * (1.0 - t * t);   // Welch window
        }
        double r[33] = {0};
        for (int lag = 0; lag <= max_order; lag++)
            for (uint32_t i = lag; i < bsize; i++)
                r[lag] += w[i] * w[i - lag];
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
            if (!realize_lpc(x, bsize, snap[m], m + 1, cbps, trial)) continue;
            out = std::move(trial);
            break;
        }
        return out;
    }

    void encode_subframe(BitWriter& bw, const std::vector<int64_t>& ch,
                         uint32_t cbps, uint32_t bsize) const {
        // constant?
        bool constant = true;
        for (uint32_t i = 1; i < bsize; i++) if (ch[i] != ch[0]) { constant = false; break; }
        if (constant) {
            bw.bits(0, 1); bw.bits(0, 6); bw.bits(0, 1);
            bw.sbits((int32_t)ch[0], (int)cbps);
            return;
        }
        // pick fixed order 0..4 minimizing estimated rice bits
        int max_order = bsize > 4 ? 4 : (int)bsize - 1;
        std::vector<int64_t> best_res;
        int best_order = 0;
        unsigned long long best_bits = ~0ull;
        std::vector<int64_t> res = ch;
        for (int o = 0; o <= max_order; o++) {
            if (o > 0)
                for (size_t i = res.size() - 1; i >= (size_t)o; i--)
                    res[i] -= res[i - 1];
            unsigned long long cost = 0;
            bool overflow = false;
            for (uint32_t i = o; i < bsize; i++) {
                long long v = res[i];
                if (v > INT32_MAX / 2 || v < INT32_MIN / 2) { overflow = true; break; }
                cost += (unsigned long long)(v < 0 ? -v : v);
            }
            unsigned long long bits = rice_bits_est(cost, bsize - o)
                                      + (unsigned long long)o * cbps;
            // order 0 is always a valid baseline (plain int32 samples)
            if ((o == 0 || !overflow) && bits < best_bits) {
                best_bits = bits;
                best_order = o;
                best_res = res;
            }
        }
        // LPC beats the fixed predictors on most tonal material — but not
        // on near-silence the fixed predictors already push under ~2
        // bits/sample, so skip the O(order*n) analysis there
        Lpc lpc;
        if (best_bits > (unsigned long long)bsize * 2)
            lpc = analyze_lpc(ch, bsize, 12, cbps);
        unsigned long long verbatim_bits = (unsigned long long)bsize * cbps;
        if (std::min(best_bits, lpc.bits) >= verbatim_bits) {
            bw.bits(0, 1); bw.bits(1, 6); bw.bits(0, 1);  // VERBATIM
            for (uint32_t i = 0; i < bsize; i++)
                bw.sbits((int32_t)ch[i], (int)cbps);
            return;
        }
        if (lpc.order > 0 && lpc.bits < best_bits) {
            bw.bits(0, 1);
            bw.bits(32 | (uint32_t)(lpc.order - 1), 6);  // LPC
            bw.bits(0, 1);                                // no wasted bits
            for (int i = 0; i < lpc.order; i++)
                bw.sbits((int32_t)ch[i], (int)cbps);
            bw.bits(15 - 1, 4);                           // precision = 15
            bw.bits((uint32_t)lpc.shift, 5);
            for (int j = 0; j < lpc.order; j++)
                bw.sbits(lpc.q[j], 15);
            encode_residual(bw, lpc.res, lpc.order, bsize);
            return;
        }
        bw.bits(0, 1);
        bw.bits(8 + (uint32_t)best_order, 6);  // FIXED
        bw.bits(0, 1);                          // no wasted bits
        for (int i = 0; i < best_order; i++) bw.sbits((int32_t)ch[i], (int)cbps);
        encode_residual(bw, best_res, best_order, bsize);
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

    void encode_residual(BitWriter& bw, const std::vector<int64_t>& res,
                         int order, uint32_t bsize) const {
        // choose the partition order scoring estimated bits, with the
        // per-partition |residual| sums built bottom-up: one pass over the
        // residual at the finest level, then pairwise merges per level
        int pmax = 0;
        while (pmax < 6 && !(bsize & ((2u << pmax) - 1))
               && (bsize >> (pmax + 1)) > (uint32_t)order)
            pmax++;
        std::vector<unsigned long long> sums(1u << pmax, 0);
        {
            uint32_t plen = bsize >> pmax;
            for (uint32_t p = 0; p < (1u << pmax); p++) {
                uint32_t lo = p == 0 ? (uint32_t)order : p * plen;
                uint32_t hi = (p + 1) * plen;
                unsigned long long s = 0;
                for (uint32_t i = lo; i < hi; i++) {
                    long long v = res[i];
                    s += (unsigned long long)(v < 0 ? -v : v);
                }
                sums[p] = s;
            }
        }
        int best_po = pmax;
        unsigned long long best_bits = ~0ull;
        for (int po = pmax; po >= 0; po--) {
            uint32_t parts = 1u << po;
            unsigned long long tb = 0;
            for (uint32_t p = 0; p < parts; p++) {
                uint32_t cnt = (bsize >> po) - (p == 0 ? order : 0);
                tb += 5ull + rice_bits_est(sums[p], cnt);
            }
            if (tb < best_bits) { best_bits = tb; best_po = po; }
            if (po > 0)   // merge pairs for the next (coarser) level
                for (uint32_t p = 0; p < parts / 2; p++)
                    sums[p] = sums[2 * p] + sums[2 * p + 1];
        }
        uint32_t po = (uint32_t)best_po;
        bw.bits(1, 2);   // method 1: 5-bit rice params (covers k up to 30)
        bw.bits(po, 4);
        uint32_t parts = 1u << po;
        uint32_t idx = order;
        for (uint32_t p = 0; p < parts; p++) {
            uint32_t cnt = (bsize >> po) - (p == 0 ? (uint32_t)order : 0);
            unsigned long long s = 0;
            for (uint32_t i = 0; i < cnt; i++) {
                long long v = res[idx + i];
                s += (unsigned long long)(v < 0 ? -v : v);
            }
            int k = rice_k(2 * s, cnt);
            bw.bits((uint32_t)k, 5);
            for (uint32_t i = 0; i < cnt; i++) {
                long long v = res[idx + i];
                uint64_t zz = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
                uint64_t q = zz >> k;
                bw.unary((uint32_t)q);
                if (k) bw.bits((uint32_t)(zz & ((1ull << k) - 1)), k);
            }
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

void tflac_write(void* h, const int32_t* x, long n) {
    ((FlacEncoder*)h)->write(x, n);
}

void tflac_close_write(void* h) {
    auto* e = (FlacEncoder*)h;
    e->close();
    delete e;
}

// Encode n interleaved frames of x into a new file at path, the full
// blocks' frames made on `threads` threads; the file's bytes are those of
// tflac_open_write + tflac_write + tflac_close_write. Returns 0, or -1
// when the file cannot be opened or the format is refused.
int tflac_encode_all(const char* path, const int32_t* x, long n, int sr,
                     int ch, int bps, int threads) {
    auto* e = (FlacEncoder*)tflac_open_write(path, sr, ch, bps);
    if (!e) return -1;
    const uint32_t B = FlacEncoder::BLOCK;
    long full = n / B;
    std::vector<std::vector<uint8_t>> frames(full);
    if (threads < 1) threads = 1;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; t++)
        pool.emplace_back([&, t] {
            for (long k = t; k < full; k += threads)
                frames[k] = e->frame_bytes(x + (size_t)k * B * ch, B,
                                           (uint32_t)k);
        });
    for (auto& th : pool) th.join();
    for (long k = 0; k < full; k++) {
        e->record_seekpoint(B);
        fwrite(frames[k].data(), 1, frames[k].size(), e->f);
        std::vector<uint8_t>().swap(frames[k]);
        e->frame_no++;
        e->total += B;
    }
    if (n > full * (long)B)
        e->write(x + (size_t)full * B * ch, n - full * (long)B);
    e->close();
    delete e;
    return 0;
}

}  // extern "C"
