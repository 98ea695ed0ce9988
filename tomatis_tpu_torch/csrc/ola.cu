// Overlap-add and the fused chunk tail for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel tomatis_tpu/ops/pallas_ola.py
// (overlap_add_pallas, body _ola_kernel) and, in the chunk tail, the
// passes that follow it in the reference chunk step
// (tomatis_tpu/engine/streaming.py:501-545: window, mask, the frame and
// window-square overlap-adds, tail adds, normalise, output gain, peaks,
// PCM_24 quantise). One tile loop serves three entry points:
//
//   tomatis_ola_f32         out[n, c] = sum_{i<K, 0<=t-i<F} y[t-i, c, i*hop+s]
//   tomatis_chunk_tail_f32  per output sample n = t*hop + s, channel c:
//       acc = sum_i (z[t-i, c, i*hop+s] * win[i*hop+s]) * mask[t-i]
//             (+ out_tail[n, c] where n < tail)
//       w   = sum_i win2[i*hop+s] * mask[t-i]  (+ w_tail[n] where n < tail)
//       emit = acc / (w + 1e-12)  or  acc / max(w, 1e-8)
//       f32:   emit [L, C]
//       pcm24: out = emit*gain [L, C], peaks[t] = max |out| over tile t,
//              3 little-endian bytes of clamp(rint(out * 2^23))
//       both:  the raw acc and w of n >= F*hop, the carries to the next
//              chunk
//   tomatis_chunk_tail_batched_f32  the chunk tail of B file lanes in one
//       launch: the reference runs the kernel under jax.vmap over lanes
//       (tomatis_tpu/parallel/batch.py:92, 272); here blockIdx.y is the
//       lane. Every lane has its own frames, tails, outputs and n_valid
//       (an int32 device array, read by the kernel: no host sync), and
//       shares win, win2 and the gain. A lane with n_valid == 0 freezes
//       its carries: it writes its input tails to them unchanged, as the
//       reference's jnp.where(n_valid > 0, ...) does per lane
//       (tomatis_tpu/engine/streaming.py:526-533), in the same pass.
// with K = n_fft/hop, W = F + K - 1 tiles and L = W*hop. mask[f] is
// f < n_valid. Each sum runs i = 0..K-1 from 0.0f, and every product and
// sum is rounded as the plain PyTorch composition rounds it
// (ops/cuda_ola.py: chunk_tail_plain, overlap_add_plain), so the kernel
// gives the same bits. FMA contraction is ruled out by writing every
// multiply and add as __fmul_rn / __fadd_rn, and the divide as the IEEE
// __fdiv_rn; the file builds without --use_fast_math.
//
// Bound: bytes. About 0.1 flop per byte moved, so the tensor cores and
// TMA have no part in it; the design moves each byte once, 16 at a time:
// - One block owns one hop tile t (blockIdx.x, W tiles: x has no 65535
//   limit; the batched entry adds the lane as blockIdx.y), so the frame index t-i and the in-frame
//   offset i*hop+s need no division, and the tile's peak is a block
//   reduction (warp shuffles, then shared memory). Up to 512 threads run
//   along s: at hop 2048 each takes one 4-sample group, with no loop.
// - A thread takes 4 consecutive samples: per channel one 16-byte load
//   from each of the K contributing frames (evict-first, z is read once),
//   plus 16-byte loads of win and win2, which stay L2-resident.
// - The [4, C] result is transposed in registers to the time-major
//   [L, C] layout and stored as C 16-byte stores; its 12*C PCM_24 bytes
//   are packed into 3*C words and stored as 8-byte (C = 2) or 4-byte
//   (C = 1) words.
// - The tail add, normaliser, divide, gain, peaks and quantise happen in
//   registers: z is read once, and out, the bytes and the carries are
//   written once, in one launch per chunk.
// Where hop % 4 != 0, C > 2 or a pointer is not 16-byte aligned, the same
// kernel runs a scalar inner loop (one sample per step) over the same
// tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kOla = 0, kEmitF32 = 1, kPcm24 = 2 };
enum Norm { kEps = 0, kFloor8 = 1 };

constexpr int kMaxThreads = 512;

struct Args {
    const float* z;         // [F, C, n_fft]
    const float* win;       // [n_fft]        (chunk tail only)
    const float* win2;      // [n_fft]        (chunk tail only)
    const float* out_tail;  // [tail, C]      (chunk tail only)
    const float* w_tail;    // [tail]         (chunk tail only)
    const float* gain;      // 0-d            (pcm24 only)
    float* out;             // [L, C]: OLA sums, emit, or emit*gain
    float* peaks;           // [W]            (pcm24 only)
    uint8_t* pcm;           // [L*C*3]        (pcm24 only)
    float* ola_carry;       // [tail, C]      (chunk tail only)
    float* w_carry;         // [tail]         (chunk tail only)
    int F, C, n_fft, hop, K, n_valid, tail;
    bool freeze;            // write the input tails to the carries
};

// The batched entry's view of lane b: every per-lane array is [B, ...],
// lane b its b-th contiguous slice; n_valid [B] int32 on the device.
__device__ __forceinline__ void select_lane(Args& a, const int* n_valid,
                                            int b) {
    const long long L = (long long)(a.F + a.K - 1) * a.hop;
    a.z += (long long)b * a.F * a.C * a.n_fft;
    a.out_tail += (long long)b * a.tail * a.C;
    a.w_tail += (long long)b * a.tail;
    a.out += (long long)b * L * a.C;
    if (a.peaks) a.peaks += (long long)b * (a.F + a.K - 1);
    if (a.pcm) a.pcm += (long long)b * L * a.C * 3;
    a.ola_carry += (long long)b * a.tail * a.C;
    a.w_carry += (long long)b * a.tail;
    const int nv = __ldg(n_valid + b);
    a.n_valid = nv < 0 ? 0 : (nv > a.F ? a.F : nv);
    a.freeze = a.n_valid == 0;
}

__device__ __forceinline__ float normalise(float acc, float w, int norm) {
    if (norm == kEps) return __fdiv_rn(acc, __fadd_rn(w, 1e-12f));
    // torch.clamp(w, min=1e-8): NaN stays NaN
    return __fdiv_rn(acc, w < 1e-8f ? 1e-8f : w);
}

__device__ __forceinline__ uint32_t quantise(float o) {
    float q = rintf(__fmul_rn(o, 8388608.0f));  // half to even
    q = fminf(fmaxf(q, -8388608.0f), 8388607.0f);
    return (uint32_t)(int32_t)q;
}

// Four 24-bit samples (low 3 bytes of u0..u3) -> three little-endian words.
__device__ __forceinline__ void pack4(uint32_t u0, uint32_t u1, uint32_t u2,
                                      uint32_t u3, uint32_t* w) {
    w[0] = (u0 & 0xFFFFFFu) | (u1 << 24);
    w[1] = ((u1 >> 8) & 0xFFFFu) | (u2 << 16);
    w[2] = ((u2 >> 16) & 0xFFu) | (u3 << 8);
}

// Frames that contribute to tile t: i in [i_lo, i_hi], frame t - i.
__device__ __forceinline__ void frame_range(const Args& a, int t, int& i_lo,
                                            int& i_hi) {
    i_lo = max(0, t - a.F + 1);
    i_hi = min(a.K - 1, t);
}

// The 4-sample group s0..s0+3 of tile t, C = CT in {1, 2}. Returns the
// group's max |out| (pcm24), else 0.
template <int MODE, int NORM, int CT>
__device__ __forceinline__ float group4(const Args& a, int t, int s0) {
    const long long n0 = (long long)t * a.hop + s0;
    float acc[CT][4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        w[j] = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[c][j] = 0.0f;
    }
    int i_lo, i_hi;
    frame_range(a, t, i_lo, i_hi);
#pragma unroll 2
    for (int i = i_lo; i <= i_hi; ++i) {
        const int f = t - i;
        const int off = i * a.hop + s0;
        float4 zv[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c)
            zv[c] = __ldcs(reinterpret_cast<const float4*>(
                a.z + ((long long)f * CT + c) * a.n_fft + off));
        if constexpr (MODE == kOla) {
#pragma unroll
            for (int c = 0; c < CT; ++c) {
                acc[c][0] = __fadd_rn(acc[c][0], zv[c].x);
                acc[c][1] = __fadd_rn(acc[c][1], zv[c].y);
                acc[c][2] = __fadd_rn(acc[c][2], zv[c].z);
                acc[c][3] = __fadd_rn(acc[c][3], zv[c].w);
            }
        } else {
            const float m = f < a.n_valid ? 1.0f : 0.0f;
            const float4 wv = __ldg(reinterpret_cast<const float4*>(a.win + off));
            const float4 w2 = __ldg(reinterpret_cast<const float4*>(a.win2 + off));
            w[0] = __fadd_rn(w[0], __fmul_rn(w2.x, m));
            w[1] = __fadd_rn(w[1], __fmul_rn(w2.y, m));
            w[2] = __fadd_rn(w[2], __fmul_rn(w2.z, m));
            w[3] = __fadd_rn(w[3], __fmul_rn(w2.w, m));
#pragma unroll
            for (int c = 0; c < CT; ++c) {
                acc[c][0] = __fadd_rn(acc[c][0], __fmul_rn(__fmul_rn(zv[c].x, wv.x), m));
                acc[c][1] = __fadd_rn(acc[c][1], __fmul_rn(__fmul_rn(zv[c].y, wv.y), m));
                acc[c][2] = __fadd_rn(acc[c][2], __fmul_rn(__fmul_rn(zv[c].z, wv.z), m));
                acc[c][3] = __fadd_rn(acc[c][3], __fmul_rn(__fmul_rn(zv[c].w, wv.w), m));
            }
        }
    }

    // span[e] is element e of the group's time-major run of 4*CT floats:
    // sample e / CT, channel e % CT
    float span[4 * CT];
    if constexpr (MODE == kOla) {
#pragma unroll
        for (int e = 0; e < 4 * CT; ++e) span[e] = acc[e % CT][e / CT];
    } else {
        // hop | tail and hop | F*hop, so a group lies wholly inside or
        // outside the tail and the carry regions
        if (n0 < a.tail) {
            const float4 wt = __ldg(reinterpret_cast<const float4*>(a.w_tail + n0));
            w[0] = __fadd_rn(w[0], wt.x);
            w[1] = __fadd_rn(w[1], wt.y);
            w[2] = __fadd_rn(w[2], wt.z);
            w[3] = __fadd_rn(w[3], wt.w);
#pragma unroll
            for (int v = 0; v < CT; ++v) {
                const float4 ot = __ldg(reinterpret_cast<const float4*>(
                    a.out_tail + n0 * CT + 4 * v));
                const float o4[4] = {ot.x, ot.y, ot.z, ot.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int e = 4 * v + k;
                    acc[e % CT][e / CT] = __fadd_rn(acc[e % CT][e / CT], o4[k]);
                }
            }
        }
        const long long r = n0 - (long long)a.F * a.hop;
        if (r >= 0 && a.freeze) {
            // r < tail: the carry region mirrors the input tails
            reinterpret_cast<float4*>(a.w_carry + r)[0] =
                __ldg(reinterpret_cast<const float4*>(a.w_tail + r));
#pragma unroll
            for (int v = 0; v < CT; ++v)
                reinterpret_cast<float4*>(a.ola_carry + r * CT)[v] =
                    __ldg(reinterpret_cast<const float4*>(a.out_tail + r * CT) + v);
        } else if (r >= 0) {
            reinterpret_cast<float4*>(a.w_carry + r)[0] =
                make_float4(w[0], w[1], w[2], w[3]);
#pragma unroll
            for (int v = 0; v < CT; ++v) {
                const int e = 4 * v;
                reinterpret_cast<float4*>(a.ola_carry + r * CT)[v] = make_float4(
                    acc[e % CT][e / CT], acc[(e + 1) % CT][(e + 1) / CT],
                    acc[(e + 2) % CT][(e + 2) / CT],
                    acc[(e + 3) % CT][(e + 3) / CT]);
            }
        }
        const float g = MODE == kPcm24 ? __ldg(a.gain) : 1.0f;
#pragma unroll
        for (int e = 0; e < 4 * CT; ++e) {
            const float x = normalise(acc[e % CT][e / CT], w[e / CT], NORM);
            span[e] = MODE == kPcm24 ? __fmul_rn(x, g) : x;
        }
    }
#pragma unroll
    for (int v = 0; v < CT; ++v)
        reinterpret_cast<float4*>(a.out + n0 * CT)[v] = make_float4(
            span[4 * v], span[4 * v + 1], span[4 * v + 2], span[4 * v + 3]);

    float pk = 0.0f;
    if constexpr (MODE == kPcm24) {
        uint32_t words[3 * CT];
#pragma unroll
        for (int v = 0; v < CT; ++v) {
#pragma unroll
            for (int k = 0; k < 4; ++k) pk = fmaxf(pk, fabsf(span[4 * v + k]));
            pack4(quantise(span[4 * v]), quantise(span[4 * v + 1]),
                  quantise(span[4 * v + 2]), quantise(span[4 * v + 3]),
                  words + 3 * v);
        }
        uint8_t* dst = a.pcm + n0 * CT * 3;
        if constexpr (CT == 2) {    // 24 bytes at a multiple of 24
#pragma unroll
            for (int k = 0; k < 3; ++k)
                reinterpret_cast<uint2*>(dst)[k] =
                    make_uint2(words[2 * k], words[2 * k + 1]);
        } else {                    // 12 bytes at a multiple of 12
#pragma unroll
            for (int k = 0; k < 3; ++k)
                reinterpret_cast<uint32_t*>(dst)[k] = words[k];
        }
    }
    return pk;
}

// One sample s of tile t, any C. Returns its max |out| (pcm24), else 0.
template <int MODE, int NORM>
__device__ __forceinline__ float sample1(const Args& a, int t, int s) {
    const long long n = (long long)t * a.hop + s;
    const long long r = n - (long long)a.F * a.hop;
    int i_lo, i_hi;
    frame_range(a, t, i_lo, i_hi);
    float w = 0.0f, g = 1.0f;
    if constexpr (MODE != kOla) {
        for (int i = i_lo; i <= i_hi; ++i) {
            const float m = t - i < a.n_valid ? 1.0f : 0.0f;
            w = __fadd_rn(w, __fmul_rn(a.win2[i * a.hop + s], m));
        }
        if (n < a.tail) w = __fadd_rn(w, a.w_tail[n]);
        if (r >= 0) a.w_carry[r] = a.freeze ? a.w_tail[r] : w;
        if constexpr (MODE == kPcm24) g = __ldg(a.gain);
    }
    float pk = 0.0f;
    for (int c = 0; c < a.C; ++c) {
        float acc = 0.0f;
        for (int i = i_lo; i <= i_hi; ++i) {
            const int f = t - i;
            const float zv = __ldcs(a.z + ((long long)f * a.C + c) * a.n_fft
                                    + i * a.hop + s);
            if constexpr (MODE == kOla) {
                acc = __fadd_rn(acc, zv);
            } else {
                const float m = f < a.n_valid ? 1.0f : 0.0f;
                acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(zv, a.win[i * a.hop + s]), m));
            }
        }
        float x = acc;
        if constexpr (MODE != kOla) {
            if (n < a.tail) acc = __fadd_rn(acc, a.out_tail[n * a.C + c]);
            if (r >= 0)
                a.ola_carry[r * a.C + c] =
                    a.freeze ? a.out_tail[r * a.C + c] : acc;
            x = normalise(acc, w, NORM);
            if constexpr (MODE == kPcm24) x = __fmul_rn(x, g);
        }
        a.out[n * a.C + c] = x;
        if constexpr (MODE == kPcm24) {
            pk = fmaxf(pk, fabsf(x));
            const uint32_t u = quantise(x);
            uint8_t* dst = a.pcm + (n * a.C + c) * 3;
            dst[0] = (uint8_t)(u & 0xFFu);
            dst[1] = (uint8_t)((u >> 8) & 0xFFu);
            dst[2] = (uint8_t)((u >> 16) & 0xFFu);
        }
    }
    return pk;
}

// CT in {1, 2}: 4-sample groups; CT == 0: the scalar loop, any C.
// BATCHED: blockIdx.y is the lane (select_lane).
template <int MODE, int NORM, int CT, bool BATCHED>
__global__ void __launch_bounds__(kMaxThreads)
chunk_tail_kernel(const Args args, const int* lane_n_valid) {
    Args a = args;
    if constexpr (BATCHED) select_lane(a, lane_n_valid, blockIdx.y);
    const int t = blockIdx.x;
    float pk = 0.0f;
    if constexpr (CT > 0) {
        for (int s0 = 4 * threadIdx.x; s0 < a.hop; s0 += 4 * blockDim.x)
            pk = fmaxf(pk, group4<MODE, NORM, CT>(a, t, s0));
    } else {
        for (int s = threadIdx.x; s < a.hop; s += blockDim.x)
            pk = fmaxf(pk, sample1<MODE, NORM>(a, t, s));
    }
    if constexpr (MODE == kPcm24) {
        __shared__ float warp_pk[kMaxThreads / 32];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
            pk = fmaxf(pk, __shfl_xor_sync(0xFFFFFFFFu, pk, d));
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        if (lane == 0) warp_pk[warp] = pk;
        __syncthreads();
        if (warp == 0) {
            pk = lane < (int)(blockDim.x >> 5) ? warp_pk[lane] : 0.0f;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                pk = fmaxf(pk, __shfl_xor_sync(0xFFFFFFFFu, pk, d));
            if (lane == 0) a.peaks[t] = pk;
        }
    }
}

bool aligned16(const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// lane_n_valid null: the single-file kernel. Otherwise the batched one
// over `lanes` lanes; with hop % 4 == 0 every lane's slice keeps the base
// pointers' 16-byte alignment (the pcm stores need 8 or 4).
template <int MODE, int NORM>
int launch(const Args& a, cudaStream_t stream,
           const int* lane_n_valid = nullptr, int lanes = 1) {
    const bool vec = a.hop % 4 == 0 && (a.C == 1 || a.C == 2)
        && aligned16(a.z) && aligned16(a.win) && aligned16(a.win2)
        && aligned16(a.out_tail) && aligned16(a.w_tail) && aligned16(a.out)
        && aligned16(a.pcm) && aligned16(a.ola_carry) && aligned16(a.w_carry);
    const int per_tile = vec ? a.hop / 4 : a.hop;
    int threads = (per_tile + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const dim3 grid((unsigned int)(a.F + a.K - 1), (unsigned int)lanes);
    const int ct = vec ? a.C : 0;
    if constexpr (MODE != kOla) {   // the standalone OLA has no lane axis
        if (lane_n_valid != nullptr) {
            if (ct == 1)
                chunk_tail_kernel<MODE, NORM, 1, true><<<grid, threads, 0, stream>>>(a, lane_n_valid);
            else if (ct == 2)
                chunk_tail_kernel<MODE, NORM, 2, true><<<grid, threads, 0, stream>>>(a, lane_n_valid);
            else
                chunk_tail_kernel<MODE, NORM, 0, true><<<grid, threads, 0, stream>>>(a, lane_n_valid);
            return (int)cudaGetLastError();
        }
    }
    if (ct == 1)
        chunk_tail_kernel<MODE, NORM, 1, false><<<grid, threads, 0, stream>>>(a, lane_n_valid);
    else if (ct == 2)
        chunk_tail_kernel<MODE, NORM, 2, false><<<grid, threads, 0, stream>>>(a, lane_n_valid);
    else
        chunk_tail_kernel<MODE, NORM, 0, false><<<grid, threads, 0, stream>>>(a, lane_n_valid);
    return (int)cudaGetLastError();
}

bool bad_shape(int F, int C, int n_fft, int hop) {
    return F <= 0 || C <= 0 || hop <= 0 || n_fft % hop != 0;
}

}  // namespace

extern "C" {

// Standalone K-way overlap-add: y [F, C, n_fft] -> out [(F+K-1)*hop, C].
// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int tomatis_ola_f32(const float* y, float* out, int F, int C, int n_fft,
                    int hop, void* stream) {
    if (bad_shape(F, C, n_fft, hop)) return (int)cudaErrorInvalidValue;
    Args a = {};
    a.z = y;
    a.out = out;
    a.F = F; a.C = C; a.n_fft = n_fft; a.hop = hop; a.K = n_fft / hop;
    return launch<kOla, kEps>(a, (cudaStream_t)stream);
}

// Fused chunk tail (see the note above). norm: 0 eps, 1 floor8;
// transport: 0 f32 (gain, peaks and pcm unused), 1 pcm24.
int tomatis_chunk_tail_f32(const float* z, const float* win,
                           const float* win2, const float* out_tail,
                           const float* w_tail, const float* gain,
                           float* out, float* peaks, uint8_t* pcm,
                           float* ola_carry, float* w_carry, int F, int C,
                           int n_fft, int hop, int n_valid, int norm,
                           int transport, void* stream) {
    if (bad_shape(F, C, n_fft, hop) || (norm != 0 && norm != 1)
        || (transport != 0 && transport != 1))
        return (int)cudaErrorInvalidValue;
    Args a = {z, win, win2, out_tail, w_tail, gain, out, peaks, pcm,
              ola_carry, w_carry, F, C, n_fft, hop, n_fft / hop, n_valid,
              n_fft - hop, false};
    cudaStream_t s = (cudaStream_t)stream;
    if (transport == 0)
        return norm == 0 ? launch<kEmitF32, kEps>(a, s)
                         : launch<kEmitF32, kFloor8>(a, s);
    return norm == 0 ? launch<kPcm24, kEps>(a, s)
                     : launch<kPcm24, kFloor8>(a, s);
}

// The chunk tail of B lanes in one launch (see the note above): z
// [B, F, C, n_fft], out_tail [B, tail, C], w_tail [B, tail], n_valid [B]
// int32 on the device; out [B, L, C], peaks [B, W], pcm [B, L*C*3],
// ola_carry [B, tail, C], w_carry [B, tail]; win, win2 and gain shared.
int tomatis_chunk_tail_batched_f32(
        const float* z, const float* win, const float* win2,
        const float* out_tail, const float* w_tail, const float* gain,
        const int* n_valid, float* out, float* peaks, uint8_t* pcm,
        float* ola_carry, float* w_carry, int B, int F, int C, int n_fft,
        int hop, int norm, int transport, void* stream) {
    if (B <= 0 || B > 65535 || n_valid == nullptr
        || bad_shape(F, C, n_fft, hop) || (norm != 0 && norm != 1)
        || (transport != 0 && transport != 1))
        return (int)cudaErrorInvalidValue;
    Args a = {z, win, win2, out_tail, w_tail, gain, out, peaks, pcm,
              ola_carry, w_carry, F, C, n_fft, hop, n_fft / hop, 0,
              n_fft - hop, false};
    cudaStream_t s = (cudaStream_t)stream;
    if (transport == 0)
        return norm == 0 ? launch<kEmitF32, kEps>(a, s, n_valid, B)
                         : launch<kEmitF32, kFloor8>(a, s, n_valid, B);
    return norm == 0 ? launch<kPcm24, kEps>(a, s, n_valid, B)
                     : launch<kPcm24, kFloor8>(a, s, n_valid, B);
}

const char* tomatis_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
