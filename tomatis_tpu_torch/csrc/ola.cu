// K-way overlap-add for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tomatis_tpu/ops/pallas_ola.py
// (overlap_add_pallas, body _ola_kernel). It computes the function, not
// the Pallas block layout: with K = n_fft / hop, for output sample
// n = t*hop + s and channel c,
//
//     out[n, c] = sum_{i<K, 0 <= t-i < F} y[t-i, c, i*hop + s]
//
// y is [F, C, n_fft] float32, out is [(F+K-1)*hop, C] float32 written
// time-major directly (the reference's transpose folds into the store).
// Every output element is written by exactly one thread, so there are no
// atomics. The sum runs i = 0..K-1 starting from 0.0f, the order of the
// plain version's shifted adds, so both give the same bits.
//
// Bound: bytes. Each y element is read once and each output element is
// written once; the K-1 adds per output are negligible beside the memory
// traffic. One thread per output sample n loops over the C channels:
// neighbouring threads read neighbouring s (coalesced loads along the
// frame) and write neighbouring C-float groups (a contiguous span per
// warp). TMA tiles and fusing the tail-carry add and the normaliser are
// left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ola_kernel(const float* __restrict__ y,
                           float* __restrict__ out,
                           int F, int C, int n_fft, int hop, int K,
                           long long n_out) {
    long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_out) return;
    int t = (int)(n / hop);
    int s = (int)(n - (long long)t * hop);
    for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int i = 0; i < K; ++i) {
            int f = t - i;
            if (f >= 0 && f < F) {
                acc += y[((long long)f * C + c) * n_fft
                         + (long long)i * hop + s];
            }
        }
        out[n * C + c] = acc;
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int tomatis_ola_f32(const float* y, float* out, int F, int C, int n_fft,
                    int hop, void* stream) {
    if (hop <= 0 || n_fft % hop != 0) return (int)cudaErrorInvalidValue;
    int K = n_fft / hop;
    long long n_out = (long long)(F + K - 1) * hop;
    if (F <= 0 || n_out <= 0) return 0;
    const int threads = 256;
    long long blocks = (n_out + threads - 1) / threads;
    ola_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        y, out, F, C, n_fft, hop, K, n_out);
    return (int)cudaGetLastError();
}

const char* tomatis_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
