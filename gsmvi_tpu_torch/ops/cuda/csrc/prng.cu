// Philox4x32-10 counter-based generator and Box-Muller normals: the draw of
// the whole-step kernel's on-card variant (K4, external_eps=False).
//
// Replaces the TPU's hardware PRNG in gsmvi_tpu/ops/pallas/fused_step.py:
// `pltpu.prng_seed(seed)` (:618) and `_boxmuller` (:578) over
// `pltpu.prng_random_bits` with `_uniform_from_bits` (:567).  The TPU's
// stream cannot be reproduced; this one is Philox4x32-10 (Salmon, Moraes,
// Dror and Shaw, SC'11), written out here: counter block i =
// (i mod 2^32, i >> 32, 0, 0), key (seed, a fixed second word), ten rounds
// with the Weyl key bump between rounds.  Uniforms take the top 24 bits of
// a word, u = (bits >> 8) 2^-24 + 2^-25 (never 0, as on the TPU), and each
// normal is the cos branch of Box-Muller on two words, with full-precision
// logf/cosf (no fast-math intrinsics): block i gives normals 2i (words 0, 1)
// and 2i + 1 (words 2, 3) of the row-major draw.
//
// What bounds it on an H100: at the main path's draw (B=32, D=256: 8,192
// normals, 32 KiB written) the launch; a large draw is bound by the
// ~130 integer and transcendental operations per two normals, not by its
// writes.  Design: one thread per counter block, no shared state, so any
// thread count reproduces the same stream; the words can be written out
// for a check against the plain version (ops/fused_step.py
// `philox4x32_reference`).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr int PRNG_THREADS = 256;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
    c = philox_round(c, k0, k1);
#pragma unroll
    for (int r = 1; r < 10; ++r) {
        k0 += PHILOX_W0;
        k1 += PHILOX_W1;
        c = philox_round(c, k0, k1);
    }
    return c;
}

// `_uniform_from_bits`: the product is exact, so a contracted FMA rounds as
// the separate multiply and add do.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
    return (float)(bits >> 8) * (1.f / 16777216.f) + (0.5f / 16777216.f);
}

__device__ __forceinline__ float box_muller(uint32_t bits1, uint32_t bits2) {
    const float u1 = uniform_from_bits(bits1), u2 = uniform_from_bits(bits2);
    return sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958648f * u2);
}

__global__ void __launch_bounds__(PRNG_THREADS) philox_kernel(
        uint32_t* words, float* normals, long long n_blocks, long long n_normals,
        uint32_t k0, uint32_t k1) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_blocks) return;
    const uint4 w = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), k0, k1);
    if (words != nullptr) {
        words[4 * i] = w.x;
        words[4 * i + 1] = w.y;
        words[4 * i + 2] = w.z;
        words[4 * i + 3] = w.w;
    }
    if (normals != nullptr) {
        if (2 * i < n_normals) normals[2 * i] = box_muller(w.x, w.y);
        if (2 * i + 1 < n_normals) normals[2 * i + 1] = box_muller(w.z, w.w);
    }
}

}  // namespace

// Counter blocks 0 .. n_blocks-1 under key (k0, k1): their four words into
// `words` (n_blocks, 4) and/or the first n_normals normals into `normals`
// (either may be null).
extern "C" int gsmvi_philox(unsigned* words, float* normals, long long n_blocks,
                            long long n_normals, unsigned k0, unsigned k1, void* stream) {
    if (n_blocks < 1 || n_normals < 0 || n_normals > 2 * n_blocks) return (int)cudaErrorInvalidValue;
    const long long grid = (n_blocks + PRNG_THREADS - 1) / PRNG_THREADS;
    philox_kernel<<<(unsigned)grid, PRNG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        words, normals, n_blocks, n_normals, k0, k1);
    return (int)cudaGetLastError();
}
