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
// What bounds it on an H100: a small draw (B=32, D=256: 8,192 normals,
// 32 KiB written) is the launch plus one thread's dependent chain of ten
// rounds and a Box-Muller; a large one is bound by instruction issue, not
// by its 4 bytes a normal written: per counter block 20 32x32->64
// multiplies and ~26 other integer operations, and per normal the fast
// paths of a full-precision logf, cosf and sqrtf (~80 float32 operations).
// The stream keeps only the cos branch, one normal per two words, so its
// transcendentals per normal are twice those of a draw that takes both
// branches (torch.randn).
//
// Design.  Each round's two products are one 32x32->64 multiply each
// (IMAD.WIDE.U32).  The grid comes from the SM count, and the two sizes
// take two plans:
// - a small draw (at most 256 normals per SM; the main path's 8,192) is a
//   chain's latency on top of the launch, so `philox_half_kernel` gives
//   each thread ONE normal: the two threads of a counter block both run
//   its chain and each its own Box-Muller, halving the per-thread critical
//   path, in 64-thread CTAs spread over the SMs; stores are one float a
//   thread, contiguous across the warp;
// - a larger draw is bound by its instructions, so `philox_kernel<NP>`
//   gives a thread NP "pairs" of counter blocks (pair p = blocks 2p and
//   2p + 1 = normals 4p .. 4p + 3): 2 NP independent chains interleaved
//   round by round, a pair's normals out as one float4 and each block's
//   words as one uint4, pair p_j = base + j T + t so the warps' float4
//   stores cover contiguous 512-byte runs; 256-thread CTAs, at most 8 per
//   SM (one resident wave), with a grid-stride loop.  NP is 1 until the
//   draw fills two waves of one-pair threads and 2 above: at (512, 1024)
//   two pairs a thread (256 CTAs, 4 warps a scheduler) ran no faster than
//   the replaced design on an H100, one pair (512 CTAs) 6 % faster.
// Any launch shape gives the same stream: a block's words depend on its
// counter alone.
//
// `philox_oracle_kernel` is the design this one replaced (one thread per
// counter block, the products as a low multiply and __umulhi, scalar
// stores), kept as `gsmvi_philox_oracle` to be timed and checked against;
// no wrapper calls it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr int PRNG_THREADS = 256;
constexpr int SMALL_THREADS = 64;     // CTA of a small draw
constexpr int SMALL_NORMALS_PER_SM = 256;
constexpr int LARGE_CTAS_PER_SM = 8;  // 8 x 256 threads: one resident wave

// `_uniform_from_bits`: the product is exact, so a contracted FMA rounds as
// the separate multiply and add do.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
    return (float)(bits >> 8) * (1.f / 16777216.f) + (0.5f / 16777216.f);
}

__device__ __forceinline__ float box_muller(uint32_t bits1, uint32_t bits2) {
    const float u1 = uniform_from_bits(bits1), u2 = uniform_from_bits(bits2);
    return sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958648f * u2);
}

__device__ __forceinline__ uint4 counter_block(long long i) {
    return make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u);
}

// One round with each product as one 32x32->64 multiply.
__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
    const uint64_t p0 = (uint64_t)PHILOX_M0 * c.x;
    const uint64_t p1 = (uint64_t)PHILOX_M1 * c.z;
    return make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k0, (uint32_t)p1,
                      (uint32_t)(p0 >> 32) ^ c.w ^ k1, (uint32_t)p0);
}

template <int NP>
__global__ void __launch_bounds__(PRNG_THREADS) philox_kernel(
        uint32_t* __restrict__ words, float* __restrict__ normals,
        long long n_blocks, long long n_normals, uint32_t k0, uint32_t k1) {
    const long long n_pairs = (n_blocks + 1) / 2;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const bool vec = (reinterpret_cast<uintptr_t>(normals) & 15) == 0;
    for (long long base = 0; base < n_pairs; base += NP * stride) {
        uint4 c[2 * NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            const long long p = base + j * stride + t;
            c[2 * j] = counter_block(2 * p);
            c[2 * j + 1] = counter_block(2 * p + 1);
        }
        uint32_t r0 = k0, r1 = k1;
#pragma unroll
        for (int r = 0; r < 10; ++r) {
            if (r) {
                r0 += PHILOX_W0;
                r1 += PHILOX_W1;
            }
#pragma unroll
            for (int q = 0; q < 2 * NP; ++q) c[q] = philox_round(c[q], r0, r1);
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
            const long long p = base + j * stride + t;
            if (p >= n_pairs) continue;
            if (words != nullptr) {
                reinterpret_cast<uint4*>(words)[2 * p] = c[2 * j];
                if (2 * p + 1 < n_blocks)
                    reinterpret_cast<uint4*>(words)[2 * p + 1] = c[2 * j + 1];
            }
            if (normals == nullptr) continue;
            const float4 z = make_float4(box_muller(c[2 * j].x, c[2 * j].y),
                                         box_muller(c[2 * j].z, c[2 * j].w),
                                         box_muller(c[2 * j + 1].x, c[2 * j + 1].y),
                                         box_muller(c[2 * j + 1].z, c[2 * j + 1].w));
            if (vec && 4 * p + 3 < n_normals) {
                reinterpret_cast<float4*>(normals)[p] = z;
            } else {
                const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (4 * p + k < n_normals) normals[4 * p + k] = zs[k];
            }
        }
    }
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

// One normal a thread: thread t runs counter block t / 2 and takes its
// words (0, 1) or (2, 3) by t's parity; the even thread writes the words.
__global__ void __launch_bounds__(SMALL_THREADS) philox_half_kernel(
        uint32_t* __restrict__ words, float* __restrict__ normals,
        long long n_blocks, long long n_normals, uint32_t k0, uint32_t k1) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long i = t >> 1;
    if (i >= n_blocks) return;
    const uint4 w = philox4x32_10(counter_block(i), k0, k1);
    const bool odd = (t & 1) != 0;
    if (words != nullptr && !odd) reinterpret_cast<uint4*>(words)[i] = w;
    if (normals != nullptr && t < n_normals)
        normals[t] = box_muller(odd ? w.z : w.x, odd ? w.w : w.y);
}

__device__ __forceinline__ uint4 philox_round_oracle(uint4 c, uint32_t k0, uint32_t k1) {
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__global__ void __launch_bounds__(PRNG_THREADS) philox_oracle_kernel(
        uint32_t* words, float* normals, long long n_blocks, long long n_normals,
        uint32_t k0, uint32_t k1) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_blocks) return;
    uint4 w = philox_round_oracle(counter_block(i), k0, k1);
#pragma unroll
    for (int r = 1; r < 10; ++r) {
        k0 += PHILOX_W0;
        k1 += PHILOX_W1;
        w = philox_round_oracle(w, k0, k1);
    }
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

int sm_count() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms < 1)
        return 132;
    return sms;
}

}  // namespace

// Counter blocks 0 .. n_blocks-1 under key (k0, k1): their four words into
// `words` (n_blocks, 4) and/or the first n_normals normals into `normals`
// (either may be null; `words` 16-byte aligned).
extern "C" int gsmvi_philox(unsigned* words, float* normals, long long n_blocks,
                            long long n_normals, unsigned k0, unsigned k1, void* stream) {
    if (n_blocks < 1 || n_normals < 0 || n_normals > 2 * n_blocks) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(words) & 15) != 0) return (int)cudaErrorMisalignedAddress;
    static int sms = 0;
    if (sms == 0) sms = sm_count();
    const long long n_pairs = (n_blocks + 1) / 2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (2 * n_blocks <= (long long)SMALL_NORMALS_PER_SM * sms) {
        const long long grid = (2 * n_blocks + SMALL_THREADS - 1) / SMALL_THREADS;
        philox_half_kernel<<<(unsigned)grid, SMALL_THREADS, 0, s>>>(
            words, normals, n_blocks, n_normals, k0, k1);
    } else {
        const long long wave = (long long)LARGE_CTAS_PER_SM * sms;
        if (n_pairs < 2 * wave * PRNG_THREADS) {
            long long grid = (n_pairs + PRNG_THREADS - 1) / PRNG_THREADS;
            if (grid > wave) grid = wave;
            philox_kernel<1><<<(unsigned)grid, PRNG_THREADS, 0, s>>>(
                words, normals, n_blocks, n_normals, k0, k1);
        } else {
            philox_kernel<2><<<(unsigned)wave, PRNG_THREADS, 0, s>>>(
                words, normals, n_blocks, n_normals, k0, k1);
        }
    }
    return (int)cudaGetLastError();
}

// The replaced design, with gsmvi_philox's arguments.
extern "C" int gsmvi_philox_oracle(unsigned* words, float* normals, long long n_blocks,
                                   long long n_normals, unsigned k0, unsigned k1,
                                   void* stream) {
    if (n_blocks < 1 || n_normals < 0 || n_normals > 2 * n_blocks) return (int)cudaErrorInvalidValue;
    const long long grid = (n_blocks + PRNG_THREADS - 1) / PRNG_THREADS;
    philox_oracle_kernel<<<(unsigned)grid, PRNG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        words, normals, n_blocks, n_normals, k0, k1);
    return (int)cudaGetLastError();
}
