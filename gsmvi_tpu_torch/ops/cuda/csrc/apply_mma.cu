// The fat apply of the eps GSM step on bf16 tensor cores, with its select:
// F' = F + su^T sw where *good, else F, at the "bf16" and "high" (bf16x3)
// precisions.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, the big_prec
// contraction `f + t_mm(stack_u, stack_w, bp)` (:346) with the
// accept/revert select (:454-455/:738-739) when pallas_precision is "bf16"
// (Precision.DEFAULT) or "high" (Precision.HIGH): K1, K2, K4 and K6 (over
// K replicas, gsmvi_tpu/ops/pallas/batch_fused.py :71-91).  The float32
// route keeps gemm.cu's FFMA template unchanged.
//
// Design: gemm.cuh's 32 x 32 output tile per block and 32-deep k slabs
// staged in padded shared memory (zero-filled past D and past k = 2B), with
// its 256 threads as eight warps, each one 16 x 8 m16n8k16 tile: per
// 16-deep k step one A and one B fragment, rounded to bf16 (hi, and lo for
// bf16x3) as they load, and one (three) mma into a float32 accumulator.
// The epilogue reads `good` and writes F + acc or F; each output has one
// owner thread, so f_out may be f_in.  Replica z (blockIdx.z) offsets every
// operand by its own stride and keeps the tiles and k order of a single
// launch.  Bounds on an H100 at (B, D) = (32, 256): 2 M FMA over a
// 256 KiB factor read and written (0.00039 ms of bytes), latency- and
// L2-bound, not FLOP-bound.
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"

namespace {

constexpr int AM_BM = 32;
constexpr int AM_BN = 32;
constexpr int AM_BK = 32;
constexpr int AM_PAD = 8;          // row pad of the staged tiles
constexpr int AM_THREADS = 256;    // eight warps, a 16 x 8 output tile each

struct ApplyArgs {
    const float* su;   // (k, d): A(m, kk) = su[kk d + m]
    const float* sw;   // (k, d): B(kk, n) = sw[kk d + n]
    const float* f_in;
    float* f_out;
    const int* good;
    int k, d;
};

template <int MODE>
__global__ void __launch_bounds__(AM_THREADS) apply_mma_kernel(ApplyArgs p) {
    __shared__ float As[AM_BK][AM_BM + AM_PAD];   // As[kk][m]
    __shared__ float Bs[AM_BK][AM_BN + AM_PAD];   // Bs[kk][n]
    const long long z = blockIdx.z;
    const float* su = p.su + z * (long long)p.k * p.d;
    const float* sw = p.sw + z * (long long)p.k * p.d;
    const float* f_in = p.f_in + z * (long long)p.d * p.d;
    float* f_out = p.f_out + z * (long long)p.d * p.d;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int m0 = blockIdx.y * AM_BM, n0 = blockIdx.x * AM_BN;
    const int wm = (warp >> 2) * 16, wn = (warp & 3) * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int k0 = 0; k0 < p.k; k0 += AM_BK) {
        for (int i = tid; i < AM_BK * AM_BM; i += AM_THREADS) {
            const int kk = i / AM_BM, c = i % AM_BM;
            const int gk = k0 + kk;
            As[kk][c] = (gk < p.k && m0 + c < p.d) ? su[(size_t)gk * p.d + m0 + c] : 0.f;
            Bs[kk][c] = (gk < p.k && n0 + c < p.d) ? sw[(size_t)gk * p.d + n0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < AM_BK; kk += 16) {
            const int k = kk + 2 * t;
            const int m = wm + g;
            const float2 xa[4] = {make_float2(As[k][m], As[k + 1][m]),
                                  make_float2(As[k][m + 8], As[k + 1][m + 8]),
                                  make_float2(As[k + 8][m], As[k + 9][m]),
                                  make_float2(As[k + 8][m + 8], As[k + 9][m + 8])};
            uint32_t ah[4], al[4], bh[2], bl[2];
            frag_a<MODE>(xa, ah, al);
            const int n = wn + g;
            frag_b<MODE>(make_float2(Bs[k][n], Bs[k + 1][n]),
                         make_float2(Bs[k + 8][n], Bs[k + 9][n]), bh, bl);
            mma_acc<MODE>(acc, ah, al, bh, bl);
        }
        __syncthreads();
    }

    const bool take = p.good[z] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + wm + g + (i >= 2 ? 8 : 0);
        const int gn = n0 + wn + 2 * t + (i & 1);
        if (gm >= p.d || gn >= p.d) continue;
        const size_t o = (size_t)gm * p.d + gn;
        const float base = f_in[o];
        f_out[o] = take ? base + acc[i] : base;
    }
}

}  // namespace

extern "C" {

// gsmvi_factor_apply (gemm.cu) at mode 1 (bf16) or 2 (bf16x3): f_out =
// f_in + su^T @ sw if *good else f_in, su, sw (k, d), f (d, d), for `reps`
// replicas stored one after another (good (reps,)); f_out may be f_in.
int gsmvi_factor_apply_mma(const float* su, const float* sw, const float* f_in,
                           float* f_out, const int* good, int k, int d, int reps, int mode,
                           void* stream) {
    if (k < 1 || d < 1 || reps < 1 || reps > 65535 || (mode != MMA_BF16 && mode != MMA_BF16X3))
        return (int)cudaErrorInvalidValue;
    ApplyArgs p{su, sw, f_in, f_out, good, k, d};
    const dim3 grid((d + AM_BN - 1) / AM_BN, (d + AM_BM - 1) / AM_BM, reps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == MMA_BF16)
        apply_mma_kernel<MMA_BF16><<<grid, AM_THREADS, 0, s>>>(p);
    else
        apply_mma_kernel<MMA_BF16X3><<<grid, AM_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
