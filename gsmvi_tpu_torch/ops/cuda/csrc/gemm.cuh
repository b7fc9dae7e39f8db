// Tiled f32 GEMM template: F' = F + A^T B with A, B (2B, D) row stacks.
//
// Replaces the Precision.HIGHEST `dot_general` contraction that the Pallas
// kernels run in their own bodies for BaM's fat apply
// (gsmvi_tpu/ops/pallas/bam_fused.py :319).  The eps step's fat apply
// (gsmvi_tpu/ops/pallas/fused_step.py :346/:417) runs on apply_f32.cu; its
// select epilogue here is that kernel's bit-for-bit oracle
// (gsmvi_factor_apply_oracle).  Every row product runs on the split-k thin
// product (thin_gemm.cu) and its primitives.
//
// Two epilogues: the eps step's select (F' where *good, else F, per
// replica), and BaM's, which also writes per-block sums of squares of F'
// and F (the trace screen), reduced in a fixed order so that the accept
// flag reproduces from run to run, behind a device halt word that makes a
// launch a no-op once a multistep block has stopped.
//
// Numerics: plain f32 FFMA, no TF32 and no mma/wgmma, which is what
// Precision.HIGHEST means on the TPU.  What bounds it on an H100: at the main
// path's shape (B=32, D=256) the apply is 2 M FMA over a 256 KiB factor,
// so it is latency- and L2-bound, not FLOP-bound; the factor stays in L2
// between the launches of one step.  Design: a 32x32 output tile per block
// of 256 threads, 32-deep k slabs staged in padded shared memory, 4 outputs
// per thread, ragged edges masked on load and store.  apply_f32.cu is its
// redesign for the eps step; BaM's apply still runs here.
//
// Replica axis: with `batch` = K > 1 the grid gains blockIdx.z = replica,
// and every operand of replica z starts its own batch stride further on
// (the K-replica launches of fit_batch, ops/batch_fused.py).  Only pointer
// offsets change: each replica's tiles and per-element accumulation order
// are those of a single launch, so replica z's result equals, bit for bit,
// a launch on replica z alone.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace gsmvi {

constexpr int GEMM_BM = 32;
constexpr int GEMM_BN = 32;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;   // 32 x 8; each thread owns 4 rows of one column

enum Epilogue { EPI_SELECT_ADD = 2, EPI_ADD_SUMSQ = 3 };

// C[m, n] = epi(sum_k a[k * lda + m] b[k * ldb + n]).
// Epilogues:
//   EPI_SELECT_ADD:        c = c_in + acc if *good != 0 else c_in (c may be c_in)
//   EPI_ADD_SUMSQ:         c = c_in + acc, and partial[2 * block] = sum(c^2),
//                          partial[2 * block + 1] = sum(c_in^2) over the tile
// With a non-null halt, the launch does nothing while *halt != 0.
// batch replicas (0 means 1) start sa, sb, sc and sgood elements apart in
// a, b, (c, c_in) and good; replica z's tile sums follow replica z - 1's
// in partial (2 tiles values each); halt is not batched.
struct GemmArgs {
    const float* a;
    const float* b;
    float* c;
    int m, n, k, lda, ldb, ldc;
    const float* c_in;
    const int* good;
    const float* halt;
    float* partial;
    int batch;
    long long sa, sb, sc, sgood;
};

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
    __shared__ float As[GEMM_BM][GEMM_BK + 1];
    __shared__ float Bs[GEMM_BK][GEMM_BN + 1];
    if (p.halt != nullptr && *p.halt != 0.f) return;
    const long long z = blockIdx.z;
    const float* pa = p.a + z * p.sa;
    const float* pb = p.b + z * p.sb;
    const float* c_in = p.c_in + z * p.sc;
    float* pc = p.c + z * p.sc;
    const int* good = p.good + z * p.sgood;
    const int tid = threadIdx.x;
    const int tx = tid % 32;
    const int ty = tid / 32;
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int k0 = 0; k0 < p.k; k0 += GEMM_BK) {
        for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
            const int kk = i / GEMM_BM, r = i % GEMM_BM;
            const int gm = m0 + r, gk = k0 + kk;
            As[r][kk] = (gm < p.m && gk < p.k) ? pa[(size_t)gk * p.lda + gm] : 0.f;
        }
        for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
            const int kk = i / GEMM_BN, cn = i % GEMM_BN;
            const int gk = k0 + kk, gn = n0 + cn;
            Bs[kk][cn] = (gk < p.k && gn < p.n) ? pb[(size_t)gk * p.ldb + gn] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK; ++kk) {
            const float bv = Bs[kk][tx];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r] = fmaf(As[ty * 4 + r][kk], bv, acc[r]);
        }
        __syncthreads();
    }

    const int gn = n0 + tx;
    if (EPI == EPI_ADD_SUMSQ) {
        __shared__ float red[2][GEMM_THREADS / 32];
        float s_new = 0.f, s_old = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int gm = m0 + ty * 4 + r;
            if (gm >= p.m || gn >= p.n) continue;
            const size_t o = (size_t)gm * p.ldc + gn;
            const float base = c_in[o];
            const float val = base + acc[r];
            pc[o] = val;
            s_new = fmaf(val, val, s_new);
            s_old = fmaf(base, base, s_old);
        }
        for (int o = 16; o > 0; o >>= 1) {
            s_new += __shfl_xor_sync(0xffffffffu, s_new, o);
            s_old += __shfl_xor_sync(0xffffffffu, s_old, o);
        }
        if ((tid & 31) == 0) {
            red[0][tid >> 5] = s_new;
            red[1][tid >> 5] = s_old;
        }
        __syncthreads();
        if (tid == 0) {
            float a = 0.f, b = 0.f;
            for (int w = 0; w < GEMM_THREADS / 32; ++w) {
                a += red[0][w];
                b += red[1][w];
            }
            const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                               blockIdx.x;
            p.partial[2 * blk] = a;
            p.partial[2 * blk + 1] = b;
        }
        return;
    }
    if (gn >= p.n) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int gm = m0 + ty * 4 + r;
        if (gm >= p.m) continue;
        const size_t o = (size_t)gm * p.ldc + gn;
        const float base = c_in[o];
        pc[o] = (*good != 0) ? base + acc[r] : base;
    }
}

template <int EPI>
inline cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
    const dim3 grid((p.n + GEMM_BN - 1) / GEMM_BN, (p.m + GEMM_BM - 1) / GEMM_BM,
                    p.batch > 0 ? p.batch : 1);
    gemm_kernel<EPI><<<grid, GEMM_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace gsmvi
