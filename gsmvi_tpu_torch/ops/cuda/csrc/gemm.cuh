// Tiled f32 GEMM template for the O(B D^2) products of the eps GSM step.
//
// Replaces the Precision.HIGHEST `jnp.dot` / `dot_general` contractions that
// the Pallas kernels run in their own bodies
// (gsmvi_tpu/ops/pallas/fused_step.py: the fat apply `F + stack_u^T
// stack_w` at :346, the Cholesky variant's `vf = v F` at :450 and `t = vf
// F^T` at :286; the Student-t and logistic-regression scores' products at
// :842 and :878-882, zoo_score.cu and zoo_score_b.cu).  The NS route's row
// products and `gaussian_score_kernel` (:778) run on the split-k thin
// product (thin_gemm.cu).
//
// The BaM step runs its fat apply on the same template
// (gsmvi_tpu/ops/pallas/bam_fused.py :319; gemm.cu `gsmvi_bam_apply`; its
// row products run on the thin product), with two additions: a device halt
// word that makes a launch a no-op once a multistep block has stopped, and
// an epilogue that also writes per-block sums of squares of F' and F (the
// trace screen), reduced in a fixed order so that the accept flag
// reproduces from run to run.  ADVI's row products take the halt word too.
//
// Numerics: plain f32 FFMA, no TF32 and no mma/wgmma, which is what
// Precision.HIGHEST means on the TPU.  What bounds it on an H100: at the main
// path's shape (B=32, D=256) each product is 2 M FMA over a 256 KiB factor,
// so it is latency- and L2-bound, not FLOP-bound; the factor stays in L2
// between the launches of one step.  Design: a 32x32 output tile per block
// of 256 threads, 32-deep k slabs staged in padded shared memory (conflict
// free for both storage orders), 4 outputs per thread, ragged edges masked
// on load and store.  Transposes are compile-time flags, so every product
// reads its operands in the layout the step keeps them in.  Making it fast
// (wgmma on 3xTF32 splits, persistent tiles) is later work.
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

enum Prologue { PRO_NONE = 0, PRO_A_MINUS_VEC = 2 };
enum Epilogue { EPI_STORE = 0, EPI_STORE_AND_ADD_VEC = 1, EPI_SELECT_ADD = 2,
                EPI_ADD_SUMSQ = 3, EPI_ADD = 4, EPI_EYE_MINUS = 5,
                EPI_ADVI_ADAM = 6, EPI_ADVI_GRAD = 7,
                EPI_SCALE = 9, EPI_AFFINE_EYE = 10, EPI_SUB_SCALE = 11,
                EPI_LOGISTIC_RESID = 12, EPI_ACC_SUB_SCALE = 13 };

// optax.adam's update with precomputed bias corrections (the ADVI kernels,
// advi.cu): omb1 = 1 - b1 and omb2 = 1 - b2 as float32.
struct AdamArgs {
    float lr, bc1, bc2, b1, omb1, b2, omb2, eps;
};

// m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2; p -= lr (m bc1) / (sqrt(v bc2) + eps),
// every operation rounded on its own (no FMA contraction), as the plain torch
// version (ops/advi_fused.py `_adam_apply`) evaluates it: the same gradient gives
// the same bits.
__device__ __forceinline__ void adam_apply(float& p, float& m, float& v, float g,
                                           const AdamArgs& a) {
    m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
    const float step = __fdiv_rn(__fmul_rn(a.lr, __fmul_rn(m, a.bc1)),
                                 __fadd_rn(__fsqrt_rn(__fmul_rn(v, a.bc2)), a.eps));
    p = __fsub_rn(p, step);
}

// C[m, n] = epi(sum_k A'(m, k) B'(k, n)).
// A'(m, k) = TA ? a[k * lda + m] : a[m * lda + k], then the prologue:
//   PRO_A_MINUS_VEC: A'(m, k) = A'(m, k) - pro_vec[k].
// B'(k, n) = TB ? b[n * ldb + k] : b[k * ldb + n].
// Epilogues:
//   EPI_STORE:             c = acc
//   EPI_STORE_AND_ADD_VEC: c = acc, c2 = epi_vec[n] + acc
//   EPI_SELECT_ADD:        c = c_in + acc if *good != 0 else c_in (c may be c_in)
//   EPI_ADD_SUMSQ:         c = c_in + acc, and partial[2 * block] = sum(c^2),
//                          partial[2 * block + 1] = sum(c_in^2) over the tile
//   EPI_ADD:               c = c_in + acc (c distinct from c_in and the operands)
//   EPI_SCALE:             c = acc * alpha
//   EPI_AFFINE_EYE:        c = alpha * ((row == col ? beta : 0) - acc)
//   EPI_SUB_SCALE:         c = (c_in - acc) * alpha (c may be c_in)
//   EPI_LOGISTIC_RESID:    c = epi_vec[n] - 1 / (1 + e^{-acc})
//   EPI_ACC_SUB_SCALE:     c = acc - c_in * epi_vec[0] (a scale in device memory)
//   EPI_EYE_MINUS:         c = I - acc, and with a non-null partial,
//                          partial[row * gridDim.x + blockIdx.x] = sum |c| over the
//                          tile's columns of that row (square C)
//   EPI_ADVI_ADAM:         g = row >= col ? -acc - (row == col) B (1 / c) : 0, then
//                          Adam on (c, m1, m2) in place with `adam` (square C; the
//                          diagonal term reads only the element its thread owns)
//   EPI_ADVI_GRAD:         c = row >= col ? -acc : 0, and *flag = 1 where that is
//                          not finite (a plain store of one value: no atomics)
// With a non-null halt, the launch does nothing while *halt != 0.
// batch replicas (0 means 1) start sa, sb, sc, svec and sgood elements apart
// in a, b, (c, c2, c_in), (pro_vec, epi_vec) and good; halt, partial, m1,
// m2 and flag are not batched (their epilogues take one replica).
struct GemmArgs {
    const float* a;
    const float* b;
    float* c;
    int m, n, k, lda, ldb, ldc;
    const float* pro_vec;
    const float* epi_vec;
    float* c2;
    const float* c_in;
    const int* good;
    const float* halt;
    float* partial;
    float* m1;
    float* m2;
    float* flag;
    float bf;
    AdamArgs adam;
    int batch;
    long long sa, sb, sc, svec, sgood;
    float alpha, beta;
};

template <bool TA, bool TB, int PRO, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
    __shared__ float As[GEMM_BM][GEMM_BK + 1];
    __shared__ float Bs[GEMM_BK][GEMM_BN + 1];
    if (p.halt != nullptr && *p.halt != 0.f) return;
    const long long z = blockIdx.z;
    const float* pa = p.a + z * p.sa;
    const float* pb = p.b + z * p.sb;
    const float* pro_vec = p.pro_vec + z * p.svec;
    const float* epi_vec = p.epi_vec + z * p.svec;
    const float* c_in = p.c_in + z * p.sc;
    float* pc = p.c + z * p.sc;
    float* c2 = p.c2 + z * p.sc;
    const int* good = p.good + z * p.sgood;
    const int tid = threadIdx.x;
    const int tx = tid % 32;
    const int ty = tid / 32;
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int k0 = 0; k0 < p.k; k0 += GEMM_BK) {
        for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
            int r, kk;
            if (TA) { kk = i / GEMM_BM; r = i % GEMM_BM; }
            else    { r = i / GEMM_BK;  kk = i % GEMM_BK; }
            const int gm = m0 + r, gk = k0 + kk;
            float v = 0.f;
            if (gm < p.m && gk < p.k) {
                v = TA ? pa[(size_t)gk * p.lda + gm] : pa[(size_t)gm * p.lda + gk];
                if (PRO == PRO_A_MINUS_VEC) v = v - pro_vec[gk];
            }
            As[r][kk] = v;
        }
        for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
            int kk, cn;
            if (TB) { cn = i / GEMM_BK; kk = i % GEMM_BK; }
            else    { kk = i / GEMM_BN; cn = i % GEMM_BN; }
            const int gk = k0 + kk, gn = n0 + cn;
            float v = 0.f;
            if (gk < p.k && gn < p.n)
                v = TB ? pb[(size_t)gn * p.ldb + gk] : pb[(size_t)gk * p.ldb + gn];
            Bs[kk][cn] = v;
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
            const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
            p.partial[2 * blk] = a;
            p.partial[2 * blk + 1] = b;
        }
        return;
    }
    if (EPI == EPI_EYE_MINUS) {
        // One warp holds 4 rows x the tile's 32 columns (lane = column): the
        // row sums of |c| are warp reductions in a fixed order.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int gm = m0 + ty * 4 + r;
            float ab = 0.f;
            if (gm < p.m && gn < p.n) {
                const float val = (gm == gn ? 1.f : 0.f) - acc[r];
                pc[(size_t)gm * p.ldc + gn] = val;
                ab = fabsf(val);
            }
            if (p.partial != nullptr) {
                for (int o = 16; o > 0; o >>= 1) ab += __shfl_xor_sync(0xffffffffu, ab, o);
                if (tx == 0 && gm < p.m) p.partial[(size_t)gm * gridDim.x + blockIdx.x] = ab;
            }
        }
        return;
    }
    if (gn >= p.n) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int gm = m0 + ty * 4 + r;
        if (gm >= p.m) continue;
        const size_t o = (size_t)gm * p.ldc + gn;
        if (EPI == EPI_STORE) {
            pc[o] = acc[r];
        } else if (EPI == EPI_STORE_AND_ADD_VEC) {
            pc[o] = acc[r];
            c2[o] = epi_vec[gn] + acc[r];
        } else if (EPI == EPI_ADD) {
            pc[o] = c_in[o] + acc[r];
        } else if (EPI == EPI_SCALE) {
            pc[o] = acc[r] * p.alpha;
        } else if (EPI == EPI_AFFINE_EYE) {
            pc[o] = p.alpha * ((gm == gn ? p.beta : 0.f) - acc[r]);
        } else if (EPI == EPI_SUB_SCALE) {
            pc[o] = (c_in[o] - acc[r]) * p.alpha;
        } else if (EPI == EPI_LOGISTIC_RESID) {
            pc[o] = epi_vec[gn] - 1.f / (1.f + expf(-acc[r]));
        } else if (EPI == EPI_ACC_SUB_SCALE) {
            pc[o] = acc[r] - __fmul_rn(c_in[o], epi_vec[0]);
        } else if (EPI == EPI_ADVI_ADAM) {
            float g = 0.f;
            if (gm >= gn) {
                g = -acc[r];
                if (gm == gn) g = __fsub_rn(g, __fmul_rn(p.bf, __fdiv_rn(1.f, pc[o])));
            }
            float pv = pc[o], mv = p.m1[o], vv = p.m2[o];
            adam_apply(pv, mv, vv, g, p.adam);
            pc[o] = pv;
            p.m1[o] = mv;
            p.m2[o] = vv;
        } else if (EPI == EPI_ADVI_GRAD) {
            const float g = gm >= gn ? -acc[r] : 0.f;
            pc[o] = g;
            if (!isfinite(g)) *p.flag = 1.f;
        } else {
            const float base = c_in[o];
            pc[o] = (*good != 0) ? base + acc[r] : base;
        }
    }
}

template <bool TA, bool TB, int PRO, int EPI>
inline cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
    const dim3 grid((p.n + GEMM_BN - 1) / GEMM_BN, (p.m + GEMM_BM - 1) / GEMM_BM,
                    p.batch > 0 ? p.batch : 1);
    gemm_kernel<TA, TB, PRO, EPI><<<grid, GEMM_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace gsmvi
