// Register-tiled (n, n) chain primitives for the cluster small space
// (eps_smallspace_cluster.cu): products, symmetrisation, the row-sum norm
// seed, the relative residual, the coupled Newton-Schulz square root and the
// Newton-Hotelling inverse, as in smallspace.cuh, which the BaM, Cholesky
// and global-memory small spaces keep using unchanged.
//
// They replace the Pallas helpers `_spd_norm_ub` (:189), `_ns_sqrt` (:198)
// and `_newton_inv` (:214) of gsmvi_tpu/ops/pallas/fused_step.py.
//
// Layout: an (n, n) matrix lives in shared memory with the padded leading
// dimension ld = round_up(n, 4) and zeros outside the (n, n) corner, which
// every function here keeps (it writes only i, j < n).  A product runs on a
// 16 x 16 grid of SC_THREADS = 256 threads, each owning a T x T output tile
// (T = 1, 2, 4 for n <= 16, 32, 64), reading rows of A as float4 along k and
// rows of B as T-wide vectors: 2T loads for 4 T^2 FMA, where the one-output-
// per-thread `smm` of smallspace.cuh makes two loads per FMA.  Each output's
// k order is ascending, as in `smm` (the padded k add exact zeros), so a
// product of the same operands gives the same value.  Every function is
// called by all threads of the block and ends in a barrier.
#pragma once

#include "smallspace.cuh"

namespace {

constexpr int SC_THREADS = 256;

__device__ __forceinline__ int padded(int n) { return (n + 3) & ~3; }

template <int T>
__device__ __forceinline__ void load_vec(float (&r)[T], const float* ptr) {
    if constexpr (T == 4) {
        const float4 v = *reinterpret_cast<const float4*>(ptr);
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else if constexpr (T == 2) {
        const float2 v = *reinterpret_cast<const float2*>(ptr);
        r[0] = v.x; r[1] = v.y;
    } else {
        r[0] = ptr[0];
    }
}

__device__ __forceinline__ void load4(float (&r)[4], const float* ptr) { load_vec<4>(r, ptr); }

// f(i, j, offset) for every i, j < n, thread (ty, tx) taking i = ty + 16 a
// and j = tx + 16 b (a, b < T); then a barrier.
template <int T, class F>
__device__ void each_entry(int n, int ld, F f) {
    const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
        for (int b = 0; b < T; ++b) {
            const int i = i0 + 16 * a, j = j0 + 16 * b;
            if (i < n && j < n) f(i, j, i * ld + j);
        }
    __syncthreads();
}

// One 4-deep k step of a T x T tile: acc += A[i0.., k..k+3] B[k..k+3, j0..].
template <int T>
__device__ __forceinline__ void tile_step(const float* A, const float* B, int ld, int i0, int j0,
                                          int k, float (&acc)[T][T]) {
    float a[T][4], b[4][T];
#pragma unroll
    for (int i = 0; i < T; ++i) load4(a[i], A + (i0 + i) * ld + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) load_vec<T>(b[q], B + (k + q) * ld + j0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < T; ++j) acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
}

// acc = A[i0.., :] B[:, j0..] over k ascending; LD > 0 is ld known at
// compile time, 0 a runtime ld.
template <int T, int LD>
__device__ __forceinline__ void tile_product(const float* A, const float* B, int ld, int i0,
                                             int j0, float (&acc)[T][T]) {
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) acc[i][j] = 0.f;
    if constexpr (LD > 0) {
#pragma unroll 4
        for (int k = 0; k < LD; k += 4) tile_step<T>(A, B, LD, i0, j0, k, acc);
    } else {
        for (int k = 0; k < ld; k += 4) tile_step<T>(A, B, ld, i0, j0, k, acc);
    }
}

template <int T, int LD, class Epi>
__device__ __forceinline__ void tmm_ld(const float* A, const float* B, float* C, int n, int ld,
                                       Epi epi) {
    const int i0 = (threadIdx.x >> 4) * T, j0 = (threadIdx.x & 15) * T;
    if (i0 < n && j0 < n) {
        float acc[T][T];
        tile_product<T, LD>(A, B, ld, i0, j0, acc);
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < T; ++j)
                if (i0 + i < n && j0 + j < n)
                    C[(i0 + i) * ld + j0 + j] = epi(i0 + i, j0 + j, acc[i][j]);
    }
    __syncthreads();
}

// C = epi(i, j, (A @ B)[i, j]); C aliases neither operand.  At ld = 16 T
// (B = 16, 32, 64) the k loop's trip count is known at compile time.
template <int T, class Epi>
__device__ void tmm(const float* A, const float* B, float* C, int n, int ld, Epi epi) {
    if (ld == 16 * T) tmm_ld<T, 16 * T>(A, B, C, n, ld, epi);
    else tmm_ld<T, 0>(A, B, C, n, ld, epi);
}

template <int T, int LD, class EpiY>
__device__ __forceinline__ void tmm_pair_ld(const float* Y, const float* Tm, const float* Z,
                                            float* Y2, float* Z2, int n, int ld, EpiY epi_y) {
    const int i0 = (threadIdx.x >> 4) * T, j0 = (threadIdx.x & 15) * T;
    if (i0 < n && j0 < n) {
        float ay[T][T], az[T][T];
        tile_product<T, LD>(Y, Tm, ld, i0, j0, ay);
        tile_product<T, LD>(Tm, Z, ld, i0, j0, az);
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < T; ++j)
                if (i0 + i < n && j0 + j < n) {
                    Y2[(i0 + i) * ld + j0 + j] = epi_y(ay[i][j]);
                    Z2[(i0 + i) * ld + j0 + j] = az[i][j];
                }
    }
    __syncthreads();
}

// Y2 = epi_y(Y Tm) and Z2 = Tm Z in one pass (the Newton-Schulz step).
template <int T, class EpiY>
__device__ void tmm_pair(const float* Y, const float* Tm, const float* Z, float* Y2, float* Z2,
                         int n, int ld, EpiY epi_y) {
    if (ld == 16 * T) tmm_pair_ld<T, 16 * T>(Y, Tm, Z, Y2, Z2, n, ld, epi_y);
    else tmm_pair_ld<T, 0>(Y, Tm, Z, Y2, Z2, n, ld, epi_y);
}

// M = 0.5 (M + M^T) in place.
template <int T>
__device__ void tsymmetrize(float* M, int n, int ld) {
    each_entry<T>(n, ld, [=](int i, int j, int o) {
        if (i < j) {
            const float s = 0.5f * (M[o] + M[j * ld + i]);
            M[o] = s;
            M[j * ld + i] = s;
        }
    });
}

// Row-sum (infinity) norm + 1e-30 of a symmetric A: `_spd_norm_ub`.  Thread
// i sums row i in ascending order, reading it as column i (A is symmetric
// bit for bit: every caller's input is a symmetrised matrix or a sum of
// them), so that a warp's loads fall in distinct banks.
__device__ float tnorm_ub(const float* A, int n, int ld, float* red) {
    float s = 0.f;
    if ((int)threadIdx.x < n) {
        for (int j = 0; j < n; ++j) s += fabsf(A[j * ld + threadIdx.x]);
    }
    return block_max(s, red) + 1e-30f;
}

// sum((S S - A)^2) / (sum(A^2) + 1e-30), with W as scratch.
template <int T>
__device__ float trel_residual(const float* S, const float* A, float* W, int n, int ld,
                               float* red) {
    tmm<T>(S, S, W, n, ld, Plain());
    float num = 0.f, den = 0.f;
    const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
        for (int b = 0; b < T; ++b) {
            const int i = i0 + 16 * a, j = j0 + 16 * b;
            if (i < n && j < n) {
                const int o = i * ld + j;
                const float r = W[o] - A[o];
                num += r * r;
                den += A[o] * A[o];
            }
        }
    num = block_sum(num, red);
    den = block_sum(den, red);
    return num / (den + 1e-30f);
}

// Coupled Newton-Schulz square root of SPD A (`_ns_sqrt`) into out;
// w[0..4] scratch.  The last step writes sqrt(norm) Y straight into out.
template <int T>
__device__ void tns_sqrt(const float* A, float* out, int n, int ld, int iters, float* const* w,
                         float* red) {
    const float nrm = tnorm_ub(A, n, ld, red);
    const float sq = sqrtf(nrm);
    float* Y = w[0];
    float* Z = w[1];
    float* Tm = w[2];
    float* Y2 = w[3];
    float* Z2 = w[4];
    each_entry<T>(n, ld, [=](int i, int j, int o) {
        Y[o] = A[o] / nrm;
        Z[o] = (i == j) ? 1.f : 0.f;
    });
    for (int it = 0; it < iters; ++it) {
        tmm<T>(Z, Y, Tm, n, ld,
               [](int i, int j, float acc) { return 0.5f * ((i == j ? 3.f : 0.f) - acc); });
        if (it + 1 < iters) {
            tmm_pair<T>(Y, Tm, Z, Y2, Z2, n, ld, [](float y) { return y; });
        } else {
            tmm_pair<T>(Y, Tm, Z, out, Z2, n, ld, [=](float y) { return y * sq; });
            return;
        }
        float* tmp = Y; Y = Y2; Y2 = tmp;
        tmp = Z; Z = Z2; Z2 = tmp;
    }
    each_entry<T>(n, ld, [=](int, int, int o) { out[o] = Y[o] * sq; });
}

// Newton-Hotelling inverse of SPD A (`_newton_inv`) into out; w[0..2]
// scratch.  The last step writes straight into out.
template <int T>
__device__ void tnewton_inv(const float* A, float* out, int n, int ld, int iters,
                            float* const* w, float* red) {
    const float inv_ub = 1.f / tnorm_ub(A, n, ld, red);
    float* X = iters > 0 ? w[0] : out;
    float* Tm = w[1];
    float* X2 = w[2];
    each_entry<T>(n, ld, [=](int i, int j, int o) { X[o] = (i == j) ? inv_ub : 0.f; });
    for (int it = 0; it < iters; ++it) {
        tmm<T>(A, X, Tm, n, ld, [](int i, int j, float acc) { return (i == j ? 2.f : 0.f) - acc; });
        float* dst = it + 1 < iters ? X2 : out;
        tmm<T>(X, Tm, dst, n, ld, Plain());
        X2 = X;
        X = dst;
    }
}

}  // namespace
