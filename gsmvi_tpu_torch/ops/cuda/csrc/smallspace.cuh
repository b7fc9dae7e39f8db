// Device functions shared by the one-block small-space kernels
// (eps_smallspace.cu for the eps-NS GSM update, bam_smallspace.cu for the
// BaM NS update, eps_chol.cu for the exact eps update): block reductions,
// (n, n) products and symmetrisation in shared memory, the matmul-only
// Newton-Schulz square root (with its inverse-root iterate) and
// Newton-Hotelling inverse, the slab-staged products between (n, n) shared
// matrices and (m, D) global row tensors, and the eps step's row scalars
// and mean select.
//
// They replace the Pallas helpers `_spd_norm_ub` (:189), `_ns_sqrt` (:198)
// and `_newton_inv` (:214) of gsmvi_tpu/ops/pallas/fused_step.py and
// `_ns_sqrt_both` (:176) of gsmvi_tpu/ops/pallas/bam_fused.py, with the
// same iteration and the same row-sum norm seed.  Every function is called
// by all threads of the block and ends in a barrier, so a caller may read
// its result right away.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SS_TD = 32;              // column slab staged in shared memory
constexpr int SS_LD = SS_TD + 1;       // padded slab row

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ float block_sum(float x, float* red) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[w] = x;
    __syncthreads();
    float r = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    return r;
}

__device__ float block_max(float x, float* red) {
    for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[w] = x;
    __syncthreads();
    float r = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
    return r;
}

// C = epi(i, j, (A @ B)[i, j]) for (n, n) shared-memory matrices; C aliases neither.
template <class Epi>
__device__ void smm(const float* A, const float* B, float* C, int n, Epi epi) {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        float acc = 0.f;
        for (int k = 0; k < n; ++k) acc = fmaf(A[i * n + k], B[k * n + j], acc);
        C[idx] = epi(i, j, acc);
    }
    __syncthreads();
}

struct Plain {
    __device__ float operator()(int, int, float acc) const { return acc; }
};

// M = 0.5 (M + M^T) in place.
__device__ void symmetrize(float* M, int n) {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        if (i < j) {
            const float s = 0.5f * (M[i * n + j] + M[j * n + i]);
            M[i * n + j] = s;
            M[j * n + i] = s;
        }
    }
    __syncthreads();
}

// Row-sum (infinity) norm + 1e-30: `_spd_norm_ub`.
__device__ float spd_norm_ub(const float* A, int n, float* red) {
    float s = 0.f;
    if ((int)threadIdx.x < n) {
        for (int j = 0; j < n; ++j) s += fabsf(A[threadIdx.x * n + j]);
    }
    return block_max(s, red) + 1e-30f;
}

// sum((S S - A)^2) / (sum(A^2) + 1e-30), with W as scratch.
__device__ float rel_residual(const float* S, const float* A, float* W, int n, float* red) {
    smm(S, S, W, n, Plain());
    float num = 0.f, den = 0.f;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        const float r = W[idx] - A[idx];
        num += r * r;
        den += A[idx] * A[idx];
    }
    num = block_sum(num, red);
    den = block_sum(den, red);
    return num / (den + 1e-30f);
}

// Coupled Newton-Schulz on SPD A (`_ns_sqrt_both`): yout = sqrt(A) and
// zout = A^{-1/2}, either may be null; w[0..4] scratch.
__device__ void ns_sqrt_both(const float* A, float* yout, float* zout, int n, int iters,
                             float* const* w, float* red) {
    const float nrm = spd_norm_ub(A, n, red);
    float* Y = w[0];
    float* Z = w[1];
    float* T = w[2];
    float* Y2 = w[3];
    float* Z2 = w[4];
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        Y[idx] = A[idx] / nrm;
        Z[idx] = (i == j) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        smm(Z, Y, T, n, [](int i, int j, float acc) { return 0.5f * ((i == j ? 3.f : 0.f) - acc); });
        // Y2 = Y T and Z2 = T Z in one pass.
        for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
            const int i = idx / n, j = idx - i * n;
            float ay = 0.f, az = 0.f;
            for (int k = 0; k < n; ++k) {
                ay = fmaf(Y[i * n + k], T[k * n + j], ay);
                az = fmaf(T[i * n + k], Z[k * n + j], az);
            }
            Y2[idx] = ay;
            Z2[idx] = az;
        }
        __syncthreads();
        float* tmp = Y; Y = Y2; Y2 = tmp;
        tmp = Z; Z = Z2; Z2 = tmp;
    }
    const float sq = sqrtf(nrm);
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        if (yout != nullptr) yout[idx] = Y[idx] * sq;
        if (zout != nullptr) zout[idx] = Z[idx] / sq;
    }
    __syncthreads();
}

// Newton-Schulz SPD square root of A (`_ns_sqrt`) into out; w[0..4] scratch.
__device__ void ns_sqrt(const float* A, float* out, int n, int iters, float* const* w, float* red) {
    ns_sqrt_both(A, out, nullptr, n, iters, w, red);
}

// Newton-Hotelling inverse of SPD A (`_newton_inv`) into out; w[0..2] scratch.
__device__ void newton_inv(const float* A, float* out, int n, int iters, float* const* w, float* red) {
    const float inv_ub = 1.f / spd_norm_ub(A, n, red);
    float* X = w[0];
    float* T = w[1];
    float* X2 = w[2];
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        X[idx] = (i == j) ? inv_ub : 0.f;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        smm(A, X, T, n, [](int i, int j, float acc) { return (i == j ? 2.f : 0.f) - acc; });
        smm(X, T, X2, n, Plain());
        float* tmp = X; X = X2; X2 = tmp;
    }
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) out[idx] = X[idx];
    __syncthreads();
}

// G = scale * X Y^T for (m, D) global row tensors, slab-staged, into the
// top-left (m, m) of an (ld, ld) matrix whose other entries are set to 0.
// Needs ld * ld <= 4 * blockDim.x and m <= ld.
__device__ void gram_rows(const float* X, const float* Y, float* G, int m, int ld, int d,
                          float scale, float* sx, float* sy) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < d; d0 += SS_TD) {
        for (int q = threadIdx.x; q < m * SS_TD; q += blockDim.x) {
            const int i = q / SS_TD, dd = q - i * SS_TD, col = d0 + dd;
            sx[i * SS_LD + dd] = col < d ? X[(size_t)i * d + col] : 0.f;
            sy[i * SS_LD + dd] = col < d ? Y[(size_t)i * d + col] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int idx = threadIdx.x + r * blockDim.x;
            if (idx < ld * ld) {
                const int i = idx / ld, k = idx - i * ld;
                if (i < m && k < m) {
                    float a = acc[r];
                    for (int dd = 0; dd < SS_TD; ++dd) a = fmaf(sx[i * SS_LD + dd], sy[k * SS_LD + dd], a);
                    acc[r] = a;
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int idx = threadIdx.x + r * blockDim.x;
        if (idx < ld * ld) G[idx] = acc[r] * scale;
    }
    __syncthreads();
}

// Row scalars of the eps-coordinate step (fused_step.py:285-296 and
// :379-389): for each of the n rows, 1/(1 + rho), w/den and gamma, from the
// (n, D) rows v, t = vf F^T and ef = e F^T, a warp per row; the three
// (n,) results land in shared memory.  Shared by the NS small space
// (eps_smallspace.cu) and the Cholesky one (eps_chol.cu).
__device__ void eps_row_scalars(const float* v, const float* t, const float* ef, int n, int d,
                                float* s_inv1r, float* s_wden, float* s_gamma) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int r = warp; r < n; r += nwarps) {
        float vsv = 0.f, mv = 0.f, wsum = 0.f;
        for (int col = lane; col < d; col += 32) {
            const size_t o = (size_t)r * d + col;
            const float vv = v[o], tt = t[o], a = -ef[o];
            vsv += vv * tt;
            mv += a * vv;
            wsum += vv * (tt - a);
        }
        for (int o = 16; o > 0; o >>= 1) {
            vsv += __shfl_xor_sync(0xffffffffu, vsv, o);
            mv += __shfl_xor_sync(0xffffffffu, mv, o);
            wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
        }
        if (lane == 0) {
            const float rho = 0.5f * (sqrtf(1.f + 4.f * (vsv + mv * mv)) - 1.f);
            const float den = 1.f + rho + mv;
            const float inv1r = 1.f / (1.f + rho);
            const float wden = wsum / den;
            s_inv1r[r] = inv1r;
            s_wden[r] = wden;
            s_gamma[r] = 1.f - (1.f + wden) * inv1r;
        }
    }
    __syncthreads();
}

// The mean with its select: mean_out = mean_in + mean_b dmu_b where good,
// else mean_in; dmu_b = (t + ef + ef w/den) / (1 + rho).  One thread per
// column sums the n rows in order (no atomics); mean_out may be mean_in.
__device__ void eps_mean_select(const float* t, const float* ef, const float* s_wden,
                                const float* s_inv1r, const float* mean_in, float* mean_out,
                                int n, int d, bool good) {
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
        float s = 0.f;
        for (int b = 0; b < n; ++b) {
            const size_t o = (size_t)b * d + col;
            const float e = ef[o];
            s += ((t[o] + e) + e * s_wden[b]) * s_inv1r[b];
        }
        const float m = mean_in[col];
        mean_out[col] = good ? m + s / (float)n : m;
    }
    __syncthreads();
}

// epi(i, col, sum_{k<m} S'[i, k] X[k, col]) for i < m, with S' = S (or S^T
// when TRANS), S an (ld, ld) shared matrix and X (m, D) global rows,
// slab-staged.
template <bool TRANS, class Epi>
__device__ void left_apply(const float* S, int ld, const float* X, int m, int d, float* sx, Epi epi) {
    for (int d0 = 0; d0 < d; d0 += SS_TD) {
        for (int q = threadIdx.x; q < m * SS_TD; q += blockDim.x) {
            const int k = q / SS_TD, dd = q - k * SS_TD, col = d0 + dd;
            sx[k * SS_LD + dd] = col < d ? X[(size_t)k * d + col] : 0.f;
        }
        __syncthreads();
        for (int q = threadIdx.x; q < m * SS_TD; q += blockDim.x) {
            const int i = q / SS_TD, dd = q - i * SS_TD, col = d0 + dd;
            float acc = 0.f;
            for (int k = 0; k < m; ++k)
                acc = fmaf(TRANS ? S[k * ld + i] : S[i * ld + k], sx[k * SS_LD + dd], acc);
            if (col < d) epi(i, col, acc);
        }
        __syncthreads();
    }
}

}  // namespace
