// Device functions shared by the small-space kernels: block reductions
// (every kernel), symmetrisation in shared memory and the slab-staged
// product of an (n, n) shared matrix with (m, D) global row tensors
// (eps_chol.cu), and the eps step's row scalars and mean select
// (eps_chol.cu).  The chains' products run on smallspace_tiled.cuh's
// register tiles in the cluster kernels, on smallspace_panel.cuh's row
// panels and in eps_smallspace_grid.cuh's workers.  Every function is called by all
// threads of the block and ends in a barrier, so a caller may read its
// result right away.
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

// Row scalars of the eps-coordinate step (fused_step.py:285-296 and
// :379-389): for each of the n rows, 1/(1 + rho), w/den and gamma, from the
// (n, D) rows v, t = vf F^T and ef = e F^T, a warp per row; the three
// (n,) results land in shared memory.  Used by the Cholesky small space
// (eps_chol.cu); the cluster NS one forms them over its blocks' columns.
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
