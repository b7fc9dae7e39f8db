// Small-space core of the eps-NS GSM update (K1's non-GEMM math).
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_smallspace_ns` (:231)
// from the row work at :287 to the stacked rows at :345, with `_ns_sqrt`
// (:198), `_newton_inv` (:214), `_spd_norm_ub` (:189), both residual gates
// (tol 3e-3) and the mean half of the accept/revert select (:454/:738).  The
// O(B D^2) products around it (ef, vf, t, the fat apply with the factor
// select) are launches of the GEMM template (gemm.cuh).
//
// What bounds it on an H100: the five Newton-Schulz / Newton-Hotelling
// chains are ~70 dependent (B x B) products, each a few hundred cycles plus
// a block barrier, so the kernel is latency-bound, not FLOP- or byte-bound.
// The (B, D) row tensors (32 KiB each at B=32, D=256; 256 KiB at B=64,
// D=1024) do not fit shared memory next to the chains, so they stay in
// global memory (L1/L2 resident) and are streamed through shared memory in
// 32-column slabs for every Gram and every (B, B) x (B, D) product.
// Design: ONE block of 1024 threads holds every (B, B) matrix in shared
// memory (10 of them, 160 KiB at B=64, dynamic shared memory) so the chains
// never leave the SM; f32 FFMA only; every symmetrisation and both relative
// residual gates are kept exactly as in the TPU kernel.  Spreading the row
// work over a grid is later work.
//
// K replicas (the batched K1 of fit_batch and K6,
// gsmvi_tpu/ops/pallas/batch_fused.py :54-145): one block per replica,
// blockIdx.x = replica, each on its own rows, mean, stacked rows, `good`
// and `nacc` slot.  The TPU ran those grid cells one after another on its
// one core; here they run side by side on the SMs, one block each (the
// shared-memory footprint allows one block per SM).  A block computes what
// a one-block launch on its replica alone computes, bit for bit.
#include "smallspace.cuh"

namespace {

constexpr int SS_THREADS = 1024;
constexpr int SS_MAXB = 64;
constexpr int SS_NMAT = 10;            // (B, B) matrices resident in shared memory

struct SmallSpaceArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* mean_out;     // may equal mean_in
    int* good;           // (1,) 1 iff both residual gates pass
    int* nacc;           // optional (1,): += good
    long long e_stride;  // elements between replicas' e rows (the others are packed)
    float* su;           // (2B, D) stack_u
    float* sw;           // (2B, D) stack_w
    float* c;            // (B, D) scratch: downdate rows
    float* xim;          // (B, D) scratch: Xi~^T
    int b, d;
    int it0, it1, it2, it3, it4;
    float tol;
};

__global__ void __launch_bounds__(SS_THREADS, 1) eps_smallspace_kernel(SmallSpaceArgs p) {
    extern __shared__ float smem[];
    const int n = p.b, d = p.d, nn = n * n;
    {   // This block's replica.
        const long long z = blockIdx.x, rows = (long long)n * d;
        p.e += z * p.e_stride;
        p.v += z * rows; p.vf += z * rows; p.t += z * rows; p.ef += z * rows;
        p.c += z * rows; p.xim += z * rows;
        p.su += 2 * z * rows; p.sw += 2 * z * rows;
        p.mean_in += z * d; p.mean_out += z * d;
        p.good += z;
        if (p.nacc != nullptr) p.nacc += z;
    }
    float* red = smem;                          // 32
    float* s_gamma = red + 32;                  // SS_MAXB each
    float* s_inv1r = s_gamma + SS_MAXB;
    float* s_wden = s_inv1r + SS_MAXB;
    float* sx = s_wden + SS_MAXB;               // SS_MAXB * SS_LD each
    float* sy = sx + SS_MAXB * SS_LD;
    float* mats = sy + SS_MAXB * SS_LD;         // SS_NMAT * nn
    float* GU = mats;            // gu, later cuiec
    float* S1 = GU + nn;         // s1, later s2
    float* CU = S1 + nn;
    float* CUI = CU + nn;        // cui, later cv
    float* W0 = CUI + nn;        // chain input / Grams / Q
    float* w[5] = {W0 + nn, W0 + 2 * nn, W0 + 3 * nn, W0 + 4 * nn, W0 + 5 * nn};
    const float zc = 1.f / sqrtf((float)n);
    const float scale2 = 1.f / (float)n;

    // Row scalars: rho, w/den, 1/(1+rho), gamma (fused_step.py:285-296).
    eps_row_scalars(p.v, p.t, p.ef, n, d, s_inv1r, s_wden, s_gamma);

    // Downdate rows c = -e gamma + vf / (1 + rho).
    for (int q = threadIdx.x; q < n * d; q += blockDim.x) {
        const int i = q / d;
        p.c[q] = -p.e[q] * s_gamma[i] + p.vf[q] * s_inv1r[i];
    }
    __syncthreads();

    // Phase 1 on Gu = e e^T / B.
    gram_rows(p.e, p.e, GU, n, n, d, scale2, sx, sy);
    symmetrize(GU, n);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + GU[idx];
    __syncthreads();
    ns_sqrt(W0, S1, n, p.it0, w, red);
    symmetrize(S1, n);
    const float res1 = rel_residual(S1, W0, w[0], n, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + S1[idx];
    __syncthreads();
    newton_inv(W0, CU, n, p.it1, w, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = ((idx / n == idx % n ? 1.f : 0.f) + S1[idx]) + GU[idx];
    __syncthreads();
    newton_inv(W0, CUI, n, p.it2, w, red);

    // Xi~^T = (c - cuiec^T e) / sqrt(B), cuiec = cui (e c^T / B).
    gram_rows(p.e, p.c, W0, n, n, d, scale2, sx, sy);
    float* CUIEC = GU;
    smm(CUI, W0, CUIEC, n, Plain());
    {
        const float* c = p.c;
        float* xim = p.xim;
        left_apply<true>(CUIEC, n, p.e, n, d, sx, [=](int i, int col, float acc) {
            const size_t o = (size_t)i * d + col;
            xim[o] = (c[o] - acc) * zc;
        });
    }

    // Phase 2 on I - Gv, Gv = Xi~^T Xi~.
    gram_rows(p.xim, p.xim, W0, n, n, d, 1.f, sx, sy);
    symmetrize(W0, n);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) - W0[idx];
    __syncthreads();
    float* S2 = S1;
    ns_sqrt(W0, S2, n, p.it3, w, red);
    symmetrize(S2, n);
    const float res2 = rel_residual(S2, W0, w[0], n, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + S2[idx];
    __syncthreads();
    float* CV = CUI;
    newton_inv(W0, CV, n, p.it4, w, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) CV[idx] = -CV[idx];
    __syncthreads();
    const bool good = (res1 < p.tol) && (res2 < p.tol);

    // Stacked rows of the fat apply F' = F + stack_u^T stack_w.
    {
        float* sw = p.sw;
        float* su = p.su;
        const float* ef = p.ef;
        // w1row = cu e / sqrt(B); u1row = -(mu - x) / sqrt(B) = ef / sqrt(B).
        left_apply<false>(CU, n, p.e, n, d, sx, [=](int i, int col, float acc) {
            const size_t o = (size_t)i * d + col;
            sw[o] = acc * zc;
            su[o] = ef[o] * zc;
        });
    }
    // Q = Xi~^T w1row^T - cuiec^T, so that
    // fw1xi^T = [-gamma ef + t/(1+rho) + Q ef] / sqrt(B)
    //        = ximf^T + (Xi~^T w1row^T) u1row   (fused_step.py:341-342).
    gram_rows(p.xim, p.sw, W0, n, n, d, 1.f, sx, sy);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        const int i = idx / n, k = idx - i * n;
        W0[idx] -= CUIEC[k * n + i];
    }
    __syncthreads();
    {
        float* su = p.su + (size_t)n * d;
        const float* ef = p.ef;
        const float* t = p.t;
        const float* g = s_gamma;
        const float* ir = s_inv1r;
        left_apply<false>(W0, n, p.ef, n, d, sx, [=](int i, int col, float acc) {
            const size_t o = (size_t)i * d + col;
            su[o] = (-g[i] * ef[o] + ir[i] * t[o] + acc) * zc;
        });
    }
    {
        float* sw = p.sw + (size_t)n * d;
        left_apply<false>(CV, n, p.xim, n, d, sx, [=](int i, int col, float acc) {
            sw[(size_t)i * d + col] = acc;
        });
    }

    // Mean with its select: mu' = mu + mean_b dmu_b where accepted.
    eps_mean_select(p.t, p.ef, s_wden, s_inv1r, p.mean_in, p.mean_out, n, d, good);
    if (threadIdx.x == 0) {
        *p.good = good ? 1 : 0;
        if (p.nacc != nullptr) *p.nacc += good ? 1 : 0;
    }
}

inline size_t smem_bytes(int b) {
    return sizeof(float) * (32 + 3 * SS_MAXB + 2 * SS_MAXB * SS_LD + (size_t)SS_NMAT * b * b);
}

}  // namespace

extern "C" int gsmvi_eps_smallspace(const float* e, const float* v, const float* vf,
                                    const float* t, const float* ef, const float* mean_in,
                                    float* mean_out, int* good, int* nacc, float* su,
                                    float* sw, float* c, float* xim, int b, int d, int it0,
                                    int it1, int it2, int it3, int it4, float tol,
                                    int reps, long long e_stride, void* stream) {
    if (b < 1 || b > SS_MAXB || d < 1 || reps < 1) return (int)cudaErrorInvalidValue;
    // Above 48 KB needs the opt-in, a function attribute: it covers every
    // later launch, whatever its grid.
    static bool smem_opt_in = false;
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            eps_smallspace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(SS_MAXB));
        if (err != cudaSuccess) return (int)err;
        smem_opt_in = true;
    }
    const size_t smem = smem_bytes(b);
    SmallSpaceArgs p{e, v, vf, t, ef, mean_in, mean_out, good, nacc, e_stride, su, sw, c,
                     xim, b, d, it0, it1, it2, it3, it4, tol};
    eps_smallspace_kernel<<<reps, SS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}
