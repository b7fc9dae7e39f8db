// Exact (Cholesky) small space of the eps-coordinate GSM update (K4a).
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_update_core` (:350)
// with `_cholt_inplace` (:142) and `_triu_inv_inplace` (:170): the body of
// `gsm_eps_update_fused(method="chol")` (`_update_kernel`, :421) and of
// `make_fused_eps_step(method="chol")` (:586).  With Z^T = [-e; c]/sqrt(B)
// and (F Z)^T = [a; bm]/sqrt(B) (2B rows each), the update is
//   G = Z^T Z (+ jitter (tr G / 2B + 1) I),  Lg^T = chol(G)^T,
//   K = I + Lg^T J Lg (J = diag(+1 x B, -1 x B)),  M = Lg^{-T},
//   Ck^T = chol(K)^T with its minimum pivot (good = minpiv > 0),
//   S2 = M (Ck^T - I)^T M^T,  F' = F + (F Z) S2 Z^T.
// The O(B D^2) products around it (ef, vf, t, and the fat apply with the
// factor select) and the O(B^2 D) Gram are launches of the GEMM template
// (gemm.cuh); the row scalars and the mean select are K1's (smallspace.cuh).
//
// What bounds it on an H100: the three sequential (2B)-step sweeps (two
// Choleskys and the backward substitution) cost two or one block barriers
// per step, ~4 x 2B barriers in all, and the three dense (2B)^3 products
// (K, then S2 in two) are a few hundred FMA per thread, so the kernel is
// latency-bound, not FLOP- or byte-bound.  Design: ONE block of 1024 threads
// keeps the three (2B, 2B) matrices the TPU kernel keeps in VMEM scratch in
// shared memory (48 KiB at B=32, 192 KiB at B=64: dynamic shared memory
// with the opt-in); a Cholesky step writes its factor row with 2B threads,
// then updates the trailing block with all threads; each backward
// substitution row spreads each column's dot over a group of lanes reduced
// by shuffles in a fixed order.  The (2B, D) rows stay in global memory and
// are streamed through shared memory in 32-column slabs for S2 Z^T.
//
// NaN: a NaN score makes G, and then K, NaN.  The minimum pivot folds with a
// NaN-propagating compare (fminf would drop the NaN) and the pivot clamp
// max(piv, 1e-30) keeps a NaN, so a NaN pivot gives good = 0, as
// `jnp.minimum`/`jnp.maximum` do on the TPU.
#include "gemm.cuh"
#include "smallspace.cuh"

using gsmvi::GemmArgs;
using gsmvi::launch_gemm;

namespace {

constexpr int CH_THREADS = 1024;
constexpr int CH_MAXB = 64;
constexpr int CH_MAXK = 2 * CH_MAXB;

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// Row work: the row scalars, then Z^T = [-e; c] / sqrt(B) and
// (F Z)^T = [a; bm] / sqrt(B) (a = -ef, bm = a + dmu_b) as (2B, D) rows, and
// rs = (1/(1+rho), w/den) for the small kernel's mean.
__global__ void __launch_bounds__(CH_THREADS, 1) eps_chol_rows_kernel(
        const float* e, const float* v, const float* vf, const float* t, const float* ef,
        float* zt, float* fzt, float* rs, int n, int d) {
    __shared__ float s_inv1r[CH_MAXB], s_wden[CH_MAXB], s_gamma[CH_MAXB];
    eps_row_scalars(v, t, ef, n, d, s_inv1r, s_wden, s_gamma);
    const float scale = 1.f / sqrtf((float)n);
    const size_t nd = (size_t)n * d;
    for (size_t q = threadIdx.x; q < nd; q += blockDim.x) {
        const int i = (int)(q / d);
        const float ee = e[q], efv = ef[q], a = -efv;
        const float c = -ee * s_gamma[i] + vf[q] * s_inv1r[i];
        const float dmu_b = ((t[q] + efv) + efv * s_wden[i]) * s_inv1r[i];
        zt[q] = -ee * scale;
        zt[nd + q] = c * scale;
        fzt[q] = a * scale;
        fzt[nd + q] = (a + dmu_b) * scale;
    }
    if ((int)threadIdx.x < n) {
        rs[threadIdx.x] = s_inv1r[threadIdx.x];
        rs[n + threadIdx.x] = s_wden[threadIdx.x];
    }
}

// Right-looking Cholesky of the (k, k) SPD W in place (`_cholt_inplace`):
// the transposed factor L^T (upper) into Lt, W destroyed.  Returns the
// minimum pivot, NaN when any pivot is NaN.
__device__ float cholt(float* W, float* Lt, int k) {
    float minpiv = INFINITY;
    for (int j = 0; j < k; ++j) {
        const float piv = W[j * k + j];
        minpiv = nan_min(minpiv, piv);
        const float inv = 1.f / sqrtf(nan_max(piv, 1e-30f));
        for (int c = threadIdx.x; c < k; c += blockDim.x)
            Lt[j * k + c] = c >= j ? W[j * k + c] * inv : 0.f;
        __syncthreads();
        // W -= l l^T with l = row j of Lt: zero left of column j, so only
        // the trailing (k - j)^2 block changes.
        const int m = k - j;
        for (int q = threadIdx.x; q < m * m; q += blockDim.x) {
            const int r = j + q / m, c = j + q % m;
            W[r * k + c] -= Lt[j * k + r] * Lt[j * k + c];
        }
        __syncthreads();
    }
    return minpiv;
}

// Inverse of the (k, k) upper triangle Lt into M (also upper) by backward
// substitution (`_triu_inv_inplace`): row j of M = (e_j - Lt[j, j+1:] M[j+1:])
// / Lt[j, j], from row k-1 up.  Each column's dot runs on a group of g lanes
// (a power of two <= 32, g * k <= blockDim), summed by shuffles in a fixed
// order; every lane takes part in the shuffles.
__device__ void triu_inv(const float* Lt, float* M, int k) {
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) M[idx] = 0.f;
    __syncthreads();
    int g = 32;
    while (g > 1 && g * k > (int)blockDim.x) g >>= 1;
    const int col = threadIdx.x / g, part = threadIdx.x % g;
    for (int j = k - 1; j >= 0; --j) {
        float acc = 0.f;
        if (col < k)
            for (int m = j + 1 + part; m < k; m += g) acc = fmaf(Lt[j * k + m], M[m * k + col], acc);
        for (int o = g >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (col < k && part == 0) M[j * k + col] = ((col == j ? 1.f : 0.f) - acc) / Lt[j * k + j];
        __syncthreads();
    }
}

struct CholArgs {
    const float* g;       // (2B, 2B) Gram Z^T Z
    const float* zt;      // (2B, D) Z^T rows
    const float* t;       // (B, D) vf F^T
    const float* ef;      // (B, D) e F^T
    const float* rs;      // (2B,) 1/(1+rho), w/den
    const float* mean_in;
    float* mean_out;      // may equal mean_in
    int* good;            // (1,) minpiv > 0
    int* nacc;            // optional (1,): += good
    float* w;             // (2B, D) S2 Z^T, the fat apply's second operand
    int n, d;
    float jitter;
};

__global__ void __launch_bounds__(CH_THREADS, 1) eps_chol_small_kernel(CholArgs p) {
    extern __shared__ float smem[];
    const int n = p.n, k = 2 * n, kk = k * k, d = p.d;
    float* red = smem;                          // 32
    float* s_inv1r = red + 32;                  // CH_MAXB each
    float* s_wden = s_inv1r + CH_MAXB;
    float* sx = s_wden + CH_MAXB;               // CH_MAXK * SS_LD
    float* W = sx + CH_MAXK * SS_LD;            // kk each
    float* L = W + kk;
    float* N = L + kk;
    if ((int)threadIdx.x < n) {
        s_inv1r[threadIdx.x] = p.rs[threadIdx.x];
        s_wden[threadIdx.x] = p.rs[n + threadIdx.x];
    }

    // W = sym(G) + jitter (tr / 2B + 1) I  (fused_step.py:398-402).
    float tr = 0.f;
    for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
        const int i = idx / k, j = idx - i * k;
        const float s = 0.5f * (p.g[i * k + j] + p.g[j * k + i]);
        W[idx] = s;
        if (i == j) tr += s;
    }
    tr = block_sum(tr, red);
    const float jit = p.jitter * (tr / (float)k + 1.f);
    for (int i = threadIdx.x; i < k; i += blockDim.x) W[i * k + i] += jit;
    __syncthreads();
    cholt(W, L, k);                                         // L = Lg^T

    // K = I + (Lg^T J) Lg, symmetrised, into W.
    for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
        const int i = idx / k, j = idx - i * k;
        float acc = 0.f;
        for (int m = 0; m < k; ++m)
            acc = fmaf(L[i * k + m] * (m < n ? 1.f : -1.f), L[j * k + m], acc);
        W[idx] = (i == j ? 1.f : 0.f) + acc;
    }
    __syncthreads();
    symmetrize(W, k);
    triu_inv(L, N, k);                                      // N = Lg^{-T}
    const float minpiv = cholt(W, L, k);                    // L = Ck^T
    const bool good = minpiv > 0.f;

    // S2 = M (Ck^T - I)^T M^T: X = M (Ck^T - I)^T into W, then X M^T into L.
    for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
        const int i = idx / k, j = idx - i * k;
        float acc = 0.f;
        for (int m = 0; m < k; ++m)
            acc = fmaf(N[i * k + m], L[j * k + m] - (j == m ? 1.f : 0.f), acc);
        W[idx] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
        const int i = idx / k, j = idx - i * k;
        float acc = 0.f;
        for (int m = 0; m < k; ++m) acc = fmaf(W[i * k + m], N[j * k + m], acc);
        L[idx] = acc;
    }
    __syncthreads();

    // w = S2 Z^T, the rows the fat apply F + (F Z) w contracts with.
    {
        float* w = p.w;
        left_apply<false>(L, k, p.zt, k, d, sx, [=](int i, int col, float acc) {
            w[(size_t)i * d + col] = acc;
        });
    }
    eps_mean_select(p.t, p.ef, s_wden, s_inv1r, p.mean_in, p.mean_out, n, d, good);
    if (threadIdx.x == 0) {
        *p.good = good ? 1 : 0;
        if (p.nacc != nullptr) *p.nacc += good ? 1 : 0;
    }
}

inline size_t smem_bytes(int b) {
    const size_t k = 2 * (size_t)b;
    return sizeof(float) * (32 + 2 * CH_MAXB + (size_t)CH_MAXK * SS_LD + 3 * k * k);
}

}  // namespace

// K4a after the row products vf = v F and t = vf F^T: the row kernel, the
// Gram G = Z^T Z on the GEMM template, and the Cholesky small space, which
// writes the mean (selected), `good` (and nacc += good) and w = S2 Z^T into
// the (2B, D) scratch `w`; the caller's fat apply F + fzt^T w with the select
// follows.  Scratch: zt, fzt, w (2B, D), g (2B, 2B), rs (2B,).
extern "C" int gsmvi_eps_chol(const float* e, const float* v, const float* vf, const float* t,
                              const float* ef, const float* mean_in, float* mean_out, int* good,
                              int* nacc, float* zt, float* fzt, float* g, float* w, float* rs,
                              int b, int d, float jitter, void* stream) {
    if (b < 1 || b > CH_MAXB || d < 1) return (int)cudaErrorInvalidValue;
    static bool smem_opt_in = false;
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            eps_chol_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(CH_MAXB));
        if (err != cudaSuccess) return (int)err;
        smem_opt_in = true;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    eps_chol_rows_kernel<<<1, CH_THREADS, 0, s>>>(e, v, vf, t, ef, zt, fzt, rs, b, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    GemmArgs gp{};
    gp.a = zt; gp.b = zt; gp.c = g;
    gp.m = 2 * b; gp.n = 2 * b; gp.k = d; gp.lda = d; gp.ldb = d; gp.ldc = 2 * b;
    err = launch_gemm<false, true, gsmvi::EPI_STORE>(gp, s);
    if (err != cudaSuccess) return (int)err;
    CholArgs p{g, zt, t, ef, rs, mean_in, mean_out, good, nacc, w, b, d, jitter};
    eps_chol_small_kernel<<<1, CH_THREADS, smem_bytes(b), s>>>(p);
    return (int)cudaGetLastError();
}
