// In-kernel analytic scores of the Gaussian-mixture and logistic-regression
// zoo targets (K11b), the score launch of the whole-step paths (K2, K4, K6,
// K8-K10) on those targets.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py (score functions traced
// into the TPU's whole-step kernels):
//   gsmvi_mixture_score  `mixture_score_kernel` (:848)
//       r = softmax_k(x . m_k - ||m_k||^2/2 + logmask_k), v = r M - x
//   gsmvi_logreg_score   `logreg_score_kernel` (:869)
//       v = (y - 1/(1 + e^{-w X^T})) X - w/ps^2
// written from that math, with the TPU kernels' order of operations so that
// the plain torch twins (ops/fused_step.py `mixture_score_reference`,
// `logreg_score_reference`) agree to rounding.  Every parameter stays in
// device memory (means, logmask; X, y, 1/ps^2): a launch never waits for the
// host.  A -1e30 logmask entry (the JAX target's padding of K to 8) gives
// e^{-1e30 - max} = 0, zero weight, as on the TPU; the sigmoid saturates to 0
// or 1 for |z| > ~100 (e^{-z} is 0 or inf), with no NaN.
//
// What bounds it on an H100:
// - mixture reads x and M and writes v once, O(B D + K D) bytes (68.6 KB at
//   B=32, D=256, K=3: 0.02 us at 3.35 TB/s) for 4 B K D FLOP, so launch
//   latency bounds it.  K is tiny (3 by default, 8 padded), so the TPU
//   kernel's two (B, K) products would be two GEMM launches whose 32x32 tiles
//   hold 3 useful columns, with a softmax launch between them.  Design: one
//   launch, a warp per row.  Each block first forms ||m_k||^2/2 (a warp per
//   component, into shared memory); each warp then forms its row's K logits
//   as shuffle-reduced dot products over D in a fixed order, keeps them in
//   shared memory, takes the max, the exps, the sum and the divide, and each
//   lane writes v[col] = sum_k r_k M[k, col] - x[col] over its columns.
// - logreg is two products of 2 B N D FLOP each (6.55 MFLOP at B=32, N=200,
//   D=256), on the GEMM template (gemm.cuh): z = w X^T with resid =
//   y - 1/(1 + e^{-z}) in its epilogue, then resid X with - w/ps^2 in its
//   epilogue (1/ps^2 read from device memory).  Two launches, resid (B, N)
//   through L2; one fused launch per row block, resid kept in shared memory,
//   is later work.
#include "gemm.cuh"

namespace {

constexpr int MIX_THREADS = 256;                 // 8 warps: 8 rows per block
constexpr int MIX_ROWS = MIX_THREADS / 32;

__device__ __forceinline__ float warp_sum(float s) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// Shared memory: half[K] = ||m_k||^2 / 2, then each warp's K logits (later
// its responsibilities).
__global__ void __launch_bounds__(MIX_THREADS) mixture_score_kernel(
        const float* x, const float* means, const float* logmask, float* v,
        int m, int d, int k) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* half = smem;
    float* r = smem + (size_t)(1 + warp) * k;
    for (int c = warp; c < k; c += MIX_ROWS) {
        const float* mk = means + (size_t)c * d;
        float s = 0.f;
        for (int col = lane; col < d; col += 32) s += mk[col] * mk[col];
        s = warp_sum(s);
        if (lane == 0) half[c] = 0.5f * s;
    }
    __syncthreads();
    const int row = blockIdx.x * MIX_ROWS + warp;
    if (row >= m) return;
    const float* xr = x + (size_t)row * d;
    for (int c = 0; c < k; ++c) {
        const float* mk = means + (size_t)c * d;
        float s = 0.f;
        for (int col = lane; col < d; col += 32) s += xr[col] * mk[col];
        s = warp_sum(s);
        if (lane == 0) r[c] = s - half[c] + logmask[c];
    }
    __syncwarp();
    float mx = r[0];
    for (int c = lane; c < k; c += 32) mx = fmaxf(mx, r[c]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < k; c += 32) {
        const float e = expf(r[c] - mx);
        r[c] = e;
        sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < k; c += 32) r[c] = r[c] / sum;
    __syncwarp();
    float* vr = v + (size_t)row * d;
    for (int col = lane; col < d; col += 32) {
        float acc = 0.f;
        for (int c = 0; c < k; ++c) acc = fmaf(r[c], means[(size_t)c * d + col], acc);
        vr[col] = acc - xr[col];
    }
}

}  // namespace

extern "C" {

// Mixture score of the (M, D) rows x into v: means (K, D), logmask (1, K);
// K <= 1024 (36 KiB of shared memory).
int gsmvi_mixture_score(const float* x, const float* means, const float* logmask,
                        float* v, int m, int d, int k, void* stream) {
    if (m < 1 || d < 1 || k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((m + MIX_ROWS - 1) / MIX_ROWS);
    const size_t smem = (size_t)(1 + MIX_ROWS) * k * sizeof(float);
    mixture_score_kernel<<<blocks, MIX_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, means, logmask, v, m, d, k);
    return (int)cudaGetLastError();
}

// Logistic-regression score of the (M, D) weight rows w into v: xdata (N, D),
// y (1, N), inv_ps2 (1, 1); resid (M, N) is scratch.  Two launches.
int gsmvi_logreg_score(const float* w, const float* xdata, const float* y,
                       const float* inv_ps2, float* resid, float* v, int m, int d,
                       int n, void* stream) {
    if (m < 1 || d < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gsmvi::GemmArgs p{};
    p.a = w; p.b = xdata; p.c = resid; p.epi_vec = y;
    p.m = m; p.n = n; p.k = d; p.lda = d; p.ldb = d; p.ldc = n;
    cudaError_t err =
        gsmvi::launch_gemm<false, true, gsmvi::PRO_NONE, gsmvi::EPI_LOGISTIC_RESID>(p, s);
    if (err != cudaSuccess) return (int)err;
    gsmvi::GemmArgs q{};
    q.a = resid; q.b = xdata; q.c = v; q.c_in = w; q.epi_vec = inv_ps2;
    q.m = m; q.n = d; q.k = n; q.lda = n; q.ldb = d; q.ldc = d;
    return (int)gsmvi::launch_gemm<false, false, gsmvi::PRO_NONE,
                                   gsmvi::EPI_ACC_SUB_SCALE>(q, s);
}

}  // extern "C"
