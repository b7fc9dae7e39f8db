// In-kernel analytic scores of the non-Gaussian zoo targets (K11a), the
// score launch of the whole-step paths (K2, K4, K6, K8-K10) on funnel,
// banana and Student-t targets.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py (score functions traced
// into the TPU's whole-step kernels):
//   gsmvi_funnel_score     `funnel_score_kernel` (:788)
//       g0 = -x0/sigma^2 + e^{-x0} sum(rest^2)/2 - (D-1)/2, g_rest = -rest e^{-x0}
//   gsmvi_banana_score     `banana_score_kernel` (:810)
//       h = x1 - b (x0^2 - s^2): g0 = -x0/s^2 + 2 b x0 h, g1 = -h, g_tail = -tail
//   gsmvi_student_t_score  `student_t_score_kernel` (:831)
//       P = (x - loc) Prec, maha = rowsum(P o (x - loc)), -(df+D)/(df+maha) P
// written from that math, with the TPU kernels' order of operations so that
// the plain torch twins (ops/fused_step.py `*_score_reference`) agree to a
// few ulp.  The parameters stay in device memory ((1, 2) rows [sigma, D],
// [b, s], [df, D]): a launch never waits for the host.  e^{-x0} overflows to
// inf for x0 < -88 as the reference's does; nothing is clamped.
//
// What bounds it on an H100: funnel and banana read x and write v once,
// O(B D) bytes (256 KiB at B=32, D=1024: 0.08 us at 3.35 TB/s), so launch
// latency bounds them; design: funnel one warp per row (the sum of rest^2 is
// a shuffle reduction in a fixed order, then the row is written), banana one
// thread per element (it reads its row's x0 and x1).  Student-t is one
// (B, D) x (D, D) product, 2 B D^2 FLOP, on the GEMM template (gemm.cuh)
// with x - loc formed in the operand prologue, then a warp-per-row kernel
// that forms maha and scales the row in place: two launches; fusing the
// scale into the GEMM's epilogue needs a row reduction across tiles and is
// later work.
#include "gemm.cuh"

namespace {

constexpr int ZOO_THREADS = 256;      // 8 warps: 8 rows per block

__global__ void __launch_bounds__(ZOO_THREADS) funnel_score_kernel(
        const float* x, const float* sd, float* v, int m, int d) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (ZOO_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= m) return;
    const float* xr = x + (size_t)row * d;
    float* vr = v + (size_t)row * d;
    float rest2 = 0.f;
    for (int col = 1 + lane; col < d; col += 32) rest2 += xr[col] * xr[col];
    for (int o = 16; o > 0; o >>= 1) rest2 += __shfl_xor_sync(0xffffffffu, rest2, o);
    const float sigma = sd[0], dd = sd[1];
    const float x0 = xr[0];
    const float e = expf(-x0);
    for (int col = 1 + lane; col < d; col += 32) vr[col] = -xr[col] * e;
    if (lane == 0) vr[0] = -x0 / (sigma * sigma) + 0.5f * e * rest2 - 0.5f * (dd - 1.f);
}

__global__ void __launch_bounds__(ZOO_THREADS) banana_score_kernel(
        const float* x, const float* cs, float* v, int m, int d) {
    const long long n = (long long)m * d;
    const float curv = cs[0], s = cs[1];
    for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < n;
         q += (long long)gridDim.x * blockDim.x) {
        const long long row = q / d;
        const int col = (int)(q - row * d);
        const float* xr = x + row * d;
        if (col >= 2) {
            v[q] = -xr[col];
            continue;
        }
        const float x0 = xr[0];
        const float h = xr[1] - curv * (x0 * x0 - s * s);
        v[q] = col == 0 ? -x0 / (s * s) + 2.f * curv * x0 * h : -h;
    }
}

// v = -(df + D) / (df + maha) * v in place, maha = rowsum(v o (x - loc)),
// with v = (x - loc) Prec on entry; a warp per row.
__global__ void __launch_bounds__(ZOO_THREADS) student_t_scale_kernel(
        const float* x, const float* loc, const float* dfd, float* v, int m, int d) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (ZOO_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= m) return;
    const float* xr = x + (size_t)row * d;
    float* vr = v + (size_t)row * d;
    float maha = 0.f;
    for (int col = lane; col < d; col += 32) maha += vr[col] * (xr[col] - loc[col]);
    for (int o = 16; o > 0; o >>= 1) maha += __shfl_xor_sync(0xffffffffu, maha, o);
    const float df = dfd[0], dd = dfd[1];
    const float scale = -(df + dd) / (df + maha);
    for (int col = lane; col < d; col += 32) vr[col] = scale * vr[col];
}

inline unsigned row_blocks(int m) { return (unsigned)((m + ZOO_THREADS / 32 - 1) / (ZOO_THREADS / 32)); }

}  // namespace

extern "C" {

// Funnel score of the (M, D) rows x into v; sd = [sigma, D] (1, 2).
int gsmvi_funnel_score(const float* x, const float* sd, float* v, int m, int d, void* stream) {
    if (m < 1 || d < 1) return (int)cudaErrorInvalidValue;
    funnel_score_kernel<<<row_blocks(m), ZOO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, sd, v, m, d);
    return (int)cudaGetLastError();
}

// Banana score of the (M, D) rows x into v; cs = [curvature, scale] (1, 2).
int gsmvi_banana_score(const float* x, const float* cs, float* v, int m, int d, void* stream) {
    if (m < 1 || d < 2) return (int)cudaErrorInvalidValue;
    long long blocks = ((long long)m * d + ZOO_THREADS - 1) / ZOO_THREADS;
    if (blocks > 4096) blocks = 4096;
    banana_score_kernel<<<(unsigned)blocks, ZOO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, cs, v, m, d);
    return (int)cudaGetLastError();
}

// Student-t score of the (M, D) rows x into v: loc (D,), prec (D, D)
// symmetric, dfd = [df, D] (1, 2).  Two launches: the GEMM, then the row
// scale.
int gsmvi_student_t_score(const float* x, const float* loc, const float* prec,
                          const float* dfd, float* v, int m, int d, void* stream) {
    if (m < 1 || d < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gsmvi::GemmArgs p{};
    p.a = x; p.b = prec; p.c = v; p.pro_vec = loc;
    p.m = m; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    const cudaError_t err =
        gsmvi::launch_gemm<false, false, gsmvi::PRO_A_MINUS_VEC, gsmvi::EPI_STORE>(p, s);
    if (err != cudaSuccess) return (int)err;
    student_t_scale_kernel<<<row_blocks(m), ZOO_THREADS, 0, s>>>(x, loc, dfd, v, m, d);
    return (int)cudaGetLastError();
}

}  // extern "C"
