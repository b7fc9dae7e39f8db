// In-kernel analytic scores of the funnel and banana zoo targets (K11a),
// the score launch of the whole-step paths (K2, K4, K6, K8-K10) on those
// targets.  The Student-t score, K11a's third, is a product and runs on the
// split-k thin product: zoo_student_t.cu.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py (score functions traced
// into the TPU's whole-step kernels):
//   gsmvi_funnel_score     `funnel_score_kernel` (:788)
//       g0 = -x0/sigma^2 + e^{-x0} sum(rest^2)/2 - (D-1)/2, g_rest = -rest e^{-x0}
//   gsmvi_banana_score     `banana_score_kernel` (:810)
//       h = x1 - b (x0^2 - s^2): g0 = -x0/s^2 + 2 b x0 h, g1 = -h, g_tail = -tail
// written from that math, with the TPU kernels' order of operations so that
// the plain torch twins (ops/fused_step.py `*_score_reference`) agree to a
// few ulp.  The parameters stay in device memory ((1, 2) rows [sigma, D],
// [b, s]): a launch never waits for the host.  e^{-x0} overflows to inf for
// x0 < -88 as the reference's does; nothing is clamped.
//
// What bounds it on an H100: funnel and banana read x and write v once,
// O(B D) bytes (256 KiB at B=32, D=1024: 0.08 us at 3.35 TB/s), so launch
// latency bounds them; design: funnel one warp per row (the sum of rest^2 is
// a shuffle reduction in a fixed order, then the row is written), banana one
// thread per element (it reads its row's x0 and x1).
#include <cuda_runtime.h>

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

}  // extern "C"
