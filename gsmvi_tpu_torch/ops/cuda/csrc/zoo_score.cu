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
// latency bounds them.  Banana: before, one thread per element, grid-strided
// over at most 4096 blocks, each finding its row by a 64-bit division and
// reading its row's x0 and x1 again; now one pass with the row mapping in
// 32-bit shifts, a float4 of x per thread, x0 and x1 read once (below).
// Funnel: before, one warp per row (4 blocks on 4 SMs at
// B=32), each walking its row twice (the sum of rest^2, then the write):
// 2.4 us on the device.  Now a row is spread over S = thin_split(D) warps
// of one block, warp r over the columns [r k_per, (r+1) k_per) of the thin
// product's partition, floor(8 / S) rows a block (one row a block at
// D >= 225: 32 blocks at B=32).  Each warp reads its columns of x once,
// writes -x e^{-x0} from registers and sums its part of rest^2 (a lane's
// fmaf chain over its columns, then a butterfly in a fixed order); after a
// block barrier the row's first warp adds the S parts in warp order and
// writes g0.  No scratch and no atomics; a row's score depends on D alone.
#include "thin_gemm.cuh"

namespace {

constexpr int ZOO_THREADS = 256;      // 8 warps
constexpr int ZOO_WARPS = ZOO_THREADS / 32;

__global__ void __launch_bounds__(ZOO_THREADS) funnel_score_kernel(
        const float* x, const float* sd, float* v, int m, int d, int split, int k_per) {
    __shared__ float part[ZOO_WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rows = ZOO_WARPS / split;   // rows a block
    const int g = warp / split, rank = warp - g * split;
    const long long row = (long long)blockIdx.x * rows + g;
    const bool live = g < rows && row < m;
    const float* xr = x + row * d;
    // x0 and [sigma, D] are read first, so that no load waits behind the
    // block barrier.
    const float x0 = live ? xr[0] : 0.f, sigma = sd[0], dd = sd[1];
    const float e = expf(-x0);
    if (live) {
        float* vr = v + row * d;
        const int c1 = min(d, (rank + 1) * k_per);
        float s = 0.f;
        for (int c = rank * k_per + lane; c < c1; c += 32) {
            const float xc = xr[c];
            if (c == 0) continue;   // g0 is the row's first warp's, below
            s = fmaf(xc, xc, s);
            vr[c] = -xc * e;
        }
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) part[warp] = s;
    }
    __syncthreads();
    if (live && rank == 0 && lane == 0) {
        float rest2 = 0.f;
        for (int r = 0; r < split; ++r) rest2 += part[warp + r];
        // -x0/sigma^2 + (e/2) rest2 - (D-1)/2, each product rounded on its
        // own as in the plain version (no contraction into a fma).
        const float g0 = __fadd_rn(-x0 / (sigma * sigma), __fmul_rn(__fmul_rn(0.5f, e), rest2));
        v[row * d] = g0 - __fmul_rn(0.5f, dd - 1.f);
    }
}

// Banana: a block covers ZOO_THREADS >> shift rows, 2^shift threads a row;
// a row's threads walk its 4-column chunks (chunk q = lane, lane + 2^shift,
// ...), loaded and stored as float4 where VEC (D % 4 == 0, 16-byte aligned
// rows), else as scalars masked at the ragged edge.  The thread of chunk 0
// holds x0 and x1 among its own loads and writes g0 and g1; every other
// element is -x.  g0's and h's operations are rounded one by one, in the
// plain version's order.
template <bool VEC>
__global__ void __launch_bounds__(ZOO_THREADS) banana_score_kernel(
        const float* x, const float* cs, float* v, int m, int d, int shift) {
    const int row = blockIdx.x * (ZOO_THREADS >> shift) + (int)(threadIdx.x >> shift);
    if (row >= m) return;
    const int tpr = 1 << shift, nc = (d + 3) >> 2;
    const float* xr = x + (size_t)row * d;
    float* vr = v + (size_t)row * d;
    for (int q = threadIdx.x & (tpr - 1); q < nc; q += tpr) {
        const int c = 4 * q;
        float xv[4];
        if (VEC) {
            const float4 t = *reinterpret_cast<const float4*>(xr + c);
            xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) xv[u] = c + u < d ? xr[c + u] : 0.f;
        }
        float out[4] = {-xv[0], -xv[1], -xv[2], -xv[3]};
        if (q == 0) {
            // h = x1 - b (x0^2 - s^2), g0 = -x0/s^2 + 2 b x0 h, g1 = -h.
            const float curv = cs[0], s = cs[1], x0 = xv[0];
            const float s2 = __fmul_rn(s, s);
            const float h = __fsub_rn(xv[1], __fmul_rn(curv, __fsub_rn(__fmul_rn(x0, x0), s2)));
            out[0] = __fadd_rn(__fdiv_rn(-x0, s2), __fmul_rn(__fmul_rn(__fmul_rn(2.f, curv), x0), h));
            out[1] = -h;
        }
        if (VEC) {
            *reinterpret_cast<float4*>(vr + c) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (c + u < d) vr[c + u] = out[u];
        }
    }
}

}  // namespace

extern "C" {

// Funnel score of the (M, D) rows x into v; sd = [sigma, D] (1, 2).  A row
// over `split` warps of a block, (split, k_per) = thin_split(d).
int gsmvi_funnel_score(const float* x, const float* sd, float* v, int m, int d, int split,
                       int k_per, void* stream) {
    if (m < 1 || !split_ok(d, split, k_per)) return (int)cudaErrorInvalidValue;
    const int rows = ZOO_WARPS / split;
    funnel_score_kernel<<<(unsigned)((m + rows - 1) / rows), ZOO_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, sd, v, m, d, split, k_per);
    return (int)cudaGetLastError();
}

// Banana score of the (M, D) rows x into v; cs = [curvature, scale] (1, 2).
// 2^shift threads a row (shift <= 8), ceil(M / (ZOO_THREADS >> shift))
// blocks; vec: float4 loads and stores (D % 4 == 0, x and v 16-byte
// aligned).
int gsmvi_banana_score(const float* x, const float* cs, float* v, int m, int d, int shift,
                       int vec, void* stream) {
    if (m < 1 || d < 2 || shift < 0 || shift > 8 || (vec && d % 4 != 0))
        return (int)cudaErrorInvalidValue;
    const int rows = ZOO_THREADS >> shift;
    const unsigned blocks = (unsigned)(((long long)m + rows - 1) / rows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec)
        banana_score_kernel<true><<<blocks, ZOO_THREADS, 0, s>>>(x, cs, v, m, d, shift);
    else
        banana_score_kernel<false><<<blocks, ZOO_THREADS, 0, s>>>(x, cs, v, m, d, shift);
    return (int)cudaGetLastError();
}

}  // extern "C"
