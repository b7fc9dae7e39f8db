// K5: the dense GSM update on Hopper, for one fit or K replicas.
//
// Replaces gsmvi_tpu/ops/pallas/gsm_step.py `gsm_update_fused` (:76; body
// `_gsm_kernel` :44-72, pallas_call :91):
//   a = mu0 - x,  t = V S0,  vsv, mv, rho, eps0 = t - a, w,
//   dmu_b = (eps0 - a (w / (1 + rho + mv))) / (1 + rho),  Bm = a + dmu_b,
//   mu = mu0 + sum_b dmu_b / B,  S = S0 + sym((A^T A - Bm^T Bm) / B).
// The TPU kernel is one program with the whole working set in VMEM.  Here
// it is four launches on the current stream:
//   1. T = V S0 on the GEMM template (gemm.cuh);
//   2. the row scalars, one warp per row (vsv, mv, w -> w / den, 1 + rho);
//   3. the columns: one thread per column walks the B rows in order, forms
//      dmu_b and Bm, writes the stacked rows L = [A; -Bm] and R = [A; Bm],
//      and sums dmu_b for the mean in a fixed order (no atomics);
//   4. S = S0 + L^T R / B, one transposed-A GEMM over the 2B stacked rows
//      (the pattern of gsmvi_factor_apply) with the add in its epilogue.
// Symmetry: ds(i, j) and ds(j, i) accumulate the same products (A_ri A_rj,
// and -(Bm_ri Bm_rj) with the sign exact) in the same k order, so ds is
// symmetric bit for bit and the TPU kernel's 0.5 (ds + ds^T) would change
// nothing; S is exactly symmetric whenever S0 is.
//
// What bounds it on an H100: 2 B D^2 FLOPs for T and 4 B D^2 for the Gram
// (12.6 MFLOP at B=32, D=256: 0.19 us at 67 TFLOP/s in float32) against
// ~0.6 MB moved (x, v, S0 read, S written), 0.18 us at 3.35 TB/s: at the
// main path's shape the launches and the two thin GEMMs' few blocks bound
// it, not FLOPs or bytes.  At B=512 (the huge-batch route) the Gram's 2B =
// 1024-deep k loop dominates.  Plain f32 FFMA, no TF32 (Precision.HIGHEST
// on the TPU).  Design: every product reuses the one GEMM template; no
// shared-memory budget limits B or D (no small space), so B runs to 65536
// and D to 8192 (GSM_STEP_BATCH_RANGE / GSM_STEP_DIM_RANGE in
// ops/gsm_step.py: 2 B D < 2^31 element offsets), and a replica axis
// (blockIdx.z, or blockIdx.y for the row and column kernels) serves
// fit_batch.  Fusing the four launches is later work.
#include "gemm.cuh"

using namespace gsmvi;

namespace {

constexpr int ROW_WARPS = 8;
constexpr int COL_THREADS = 64;

// Row scalars, one warp per row of replica blockIdx.y:
// wden = w / (1 + rho + mv) and opr = 1 + rho.
__global__ void __launch_bounds__(ROW_WARPS * 32) gsm_row_scalars_kernel(
        const float* x, const float* v, const float* t, const float* mu0,
        float* wden, float* opr, int b, int d) {
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r >= b) return;   // the whole warp shares r
    const long long z = blockIdx.y;
    const size_t row = ((size_t)z * b + r) * d;
    const float* m = mu0 + z * d;
    float vsv = 0.f, mv = 0.f, w = 0.f;
    for (int col = lane; col < d; col += 32) {
        const float vv = v[row + col], tt = t[row + col];
        const float a = m[col] - x[row + col];
        vsv += vv * tt;
        mv += a * vv;
        w += vv * (tt - a);
    }
    for (int o = 16; o > 0; o >>= 1) {
        vsv += __shfl_xor_sync(0xffffffffu, vsv, o);
        mv += __shfl_xor_sync(0xffffffffu, mv, o);
        w += __shfl_xor_sync(0xffffffffu, w, o);
    }
    if (lane == 0) {
        const float rho = 0.5f * (sqrtf(1.f + 4.f * (vsv + mv * mv)) - 1.f);
        wden[z * b + r] = w / (1.f + rho + mv);
        opr[z * b + r] = 1.f + rho;
    }
}

// dmu_b, the stacked Gram rows and the new mean, one thread per column of
// replica blockIdx.y, the B rows summed in order.
__global__ void __launch_bounds__(COL_THREADS) gsm_columns_kernel(
        const float* x, const float* t, const float* mu0, const float* wden,
        const float* opr, float* l, float* r, float* mu_out, int b, int d) {
    const int col = blockIdx.x * COL_THREADS + threadIdx.x;
    if (col >= d) return;
    const long long z = blockIdx.y;
    const size_t rows = (size_t)b * d;
    x += z * rows;
    t += z * rows;
    l += 2 * z * rows;
    r += 2 * z * rows;
    wden += z * b;
    opr += z * b;
    const float m = mu0[z * d + col];
    float s = 0.f;
    for (int i = 0; i < b; ++i) {
        const size_t o = (size_t)i * d + col;
        const float a = m - x[o];
        const float dmu = ((t[o] - a) - a * wden[i]) / opr[i];
        const float bm = a + dmu;
        l[o] = a;
        r[o] = a;
        l[rows + o] = -bm;
        r[rows + o] = bm;
        s += dmu;
    }
    mu_out[z * d + col] = m + s / (float)b;
}

}  // namespace

extern "C" {

// (mu_out, s_out) = the dense GSM update of (x, v, mu0, s0) for `reps`
// replicas stored one after another: x, v, t (reps, B, D); mu0, mu_out
// (reps, D); s0, s_out (reps, D, D), s_out distinct from s0; scratch wden,
// opr (reps, B) and l, r (reps, 2B, D).
int gsmvi_gsm_update(const float* x, const float* v, const float* mu0, const float* s0,
                     float* t, float* wden, float* opr, float* l, float* r,
                     float* mu_out, float* s_out, int b, int d, int reps, void* stream) {
    if (b < 1 || d < 1 || reps < 1 || reps > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    GemmArgs p{};
    p.a = v; p.b = s0; p.c = t;
    p.m = b; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    p.batch = reps; p.sa = (long long)b * d; p.sb = (long long)d * d; p.sc = p.sa;
    cudaError_t err = launch_gemm<false, false, PRO_NONE, EPI_STORE>(p, st);
    if (err != cudaSuccess) return (int)err;
    gsm_row_scalars_kernel<<<dim3((b + ROW_WARPS - 1) / ROW_WARPS, reps), ROW_WARPS * 32, 0, st>>>(
        x, v, t, mu0, wden, opr, b, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    gsm_columns_kernel<<<dim3((d + COL_THREADS - 1) / COL_THREADS, reps), COL_THREADS, 0, st>>>(
        x, t, mu0, wden, opr, l, r, mu_out, b, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    GemmArgs q{};
    q.a = l; q.b = r; q.c = s_out; q.c_in = s0; q.div = (float)b;
    q.m = d; q.n = d; q.k = 2 * b; q.lda = d; q.ldb = d; q.ldc = d;
    q.batch = reps; q.sa = q.sb = 2LL * b * d; q.sc = (long long)d * d;
    return (int)launch_gemm<true, false, PRO_NONE, EPI_ADD_DIV>(q, st);
}

}  // extern "C"
