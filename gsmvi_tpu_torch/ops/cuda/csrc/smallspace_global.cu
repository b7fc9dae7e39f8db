// Large-batch eps-NS small space: the GSM update for 128 < B <= 512, with
// the (B, B) matrices in global memory.
//
// Replaces, for the batches whose matrices no cluster's shared memory holds
// (eps_smallspace_cluster.cu: twelve (B, B) in every block, B <= 64;
// eps_smallspace_panel.cu: row panels over a cluster, B 65-128), the TPU
// kernel body
//   gsmvi_eps_smallspace_large  gsmvi_tpu/ops/pallas/fused_step.py
//       `_eps_smallspace_ns` (:231) from the row work at :287 to the stacked
//       rows at :345, both residual gates and the mean half of the select;
//       the body of K1 `gsm_eps_update_fused` (:461) and, through the same
//       launches, of K2 (:685), K4 (:586) and K6 (batch_fused.py:54).
// It computes what its shared-memory twins compute, step for step: the same
// Newton-Schulz / Newton-Hotelling chains with the same row-sum norm seeds,
// every symmetrisation, the same residuals.  Only the storage and the
// schedule differ, so sums run in other orders.  (It takes any B >= 1; the
// wrappers send it B > 128 only.)
//
// What bounds it on an H100: the chains are ~100 dependent (n, n) products
// at the long profile, 2 n^3 FLOP each: 27 GFLOP per update at B=512 (0.40
// ms at 67 TFLOP/s).  At B=512 a product is 256 tiles of 2 M FMA, and the
// FFMA rate of the tiled template bounds it; at B=128 a product was 16
// tiles, bound by launch latency and the dependency chain (the reason for
// eps_smallspace_panel.cu).
// Design: every product is a launch of the f32 GEMM template (gemm.cuh, a
// replica axis on blockIdx.z), every norm bound, residual and flag a small
// one-block kernel writing into device memory, every elementwise step a grid
// kernel; the host enqueues the whole chain on the stream and never waits.
// Ten (B, B) matrices are 10 MiB at B=512: resident in the 50 MB L2.  A
// persistent cooperative kernel or a 16-block cluster is later work.
#include "gemm.cuh"
#include "smallspace.cuh"

using gsmvi::GemmArgs;
using gsmvi::launch_gemm;

namespace {

constexpr int EW_THREADS = 256;
constexpr int RED_THREADS = 1024;
constexpr int GL_EPS_MAXB = 512;
constexpr int GL_EPS_NMAT = 10;
constexpr int GL_NSCAL = 16;         // norm, residual and flag slots

#define GL_CHECK(expr)                                   \
    do {                                                 \
        const cudaError_t err_ = (expr);                 \
        if (err_ != cudaSuccess) return err_;            \
    } while (0)

// Replica z's slice of a tensor whose replicas lie `stride` elements apart.
template <class T>
__device__ __forceinline__ T* rep(T* p, long long stride) {
    return p == nullptr ? p : p + (long long)blockIdx.z * stride;
}

// out = (i == j ? diag : 0) + bx X[i, j] (+ by Y[i, j], or Y[j, i] when
// ty) on (n, n) matrices; X and Y may be null (then 0); out may alias X.
__global__ void __launch_bounds__(EW_THREADS) gl_combine_kernel(
        float* out, const float* x, const float* y, int n, float diag, float bx,
        float by, int ty, long long s) {
    out = rep(out, s);
    x = rep(x, s);
    y = rep(y, s);
    const int nn = n * n;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < nn;
         idx += gridDim.x * blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        float r = (i == j ? diag : 0.f);
        if (x != nullptr) r = r + bx * x[idx];
        if (y != nullptr) r = r + by * y[ty ? j * n + i : idx];
        out[idx] = r;
    }
}

// M = 0.5 (M + M^T) in place: the thread of (i, j), i < j, writes both.
__global__ void __launch_bounds__(EW_THREADS) gl_symmetrize_kernel(
        float* m, int n, long long s) {
    m = rep(m, s);
    const int nn = n * n;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < nn;
         idx += gridDim.x * blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        if (i < j) {
            const float v = 0.5f * (m[i * n + j] + m[j * n + i]);
            m[i * n + j] = v;
            m[j * n + i] = v;
        }
    }
}

// `_spd_norm_ub`: max over rows of the row sum of |A| (each row summed in
// column order), + 1e-30, into *out; one block per replica (blockIdx.x),
// whose matrix and slot lie s elements after the previous replica's.
__global__ void __launch_bounds__(RED_THREADS) gl_norm_ub_kernel(
        const float* a, int n, float* out, long long s) {
    __shared__ float red[32];
    a += (long long)blockIdx.x * s;
    out += (long long)blockIdx.x * s;
    float mx = 0.f;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
        float rs = 0.f;
        for (int j = 0; j < n; ++j) rs += fabsf(a[(size_t)r * n + j]);
        mx = nan_max(mx, rs);
    }
    const float m = block_max(mx, red);
    if (threadIdx.x == 0) *out = m + 1e-30f;
}

// The norm-seeded ends of the chains, from the bound `nrm` in device memory:
//   mode 0 (NS start):     x = a / nrm, y = I
//   mode 1 (NS end):       x = a * sqrt(nrm), y = b / sqrt(nrm) (either null)
//   mode 2 (inverse start): x = I * (1 / nrm)
__global__ void __launch_bounds__(EW_THREADS) gl_norm_scale_kernel(
        int mode, const float* a, const float* b, float* x, float* y,
        const float* nrm, int n, long long s) {
    a = rep(a, s);
    b = rep(b, s);
    x = rep(x, s);
    y = rep(y, s);
    const float nv = nrm[(long long)blockIdx.z * s];
    const float sq = sqrtf(nv), inv = 1.f / nv;
    const int nn = n * n;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < nn;
         idx += gridDim.x * blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        if (mode == 0) {
            x[idx] = a[idx] / nv;
            y[idx] = (i == j) ? 1.f : 0.f;
        } else if (mode == 1) {
            if (x != nullptr) x[idx] = a[idx] * sq;
            if (y != nullptr) y[idx] = b[idx] / sq;
        } else {
            x[idx] = (i == j) ? inv : 0.f;
        }
    }
}

// sum((W - A)^2) / (sum(A^2) + 1e-30) into *out (`rel_residual`), one block
// per replica.
__global__ void __launch_bounds__(RED_THREADS) gl_residual_kernel(
        const float* w, const float* a, int n, float* out, long long s) {
    __shared__ float red[32];
    w += (long long)blockIdx.x * s;
    if (a != nullptr) a += (long long)blockIdx.x * s;
    out += (long long)blockIdx.x * s;
    const int nn = n * n;
    float num = 0.f, den = 0.f;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        const float ref = a[idx];
        const float r = w[idx] - ref;
        num += r * r;
        den += ref * ref;
    }
    num = block_sum(num, red);
    den = block_sum(den, red);
    if (threadIdx.x == 0) *out = num / (den + 1e-30f);
}

// ---------------------------------------------------------------------------
// Chains on (n, n) matrices in global memory (the host side of the schedule).
// ---------------------------------------------------------------------------

struct Chain {
    cudaStream_t stream;
    int n, reps;
    long long s;          // elements between replicas' workspaces

    dim3 ew_grid() const {
        int blocks = (n * n + EW_THREADS - 1) / EW_THREADS;
        if (blocks > 1024) blocks = 1024;
        return dim3(blocks, 1, reps);
    }

    cudaError_t combine(float* out, const float* x, const float* y, float diag,
                        float bx, float by, int ty = 0) const {
        gl_combine_kernel<<<ew_grid(), EW_THREADS, 0, stream>>>(
            out, x, y, n, diag, bx, by, ty, s);
        return cudaGetLastError();
    }

    cudaError_t symmetrize(float* m) const {
        gl_symmetrize_kernel<<<ew_grid(), EW_THREADS, 0, stream>>>(m, n, s);
        return cudaGetLastError();
    }

    cudaError_t norm_ub(const float* a, float* out) const {
        gl_norm_ub_kernel<<<reps, RED_THREADS, 0, stream>>>(a, n, out, s);
        return cudaGetLastError();
    }

    cudaError_t norm_scale(int mode, const float* a, const float* b, float* x, float* y,
                           const float* nrm) const {
        gl_norm_scale_kernel<<<ew_grid(), EW_THREADS, 0, stream>>>(
            mode, a, b, x, y, nrm, n, s);
        return cudaGetLastError();
    }

    cudaError_t residual(const float* w, const float* a, float* out) const {
        gl_residual_kernel<<<reps, RED_THREADS, 0, stream>>>(w, a, n, out, s);
        return cudaGetLastError();
    }

    // C = epi(A B) for (n, n) matrices: EPI_STORE, or EPI_AFFINE_EYE with
    // (alpha, beta), or EPI_SCALE with alpha.
    template <int EPI>
    cudaError_t mm(const float* a, const float* b, float* c, float alpha = 1.f,
                   float beta = 0.f) const {
        GemmArgs p{};
        p.a = a; p.b = b; p.c = c;
        p.m = n; p.n = n; p.k = n; p.lda = n; p.ldb = n; p.ldc = n;
        p.batch = reps; p.sa = p.sb = p.sc = s;
        p.alpha = alpha; p.beta = beta;
        return launch_gemm<false, false, EPI>(p, stream);
    }

    // Coupled Newton-Schulz on SPD A (`_ns_sqrt_both`): yout = sqrt(A),
    // zout = A^{-1/2} (either null); w[0..4] scratch, nrm one scalar slot.
    cudaError_t ns_sqrt_both(const float* a, float* yout, float* zout, int iters,
                             float* const* w, float* nrm) const {
        GL_CHECK(norm_ub(a, nrm));
        float* y = w[0];
        float* z = w[1];
        float* t = w[2];
        float* y2 = w[3];
        float* z2 = w[4];
        GL_CHECK(norm_scale(0, a, nullptr, y, z, nrm));
        for (int it = 0; it < iters; ++it) {
            GL_CHECK(mm<gsmvi::EPI_AFFINE_EYE>(z, y, t, 0.5f, 3.f));
            GL_CHECK(mm<gsmvi::EPI_STORE>(y, t, y2));
            GL_CHECK(mm<gsmvi::EPI_STORE>(t, z, z2));
            float* tmp = y; y = y2; y2 = tmp;
            tmp = z; z = z2; z2 = tmp;
        }
        return norm_scale(1, y, z, yout, zout, nrm);
    }

    // Newton-Hotelling inverse of SPD A (`_newton_inv`) into out; w[0..2].
    cudaError_t newton_inv(const float* a, float* out, int iters, float* const* w,
                           float* nrm) const {
        GL_CHECK(norm_ub(a, nrm));
        float* x = w[0];
        float* t = w[1];
        float* x2 = w[2];
        GL_CHECK(norm_scale(2, nullptr, nullptr, x, nullptr, nrm));
        for (int it = 0; it < iters; ++it) {
            GL_CHECK(mm<gsmvi::EPI_AFFINE_EYE>(a, x, t, 1.f, 2.f));
            GL_CHECK(mm<gsmvi::EPI_STORE>(x, t, x2));
            float* tmp = x; x = x2; x2 = tmp;
        }
        return combine(out, x, nullptr, 0.f, 1.f, 0.f);
    }

    // sum((S S - A)^2) / (sum(A^2) + 1e-30) into *out, W scratch.
    cudaError_t rel_residual(const float* sm, const float* a, float* w, float* out) const {
        GL_CHECK(mm<gsmvi::EPI_STORE>(sm, sm, w));
        return residual(w, a, out);
    }
};

// A product with rows: C (m_out, n_out) = epi(A' B'), A' = A or A^T
// (TA), B' = B or B^T (TB), over replicas `reps` with strides (sa, sb, sc).
template <bool TA, bool TB, int EPI>
cudaError_t rows_mm(cudaStream_t stream, int reps, const float* a, long long sa, int lda,
                    const float* b, long long sb, int ldb, float* c, long long sc, int ldc,
                    int m, int n, int k, float alpha = 1.f, const float* c_in = nullptr) {
    GemmArgs p{};
    p.a = a; p.b = b; p.c = c; p.c_in = c_in;
    p.m = m; p.n = n; p.k = k; p.lda = lda; p.ldb = ldb; p.ldc = ldc;
    p.batch = reps; p.sa = sa; p.sb = sb; p.sc = sc;
    p.alpha = alpha;
    return launch_gemm<TA, TB, EPI>(p, stream);
}

// ---------------------------------------------------------------------------
// eps-NS small space (K1's body), replicas on blockIdx.z.
// ---------------------------------------------------------------------------

// Row scalars (fused_step.py:285-296), a warp per row: 1/(1+rho), w/den,
// gamma into (n,) arrays.
__global__ void __launch_bounds__(EW_THREADS) gl_eps_row_scalars_kernel(
        const float* v, const float* t, const float* ef, int n, int d, float* s_inv1r,
        float* s_wden, float* s_gamma, long long s_rows, long long s_scal) {
    const long long zr = (long long)blockIdx.z * s_rows;
    v += zr; t += zr; ef += zr;
    const long long zs = (long long)blockIdx.z * s_scal;
    s_inv1r += zs; s_wden += zs; s_gamma += zs;
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (r >= n) return;
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

// Downdate rows c = -e gamma + vf / (1 + rho).
__global__ void __launch_bounds__(EW_THREADS) gl_eps_c_kernel(
        const float* e, const float* vf, float* c, const float* s_gamma,
        const float* s_inv1r, int n, int d, long long e_stride, long long s_rows,
        long long s_scal) {
    e += (long long)blockIdx.z * e_stride;
    vf += (long long)blockIdx.z * s_rows;
    c += (long long)blockIdx.z * s_rows;
    s_gamma += (long long)blockIdx.z * s_scal;
    s_inv1r += (long long)blockIdx.z * s_scal;
    const long long nd = (long long)n * d;
    for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < nd;
         q += (long long)gridDim.x * blockDim.x) {
        const int i = (int)(q / d);
        c[q] = -e[q] * s_gamma[i] + vf[q] * s_inv1r[i];
    }
}

// Stacked rows around the GEMMs: su[0:n] = ef / sqrt(B) (u1row) and, with
// su[n:2n] holding Q ef, su[n + i] = (-gamma ef + t/(1+rho) + Q ef) / sqrt(B)
// (fw1xi^T, fused_step.py:341-342).
__global__ void __launch_bounds__(EW_THREADS) gl_eps_su_kernel(
        const float* ef, const float* t, float* su, const float* s_gamma,
        const float* s_inv1r, int n, int d, float zc, long long s_rows, long long s_scal) {
    ef += (long long)blockIdx.z * s_rows;
    t += (long long)blockIdx.z * s_rows;
    su += 2 * (long long)blockIdx.z * s_rows;
    s_gamma += (long long)blockIdx.z * s_scal;
    s_inv1r += (long long)blockIdx.z * s_scal;
    const long long nd = (long long)n * d;
    for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < nd;
         q += (long long)gridDim.x * blockDim.x) {
        const int i = (int)(q / d);
        su[q] = ef[q] * zc;
        const float acc = su[nd + q];
        su[nd + q] = (-s_gamma[i] * ef[q] + s_inv1r[i] * t[q] + acc) * zc;
    }
}

// good = both residuals under tol; nacc += good (one thread per replica).
__global__ void gl_eps_good_kernel(const float* scal, int* good, int* nacc, float tol,
                                   long long s_scal, int reps, int res1_slot, int res2_slot) {
    const int z = blockIdx.x * blockDim.x + threadIdx.x;
    if (z >= reps) return;
    const float* sc = scal + (long long)z * s_scal;
    const bool g = (sc[res1_slot] < tol) && (sc[res2_slot] < tol);
    good[z] = g ? 1 : 0;
    if (nacc != nullptr) nacc[z] += g ? 1 : 0;
}

// The mean with its select (`eps_mean_select` over a grid of columns).
__global__ void __launch_bounds__(EW_THREADS) gl_eps_mean_kernel(
        const float* t, const float* ef, const float* s_wden, const float* s_inv1r,
        const float* mean_in, float* mean_out, const int* good, int n, int d,
        long long s_rows, long long s_scal) {
    const int z = blockIdx.z;
    t += (long long)z * s_rows;
    ef += (long long)z * s_rows;
    s_wden += (long long)z * s_scal;
    s_inv1r += (long long)z * s_scal;
    mean_in += (long long)z * d;
    mean_out += (long long)z * d;
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= d) return;
    float s = 0.f;
    for (int b = 0; b < n; ++b) {
        const size_t o = (size_t)b * d + col;
        const float e = ef[o];
        s += ((t[o] + e) + e * s_wden[b]) * s_inv1r[b];
    }
    const float m = mean_in[col];
    mean_out[col] = good[z] != 0 ? m + s / (float)n : m;
}

inline dim3 rows_grid(long long nd, int reps) {
    long long blocks = (nd + EW_THREADS - 1) / EW_THREADS;
    if (blocks > 2048) blocks = 2048;
    return dim3((unsigned)blocks, 1, reps);
}

// Scalar slots of a replica's workspace.
constexpr int SL_NRM = 0, SL_RES1 = 1, SL_RES2 = 2;

}  // namespace

extern "C" {

// Workspace floats per replica of gsmvi_eps_smallspace_large at batch b.
long long gsmvi_eps_large_ws(int b) {
    return (long long)GL_EPS_NMAT * b * b + 3LL * b + GL_NSCAL;
}

// K1's small space for 128 < B <= 512 (any B >= 1 works): the arguments of
// gsmvi_eps_smallspace_cluster but the cluster's shape, plus `ws`, gsmvi_eps_large_ws(b) floats per replica.
int gsmvi_eps_smallspace_large(const float* e, const float* v, const float* vf, const float* t,
                               const float* ef, const float* mean_in, float* mean_out,
                               int* good, int* nacc, float* su, float* sw, float* c,
                               float* xim, float* ws, int b, int d, int it0, int it1, int it2,
                               int it3, int it4, float tol, int reps, long long e_stride,
                               void* stream) {
    if (b < 1 || b > GL_EPS_MAXB || d < 1 || reps < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n = b;
    const long long nn = (long long)n * n, nd = (long long)n * d;
    const long long s_ws = gsmvi_eps_large_ws(b);
    float* GU = ws;              // gu, later cuiec
    float* S1 = GU + nn;         // s1, later s2
    float* CU = S1 + nn;
    float* CUI = CU + nn;        // cui, later cv
    float* W0 = CUI + nn;        // chain input / Grams / Q
    float* w[5] = {W0 + nn, W0 + 2 * nn, W0 + 3 * nn, W0 + 4 * nn, W0 + 5 * nn};
    float* s_inv1r = ws + GL_EPS_NMAT * nn;
    float* s_wden = s_inv1r + n;
    float* s_gamma = s_wden + n;
    float* scal = s_gamma + n;
    const Chain ch{st, n, reps, s_ws};
    const float zc = 1.f / sqrtf((float)n);
    const float scale2 = 1.f / (float)n;

    gl_eps_row_scalars_kernel<<<dim3((n + 7) / 8, 1, reps), EW_THREADS, 0, st>>>(
        v, t, ef, n, d, s_inv1r, s_wden, s_gamma, nd, s_ws);
    GL_CHECK(cudaGetLastError());
    gl_eps_c_kernel<<<rows_grid(nd, reps), EW_THREADS, 0, st>>>(
        e, vf, c, s_gamma, s_inv1r, n, d, e_stride, nd, s_ws);
    GL_CHECK(cudaGetLastError());

    // Phase 1 on Gu = e e^T / B.
    GL_CHECK((rows_mm<false, true, gsmvi::EPI_SCALE>(st, reps, e, e_stride, d, e, e_stride, d,
                                                     GU, s_ws, n, n, n, d, scale2)));
    GL_CHECK(ch.symmetrize(GU));
    GL_CHECK(ch.combine(W0, GU, nullptr, 1.f, 1.f, 0.f));
    GL_CHECK(ch.ns_sqrt_both(W0, S1, nullptr, it0, w, scal + SL_NRM));
    GL_CHECK(ch.symmetrize(S1));
    GL_CHECK(ch.rel_residual(S1, W0, w[0], scal + SL_RES1));
    GL_CHECK(ch.combine(W0, S1, nullptr, 1.f, 1.f, 0.f));
    GL_CHECK(ch.newton_inv(W0, CU, it1, w, scal + SL_NRM));
    GL_CHECK(ch.combine(W0, S1, GU, 1.f, 1.f, 1.f));
    GL_CHECK(ch.newton_inv(W0, CUI, it2, w, scal + SL_NRM));

    // Xi~^T = (c - cuiec^T e) / sqrt(B), cuiec = cui (e c^T / B).
    GL_CHECK((rows_mm<false, true, gsmvi::EPI_SCALE>(st, reps, e, e_stride, d, c, nd, d,
                                                     W0, s_ws, n, n, n, d, scale2)));
    float* CUIEC = GU;
    GL_CHECK(ch.mm<gsmvi::EPI_STORE>(CUI, W0, CUIEC));
    GL_CHECK((rows_mm<true, false, gsmvi::EPI_SUB_SCALE>(st, reps, CUIEC, s_ws, n, e, e_stride,
                                                         d, xim, nd, d, n, d, n, zc, c)));

    // Phase 2 on I - Gv, Gv = Xi~^T Xi~.
    GL_CHECK((rows_mm<false, true, gsmvi::EPI_STORE>(st, reps, xim, nd, d, xim, nd, d, W0,
                                                     s_ws, n, n, n, d)));
    GL_CHECK(ch.symmetrize(W0));
    GL_CHECK(ch.combine(W0, W0, nullptr, 1.f, -1.f, 0.f));
    float* S2 = S1;
    GL_CHECK(ch.ns_sqrt_both(W0, S2, nullptr, it3, w, scal + SL_NRM));
    GL_CHECK(ch.symmetrize(S2));
    GL_CHECK(ch.rel_residual(S2, W0, w[0], scal + SL_RES2));
    GL_CHECK(ch.combine(W0, S2, nullptr, 1.f, 1.f, 0.f));
    float* CV = CUI;
    GL_CHECK(ch.newton_inv(W0, CV, it4, w, scal + SL_NRM));
    GL_CHECK(ch.combine(CV, CV, nullptr, 0.f, -1.f, 0.f));
    gl_eps_good_kernel<<<(reps + 127) / 128, 128, 0, st>>>(scal, good, nacc, tol, s_ws, reps,
                                                           SL_RES1, SL_RES2);
    GL_CHECK(cudaGetLastError());

    // Stacked rows of F' = F + stack_u^T stack_w: w1row = cu e / sqrt(B);
    // Q = Xi~^T w1row^T - cuiec^T; su = [ef; fw1xi^T] / sqrt(B) with
    // fw1xi^T from Q ef; w2row = cv Xi~^T.
    GL_CHECK((rows_mm<false, false, gsmvi::EPI_SCALE>(st, reps, CU, s_ws, n, e, e_stride, d,
                                                      sw, 2 * nd, d, n, d, n, zc)));
    GL_CHECK((rows_mm<false, true, gsmvi::EPI_STORE>(st, reps, xim, nd, d, sw, 2 * nd, d, W0,
                                                     s_ws, n, n, n, d)));
    GL_CHECK(ch.combine(W0, W0, CUIEC, 0.f, 1.f, -1.f, 1));
    GL_CHECK((rows_mm<false, false, gsmvi::EPI_STORE>(st, reps, W0, s_ws, n, ef, nd, d,
                                                      su + nd, 2 * nd, d, n, d, n)));
    gl_eps_su_kernel<<<rows_grid(nd, reps), EW_THREADS, 0, st>>>(ef, t, su, s_gamma, s_inv1r,
                                                                 n, d, zc, nd, s_ws);
    GL_CHECK(cudaGetLastError());
    GL_CHECK((rows_mm<false, false, gsmvi::EPI_STORE>(st, reps, CV, s_ws, n, xim, nd, d,
                                                      sw + nd, 2 * nd, d, n, d, n)));

    // Mean with its select.
    gl_eps_mean_kernel<<<dim3((d + EW_THREADS - 1) / EW_THREADS, 1, reps), EW_THREADS, 0, st>>>(
        t, ef, s_wden, s_inv1r, mean_in, mean_out, good, n, d, nd, s_ws);
    return (int)cudaGetLastError();
}

}  // extern "C"
