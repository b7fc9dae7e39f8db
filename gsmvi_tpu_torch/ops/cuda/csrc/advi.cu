// The whole-step ADVI kernels K9 (analytic gradient) and K10 (STL gradient
// with a Newton-tracked inverse), launched per sub-step by
// gsmvi_tpu_torch/ops/advi_fused.py.
//
// Replaces gsmvi_tpu/ops/pallas/advi_fused.py:
//   K9  `make_fused_advi_multistep` (:121, the body at :151-187):
//       gsmvi_rows (x = loc + e L^T, gemm.cu), the score (K3),
//       gsmvi_advi_l_adam (S^T E with dL and Adam on L, mL, vL in the GEMM
//       epilogue) and gsmvi_advi_loc_adam (dloc and Adam on loc).
//   K10 `make_fused_advi_stl_multistep` (:249, the body at :295-351):
//       gsmvi_advi_residual (R = I - L A with per-tile row sums of |R|),
//       gsmvi_advi_residual_finalize (the first-residual gate :300-306),
//       gsmvi_advi_sweep (A' = A + A R into a second buffer), x and the
//       score, P = E A' (gsmvi_rows), gsmvi_advi_stl_cols (G = S + P, dloc),
//       gsmvi_advi_grad_l (dL = tril(-G^T E)), gsmvi_advi_stl_decide (the
//       nonfinite gate :322-331, consume, stop) and gsmvi_advi_stl_apply
//       (Adam on loc, L and the moments and A <- A', all only if consumed).
//
// What bounds it on an H100: at D=256, B=32 a K9 sub-step is three O(B D^2)
// products (2 M FMA each) and O(D^2) elementwise Adam, so it is bound by
// launch latency and L2 traffic of the (D, D) state, not by FLOPs; K10 adds
// 2 sweeps x 2 (D, D, D) products (17 M FMA each), which dominate its device
// time.  Design: every product is a launch of the f32 GEMM template
// (gemm.cuh), the state stays in device memory and L2 across launches, and
// K9 applies Adam in the S^T E epilogue, where each element of L and its
// moments is read and written by the one thread that owns it.  K10 cannot:
// whether ANY Adam applies depends on the finiteness of the WHOLE gradient,
// so the gradient goes to scratch, a one-thread decide writes `consume`, and
// an elementwise kernel applies.  Reductions are per column or per tile row
// in a fixed order and the flags are plain stores of one value: no float
// atomics, so the gates reproduce from run to run.  A halted block (the
// report's `stiff` word set) makes every later K10 launch a no-op.
#include "gemm.cuh"

using namespace gsmvi;

namespace {

constexpr int COL_THREADS = 256;
constexpr int FIN_THREADS = 1024;
constexpr int APPLY_THREADS = 256;

// K10 report (float32), the layout of ops/advi_fused.py's REP_* indices.
constexpr int REP_NDONE = 0, REP_STIFF = 1, REP_CONSUME = 2, REP_BAD = 3, REP_NONFINITE = 4,
              REP_RNORM = 5;

// K9: g_loc[j] = -sum_b s[b, j] (rows in order), Adam on loc, mloc, vloc.
__global__ void __launch_bounds__(COL_THREADS) advi_loc_adam_kernel(
        const float* s, float* loc, float* mloc, float* vloc, int b, int d, AdamArgs adam) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= d) return;
    float acc = 0.f;
    for (int r = 0; r < b; ++r) acc += s[(size_t)r * d + j];
    float p = loc[j], m = mloc[j], v = vloc[j];
    adam_apply(p, m, v, -acc, adam);
    loc[j] = p;
    mloc[j] = m;
    vloc[j] = v;
}

// K10 gate: r_norm = max over rows of the row sum of |R| (the tile partials
// summed in order); bad = r_norm nonfinite or above gate_first.  Also clears
// the sub-step's nonfinite-gradient flag.
__global__ void __launch_bounds__(FIN_THREADS) advi_residual_finalize_kernel(
        const float* partial, int ntx, float* rep, int d, float gate_first) {
    __shared__ float smax[FIN_THREADS / 32];
    __shared__ int snf[FIN_THREADS / 32];
    if (rep[REP_STIFF] != 0.f) return;
    float mx = 0.f;
    int nf = 0;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
        float rs = 0.f;
        for (int t = 0; t < ntx; ++t) rs += partial[(size_t)i * ntx + t];
        if (isfinite(rs)) mx = fmaxf(mx, rs);
        else nf = 1;
    }
    for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        nf |= __shfl_xor_sync(0xffffffffu, nf, o);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        smax[warp] = mx;
        snf[warp] = nf;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < (int)(blockDim.x / 32); ++w) {
            mx = fmaxf(mx, smax[w]);
            nf |= snf[w];
        }
        rep[REP_RNORM] = nf ? __int_as_float(0x7fc00000) : mx;
        rep[REP_BAD] = (nf || mx > gate_first) ? 1.f : 0.f;
        rep[REP_NONFINITE] = 0.f;
    }
}

// K10: g = s + p (kept for the G^T E product), gloc[j] = -sum_b g[b, j],
// flag a nonfinite dloc.
__global__ void __launch_bounds__(COL_THREADS) advi_stl_cols_kernel(
        const float* s, const float* p, float* g, float* gloc, float* rep, int b, int d) {
    if (rep[REP_STIFF] != 0.f) return;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= d) return;
    float acc = 0.f;
    for (int r = 0; r < b; ++r) {
        const size_t o = (size_t)r * d + j;
        const float gv = s[o] + p[o];
        g[o] = gv;
        acc += gv;
    }
    const float gl = -acc;
    gloc[j] = gl;
    if (!isfinite(gl)) rep[REP_NONFINITE] = 1.f;
}

// K10: consume = !stopped && !bad && finite; a stop sets `stiff`, which
// halts the rest of the block.
__global__ void advi_stl_decide_kernel(float* rep) {
    if (rep[REP_STIFF] != 0.f) {
        rep[REP_CONSUME] = 0.f;
        return;
    }
    if (rep[REP_BAD] != 0.f || rep[REP_NONFINITE] != 0.f) {
        rep[REP_STIFF] = 1.f;
        rep[REP_CONSUME] = 0.f;
    } else {
        rep[REP_CONSUME] = 1.f;
        rep[REP_NDONE] += 1.f;
    }
}

// K10: if consumed, Adam on L (g from scratch; 0 above the diagonal), its
// moments and loc, and A <- A'.  Elements [0, d*d) are L's, [d*d, d*d+d) loc's.
__global__ void __launch_bounds__(APPLY_THREADS) advi_stl_apply_kernel(
        const float* rep, const float* gl, const float* gloc, float* l, float* ml, float* vl,
        float* loc, float* mloc, float* vloc, const float* a_new, float* a, int d,
        AdamArgs adam) {
    if (rep[REP_CONSUME] == 0.f) return;
    const size_t dd = (size_t)d * d;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < dd + d;
         idx += stride) {
        if (idx < dd) {
            float p = l[idx], m = ml[idx], v = vl[idx];
            adam_apply(p, m, v, gl[idx], adam);
            l[idx] = p;
            ml[idx] = m;
            vl[idx] = v;
            a[idx] = a_new[idx];
        } else {
            const size_t j = idx - dd;
            float p = loc[j], m = mloc[j], v = vloc[j];
            adam_apply(p, m, v, gloc[j], adam);
            loc[j] = p;
            mloc[j] = m;
            vloc[j] = v;
        }
    }
}

inline AdamArgs adam_args(float lr, float bc1, float bc2, float b1, float omb1, float b2,
                          float omb2, float eps) {
    return AdamArgs{lr, bc1, bc2, b1, omb1, b2, omb2, eps};
}

inline int col_blocks(int d) { return (d + COL_THREADS - 1) / COL_THREADS; }

}  // namespace

extern "C" {

// K9: g_L = tril(-S^T E - B diag(1/L_ii)) and Adam on l, ml, vl in place;
// s, e (B, D), l, ml, vl (D, D).
int gsmvi_advi_l_adam(const float* s, const float* e, float* l, float* ml, float* vl, int b,
                      int d, float lr, float bc1, float bc2, float b1, float omb1, float b2,
                      float omb2, float eps, float bf, void* stream) {
    GemmArgs p{};
    p.a = s; p.b = e; p.c = l; p.m1 = ml; p.m2 = vl; p.bf = bf;
    p.adam = adam_args(lr, bc1, bc2, b1, omb1, b2, omb2, eps);
    p.m = d; p.n = d; p.k = b; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<true, false, PRO_NONE, EPI_ADVI_ADAM>(p, static_cast<cudaStream_t>(stream));
}

// K9: dloc and Adam on loc, mloc, vloc (D,) from s (B, D).
int gsmvi_advi_loc_adam(const float* s, float* loc, float* mloc, float* vloc, int b, int d,
                        float lr, float bc1, float bc2, float b1, float omb1, float b2,
                        float omb2, float eps, void* stream) {
    advi_loc_adam_kernel<<<col_blocks(d), COL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s, loc, mloc, vloc, b, d, adam_args(lr, bc1, bc2, b1, omb1, b2, omb2, eps));
    return (int)cudaGetLastError();
}

// K10: r = I - l @ a (D, D); with partial (D * ceil(D/32),) also the tile
// row sums of |r|.  No-op while *halt != 0.
int gsmvi_advi_residual(const float* l, const float* a, float* r, float* partial,
                        const float* halt, int d, void* stream) {
    GemmArgs p{};
    p.a = l; p.b = a; p.c = r; p.partial = partial; p.halt = halt;
    p.m = d; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<false, false, PRO_NONE, EPI_EYE_MINUS>(p, static_cast<cudaStream_t>(stream));
}

int gsmvi_advi_residual_finalize(const float* partial, int ntx, float* rep, int d,
                                 float gate_first, void* stream) {
    advi_residual_finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        partial, ntx, rep, d, gate_first);
    return (int)cudaGetLastError();
}

// K10: a_out = a + a @ r (a_out distinct from a and r).  No-op while *halt != 0.
int gsmvi_advi_sweep(const float* a, const float* r, float* a_out, const float* halt, int d,
                     void* stream) {
    if (a_out == a || a_out == r) return (int)cudaErrorInvalidValue;
    GemmArgs p{};
    p.a = a; p.b = r; p.c = a_out; p.c_in = a; p.halt = halt;
    p.m = d; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<false, false, PRO_NONE, EPI_ADD>(p, static_cast<cudaStream_t>(stream));
}

int gsmvi_advi_stl_cols(const float* s, const float* p, float* g, float* gloc, float* rep,
                        int b, int d, void* stream) {
    advi_stl_cols_kernel<<<col_blocks(d), COL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s, p, g, gloc, rep, b, d);
    return (int)cudaGetLastError();
}

// K10: gl = tril(-g^T e), g, e (B, D); flags a nonfinite entry in the report.
int gsmvi_advi_grad_l(const float* g, const float* e, float* gl, float* rep, int b, int d,
                      void* stream) {
    GemmArgs p{};
    p.a = g; p.b = e; p.c = gl; p.flag = rep + REP_NONFINITE; p.halt = rep + REP_STIFF;
    p.m = d; p.n = d; p.k = b; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<true, false, PRO_NONE, EPI_ADVI_GRAD>(p, static_cast<cudaStream_t>(stream));
}

int gsmvi_advi_stl_decide(float* rep, void* stream) {
    advi_stl_decide_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(rep);
    return (int)cudaGetLastError();
}

int gsmvi_advi_stl_apply(const float* rep, const float* gl, const float* gloc, float* l,
                         float* ml, float* vl, float* loc, float* mloc, float* vloc,
                         const float* a_new, float* a, int d, float lr, float bc1, float bc2,
                         float b1, float omb1, float b2, float omb2, float eps,
                         void* stream) {
    const size_t n = (size_t)d * d + d;
    int blocks = (int)((n + APPLY_THREADS - 1) / APPLY_THREADS);
    if (blocks > 1024) blocks = 1024;
    advi_stl_apply_kernel<<<blocks, APPLY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rep, gl, gloc, l, ml, vl, loc, mloc, vloc, a_new, a, d,
        adam_args(lr, bc1, bc2, b1, omb1, b2, omb2, eps));
    return (int)cudaGetLastError();
}

}  // extern "C"
