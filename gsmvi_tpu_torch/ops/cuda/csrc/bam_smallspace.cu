// Small-space core of the BaM NS update (K7/K8's non-GEMM math), the
// finalize that decides the step, and the factor select.
//
// Replaces gsmvi_tpu/ops/pallas/bam_fused.py `_bam_smallspace_ns` (:195) from
// the row factors at :242 to the trace screen at :321, with `_ns_sqrt_both`
// (:176), both stiffness gates (:276), the three residual gates (:260, :280,
// :284; tol 3e-3) and the trace gate (:323-326), and the select and exports
// of `_update_kernel` (:361-374) and of the multistep body (:463-491).  The
// O(B D^2) products around it are launches of the GEMM template (gemm.cu:
// `gsmvi_rows`, `gsmvi_bam_apply`).
//
// By linearity of centring, the (kpad, D) row objects q_t = FU^T F,
// qf = q_t F^T and fom_t = Om^T F^T are affine in the rows vf = v F,
// t = vf F^T and ef = e F^T, so the kernel assembles them from those three
// GEMM outputs and their column means (sums in another order than JAX's
// direct products; the kernel-vs-plain tolerance covers it).
//
// The small dimension is padded to kpad = B + 8 exactly as the TPU kernel
// pads it: the padded identity enters the residual gates (res_p is divided
// by kpad; the pad diagonal adds to the res_u / res_1 sums), so the padding
// is part of the accept decision, not layout.  Rows are kept for the B+1
// non-zero rows only.
//
// What bounds it on an H100: five chains of ~180 dependent (kpad, kpad)
// products at the long profile (~60 at the most benign tier), each a few
// hundred cycles plus a block barrier: latency, not FLOPs or bytes.  Design:
// ONE block of 1024 threads holds all twelve (kpad, kpad) matrices in
// shared memory (192 KiB at kpad = 64) and streams the (B+1, D) rows
// through 32-column slabs (smallspace.cuh).  The select comes after the
// apply (the trace gate needs ||F'||^2), so the fat apply writes F' to a
// second buffer with per-tile sums of squares, the mean matvecs read F',
// and a one-block finalize reduces the partials in a fixed order (no float
// atomics: the accept flag reproduces), decides keep = good & ~stiff,
// writes the mean and a float32 report; a grid select then copies F or F'.
// In a multistep block each launch reads the report's `stopped` word and
// does nothing once the block has stopped.
#include "smallspace.cuh"

namespace {

constexpr int BS_THREADS = 1024;
constexpr int BS_MAXK = 64;       // kpad <= 64: gram_rows needs kpad^2 <= 4 * BS_THREADS
constexpr int BS_NMAT = 12;       // (kpad, kpad) matrices resident in shared memory
constexpr int FIN_THREADS = 256;
constexpr int SEL_THREADS = 256;

// Report (float32), the layout of ops/bam_fused.py's REP_* indices.
constexpr int REP_KEEP = 0, REP_STIFF = 1, REP_GU = 2, REP_LMAX = 3, REP_NDONE = 4,
              REP_NACC = 5, REP_STOPPED = 6, REP_APPLY = 7;
// Small-space results handed to the finalize.
constexpr int SS_GU = 0, SS_LMAX = 1, SS_RESOK = 2, SS_STIFF = 3, SS_TRA = 4, SS_TRB = 5;

struct BamArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* rows;         // (4 (B+1), D) scratch: om_t, q_t, qf, fyT
    float* su;           // (2 (B+1), D) stack_u = [fom_t; u2row]
    float* sw;           // (2 (B+1), D) stack_w = [w1row; y_t]
    float* vec;          // (2, D): gbar, xbar = mu + efbar
    float* ss;           // (8,) small-space results (SS_*)
    const float* halt;   // optional: do nothing while *halt != 0
    int b, d;
    float reg;
    int it0, it1, it2, it3, it4;
    float lmax_gate, gu_gate, tol;
};

__global__ void __launch_bounds__(BS_THREADS, 1) bam_smallspace_kernel(BamArgs p) {
    if (p.halt != nullptr && *p.halt != 0.f) return;
    extern __shared__ float smem[];
    const int b = p.b, d = p.d, m = b + 1, n = b + 8, nn = n * n;
    float* red = smem;                          // 32
    float* sx = red + 32;                       // BS_MAXK * SS_LD each
    float* sy = sx + BS_MAXK * SS_LD;
    float* W0 = sy + BS_MAXK * SS_LD;           // chain input / Grams
    float* w[5] = {W0 + nn, W0 + 2 * nn, W0 + 3 * nn, W0 + 4 * nn, W0 + 5 * nn};
    float* GU = W0 + 6 * nn;     // gu, later g, later p p, later Gram(fom)
    float* SU = GU + nn;         // s_u, later s1, later winv
    float* CU = SU + nn;
    float* CUOMQ = CU + nn;      // cu (Om^T Q)
    float* P = CUOMQ + nn;       // (I + s1)^{-1/2}
    float* TAU = P + nn;
    float* om = p.rows;
    float* q = om + (size_t)m * d;
    float* qf = q + (size_t)m * d;
    float* fy = qf + (size_t)m * d;
    float* fom = p.su;
    float* u2 = p.su + (size_t)m * d;
    float* w1 = p.sw;
    float* y = p.sw + (size_t)m * d;

    const float reg = p.reg;
    const float r1 = reg / (1.f + reg);
    const float sru = sqrtf(reg / (float)b);
    const float sr1 = sqrtf(r1);

    // Row factors (bam_fused.py:242-251): om_t = [sru (e - ebar); -sr1 ebar],
    // q_t = fu_t F = [sru (vf - vfbar); sr1 vfbar], qf = q_t F^T from t,
    // fom_t = om_t F^T from ef; gbar and xbar for the mean.
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
        float se = 0.f, sv = 0.f, svf = 0.f, st = 0.f, sef = 0.f;
        for (int r = 0; r < b; ++r) {
            const size_t o = (size_t)r * d + col;
            se += p.e[o];
            sv += p.v[o];
            svf += p.vf[o];
            st += p.t[o];
            sef += p.ef[o];
        }
        const float eb = se / (float)b, gb = sv / (float)b, vfb = svf / (float)b;
        const float tb = st / (float)b, efb = sef / (float)b;
        for (int r = 0; r < b; ++r) {
            const size_t o = (size_t)r * d + col;
            om[o] = sru * (p.e[o] - eb);
            q[o] = sru * (p.vf[o] - vfb);
            qf[o] = sru * (p.t[o] - tb);
            fom[o] = sru * (p.ef[o] - efb);
        }
        const size_t o = (size_t)b * d + col;
        om[o] = -sr1 * eb;
        q[o] = sr1 * vfb;
        qf[o] = sr1 * tb;
        fom[o] = -sr1 * efb;
        p.vec[col] = gb;
        p.vec[d + col] = p.mean_in[col] + efb;
    }
    __syncthreads();

    // cu chain (:255-262): W1 = I + Om cu Om^T, cu = (I + sqrt(I + Gu))^{-1}.
    gram_rows(om, om, GU, m, n, d, 1.f, sx, sy);
    symmetrize(GU, n);
    const float gu_ub = spd_norm_ub(GU, n, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + GU[idx];
    __syncthreads();
    ns_sqrt(W0, SU, n, p.it0, w, red);
    symmetrize(SU, n);
    const float res_u = rel_residual(SU, W0, w[0], n, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + SU[idx];
    __syncthreads();
    newton_inv(W0, CU, n, p.it1, w, red);

    // Y^T = q_t + (cu Om^T Q)^T om_t (:265-267), into stack_w's second half.
    gram_rows(om, q, W0, m, n, d, 1.f, sx, sy);
    smm(CU, W0, CUOMQ, n, Plain());
    left_apply<true>(CUOMQ, n, om, m, d, sx, [=](int i, int col, float acc) {
        const size_t o = (size_t)i * d + col;
        y[o] = q[o] + acc;
    });

    // Gated Gram and the stiffness gates (:270-276).
    gram_rows(y, y, GU, m, n, d, 1.f, sx, sy);
    symmetrize(GU, n);
    const float lmax_ub = spd_norm_ub(GU, n, red);
    const bool stiff = (lmax_ub > p.lmax_gate) || (gu_ub > p.gu_gate);

    // psi(G) chain (:277-288): s1 = sqrt(I + 4G), p = (I + s1)^{-1/2},
    // winv = (I + sqrt(2) p)^{-1}, tau = -4 p^4 winv.
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + 4.f * GU[idx];
    __syncthreads();
    ns_sqrt(W0, SU, n, p.it2, w, red);
    symmetrize(SU, n);
    const float res_1 = rel_residual(SU, W0, w[0], n, red);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + SU[idx];
    __syncthreads();
    ns_sqrt_both(W0, nullptr, P, n, p.it3, w, red);
    symmetrize(P, n);
    smm(P, P, GU, n, Plain());                  // p2 = p p
    smm(GU, W0, w[0], n, Plain());              // p2 (I + s1)
    float rp = 0.f;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        const float r = w[0][idx] - (idx / n == idx % n ? 1.f : 0.f);
        rp += r * r;
    }
    const float res_p = block_sum(rp, red) / (float)n;
    const float sqrt2 = sqrtf(2.f);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
        W0[idx] = (idx / n == idx % n ? 1.f : 0.f) + sqrt2 * P[idx];
    __syncthreads();
    newton_inv(W0, SU, n, p.it4, w, red);       // winv
    smm(GU, GU, w[3], n, Plain());              // p2 p2
    smm(w[3], SU, TAU, n, [](int, int, float acc) { return -4.f * acc; });
    symmetrize(TAU, n);

    // Stacked rows of F' = F + stack_u^T stack_w (:310-318).
    left_apply<false>(CU, n, om, m, d, sx, [=](int i, int col, float acc) {
        w1[(size_t)i * d + col] = acc;                          // w1row
    });
    left_apply<true>(CUOMQ, n, fom, m, d, sx, [=](int i, int col, float acc) {
        const size_t o = (size_t)i * d + col;
        fy[o] = qf[o] + acc;                                    // yf
    });
    gram_rows(y, w1, W0, m, n, d, 1.f, sx, sy);                 // yw1
    left_apply<false>(W0, n, fom, m, d, sx, [=](int i, int col, float acc) {
        const size_t o = (size_t)i * d + col;
        fy[o] = fy[o] + acc;                                    // (Fw1 Y)^T
    });
    left_apply<false>(TAU, n, fy, m, d, sx, [=](int i, int col, float acc) {
        u2[(size_t)i * d + col] = acc;                          // u2row
    });

    // Trace screen from small Grams (:320-322):
    // sum(w1f o fom_t) = sum(cu o Gram(fom)), sum(Gram(fom) o Gram(w1)).
    gram_rows(fom, fom, GU, m, n, d, 1.f, sx, sy);
    gram_rows(w1, w1, W0, m, n, d, 1.f, sx, sy);
    float ta = 0.f, tb = 0.f;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        ta = fmaf(CU[idx], GU[idx], ta);
        tb = fmaf(GU[idx], W0[idx], tb);
    }
    ta = block_sum(ta, red);
    tb = block_sum(tb, red);
    if (threadIdx.x == 0) {
        p.ss[SS_GU] = gu_ub;
        p.ss[SS_LMAX] = lmax_ub;
        p.ss[SS_RESOK] = (res_u < p.tol && res_1 < p.tol && res_p < p.tol) ? 1.f : 0.f;
        p.ss[SS_STIFF] = stiff ? 1.f : 0.f;
        p.ss[SS_TRA] = ta;
        p.ss[SS_TRB] = tb;
    }
}

inline size_t bam_smem_bytes(int kpad) {
    return sizeof(float) * (32 + 2 * BS_MAXK * SS_LD + (size_t)BS_NMAT * kpad * kpad);
}

struct FinArgs {
    const float* partial;   // (2 nparts,) tile sums of squares of F', F
    int nparts;
    const float* ss;        // small-space results
    const float* sg;        // (D,) s_gbar = (gbar F') F'^T
    const float* vec;       // (2, D): gbar, xbar
    const float* mean_in;
    float* mean_out;        // may equal mean_in
    float* rep;             // (8,) report
    int multistep, stop_on_reject;
    float reg;
    int d;
};

// Trace gate, keep = good & ~stiff, the mean with its select, and the
// report (bam_fused.py:323-333, :368-374, :477-490).
__global__ void __launch_bounds__(FIN_THREADS) bam_finalize_kernel(FinArgs p) {
    __shared__ float red[32];
    if (p.multistep && p.rep[REP_STOPPED] != 0.f) return;
    float a = 0.f, c = 0.f;
    for (int i = threadIdx.x; i < p.nparts; i += blockDim.x) {
        a += p.partial[2 * i];
        c += p.partial[2 * i + 1];
    }
    const float tr_new = block_sum(a, red);
    const float fnorm = block_sum(c, red);
    const float tr_v = (fnorm + 2.f * p.ss[SS_TRA]) + p.ss[SS_TRB];
    const bool good = isfinite(tr_new) && (tr_new <= 1.05f * tr_v + 1e-6f)
                      && p.ss[SS_RESOK] != 0.f;
    const bool stiff = p.ss[SS_STIFF] != 0.f;
    const bool stop_now = p.multistep && (stiff || (p.stop_on_reject && !good));
    const bool apply = good && !stiff && !stop_now;
    const float r1 = p.reg / (1.f + p.reg);
    for (int col = threadIdx.x; col < p.d; col += blockDim.x) {
        const float m0 = p.mean_in[col];
        const float mu_new = m0 / (1.f + p.reg) + r1 * (p.sg[col] + p.vec[p.d + col]);
        p.mean_out[col] = apply ? mu_new : m0;
    }
    if (threadIdx.x == 0) {
        float* r = p.rep;
        r[REP_KEEP] = (good && !stiff) ? 1.f : 0.f;
        r[REP_STIFF] = stiff ? 1.f : 0.f;
        r[REP_GU] = p.ss[SS_GU];
        r[REP_LMAX] = p.ss[SS_LMAX];
        r[REP_APPLY] = apply ? 1.f : 0.f;
        if (p.multistep) {
            if (stop_now) {
                r[REP_STOPPED] = stiff ? 1.f : 2.f;
            } else {
                r[REP_NDONE] += 1.f;
                r[REP_NACC] += good ? 1.f : 0.f;
            }
        } else {
            r[REP_NDONE] = 1.f;
            r[REP_NACC] = apply ? 1.f : 0.f;
            r[REP_STOPPED] = 0.f;
        }
    }
}

// dst = a if the report's apply flag is set else b; dst may equal a or b.
__global__ void __launch_bounds__(SEL_THREADS) bam_select_kernel(const float* rep, const float* a,
                                                                 const float* b, float* dst, int n) {
    const float* src = rep[REP_APPLY] != 0.f ? a : b;
    if (src == dst) return;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
        dst[i] = src[i];
}

}  // namespace

extern "C" {

int gsmvi_bam_smallspace(const float* e, const float* v, const float* vf, const float* t,
                         const float* ef, const float* mean_in, float* rows, float* su,
                         float* sw, float* vec, float* ss, const float* halt, int b, int d,
                         float reg, int it0, int it1, int it2, int it3, int it4,
                         float lmax_gate, float gu_gate, float tol, void* stream) {
    if (b < 1 || b + 8 > BS_MAXK || d < 1) return (int)cudaErrorInvalidValue;
    static bool smem_opt_in = false;   // above 48 KB needs the per-kernel opt-in
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            bam_smallspace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bam_smem_bytes(BS_MAXK));
        if (err != cudaSuccess) return (int)err;
        smem_opt_in = true;
    }
    BamArgs p{e, v, vf, t, ef, mean_in, rows, su, sw, vec, ss, halt, b, d, reg,
              it0, it1, it2, it3, it4, lmax_gate, gu_gate, tol};
    bam_smallspace_kernel<<<1, BS_THREADS, bam_smem_bytes(b + 8),
                            static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}

int gsmvi_bam_finalize(const float* partial, int nparts, const float* ss, const float* sg,
                       const float* vec, const float* mean_in, float* mean_out, float* rep,
                       int multistep, int stop_on_reject, float reg, int d, void* stream) {
    FinArgs p{partial, nparts, ss, sg, vec, mean_in, mean_out, rep, multistep,
              stop_on_reject, reg, d};
    bam_finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}

int gsmvi_bam_select(const float* rep, const float* a, const float* b, float* dst, int n,
                     void* stream) {
    int blocks = (n + SEL_THREADS - 1) / SEL_THREADS;
    if (blocks > 1024) blocks = 1024;
    bam_select_kernel<<<blocks, SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rep, a, b, dst, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
