// BaM's NS small space for 56 < B <= 128 (kpad = B + 8 in 65-136) as one
// thread-block-cluster launch per update, its (kpad, kpad) matrices in row
// panels over the blocks' shared memory (smallspace_panel.cuh).
//
// Replaces gsmvi_tpu/ops/pallas/bam_fused.py `_bam_smallspace_ns` (:195)
// from the row factors at :242 to the trace screen at :321, with
// `_ns_sqrt_both` (:176), both stiffness gates (:276), the three residual
// gates (tol 3e-3) and the trace screen's small Grams: the body of K7 (:380)
// and K8 (:425) at these batches.  It writes what the cluster kernel of
// bam_smallspace_cluster.cu writes for B <= 56 (the stacked rows, gbar and
// xbar, and the `ss` results that bam_smallspace.cu's finalize reads), with
// the same padding: kpad = B + 8 enters the gates.
//
// What bounds it on an H100: ~180 dependent (kpad, kpad) products at tier 0
// (iters (20, 13, 16, 11, 6)), 2 kpad^3 FLOP each, 0.9 GFLOP at kpad = 136:
// the dependency chain and the cluster's barriers, not FLOPs or bytes.
// Design: one cluster of P = PN_RANKS = 16 blocks (a non-portable size: at
// B=128 a call took 1.31 ms at P = 16 and 1.76 at the portable P = 8 on an
// H100 at 700 W, PERF.md), block r owning ceil(kpad/P) <= 9 rows of every
// (kpad, kpad) matrix (smallspace_panel.cuh says how products, norms and
// residuals run on the panels).
// - Row factors: block r takes the columns [r cols, (r+1) cols) of D and
//   writes om_t, q_t, qf, fom_t (B + 1 rows each), gbar and xbar there, from
//   column means summed by warps in row-strided partials, then added in
//   warp order.
// - Grams (Om Om^T, Om Q^T, y y^T, y w1^T, fom fom^T, w1 w1^T): block r forms
//   its rows over all of D, each entry one fused multiply-add chain over d
//   ascending; the rows' products (y, w1row, yf + yw1 fom, u2row) are formed
//   by the rows' owners from 128-column slabs staged in shared memory.  The
//   row objects live in device memory (L2-resident) and are read after
//   the barrier that follows their writing.
// - Every block takes the same gate decisions from the rank-ordered cluster
//   sums; rank 0 writes `ss`.
// Halt: in a multistep block each launch reads the report's `stopped`
// word; every block reads it once, at entry, and returns before any cluster
// barrier, so no block waits on a peer that left.
// K replicas: blockIdx.y = replica, one cluster each (bam_replica.cuh),
// with its own mirrors; replica z equals a launch on replica z alone.
// Shared memory (P = 16): fourteen (9, 140) panels, a (140, 140) staging
// matrix, a (9, 132) Gram slab and the column sums' partials: 158,992 bytes
// at kpad = 136 (pn_smem_floats); the panels' mirrors in device memory,
// 14 (140, 140) (gsmvi_bam_panel_ws).
//
// The kernel is a template on the thread tile (smallspace_panel.cuh's
// mm_acc): 8 TR rows and 128 NC columns per block cover its panel.  Each
// instantiation lives in its own source, so that the build compiles them
// side by side: (1, 1) in bam_smallspace_panel.cu (up to 8 rows, kpad <=
// 128) and (2, 2) in bam_smallspace_panel_t22.cu (kpad 129-136, 9 rows).
#pragma once

#include "bam_replica.cuh"
#include "smallspace_panel.cuh"

namespace {

constexpr int PB_MINB = 1;
constexpr int PB_MAXB = 128;
constexpr int PB_NMAT = 14;
constexpr int PB_WARPS = PN_THREADS / 32;
constexpr int PB_EXTRA = 5 * PB_WARPS * 32;   // the column sums' partials

// Small-space results: the layout bam_smallspace.cu's finalize reads.
constexpr int PB_SS_GU = 0, PB_SS_LMAX = 1, PB_SS_RESOK = 2, PB_SS_STIFF = 3, PB_SS_TRA = 4,
              PB_SS_TRB = 5;

__host__ __device__ constexpr size_t pb_smem_bytes(int b) {
    return sizeof(float) * (size_t)pn_smem_floats(b + 8, PB_NMAT, PB_EXTRA);
}

struct PanelBamArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* rows;         // (4 (B+1), D) scratch: om_t, q_t, qf, fy
    float* su;           // (2 (B+1), D) stack_u = [fom_t; u2row]
    float* sw;           // (2 (B+1), D) stack_w = [w1row; y_t]
    float* vec;          // (2, D): gbar, xbar = mu + efbar
    float* ss;           // (8,) small-space results (PB_SS_*)
    const float* halt;   // optional: do nothing while *halt != 0
    float* ws;           // the panels' mirrors, pn_ws_floats(B + 8, PB_NMAT)
    int b, d;
    float reg;
    int it0, it1, it2, it3, it4;
    float lmax_gate, gu_gate, tol;
    const float* tier;   // optional (K, BAM_TIER_STRIDE) per-replica NS tiers
};

template <int TR, int NC>
__global__ void __launch_bounds__(PN_THREADS, 1) bam_panel_kernel(PanelBamArgs p) {
    // The same word for every block: all return here or none does.
    if (p.halt != nullptr && *p.halt != 0.f) return;
    bam_take_replica(p);
    p.ws += blockIdx.y * pn_ws_floats(p.b + 8, PB_NMAT);
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int b = p.b, d = p.d, m = b + 1, n = b + 8;
    PanelCtx g;
    float* M[PB_NMAT];
    float* cpart = pn_setup(g, smem, p.ws, n, PB_NMAT, PB_EXTRA, M);
    float* W0 = M[0];
    float* w[5] = {M[1], M[2], M[3], M[4], M[5]};
    float* GU = M[6];
    float* SU = M[7];
    float* CU = M[8];
    float* TAU = M[9];
    float* P = M[10];
    float* X11 = M[11];
    float* X12 = M[12];
    float* X13 = M[13];
    float* om_g = p.rows;
    float* q_g = om_g + (size_t)m * d;
    float* qf_g = q_g + (size_t)m * d;
    float* fy_g = qf_g + (size_t)m * d;
    float* fom_g = p.su;
    float* u2_g = p.su + (size_t)m * d;
    float* w1_g = p.sw;
    float* y_g = p.sw + (size_t)m * d;
    const float reg = p.reg;
    const float r1 = reg / (1.f + reg);
    const float sru = sqrtf(reg / (float)b);
    const float sr1 = sqrtf(r1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    PN_PHASE(0);

    // Row factors (bam_fused.py:242-251) of this block's columns, 32 at a
    // time: om_t = [sru (e - ebar); -sr1 ebar], q_t = [sru (vf - vfbar);
    // sr1 vfbar], qf from t, fom_t from ef, gbar and xbar = mu + efbar.
    {
        const int cols = (d + PN_RANKS - 1) / PN_RANKS;
        const int c0 = g.rank * cols, c1 = min(d, c0 + cols);
        const float* src[5] = {p.e, p.v, p.vf, p.t, p.ef};
        for (int s0 = c0; s0 < c1; s0 += 32) {
            const int col = s0 + lane;
            const bool in = col < c1;
            float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
            if (in)
                for (int r = warp; r < b; r += PB_WARPS) {
#pragma unroll
                    for (int k = 0; k < 5; ++k) s[k] += src[k][(size_t)r * d + col];
                }
#pragma unroll
            for (int k = 0; k < 5; ++k) cpart[(k * PB_WARPS + warp) * 32 + lane] = s[k];
            __syncthreads();
            float mb[5];
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                float a = 0.f;
                for (int q = 0; q < PB_WARPS; ++q) a += cpart[(k * PB_WARPS + q) * 32 + lane];
                mb[k] = a / (float)b;
            }
            if (in) {
                for (int r = warp; r < b; r += PB_WARPS) {
                    const size_t o = (size_t)r * d + col;
                    om_g[o] = sru * (p.e[o] - mb[0]);
                    q_g[o] = sru * (p.vf[o] - mb[2]);
                    qf_g[o] = sru * (p.t[o] - mb[3]);
                    fom_g[o] = sru * (p.ef[o] - mb[4]);
                }
                if (warp == 0) {
                    const size_t o = (size_t)b * d + col;
                    om_g[o] = -sr1 * mb[0];
                    q_g[o] = sr1 * mb[2];
                    qf_g[o] = sr1 * mb[3];
                    fom_g[o] = -sr1 * mb[4];
                    p.vec[col] = mb[1];
                    p.vec[d + col] = p.mean_in[col] + mb[4];
                }
            }
            __syncthreads();
        }
    }
    pn_sync();                           // every block's columns are written
    PN_PHASE(1);

    // cu chain (:255-262): W1 = I + Om cu Om^T, cu = (I + sqrt(I + Gu))^{-1}.
    gram<TR, NC>(g, om_g, m, om_g, m, d, 1.f, X12);
    gram<TR, NC>(g, om_g, m, q_g, m, d, 1.f, X13);          // Om^T Q
    pn_sync();
    psym(g, X12, GU, Plain());
    const float gu_ub = norm_ub(g, GU);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + GU[o]; });
    PN_PHASE(2);
    pns<TR, NC>(g, W0, X11, nullptr, p.it0, w);
    pn_sync();
    psym(g, X11, SU, Plain());
    const float res_u = rel_residual<TR, NC>(g, SU, W0, w[0]);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + SU[o]; });
    pnewton<TR, NC>(g, W0, CU, p.it1, w);
    PN_PHASE(3);

    // cu (Om^T Q) and its transpose's panel.
    float* CUOMQ = TAU;
    float* CUOMQT = X12;
    pn_sync();
    pmm<TR, NC>(g, CU, X13, CUOMQ, Plain());
    pn_sync();
    ptrans(g, CUOMQ, CUOMQT);

    // y_t = q_t + (cu Om^T Q)^T om_t (:265-267) and w1row = cu om_t (:310).
    rowprod2<TR, NC>(
        g, CUOMQT, CU, om_g, m, d, m,
        [=](int gi, int col, float acc) {
            const size_t o = (size_t)gi * d + col;
            y_g[o] = __ldcg(q_g + o) + acc;
        },
        [=](int gi, int col, float acc) { w1_g[(size_t)gi * d + col] = acc; });
    pn_sync();                           // every block's rows of y and w1
    PN_PHASE(4);

    // Gated Gram and the stiffness statistic (:270-276); y w1^T for fy.
    float* YW1 = X13;
    gram<TR, NC>(g, y_g, m, y_g, m, d, 1.f, X11);
    gram<TR, NC>(g, y_g, m, w1_g, m, d, 1.f, YW1);
    pn_sync();
    float* G = GU;
    psym(g, X11, G, Plain());
    const float lmax_ub = norm_ub(g, G);
    const bool stiff = (lmax_ub > p.lmax_gate) || (gu_ub > p.gu_gate);
    PN_PHASE(5);

    // psi(G) chain (:277-288): s1 = sqrt(I + 4G), p = (I + s1)^{-1/2},
    // winv = (I + sqrt(2) p)^{-1}, tau = -4 p^4 winv.
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + 4.f * G[o]; });
    pns<TR, NC>(g, W0, SU, nullptr, p.it2, w);
    float* S1 = X11;
    pn_sync();
    psym(g, SU, S1, Plain());
    const float res_1 = rel_residual<TR, NC>(g, S1, W0, w[0]);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + S1[o]; });
    PN_PHASE(6);
    pns<TR, NC>(g, W0, nullptr, SU, p.it3, w);
    pn_sync();
    psym(g, SU, P, Plain());
    PN_PHASE(7);
    float* P2 = G;
    pn_flush(g, W0);                     // read by p2 (I + s1)
    pn_sync();
    pmm<TR, NC>(g, P, P, P2, Plain());                    // p2 = p p
    pn_sync();
    pmm<TR, NC>(g, P2, W0, w[0], Plain());                // p2 (I + s1)
    float rp = 0.f;
    {
        float* r = w[0];
        for (int idx = threadIdx.x; idx < g.nr * g.n; idx += PN_THREADS) {
            const int i = idx / g.n, j = idx - i * g.n;
            const float x = r[i * g.ld + j] - (g.row0 + i == j ? 1.f : 0.f);
            rp += x * x;
        }
    }
    const float res_p = cluster_sum2(g, block_sum(rp, g.red), 0.f).x / (float)n;
    const float sqrt2 = sqrtf(2.f);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + sqrt2 * P[o]; });
    PN_PHASE(8);
    pnewton<TR, NC>(g, W0, SU, p.it4, w);                   // winv
    pn_sync();
    pmm<TR, NC>(g, P2, P2, w[3], Plain());                // p2 p2
    pn_sync();
    pmm<TR, NC>(g, w[3], SU, X11, [](int, int, float acc) { return acc * -4.f; });
    pn_sync();
    psym(g, X11, TAU, Plain());
    PN_PHASE(9);

    // Stacked rows of F' = F + stack_u^T stack_w (:310-318): yf = qf +
    // (cu Om^T Q)^T fom_t, (Fw1 Y)^T = yf + yw1 fom_t, then u2row = tau
    // (Fw1 Y)^T.
    rowprod2<TR, NC>(
        g, CUOMQT, YW1, fom_g, m, d, m,
        [=](int gi, int col, float acc) {
            const size_t o = (size_t)gi * d + col;
            fy_g[o] = __ldcg(qf_g + o) + acc;
        },
        [=](int gi, int col, float acc) {
            const size_t o = (size_t)gi * d + col;
            fy_g[o] = fy_g[o] + acc;
        });
    pn_sync();                           // every block's rows of (Fw1 Y)^T
    rowprod2<TR, NC>(
        g, TAU, nullptr, fy_g, m, d, m,
        [=](int gi, int col, float acc) { u2_g[(size_t)gi * d + col] = acc; },
        [](int, int, float) {});
    PN_PHASE(10);

    // Trace screen from small Grams (:320-322): sum(w1f o fom_t) =
    // sum(cu o Gram(fom)), sum(Gram(fom) o Gram(w1)).
    float* GF = X12;
    float* GW1 = X13;
    gram<TR, NC>(g, fom_g, m, fom_g, m, d, 1.f, GF);
    gram<TR, NC>(g, w1_g, m, w1_g, m, d, 1.f, GW1);
    float ta = 0.f, tb = 0.f;
    for (int idx = threadIdx.x; idx < g.nr * g.n; idx += PN_THREADS) {
        const int i = idx / g.n, o = i * g.ld + idx - i * g.n;
        ta = fmaf(CU[o], GF[o], ta);
        tb = fmaf(GF[o], GW1[o], tb);
    }
    ta = block_sum(ta, g.red);
    tb = block_sum(tb, g.red);
    const float2 tr = cluster_sum2(g, ta, tb);
    pn_arrive();                         // done reading the peers' slots
    if (g.rank == 0 && threadIdx.x == 0) {
        p.ss[PB_SS_GU] = gu_ub;
        p.ss[PB_SS_LMAX] = lmax_ub;
        p.ss[PB_SS_RESOK] = (res_u < p.tol && res_1 < p.tol && res_p < p.tol) ? 1.f : 0.f;
        p.ss[PB_SS_STIFF] = stiff ? 1.f : 0.f;
        p.ss[PB_SS_TRA] = tr.x;
        p.ss[PB_SS_TRB] = tr.y;
    }
    PN_PHASE(11);
    pn_wait();                           // no block leaves while a peer reads it
}

}  // namespace

// One instantiation's C entries: name launches on `args` (a PanelBamArgs),
// name##_clusters reads the placement.
#define GSMVI_BAM_PANEL_ENTRY(name, TR, NC)                                                  \
    namespace {                                                                           \
    int name##_smem = 0;                                                                  \
    }                                                                                     \
    extern "C" long long name##_clusters(int b) {                                         \
        return pn_max_clusters(bam_panel_kernel<TR, NC>, pb_smem_bytes(b), &name##_smem); \
    }                                                                                     \
    extern "C" int name(const void* args, int reps, void* stream) {                       \
        const PanelBamArgs& p = *static_cast<const PanelBamArgs*>(args);                 \
        const size_t smem = pb_smem_bytes(p.b);                                           \
        cudaError_t err = pn_attributes(bam_panel_kernel<TR, NC>, smem, &name##_smem);    \
        if (err != cudaSuccess) return (int)err;                                          \
        cudaLaunchAttribute attr[1];                                                      \
        const cudaLaunchConfig_t cfg =                                                    \
            pn_config(reps, smem, static_cast<cudaStream_t>(stream), attr);               \
        err = cudaLaunchKernelEx(&cfg, bam_panel_kernel<TR, NC>, p);                     \
        if (err != cudaSuccess) return (int)err;                                          \
        return (int)cudaGetLastError();                                                   \
    }                                                                                     \
    GSMVI_PANEL_PHASES(name)
