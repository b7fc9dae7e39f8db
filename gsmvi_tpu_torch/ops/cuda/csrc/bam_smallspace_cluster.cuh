// Small-space core of the BaM NS update (K7/K8's non-GEMM math) on a
// thread-block cluster, for B <= 56 (kpad = B + 8 <= 64).
//
// Replaces gsmvi_tpu/ops/pallas/bam_fused.py `_bam_smallspace_ns` (:195)
// from the row factors at :242 to the trace screen at :321, with
// `_ns_sqrt_both` (:176), both stiffness gates (:276), the three residual
// gates (:260, :280, :284; tol 3e-3) and the trace screen's small Grams.  It
// writes the stacked rows of F' = F + stack_u^T stack_w and the small-space
// results (`ss`) that the fat apply, the finalize and the select of
// bam_smallspace.cu read.  The O(B D^2) products around it (vf, t, ef, the
// mean matvecs) run on the split-k thin product (thin_gemm.cu), the fat
// apply on gemm.cuh.
//
// By linearity of centring, the (kpad, D) row objects q_t = FU^T F,
// qf = q_t F^T and fom_t = Om^T F^T are affine in the rows vf = v F,
// t = vf F^T and ef = e F^T, so the kernel assembles them from those rows
// and their column means.  The small dimension is padded to kpad = B + 8 as
// the TPU kernel pads it: the padded identity enters the residual gates
// (res_p is divided by kpad; the pad diagonal adds to the res_u / res_1
// sums), so the padding is part of the accept decision, not layout.  Rows
// are kept for the B + 1 non-zero rows only.
//
// What bounds it on an H100: five chains of dependent (kpad, kpad)
// products (~140 product passes at the long NS profile, ~50 at the most
// benign tier), each a few hundred cycles plus a barrier: latency, not
// FLOPs or bytes.  The one-block kernel this replaces ran them with one
// output per thread and its row work (the row factors, 6 Grams and 5
// (kpad, kpad) x (kpad, D) products) on the same SM in 32-column slabs.
// Design, as eps_smallspace_cluster.cuh, whose slab, Gram and reduction
// helpers it reuses:
// - One cluster of C = min(8, ceil(D/32)) blocks (the caller's
//   `cluster_columns`, a function of D alone, so that a replica axis can
//   later go on blockIdx.y); block r owns the columns [r cols, (r+1) cols)
//   and forms the row objects of those columns only: om, q, qf, fom and
//   the mean rows in pass 1; y = q + CUOMQ^T om and w1 = CU om in pass 2;
//   fy = (qf + CUOMQ^T fom) + YW1 fom and u2 = TAU fy in pass 3.
// - Two cluster reductions: Gu = om om^T with om q^T (pass 1), and y y^T,
//   y w1^T, fom fom^T and w1 w1^T in one pass (pass 2).  Each block forms
//   its (kpad, kpad) partials over its own columns (the pad rows zero);
//   every block sums the C partials in rank order 0..C-1 through
//   distributed shared memory: no atomics, so every block holds the same
//   bits, run after run.
// - Every block runs the five chains redundantly on those identical Grams,
//   so all agree on every gate without a broadcast; rank 0 writes `ss`.
// - The chains' products are register-tiled (smallspace_tiled.cuh), k
//   ascending per output as in the one-block kernel.
// Shared memory: 12 (kpad, kpad) matrices at a padded leading dimension,
// three (kpad, 32) slabs and the column sums' partials: 222 KiB at
// kpad = 64 (dynamic, opted in).  Reduction 2's four partials do not fit
// beside the chains' twelve matrices there, so they alias chain scratch:
// they are stored into two matrices of the finished cu chain and into the
// two that held reduction 1's partials, the latter only after a cluster
// wait for the peers' reads of those, and the psi chain overwrites them
// only after a second wait (split arrive/wait cluster barriers, as in
// eps_smallspace_cluster.cuh).  After that wait no block reads a peer, so
// blocks leave freely.
// Halt: in a multistep block each launch reads the report's `stopped`
// word; every block reads it once, at entry, and returns before any cluster
// barrier, so no block waits on a peer that left.
// K replicas (FactorBaM.fit_batch, K7's replica axis): blockIdx.y =
// replica, one cluster each, every operand of replica z packed after
// replica z - 1's.  C depends on D only, never on K, so replica z equals a
// launch on replica z alone, bit for bit.  With a tier table (K rows of
// BAM_TIER_STRIDE floats: the five sweep counts, lmax_gate, gu_gate) each
// replica runs its own NS tier; without one, the launch's scalars.
//
// The kernel is a template on the chain tile T; each of its instantiations
// lives in its own source (bam_smallspace_cluster.cu for T = 3, the main
// path's kpad = 40, and bam_smallspace_cluster_t{1,2,4}.cu), so that the
// build compiles them side by side.
#pragma once

#include "bam_replica.cuh"
#include "eps_smallspace_cluster.cuh"

namespace {

constexpr int BC_NMAT = 12;            // (kpad, kpad) matrices resident in shared memory
constexpr int BC_MAXK = 64;            // kpad <= 16 T with T <= 4
constexpr int BC_WARPS = SC_THREADS / 32;

// Small-space results: the layout bam_smallspace.cu's finalize reads.
constexpr int BC_SS_GU = 0, BC_SS_LMAX = 1, BC_SS_RESOK = 2, BC_SS_STIFF = 3, BC_SS_TRA = 4,
              BC_SS_TRB = 5;

struct BamClusterArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* rows;         // (4 (B+1), D) scratch: om_t, q_t, qf
    float* su;           // (2 (B+1), D) stack_u = [fom_t; u2row]
    float* sw;           // (2 (B+1), D) stack_w = [w1row; y_t]
    float* vec;          // (2, D): gbar, xbar = mu + efbar
    float* ss;           // (8,) small-space results (BC_SS_*)
    const float* halt;   // optional: do nothing while *halt != 0
    int b, d, cols;      // cols: columns per block of the cluster
    float reg;
    int it0, it1, it2, it3, it4;
    float lmax_gate, gu_gate, tol;
    const float* tier;   // optional (K, BAM_TIER_STRIDE) per-replica NS tiers
};

// Leading dimension of the (kpad, kpad) matrices at tile T: a multiple of 4
// (float4 rows), and of 12 at T = 3 (a 3-row tile never passes row ld).
__host__ __device__ constexpr int bam_cluster_ld(int n, int tile) {
    return tile == 3 ? (n + 11) / 12 * 12 : (n + 3) & ~3;
}

inline size_t bam_cluster_smem(int n, int tile) {
    const size_t ld = bam_cluster_ld(n, tile);
    return sizeof(float) *
           (BC_NMAT * ld * ld + 3 * ld * CL_SLD + 3 * BC_WARPS * CL_SW + 32);
}

// mean[t] = the mean over rows [0, rows) of column threadIdx.x % 32 of the
// slab slab[t]: each warp sums rows w, w + 8, ... into cpart, then every
// thread adds the 8 partials of its column in order.
template <int NT>
__device__ void slab_col_means(float* const (&slab)[NT], int rows, float* cpart,
                               float (&mean)[NT]) {
    const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
    float s[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t] = 0.f;
    for (int i = g; i < rows; i += BC_WARPS) {
#pragma unroll
        for (int t = 0; t < NT; ++t) s[t] += slab[t][i * CL_SLD + c];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) cpart[(t * BC_WARPS + g) * CL_SW + c] = s[t];
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        float a = 0.f;
        for (int q = 0; q < BC_WARPS; ++q) a += cpart[(t * BC_WARPS + q) * CL_SW + c];
        mean[t] = a / (float)rows;
    }
}

// g1 += X1 X1^T and g2 += X2 X2^T over one slab, in gram_slab's layout.
template <int T>
__device__ void gram_slab_self2(const float* X1, const float* X2, int n, float (&g1)[T][T],
                                float (&g2)[T][T]) {
    const int i0 = (threadIdx.x >> 4) * T, tx = threadIdx.x & 15;
    if (i0 >= n || tx >= n) return;
    int ri[T], rk[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        ri[i] = min(i0 + i, n - 1) * CL_SLD;
        rk[i] = min(tx + 16 * i, n - 1) * CL_SLD;
    }
#pragma unroll
    for (int dd = 0; dd < CL_SW; dd += 4) {
        float x1[T][4], y1[T][4], x2[T][4], y2[T][4];
#pragma unroll
        for (int i = 0; i < T; ++i) {
            load4(x1[i], X1 + ri[i] + dd);
            load4(y1[i], X1 + rk[i] + dd);
            load4(x2[i], X2 + ri[i] + dd);
            load4(y2[i], X2 + rk[i] + dd);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < T; ++i)
#pragma unroll
                for (int k = 0; k < T; ++k) {
                    g1[i][k] = fmaf(x1[i][q], y1[k][q], g1[i][k]);
                    g2[i][k] = fmaf(x2[i][q], y2[k][q], g2[i][k]);
                }
    }
}

// acc[r][j] = sum_{k<n} S'[i, k] X[k, 4 cg + j] for rows i = rg + 32 r of the
// slab X, S' = S (or S^T under TR): left_slab2's layout, one product.
template <bool TR>
__device__ void left_slab1(const float* S, const float* X, int ld, int n, float (&acc)[2][4]) {
    const int rg = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    if (rg >= n) return;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        float x[4];
        load4(x, X + k * CL_SLD + c4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = rg + 32 * r;
            if (i >= n) continue;
            const float s = TR ? S[k * ld + i] : S[i * ld + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(s, x[j], acc[r][j]);
        }
    }
}

// f(i, dd, r, j) for this thread's elements of a left_slab product's output
// (rows i = rg + 32 r < m, slab columns dd = 4 cg + j).
template <class F>
__device__ __forceinline__ void each_slab_out(int m, F f) {
    const int rg = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = rg + 32 * r;
        if (i >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) f(i, c4 + j, r, j);
    }
}

template <int T>
__global__ void __launch_bounds__(SC_THREADS, 1) bam_cluster_kernel(BamClusterArgs p) {
    // The same word for every block: all return here or none does.
    if (p.halt != nullptr && *p.halt != 0.f) return;
    bam_take_replica(p);
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int nrank = static_cast<int>(cluster.num_blocks());
    const int b = p.b, d = p.d, m = b + 1, n = b + 8;
    const int ld = bam_cluster_ld(n, T), mm = ld * ld;
    const int c0 = rank * p.cols, c1 = min(d, c0 + p.cols);
    float* M[BC_NMAT];
#pragma unroll
    for (int i = 0; i < BC_NMAT; ++i) M[i] = smem + i * mm;
    float* sx = smem + BC_NMAT * mm;
    float* sy = sx + ld * CL_SLD;
    float* sz = sy + ld * CL_SLD;
    float* cpart = sz + ld * CL_SLD;            // 3 x 8 x 32 column-sum partials
    float* red = cpart + 3 * BC_WARPS * CL_SW;  // 32
    // Zeros outside every matrix's (n, n) corner and in the slab rows past
    // m, which nothing writes: the Grams' pad rows and columns stay 0.
    for (int idx = threadIdx.x; idx < BC_NMAT * mm + 3 * ld * CL_SLD; idx += blockDim.x)
        smem[idx] = 0.f;
    __syncthreads();
    PHASE(0);
    float* om_g = p.rows;
    float* q_g = om_g + (size_t)m * d;
    float* qf_g = q_g + (size_t)m * d;
    float* fom_g = p.su;
    float* u2_g = p.su + (size_t)m * d;
    float* w1_g = p.sw;
    float* y_g = p.sw + (size_t)m * d;
    const float reg = p.reg;
    const float r1 = reg / (1.f + reg);
    const float sru = sqrtf(reg / (float)b);
    const float sr1 = sqrtf(r1);
    const int lane = threadIdx.x & 31;          // a staging thread's slab column

    // Pass 1: the row factors (bam_fused.py:242-251) of this block's
    // columns, om_t = [sru (e - ebar); -sr1 ebar], q_t = [sru (vf - vfbar);
    // sr1 vfbar], qf from t, fom_t from ef, gbar and xbar; and the partial
    // Grams om om^T, om q^T.
    float g1[T][T], g2[T][T];
    zero_acc(g1);
    zero_acc(g2);
    for (int s0 = c0; s0 < c1; s0 += CL_SW) {
        const int col = s0 + lane;
        const bool in = col < c1;
        stage<2>({sx, sy}, {p.v, p.t}, b, d, s0, c1);
        __syncthreads();
        float gt[2];                            // gbar, tbar
        slab_col_means<2>({sx, sy}, b, cpart, gt);
#pragma unroll
        for (int it = 0; it < CL_PER_THREAD; ++it) {
            const int i = (threadIdx.x + it * SC_THREADS) / CL_SW;
            if (i < b && in) qf_g[(size_t)i * d + col] = sru * (sy[i * CL_SLD + lane] - gt[1]);
        }
        if (threadIdx.x < CL_SW && in) {
            qf_g[(size_t)b * d + col] = sr1 * gt[1];
            p.vec[col] = gt[0];
        }
        __syncthreads();                        // done with sx, sy and cpart
        stage<3>({sx, sy, sz}, {p.e, p.vf, p.ef}, b, d, s0, c1);
        __syncthreads();
        float mb[3];                            // ebar, vfbar, efbar
        slab_col_means<3>({sx, sy, sz}, b, cpart, mb);
#pragma unroll
        for (int it = 0; it < CL_PER_THREAD; ++it) {
            const int i = (threadIdx.x + it * SC_THREADS) / CL_SW;
            if (i >= b) continue;
            const int o = i * CL_SLD + lane;
            const float om = sru * (sx[o] - mb[0]);
            const float q = sru * (sy[o] - mb[1]);
            sx[o] = om;
            sy[o] = q;
            if (in) {
                const size_t og = (size_t)i * d + col;
                om_g[og] = om;
                q_g[og] = q;
                fom_g[og] = sru * (sz[o] - mb[2]);
            }
        }
        if (threadIdx.x < CL_SW) {
            const float om = -sr1 * mb[0], q = sr1 * mb[1];
            sx[b * CL_SLD + lane] = om;
            sy[b * CL_SLD + lane] = q;
            if (in) {
                const size_t og = (size_t)b * d + col;
                om_g[og] = om;
                q_g[og] = q;
                fom_g[og] = -sr1 * mb[2];
                p.vec[d + col] = p.mean_in[col] + mb[2];
            }
        }
        __syncthreads();
        gram_slab<T>(sx, sx, sy, n, g1, g2);
        __syncthreads();
    }
    store_partial<T>(M[10], g1, n, ld);
    store_partial<T>(M[11], g2, n, ld);
    cluster_sync_all();
    PHASE(1);

    // cu chain (:255-262) on Gu, every block alike: W1 = I + Om cu Om^T,
    // cu = (I + sqrt(I + Gu))^{-1}.
    float* GU = M[0];
    float* SU = M[1];
    float* CU = M[2];
    float* CUOMQ = M[3];
    float* W0 = M[4];
    float* w[5] = {M[5], M[6], M[7], M[8], M[9]};
    cluster_sum<T>(GU, M[10], n, ld, 1.f, nrank);
    tsymmetrize<T>(GU, n, ld);
    const float gu_ub = tnorm_ub(GU, n, ld, red);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + GU[o]; });
    tns_sqrt<T>(W0, SU, n, ld, p.it0, w, red);
    PHASE(2);
    tsymmetrize<T>(SU, n, ld);
    const float res_u = trel_residual<T>(SU, W0, w[0], n, ld, red);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + SU[o]; });
    tnewton_inv<T>(W0, CU, n, ld, p.it1, w, red);
    PHASE(3);
    // cu (Om^T Q); the peers' om q^T partials are still in place.
    cluster_sum<T>(w[0], M[11], n, ld, 1.f, nrank);
    cluster_arrive();            // done reading the peers' reduction-1 partials
    tmm<T>(CU, w[0], CUOMQ, n, ld, Plain());
    PHASE(4);

    // Pass 2: y_t = q_t + (cu Om^T Q)^T om_t (:265-267) and w1row = cu om_t
    // (:310) of this block's columns, and the partial Grams y y^T, y w1^T,
    // fom fom^T, w1 w1^T.
    float gy[T][T], gyw[T][T], gf[T][T], gw[T][T];
    zero_acc(gy);
    zero_acc(gyw);
    zero_acc(gf);
    zero_acc(gw);
    for (int s0 = c0; s0 < c1; s0 += CL_SW) {
        stage<3>({sx, sy, sz}, {om_g, q_g, fom_g}, m, d, s0, c1);
        __syncthreads();
        float ay[2][4], aw[2][4];
        left_slab2<true, false>(CUOMQ, sx, CU, sx, ld, m, ay, aw);
        each_slab_out(m, [&](int i, int dd, int r, int j) {
            const float y = sy[i * CL_SLD + dd] + ay[r][j];
            sy[i * CL_SLD + dd] = y;
            if (s0 + dd < c1) y_g[(size_t)i * d + s0 + dd] = y;
        });
        __syncthreads();                        // every thread is done reading om
        each_slab_out(m, [&](int i, int dd, int r, int j) {
            sx[i * CL_SLD + dd] = aw[r][j];
            if (s0 + dd < c1) w1_g[(size_t)i * d + s0 + dd] = aw[r][j];
        });
        __syncthreads();
        gram_slab<T>(sy, sy, sx, n, gy, gyw);
        gram_slab_self2<T>(sz, sx, n, gf, gw);
        __syncthreads();
    }
    cluster_wait();              // the peers are done reading M[10], M[11]
    store_partial<T>(M[10], gy, n, ld);
    store_partial<T>(M[11], gyw, n, ld);
    store_partial<T>(M[6], gf, n, ld);
    store_partial<T>(M[7], gw, n, ld);
    cluster_sync_all();
    PHASE(5);

    float* G = M[0];             // y y^T
    float* YW1 = M[1];           // y w1^T
    float* GF = M[4];            // fom fom^T
    float* GW1 = M[5];           // w1 w1^T
    cluster_sum<T>(G, M[10], n, ld, 1.f, nrank);
    cluster_sum<T>(YW1, M[11], n, ld, 1.f, nrank);
    cluster_sum<T>(GF, M[6], n, ld, 1.f, nrank);
    cluster_sum<T>(GW1, M[7], n, ld, 1.f, nrank);
    cluster_arrive();            // done reading the peers' reduction-2 partials
    PHASE(6);

    // Trace screen from small Grams (:320-322): sum(w1f o fom_t) =
    // sum(cu o Gram(fom)), sum(Gram(fom) o Gram(w1)).
    float ta = 0.f, tb = 0.f;
    {
        const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int c = 0; c < T; ++c) {
                const int i = i0 + 16 * a, j = j0 + 16 * c;
                if (i < n && j < n) {
                    const int o = i * ld + j;
                    ta = fmaf(CU[o], GF[o], ta);
                    tb = fmaf(GF[o], GW1[o], tb);
                }
            }
    }
    ta = block_sum(ta, red);
    tb = block_sum(tb, red);

    // Gated Gram and the stiffness gates (:270-276).
    tsymmetrize<T>(G, n, ld);
    const float lmax_ub = tnorm_ub(G, n, ld, red);
    const bool stiff = (lmax_ub > p.lmax_gate) || (gu_ub > p.gu_gate);

    // psi(G) chain (:277-288): s1 = sqrt(I + 4G), p = (I + s1)^{-1/2},
    // winv = (I + sqrt(2) p)^{-1}, tau = -4 p^4 winv.  Its scratch covers
    // the reduction-2 partials, so it starts after the peers' reads.
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + 4.f * G[o]; });
    cluster_wait();
    PHASE(7);
    float* S1 = M[2];            // s1, later winv
    float* P = M[10];
    float* P2 = M[0];
    float* TAU = M[11];
    tns_sqrt<T>(W0, S1, n, ld, p.it2, w, red);
    PHASE(8);
    tsymmetrize<T>(S1, n, ld);
    const float res_1 = trel_residual<T>(S1, W0, w[0], n, ld, red);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + S1[o]; });
    PHASE(9);
    tns_inv_sqrt<T>(W0, P, n, ld, p.it3, w, red);
    PHASE(10);
    tsymmetrize<T>(P, n, ld);
    tmm<T>(P, P, P2, n, ld, Plain());                       // p2 = p p
    tmm<T>(P2, W0, w[0], n, ld, Plain());                   // p2 (I + s1)
    float rp = 0.f;
    {
        const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int c = 0; c < T; ++c) {
                const int i = i0 + 16 * a, j = j0 + 16 * c;
                if (i < n && j < n) {
                    const float r = w[0][i * ld + j] - (i == j ? 1.f : 0.f);
                    rp += r * r;
                }
            }
    }
    const float res_p = block_sum(rp, red) / (float)n;
    const float sqrt2 = sqrtf(2.f);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + sqrt2 * P[o]; });
    PHASE(11);
    tnewton_inv<T>(W0, S1, n, ld, p.it4, w, red);          // winv
    tmm<T>(P2, P2, w[3], n, ld, Plain());                   // p2 p2
    tmm<T>(w[3], S1, TAU, n, ld, [](int, int, float acc) { return -4.f * acc; });
    tsymmetrize<T>(TAU, n, ld);
    PHASE(12);

    // Pass 3: the stacked rows' second halves (:310-318) of this block's
    // columns: yf = qf + (cu Om^T Q)^T fom_t, (Fw1 Y)^T = yf + yw1 fom_t,
    // u2row = tau (Fw1 Y)^T.
    for (int s0 = c0; s0 < c1; s0 += CL_SW) {
        stage<2>({sx, sy}, {fom_g, qf_g}, m, d, s0, c1);
        __syncthreads();
        float a1[2][4], a2[2][4];
        left_slab2<true, false>(CUOMQ, sx, YW1, sx, ld, m, a1, a2);
        each_slab_out(m, [&](int i, int dd, int r, int j) {
            sy[i * CL_SLD + dd] = (sy[i * CL_SLD + dd] + a1[r][j]) + a2[r][j];
        });
        __syncthreads();
        float au[2][4];
        left_slab1<false>(TAU, sy, ld, m, au);
        each_slab_out(m, [&](int i, int dd, int r, int j) {
            if (s0 + dd < c1) u2_g[(size_t)i * d + s0 + dd] = au[r][j];
        });
        __syncthreads();
    }
    PHASE(13);
    if (rank == 0 && threadIdx.x == 0) {
        p.ss[BC_SS_GU] = gu_ub;
        p.ss[BC_SS_LMAX] = lmax_ub;
        p.ss[BC_SS_RESOK] = (res_u < p.tol && res_1 < p.tol && res_p < p.tol) ? 1.f : 0.f;
        p.ss[BC_SS_STIFF] = stiff ? 1.f : 0.f;
        p.ss[BC_SS_TRA] = ta;
        p.ss[BC_SS_TRB] = tb;
    }
    PHASE(14);
}

template <int T>
cudaError_t launch_bam_cluster(const BamClusterArgs& p, int ranks, int reps,
                               cudaStream_t stream) {
    // Above 48 KB needs the opt-in, a function attribute: it covers every
    // later launch of this instantiation (kpad up to 16 T).
    static bool smem_opt_in = false;
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            bam_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bam_cluster_smem(16 * T, T));
        if (err != cudaSuccess) return err;
        smem_opt_in = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ranks, reps, 1);
    cfg.blockDim = dim3(SC_THREADS, 1, 1);
    cfg.dynamicSmemBytes = bam_cluster_smem(p.b + 8, T);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, bam_cluster_kernel<T>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// One instantiation's C entry: args points to a BamClusterArgs, `reps`
// replicas on blockIdx.y.  With
// GSMVI_PHASE_STAMPS (tools/smallspace_phases.py --kernel bam), name_phases
// copies its phase timestamps (PHASE(0..14) above) into out.
#define GSMVI_BAM_CLUSTER_ENTRY(name, T)                                                       \
    extern "C" int name(const void* args, int ranks, int reps, void* stream) {                \
        return (int)launch_bam_cluster<T>(*static_cast<const BamClusterArgs*>(args), ranks,    \
                                          reps, static_cast<cudaStream_t>(stream));            \
    }                                                                                          \
    GSMVI_EPS_CLUSTER_PHASES(name)

}  // namespace
