// Small-space core of the eps-NS GSM update (K1's non-GEMM math) on a
// thread-block cluster, for B <= 64.
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_smallspace_ns` (:231)
// from the row work at :287 to the stacked rows at :345, with `_ns_sqrt`
// (:198), `_newton_inv` (:214), `_spd_norm_ub` (:189), both residual gates
// (tol 3e-3) and the mean half of the accept/revert select (:454/:738).  The
// O(B D^2) products around it (ef, vf, t) run on the split-k thin product
// (thin_gemm.cu), the fat apply with the factor select on gemm.cuh.
//
// What bounds it on an H100: ~70 dependent (B, B) products of the five
// Newton-Schulz / Newton-Hotelling chains (iters (5, 4, 6, 7, 4) at B <= 32),
// each a few hundred cycles plus a barrier: latency, not FLOPs or bytes (the
// whole K1 call is 26 MFLOP).  The one-block kernel this replaces also ran
// the row work (4 Grams, 4 (B, B) x (B, D) products, the row scalars, the
// mean) on its one SM, in 32-column slabs: ~64 slab phases at D=256.
// Design:
// - One cluster of C = min(8, ceil(D/32)) blocks per replica (the caller's
//   `cluster_columns`, a function of D alone); block r owns the columns
//   [r cols, (r+1) cols) and does the row work of those columns only, in
//   32-column slabs staged in its shared memory (one slab per block at
//   D=256).
// - The five quantities that need all of D (the row sums behind rho, w/den
//   and gamma; Gu = e e^T/B with e c^T/B; Gv = Xi~^T Xi~ with Xi~^T w1row^T)
//   are formed as per-block partials over the block's columns and summed by
//   every block, through distributed shared memory, in rank order 0..C-1: no
//   atomics, so every block holds the same bits, run after run.  Three
//   reductions (the pairs formed in one pass) and split arrive/wait cluster
//   barriers, so a block waits for its peers to have read its partials only
//   when it next overwrites them.
// - Every block runs the (B, B) chains redundantly on those identical Grams,
//   so all hold the same S1, CU, CUI, CV and Q without a broadcast and the
//   gates agree; rank 0 writes `good` and `nacc`.
// - The chains' products are register-tiled (smallspace_tiled.cuh): 256
//   threads, a T x T tile each, 128-bit shared loads, k ascending per output
//   as in the one-block kernel; every symmetrisation is kept.
// Shared memory: 12 (B, B) matrices at a padded leading dimension plus three
// (B, 32) slabs, 221 KiB at B=64 (dynamic, opted in), 62 KiB at B=32.
//
// K replicas (batched K1 and K6): blockIdx.y = replica, one cluster each.
// C depends on D only, never on K, so replica z equals a launch on replica
// z alone, bit for bit.
//
// The kernel is a template on the tile T; each of its three instantiations
// lives in its own source (eps_smallspace_cluster.cu for T = 2,
// eps_smallspace_cluster_b16.cu, eps_smallspace_cluster_b64.cu), so that the
// build compiles them side by side.
#pragma once

#include <cooperative_groups.h>

#include "smallspace_tiled.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL_MAXB = 64;
constexpr int CL_MAX_RANKS = 8;        // the portable cluster size
constexpr int CL_SW = 32;              // columns per slab
constexpr int CL_SLD = CL_SW + 4;      // padded slab row (16-byte aligned)
constexpr int CL_NMAT = 12;            // (B, B) matrices resident in shared memory
constexpr int CL_PHASES = 15;

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py, which reads them through the entry's
// `_phases` twin): thread 0 of each block of replica 0 writes the global
// timer (ns) at PHASE(k), k < CL_PHASES.  Without the macro PHASE is empty.
#ifdef GSMVI_PHASE_STAMPS
__device__ long long phase_ns[CL_MAX_RANKS * CL_PHASES];
#define PHASE(k)                                                                  \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.y == 0) {                                \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            phase_ns[blockIdx.x * CL_PHASES + (k)] = t_;                          \
        }                                                                         \
    } while (0)
#else
#define PHASE(k) \
    do {         \
    } while (0)
#endif

struct ClusterArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* mean_out;     // may equal mean_in
    int* good;           // (1,) 1 iff both residual gates pass
    int* nacc;           // optional (1,): += good
    long long e_stride;  // elements between replicas' e rows (the others are packed)
    float* su;           // (2B, D) stack_u
    float* sw;           // (2B, D) stack_w
    float* c;            // (B, D) scratch: downdate rows
    float* xim;          // (B, D) scratch: Xi~^T
    int b, d, cols;      // cols: columns per block of the cluster
    int it0, it1, it2, it3, it4;
    float tol;
};

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
    cluster_arrive();
    cluster_wait();
}

// dst = scale * (src_0 + src_1 + ... + src_{C-1}) over the (n, n) corner,
// src_q being rank q's copy of src, summed in rank order.
template <int T>
__device__ void cluster_sum(float* dst, float* src, int n, int ld, float scale, int nrank) {
    cg::cluster_group cluster = cg::this_cluster();
    const float* peer[CL_MAX_RANKS];
#pragma unroll
    for (int q = 0; q < CL_MAX_RANKS; ++q)
        peer[q] = q < nrank ? cluster.map_shared_rank(src, q) : src;
    each_entry<T>(n, ld, [&](int, int, int o) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < CL_MAX_RANKS; ++q)
            if (q < nrank) s += peer[q][o];
        dst[o] = s * scale;
    });
}

// Accumulate the partial Grams g1 += X Y1^T and g2 += X Y2^T over one
// slab: X, Y1, Y2 (n, CL_SW) slabs at stride CL_SLD.  Thread (ty, tx) owns
// rows ty T + i and columns tx + 16 k (conflict-free 128-bit loads); rows
// past n read row n - 1 and are never stored.  Columns ascend.
template <int T>
__device__ void gram_slab(const float* X, const float* Y1, const float* Y2, int n,
                          float (&g1)[T][T], float (&g2)[T][T]) {
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
        float x[T][4], a[T][4], b[T][4];
#pragma unroll
        for (int i = 0; i < T; ++i) {
            load4(x[i], X + ri[i] + dd);
            load4(a[i], Y1 + rk[i] + dd);
            load4(b[i], Y2 + rk[i] + dd);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < T; ++i)
#pragma unroll
                for (int k = 0; k < T; ++k) {
                    g1[i][k] = fmaf(x[i][q], a[k][q], g1[i][k]);
                    g2[i][k] = fmaf(x[i][q], b[k][q], g2[i][k]);
                }
    }
}

// P = g (this block's partial) over the (n, n) corner.
template <int T>
__device__ void store_partial(float* P, const float (&g)[T][T], int n, int ld) {
    const int i0 = (threadIdx.x >> 4) * T, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
        for (int k = 0; k < T; ++k)
            if (i0 + i < n && tx + 16 * k < n) P[(i0 + i) * ld + tx + 16 * k] = g[i][k];
}

template <int T>
__device__ void zero_acc(float (&g)[T][T]) {
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
        for (int k = 0; k < T; ++k) g[i][k] = 0.f;
}

// acc1[r][j] = sum_{k<n} S1'[i, k] X1[k, 4 cg + j] and acc2 likewise for
// rows i = rg + 32 r of the slabs X1, X2 (stride CL_SLD), S' = S (or S^T
// under TRANS) at stride ld; thread = (rg, cg) = (tid / 8, tid % 8).  The
// two products share one loop (k ascending in each).
template <bool TR1, bool TR2>
__device__ void left_slab2(const float* S1, const float* X1, const float* S2, const float* X2,
                           int ld, int n, float (&acc1)[2][4], float (&acc2)[2][4]) {
    const int rg = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[r][j] = acc2[r][j] = 0.f;
    if (rg >= n) return;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        float x1[4], x2[4];
        load4(x1, X1 + k * CL_SLD + c4);
        load4(x2, X2 + k * CL_SLD + c4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = rg + 32 * r;
            if (i >= n) continue;
            const float s1 = TR1 ? S1[k * ld + i] : S1[i * ld + k];
            const float s2 = TR2 ? S2[k * ld + i] : S2[i * ld + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc1[r][j] = fmaf(s1, x1[j], acc1[r][j]);
                acc2[r][j] = fmaf(s2, x2[j], acc2[r][j]);
            }
        }
    }
}

// The slab element q of a thread's it-th load: row i, slab column dd.
constexpr int CL_PER_THREAD = CL_MAXB * CL_SW / SC_THREADS;

// Stage rows [0, n) x columns [s0, s0 + CL_SW) of the (n, d) tensors src[t]
// (t < NT) into the slabs dst[t], zero past column c1; each thread issues all
// its loads before its first store.
template <int NT>
__device__ void stage(float* const (&dst)[NT], const float* const (&src)[NT], int n, int d,
                      int s0, int c1) {
    float val[NT][CL_PER_THREAD];
#pragma unroll
    for (int it = 0; it < CL_PER_THREAD; ++it) {
        const int q = threadIdx.x + it * SC_THREADS, i = q / CL_SW, col = s0 + q % CL_SW;
        const bool in = i < n && col < c1;
#pragma unroll
        for (int t = 0; t < NT; ++t) val[t][it] = in ? src[t][(size_t)i * d + col] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < CL_PER_THREAD; ++it) {
        const int q = threadIdx.x + it * SC_THREADS, i = q / CL_SW, dd = q % CL_SW;
        if (i < n) {
#pragma unroll
            for (int t = 0; t < NT; ++t) dst[t][i * CL_SLD + dd] = val[t][it];
        }
    }
}

template <int T>
__global__ void __launch_bounds__(SC_THREADS, 1) eps_cluster_kernel(ClusterArgs p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int nrank = static_cast<int>(cluster.num_blocks());
    const int n = p.b, d = p.d, ld = padded(n), mm = ld * ld;
    const int c0 = rank * p.cols, c1 = min(d, c0 + p.cols);
    {   // This cluster's replica.
        const long long z = blockIdx.y, rows = (long long)n * d;
        p.e += z * p.e_stride;
        p.v += z * rows; p.vf += z * rows; p.t += z * rows; p.ef += z * rows;
        p.c += z * rows; p.xim += z * rows;
        p.su += 2 * z * rows; p.sw += 2 * z * rows;
        p.mean_in += z * d; p.mean_out += z * d;
        p.good += z;
        if (p.nacc != nullptr) p.nacc += z;
    }
    float* GU = smem;            // gu, later cuiec
    float* S1 = GU + mm;         // s1, later s2
    float* CU = S1 + mm;
    float* CUI = CU + mm;        // cui, later cv
    float* W0 = CUI + mm;        // chain input / Grams / Q
    float* w[5] = {W0 + mm, W0 + 2 * mm, W0 + 3 * mm, W0 + 4 * mm, W0 + 5 * mm};
    float* P0 = W0 + 6 * mm;     // this block's partial Grams, read by its peers
    float* P1 = P0 + mm;
    float* sx = smem + CL_NMAT * mm;
    float* sy = sx + ld * CL_SLD;
    float* sz = sy + ld * CL_SLD;
    float* red = sz + ld * CL_SLD;              // 32
    float* part = red + 32;                     // 3 ld: row-sum partials
    float* s_gamma = part + 3 * ld;
    float* s_inv1r = s_gamma + ld;
    float* s_wden = s_inv1r + ld;
    for (int idx = threadIdx.x; idx < CL_NMAT * mm; idx += blockDim.x) smem[idx] = 0.f;
    const float zc = 1.f / sqrtf((float)n);
    const float scale2 = 1.f / (float)n;
    PHASE(0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rg = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;

    // Row sums vsv, mv, wsum over this block's columns (fused_step.py:285-296):
    // lane l of the warp of row r takes the columns s0 + l of each slab, then
    // a warp reduction; then over the cluster.
    {
        constexpr int RPW = CL_MAXB / (SC_THREADS / 32);     // rows per warp
        float vsv[RPW], mv[RPW], wsum[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) vsv[i] = mv[i] = wsum[i] = 0.f;
        for (int s0 = c0; s0 < c1; s0 += CL_SW) {
            stage<3>({sx, sy, sz}, {p.v, p.t, p.ef}, n, d, s0, c1);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int r = warp + i * (SC_THREADS / 32);
                if (r >= n) continue;
                const float vv = sx[r * CL_SLD + lane], tt = sy[r * CL_SLD + lane];
                const float a = -sz[r * CL_SLD + lane];
                vsv[i] += vv * tt;
                mv[i] += a * vv;
                wsum[i] += vv * (tt - a);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp + i * (SC_THREADS / 32);
            for (int o = 16; o > 0; o >>= 1) {
                vsv[i] += __shfl_xor_sync(0xffffffffu, vsv[i], o);
                mv[i] += __shfl_xor_sync(0xffffffffu, mv[i], o);
                wsum[i] += __shfl_xor_sync(0xffffffffu, wsum[i], o);
            }
            if (lane == 0 && r < n) {
                part[r] = vsv[i];
                part[ld + r] = mv[i];
                part[2 * ld + r] = wsum[i];
            }
        }
    }
    cluster_sync_all();
    PHASE(1);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
        float vsv = 0.f, mv = 0.f, wsum = 0.f;
        for (int q = 0; q < nrank; ++q) {
            const float* pq = cluster.map_shared_rank(part, q);
            vsv += pq[r];
            mv += pq[ld + r];
            wsum += pq[2 * ld + r];
        }
        const float rho = 0.5f * (sqrtf(1.f + 4.f * (vsv + mv * mv)) - 1.f);
        const float den = 1.f + rho + mv;
        const float inv1r = 1.f / (1.f + rho);
        const float wden = wsum / den;
        s_inv1r[r] = inv1r;
        s_wden[r] = wden;
        s_gamma[r] = 1.f - (1.f + wden) * inv1r;
    }
    __syncthreads();
    PHASE(2);

    // Pass 1: downdate rows c = -e gamma + vf / (1 + rho), and the partial
    // Grams e e^T and e c^T over this block's columns.
    float g1[T][T], g2[T][T];
    zero_acc(g1);
    zero_acc(g2);
    for (int s0 = c0; s0 < c1; s0 += CL_SW) {
        stage<2>({sx, sy}, {p.e, p.vf}, n, d, s0, c1);
        // Each thread turns the vf it staged into c.
#pragma unroll
        for (int it = 0; it < CL_PER_THREAD; ++it) {
            const int q = threadIdx.x + it * SC_THREADS, i = q / CL_SW, dd = q % CL_SW;
            if (i >= n) continue;
            const int col = s0 + dd;
            float cv = 0.f;
            if (col < c1) {
                cv = -sx[i * CL_SLD + dd] * s_gamma[i] + sy[i * CL_SLD + dd] * s_inv1r[i];
                p.c[(size_t)i * d + col] = cv;
            }
            sy[i * CL_SLD + dd] = cv;
        }
        __syncthreads();
        gram_slab<T>(sx, sx, sy, n, g1, g2);
        __syncthreads();
    }
    store_partial<T>(P0, g1, n, ld);
    store_partial<T>(P1, g2, n, ld);
    cluster_sync_all();
    PHASE(3);

    // Phase 1 on Gu = e e^T / B (every block alike).
    cluster_sum<T>(GU, P0, n, ld, scale2, nrank);
    tsymmetrize<T>(GU, n, ld);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + GU[o]; });
    tns_sqrt<T>(W0, S1, n, ld, p.it0, w, red);
    PHASE(4);
    tsymmetrize<T>(S1, n, ld);
    const float res1 = trel_residual<T>(S1, W0, w[0], n, ld, red);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + S1[o]; });
    tnewton_inv<T>(W0, CU, n, ld, p.it1, w, red);
    PHASE(5);
    each_entry<T>(n, ld,
                  [=](int i, int j, int o) { W0[o] = ((i == j ? 1.f : 0.f) + S1[o]) + GU[o]; });
    tnewton_inv<T>(W0, CUI, n, ld, p.it2, w, red);
    PHASE(6);

    // cuiec = cui (e c^T / B); the peers' e c^T partials are still in place.
    float* EC = w[0];
    cluster_sum<T>(EC, P1, n, ld, scale2, nrank);
    cluster_arrive();            // done reading the peers' P0, P1
    float* CUIEC = GU;
    tmm<T>(CUI, EC, CUIEC, n, ld, Plain());
    PHASE(7);

    // Pass 2: Xi~^T = (c - cuiec^T e) / sqrt(B), w1row = cu e / sqrt(B),
    // u1row = ef / sqrt(B), and the partial Grams Xi~^T Xi~, Xi~^T w1row^T.
    zero_acc(g1);
    zero_acc(g2);
    for (int s0 = c0; s0 < c1; s0 += CL_SW) {
        stage<1>({sx}, {p.e}, n, d, s0, c1);
        float cr[2][4], er[2][4];       // this thread's c and ef, loaded early
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = rg + 32 * r, col = s0 + c4 + j;
                const bool in = i < n && col < c1;
                const size_t o = (size_t)i * d + col;
                cr[r][j] = in ? p.c[o] : 0.f;
                er[r][j] = in ? p.ef[o] : 0.f;
            }
        __syncthreads();
        float ax[2][4], aw[2][4];
        left_slab2<true, false>(CUIEC, sx, CU, sx, ld, n, ax, aw);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = rg + 32 * r;
            if (i >= n) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int dd = c4 + j, col = s0 + dd;
                float xv = 0.f, wv = 0.f;
                if (col < c1) {
                    const size_t o = (size_t)i * d + col;
                    xv = (cr[r][j] - ax[r][j]) * zc;
                    wv = aw[r][j] * zc;
                    p.xim[o] = xv;
                    p.sw[o] = wv;
                    p.su[o] = er[r][j] * zc;
                }
                sy[i * CL_SLD + dd] = xv;
                sz[i * CL_SLD + dd] = wv;
            }
        }
        __syncthreads();
        gram_slab<T>(sy, sy, sz, n, g1, g2);
        __syncthreads();
    }
    cluster_wait();              // the peers are done reading P0, P1
    PHASE(8);
    store_partial<T>(P0, g1, n, ld);
    store_partial<T>(P1, g2, n, ld);
    cluster_sync_all();
    PHASE(9);

    // Phase 2 on I - Gv, Gv = Xi~^T Xi~.
    cluster_sum<T>(W0, P0, n, ld, 1.f, nrank);
    tsymmetrize<T>(W0, n, ld);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) - W0[o]; });
    float* S2 = S1;
    tns_sqrt<T>(W0, S2, n, ld, p.it3, w, red);
    PHASE(10);
    tsymmetrize<T>(S2, n, ld);
    const float res2 = trel_residual<T>(S2, W0, w[0], n, ld, red);
    each_entry<T>(n, ld, [=](int i, int j, int o) { W0[o] = (i == j ? 1.f : 0.f) + S2[o]; });
    float* CV = CUI;
    tnewton_inv<T>(W0, CV, n, ld, p.it4, w, red);
    PHASE(11);
    const bool good = (res1 < p.tol) && (res2 < p.tol);

    // Q = Xi~^T w1row^T - cuiec^T, so that
    // fw1xi^T = [-gamma ef + t/(1+rho) + Q ef] / sqrt(B)
    //        = ximf^T + (Xi~^T w1row^T) u1row   (fused_step.py:341-342);
    // and cv = -(I + S2)^{-1}.
    cluster_sum<T>(W0, P1, n, ld, 1.f, nrank);
    cluster_arrive();            // done reading the peers' P0, P1
    each_entry<T>(n, ld, [=](int i, int k, int o) {
        W0[o] -= CUIEC[k * ld + i];
        CV[o] = -CV[o];
    });
    PHASE(12);

    // Pass 3: the stacked rows' second halves, fw1xi^T and cv Xi~^T, and the
    // mean with its select: mu' = mu + mean_b dmu_b where accepted,
    // dmu_b = (t + ef + ef w/den) / (1 + rho), each column's rows in order.
    {
        float* su = p.su + (size_t)n * d;
        float* sw = p.sw + (size_t)n * d;
        for (int s0 = c0; s0 < c1; s0 += CL_SW) {
            stage<3>({sx, sy, sz}, {p.ef, p.xim, p.t}, n, d, s0, c1);
            __syncthreads();
            float aq[2][4], av[2][4];
            left_slab2<false, false>(W0, sx, CV, sy, ld, n, aq, av);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = rg + 32 * r;
                if (i >= n) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int dd = c4 + j, col = s0 + dd;
                    if (col >= c1) continue;
                    const size_t o = (size_t)i * d + col;
                    su[o] = (-s_gamma[i] * sx[i * CL_SLD + dd] + s_inv1r[i] * sz[i * CL_SLD + dd] +
                             aq[r][j]) * zc;
                    sw[o] = av[r][j];
                }
            }
            const int col = s0 + threadIdx.x;
            if (threadIdx.x < CL_SW && col < c1) {
                float s = 0.f;
                for (int b = 0; b < n; ++b) {
                    const float e = sx[b * CL_SLD + threadIdx.x];
                    s += ((sz[b * CL_SLD + threadIdx.x] + e) + e * s_wden[b]) * s_inv1r[b];
                }
                const float m = p.mean_in[col];
                p.mean_out[col] = good ? m + s / (float)n : m;
            }
            __syncthreads();
        }
    }
    PHASE(13);
    if (rank == 0 && threadIdx.x == 0) {
        *p.good = good ? 1 : 0;
        if (p.nacc != nullptr) *p.nacc += good ? 1 : 0;
    }
    cluster_wait();              // no block leaves while a peer reads its partials
    PHASE(14);
}

size_t smem_bytes(int b) {
    const size_t ld = (size_t)((b + 3) & ~3);
    return sizeof(float) * (CL_NMAT * ld * ld + 3 * ld * CL_SLD + 32 + 6 * ld);
}

template <int T>
cudaError_t launch_cluster(const ClusterArgs& p, int ranks, int reps, cudaStream_t stream) {
    // Above 48 KB needs the opt-in, a function attribute: it covers every
    // later launch of this instantiation (B up to 16 T).
    static bool smem_opt_in = false;
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            eps_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(16 * T));
        if (err != cudaSuccess) return err;
        smem_opt_in = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ranks, reps, 1);
    cfg.blockDim = dim3(SC_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(p.b);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, eps_cluster_kernel<T>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// One instantiation's C entry: args points to a ClusterArgs.  With
// GSMVI_PHASE_STAMPS, name_phases copies its phase timestamps into out.
#ifdef GSMVI_PHASE_STAMPS
#define GSMVI_EPS_CLUSTER_PHASES(name)                                                        \
    extern "C" int name##_phases(long long* out) {                                           \
        return (int)cudaMemcpyFromSymbol(out, phase_ns, sizeof(phase_ns));                    \
    }
#else
#define GSMVI_EPS_CLUSTER_PHASES(name)
#endif
#define GSMVI_EPS_CLUSTER_ENTRY(name, T)                                                      \
    extern "C" int name(const void* args, int ranks, int reps, void* stream) {               \
        return (int)launch_cluster<T>(*static_cast<const ClusterArgs*>(args), ranks, reps,    \
                                      static_cast<cudaStream_t>(stream));                      \
    }                                                                                         \
    GSMVI_EPS_CLUSTER_PHASES(name)

}  // namespace

