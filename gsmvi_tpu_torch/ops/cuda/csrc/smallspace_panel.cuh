// Row-panel primitives of the large-batch small spaces on a thread-block
// cluster (eps_smallspace_panel.cu, B 65-128; bam_smallspace_panel*.cu,
// kpad = B + 8 in 65-136): the (n, n) matrices of the chains split into row
// panels over the blocks' shared memory (mirrored in L2), products, the
// symmetrisation and transposition across panels, the row-sum norm seed, the
// relative residual, the coupled Newton-Schulz iterations and the
// Newton-Hotelling inverse, the Grams of (rows, D) tensors in device memory
// and the products of a panel with such rows.
//
// They replace, at these sizes, the Pallas helpers `_spd_norm_ub` (:189),
// `_ns_sqrt` (:198) and `_newton_inv` (:214) of
// gsmvi_tpu/ops/pallas/fused_step.py and `_ns_sqrt_both` (:176) of
// gsmvi_tpu/ops/pallas/bam_fused.py, and the row work around them.
//
// Layout: PN_RANKS = 16 blocks per cluster (blockIdx.x = rank; a
// non-portable cluster size, fixed at compile time), block r owning rows
// [r R, r R + nr) of every (n, n) matrix, R = ceil(n / 16), as an (R, ld)
// panel in its shared memory (blocks past the last row hold none); ld =
// pn_ld(n), and zeros outside the matrix, which every function here keeps.
// Each panel is mirrored into a per-replica workspace in device memory (an
// (ld, ld) matrix per panel, L2-resident), written with the panel, for the
// peers to read.
//
// A product C = A B: block r copies B's n rows from the mirror, in row
// (rank) order, into one (n, ld) staging matrix (16-byte loads past L1,
// sixteen in flight per thread), then forms its own panel C_r = A_r B from
// its panel A_r, every output one fused multiply-add chain with k ascending,
// the
// order of a one-block product (mm_acc says how the threads share it).
// The all-gather goes through L2 and not through distributed shared
// memory: copying the peers' panels from their shared memory measured ~4.5
// us per (128, 128) product on an H100 (~14 GB/s into each SM), the copy
// from L2 ~1 us; copying it in four cp.async chunks behind the product's
// first chunks measured slower (PERF.md).
// Cluster
// barriers (arrive.release / wait.acquire) come before each phase that
// reads a peer's rows, never inside one; a phase never writes the panel it
// reads remotely (no product, symmetrisation or transposition is in place
// across blocks), so one barrier per phase
// suffices.  Scalars (norm bounds, residual sums, trace sums) are reduced
// in each block, published in a ring of slots and combined by every block
// in rank order, so every block holds the same bits and the gates agree.
#pragma once

#include <cooperative_groups.h>

#include "smallspace.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PN_THREADS = 256;
constexpr int PN_RANKS = 16;             // blocks per cluster, never a function of D or K
constexpr int PN_SLAB = 128;              // D columns of a row slab, d's of a Gram slab
constexpr int PN_SA_LD = PN_SLAB + 4;     // a Gram's staged A rows
constexpr int PN_NSLOT = 4;               // scalar exchange slots (ring)
constexpr int PN_PHASES = 12;

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel panel): thread 0 of each block of
// replica 0 writes the global timer (ns) at PN_PHASE(k).
#ifdef GSMVI_PHASE_STAMPS
__device__ long long phase_ns[PN_RANKS * PN_PHASES];
#define PN_PHASE(k)                                                               \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.y == 0) {                                \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            phase_ns[blockIdx.x * PN_PHASES + (k)] = t_;                          \
        }                                                                         \
    } while (0)
#define GSMVI_PANEL_PHASES(name)                                                  \
    extern "C" int name##_phases(long long* out) {                               \
        return (int)cudaMemcpyFromSymbol(out, phase_ns, sizeof(phase_ns));        \
    }
#else
#define PN_PHASE(k) \
    do {            \
    } while (0)
#define GSMVI_PANEL_PHASES(name)
#endif

__host__ __device__ constexpr int pn_round4(int x) { return (x + 3) & ~3; }

// The panels' leading dimension: n rounded up to a multiple of 4 whose
// quarter is odd, so that 8 consecutive rows' 16-byte quads fall in distinct
// banks.
__host__ __device__ constexpr int pn_ld(int n) {
    return (pn_round4(n) / 4) % 2 == 1 ? pn_round4(n) : pn_round4(n) + 4;
}

// Floats of a replica's mirror workspace: an (ld, ld) matrix per panel.
__host__ __device__ constexpr long long pn_ws_floats(int n, int nmat) {
    return (long long)nmat * pn_ld(n) * pn_ld(n);
}

__host__ __device__ constexpr int pn_rows(int n) { return (n + PN_RANKS - 1) / PN_RANKS; }

// Floats of the staging matrix: a gathered (n, n) matrix at leading
// dimension ld, a Gram's slab of ld rows at leading dimension PN_SA_LD, or a
// row slab (round_up(rows, 4) <= ld, PN_SLAB).
__host__ __device__ constexpr int pn_fb_floats(int n) {
    return pn_ld(n) * (pn_ld(n) > PN_SA_LD ? pn_ld(n) : PN_SA_LD);
}

// Floats of the shared-memory layout: nmat panels, the staging matrix, the
// Gram's A slab, `extra` floats of the kernel's own, the exchange slots
// and the block-reduction scratch.
__host__ __device__ constexpr int pn_smem_floats(int n, int nmat, int extra) {
    return nmat * pn_rows(n) * pn_ld(n) + pn_fb_floats(n) + pn_rows(n) * PN_SA_LD
           + pn_round4(extra) + 2 * PN_NSLOT + 32;
}

struct PanelCtx {
    float* panels;  // the first panel; panel k lies k pm floats further
    float* gm;      // the panels' mirrors in device memory, (ld, ld) each
    int pm;         // floats per panel
    int n;          // matrix order
    int ld;         // panels' leading dimension (pn_ld): a product's k depth
    int R;          // rows per block
    int rank;
    int row0, nr;   // this block's first row and its row count
    float* fb;      // staging matrix
    float* sa;      // a Gram's A slab, (R, PN_SA_LD)
    float* slots;   // (PN_NSLOT, 2) exchange slots
    float* red;     // 32 floats of block-reduction scratch
    int slot;       // next exchange slot, the same in every thread
};

// Carve the layout of pn_smem_floats out of smem: panels M[0..nmat), then
// the staging matrix, the A slab, `extra` (returned) and the slots; gm is
// this replica's mirror workspace (pn_ws_floats).
__device__ float* pn_setup(PanelCtx& g, float* smem, float* gm, int n, int nmat, int extra,
                           float** M) {
    g.n = n;
    g.ld = pn_ld(n);
    g.rank = static_cast<int>(cg::this_cluster().block_rank());
    g.R = pn_rows(n);
    g.row0 = g.rank * g.R;
    g.nr = max(0, min(n, g.row0 + g.R) - g.row0);
    const int pm = g.R * g.ld;
    g.panels = smem;
    g.gm = gm;
    g.pm = pm;
    for (int i = 0; i < nmat; ++i) M[i] = smem + i * pm;
    g.fb = smem + nmat * pm;
    g.sa = g.fb + pn_fb_floats(n);
    float* ex = g.sa + g.R * PN_SA_LD;
    g.slots = ex + pn_round4(extra);
    g.red = g.slots + 2 * PN_NSLOT;
    g.slot = 0;
    const int total = pn_smem_floats(n, nmat, extra);
    for (int idx = threadIdx.x; idx < total; idx += PN_THREADS) smem[idx] = 0.f;
    __syncthreads();
    return ex;
}

__device__ __forceinline__ void pn_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void pn_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A full cluster barrier: every block's earlier writes (shared and device
// memory) are visible to every block after it, and every block's earlier
// remote reads are done.
__device__ __forceinline__ void pn_sync() {
    pn_arrive();
    pn_wait();
}

// Rank q's copy of the shared-memory address p (the same offset).
__device__ __forceinline__ const float* pn_peer(const float* p, int q) {
    return cg::this_cluster().map_shared_rank(const_cast<float*>(p), q);
}

__device__ __forceinline__ void pn_load4(float (&r)[4], const float* ptr) {
    const float4 v = *reinterpret_cast<const float4*>(ptr);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

// f(global row, column, offset) for every entry of this block's panel;
// then a block barrier.
template <class F>
__device__ void each_local(const PanelCtx& g, F f) {
    for (int idx = threadIdx.x; idx < g.nr * g.n; idx += PN_THREADS) {
        const int i = idx / g.n, j = idx - i * g.n;
        f(g.row0 + i, j, i * g.ld + j);
    }
    __syncthreads();
}

// The mirror of the panel M: the whole (ld, ld) matrix in device memory.
__device__ __forceinline__ float* pn_mirror(const PanelCtx& g, const float* M) {
    return g.gm + (size_t)((M - g.panels) / g.pm) * g.ld * g.ld;
}

// Copy this block's rows of the panel M into its mirror (after local
// writes; a cluster barrier before any peer reads it).
__device__ void pn_flush(const PanelCtx& g, const float* M) {
    float4* dst = reinterpret_cast<float4*>(pn_mirror(g, M) + (size_t)g.row0 * g.ld);
    const float4* src = reinterpret_cast<const float4*>(M);
    for (int idx = threadIdx.x; idx < g.nr * (g.ld >> 2); idx += PN_THREADS) dst[idx] = src[idx];
}

// fb[k][:] = row k of the cluster's matrix whose panels lie at M, k < n, at
// leading dimension ld, from its mirror (16-byte loads past L1, sixteen in
// flight per thread); rows n..ld-1 zero.
__device__ void pn_gather(const PanelCtx& g, const float* M) {
    constexpr int G = 16;
    const float4* src = reinterpret_cast<const float4*>(pn_mirror(g, M));
    const int live = g.n * (g.ld >> 2), total = g.ld * (g.ld >> 2);
    float4* dst = reinterpret_cast<float4*>(g.fb);
    for (int base = threadIdx.x; base < total; base += G * PN_THREADS) {
        float4 v[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int idx = base + u * PN_THREADS;
            v[u] = idx < live ? __ldcg(src + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int idx = base + u * PN_THREADS;
            if (idx < total) dst[idx] = v[u];
        }
    }
}

// Copy rows [0, rows) x columns [0, w4) of a row tensor in device memory
// into shared memory: dst[r ldd + c] = X[(row0 + r) d + c0 + c] for r <
// live_rows and c0 + c < d, else 0; w4 a multiple of 4.  Asynchronous
// copies (cp.async) that bypass the registers, so a thread keeps dozens in
// flight: 16 bytes each where d and X's rows allow it, else 4.  Then a
// block barrier.  (Loads through registers, a few in flight per thread,
// staged a slab at ~9 GB/s into an SM on an H100.)
__device__ void pn_stage(float* dst, int ldd, const float* X, int d, int row0, int rows,
                         int live_rows, int c0, int w4) {
    const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (d % 4 == 0 && (reinterpret_cast<size_t>(X) & 15) == 0 && ldd % 4 == 0) {
        const int q4 = w4 >> 2;
        for (int idx = threadIdx.x; idx < rows * q4; idx += PN_THREADS) {
            const int r = idx / q4, c = 4 * (idx - r * q4);
            const bool live = r < live_rows && c0 + c < d;
            const float* src = live ? X + (size_t)(row0 + r) * d + c0 + c : X;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                             sbase + 4u * (r * ldd + c)),
                         "l"(src), "r"(live ? 16 : 0));
        }
    } else {
        for (int idx = threadIdx.x; idx < rows * w4; idx += PN_THREADS) {
            const int r = idx / w4, c = idx - r * w4;
            const bool live = r < live_rows && c0 + c < d;
            const float* src = live ? X + (size_t)(row0 + r) * d + c0 + c : X;
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                             sbase + 4u * (r * ldd + c)),
                         "l"(src), "r"(live ? 4 : 0));
        }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
}

// The thread tile: warp w (tid / 32) and lane (rl, cl) = (lane % 8, lane /
// 8) own rows rl + 8x (x < TR) and the column quads q = cl + 4w + 32c
// (c < NC), columns 4q..4q+3: a warp covers 8 TR rows and 16 columns of
// each 128-column block.  Per 4-deep k step a thread loads TR row quads of
// A (the warp's 8 distinct rows fall in distinct banks, as lda / 4 is odd)
// and 4 column quads of B (64 consecutive bytes per warp): 6 wavefronts a
// warp for 32 fused multiply-adds a thread at TR = 2, so the FMA pipes and
// not shared memory bound the product.
template <int TR, int NC>
using PnAcc = float[TR][NC][4];

// acc += A[i][0:k4] B[0:k4][j] over this thread's tile, k ascending in one
// fused multiply-add chain per output, k4 a multiple of 4.  A: leading
// dimension lda, 16-byte rows, rows clamped to amax.  B: B[k][j] at
// B[k ldb + j], or, with BT, at B[j ldb + k] (B^T stored, its rows 16-byte
// quads along k).  Column quads past ncols are skipped when a warp holds
// none below ncols; their starts are clamped to jlast (the last quad start
// B holds).
template <int TR, int NC, bool BT = false>
__device__ __forceinline__ void mm_acc(const float* A, int lda, const float* B, int ldb, int k4,
                                       int amax, int ncols, int jlast, PnAcc<TR, NC>& acc) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int rl = lane & 7, cl = lane >> 3;
    const float* ap[TR];
#pragma unroll
    for (int x = 0; x < TR; ++x) ap[x] = A + min(rl + 8 * x, amax) * lda;
    // b[q][y] = B[k + q][j0 + y] for the k step at kk.
    auto load_b = [&](float (&b)[4][4], const float* bp, int kk) {
        if constexpr (BT) {
            float t[4][4];
#pragma unroll
            for (int y = 0; y < 4; ++y) pn_load4(t[y], bp + y * ldb + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int y = 0; y < 4; ++y) b[q][y] = t[y][q];
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) pn_load4(b[q], bp + (kk + q) * ldb);
        }
    };
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        if (16 * w + 128 * c >= ncols) continue;       // the whole warp: no live column
        const int j0 = min(4 * (cl + 4 * w + 32 * c), jlast);
        const float* bp = BT ? B + j0 * ldb : B + j0;
        // Registers double-buffered: the next k step's quads load while this
        // step's fused multiply-adds run.
        float a[TR][4], b[4][4];
#pragma unroll
        for (int x = 0; x < TR; ++x) pn_load4(a[x], ap[x]);
        load_b(b, bp, 0);
#pragma unroll 2
        for (int k = 0; k < k4; k += 4) {
            const int kn = k + 4 < k4 ? k + 4 : k;
            float an[TR][4], bn[4][4];
#pragma unroll
            for (int x = 0; x < TR; ++x) pn_load4(an[x], ap[x] + kn);
            load_b(bn, bp, kn);
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int x = 0; x < TR; ++x)
#pragma unroll
                    for (int y = 0; y < 4; ++y) acc[x][c][y] = fmaf(a[x][q], b[q][y], acc[x][c][y]);
#pragma unroll
            for (int x = 0; x < TR; ++x)
#pragma unroll
                for (int q = 0; q < 4; ++q) a[x][q] = an[x][q];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int y = 0; y < 4; ++y) b[q][y] = bn[q][y];
        }
    }
}

// f(local row i, column j, acc) for this thread's live tile entries, i < nr
// and j < ncols.
template <int TR, int NC, class F>
__device__ __forceinline__ void each_tile(const PnAcc<TR, NC>& acc, int nr, int ncols, F f) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int rl = lane & 7, cl = lane >> 3;
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
                const int i = rl + 8 * x, j = 4 * (cl + 4 * w + 32 * c) + y;
                if (i < nr && j < ncols) f(i, j, acc[x][c][y]);
            }
}

// C[i][j] = epi(global row, j, acc) over this block's panel, and into
// its mirror.
template <int TR, int NC, class Epi>
__device__ __forceinline__ void store_panel(const PanelCtx& g, float* C, const PnAcc<TR, NC>& acc,
                                            Epi epi) {
    float* cm = pn_mirror(g, C) + (size_t)g.row0 * g.ld;
    each_tile<TR, NC>(acc, g.nr, g.n, [&](int i, int j, float a) {
        const float c = epi(g.row0 + i, j, a);
        C[i * g.ld + j] = c;
        cm[i * g.ld + j] = c;
    });
}

// C_r = epi(A_r B): stages B from its mirror (call after a cluster barrier
// that follows B's last write); C is neither A nor B.
template <int TR, int NC, class Epi>
__device__ void pmm(const PanelCtx& g, const float* A, const float* B, float* C, Epi epi) {
    pn_gather(g, B);
    __syncthreads();
    PnAcc<TR, NC> acc = {};
    mm_acc<TR, NC>(A, g.ld, g.fb, g.ld, g.ld, g.R - 1, g.n, g.ld - 4, acc);
    store_panel<TR, NC>(g, C, acc, epi);
    __syncthreads();
}

// dst = f(i, j, v(i, j, M[i][j], M[j][i])) over this block's panel, M^T's
// entries read from M's mirror (call after a barrier; dst is not M), and
// dst into its mirror.
template <class F>
__device__ void ptransform(const PanelCtx& g, const float* M, float* dst, F f) {
    constexpr int G = 8;
    const float* mg = pn_mirror(g, M);
    float* dg = pn_mirror(g, dst) + (size_t)g.row0 * g.ld;
    const int total = g.nr * g.n;
    for (int base = threadIdx.x; base < total; base += G * PN_THREADS) {
        float mt[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int idx = base + u * PN_THREADS;
            mt[u] = 0.f;
            if (idx < total) {
                const int i = idx / g.n, j = idx - i * g.n;
                mt[u] = __ldcg(mg + (size_t)j * g.ld + g.row0 + i);
            }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
            const int idx = base + u * PN_THREADS;
            if (idx < total) {
                const int i = idx / g.n, j = idx - i * g.n, o = i * g.ld + j;
                const float r = f(g.row0 + i, j, M[o], mt[u]);
                dst[o] = r;
                dg[o] = r;
            }
        }
    }
    __syncthreads();
}

// dst = f(i, j, 0.5 (M + M^T)) (the diagonal kept as it is).
template <class F>
__device__ void psym(const PanelCtx& g, const float* M, float* dst, F f) {
    ptransform(g, M, dst, [=](int gi, int j, float m, float mt) {
        return f(gi, j, gi == j ? m : 0.5f * (m + mt));
    });
}

// dst = the panel of M^T: dst[i][k] = M[k][row0 + i].
__device__ void ptrans(const PanelCtx& g, const float* M, float* dst) {
    ptransform(g, M, dst, [](int, int, float, float mt) { return mt; });
}

// Publish (a, b) in this block's next slot and return its index; a
// cluster barrier follows, so every block's pair is visible.  A slot is
// written again only PN_NSLOT exchanges later, each behind its own barrier,
// so no peer still reads it.
__device__ int pn_publish(PanelCtx& g, float a, float b) {
    const int s = g.slot;
    g.slot = (s + 1) % PN_NSLOT;
    if (threadIdx.x == 0) {
        g.slots[2 * s] = a;
        g.slots[2 * s + 1] = b;
    }
    pn_sync();
    return s;
}

// The cluster's max of each block's x, every block alike.
__device__ float cluster_max(PanelCtx& g, float x) {
    const int s = pn_publish(g, x, 0.f);
    float m = 0.f;
    for (int q = 0; q < PN_RANKS; ++q) m = nan_max(m, pn_peer(g.slots, q)[2 * s]);
    return m;
}

// The cluster's sums of each block's (a, b), in rank order.
__device__ float2 cluster_sum2(PanelCtx& g, float a, float b) {
    const int s = pn_publish(g, a, b);
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < PN_RANKS; ++q) {
        const float* p = pn_peer(g.slots, q) + 2 * s;
        sa += p[0];
        sb += p[1];
    }
    return make_float2(sa, sb);
}

// `_spd_norm_ub`: the max over rows of the row sum of |A|, + 1e-30; a warp
// per local row (lane partials, then a butterfly), the max over the cluster.
__device__ float norm_ub(PanelCtx& g, const float* A) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float mx = 0.f;
    for (int i = warp; i < g.nr; i += PN_THREADS / 32) {
        float s = 0.f;
        for (int j = lane; j < g.n; j += 32) s += fabsf(A[i * g.ld + j]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mx = nan_max(mx, s);
    }
    return cluster_max(g, block_max(mx, g.red)) + 1e-30f;
}

// sum((S S - A)^2) / (sum(A^2) + 1e-30), W scratch; S's last write precedes
// a barrier inside.
template <int TR, int NC>
__device__ float rel_residual(PanelCtx& g, const float* S, const float* A, float* W) {
    pn_sync();
    pmm<TR, NC>(g, S, S, W, Plain());
    float num = 0.f, den = 0.f;
    for (int idx = threadIdx.x; idx < g.nr * g.n; idx += PN_THREADS) {
        const int i = idx / g.n, o = i * g.ld + idx - i * g.n;
        const float r = W[o] - A[o];
        num += r * r;
        den += A[o] * A[o];
    }
    num = block_sum(num, g.red);
    den = block_sum(den, g.red);
    const float2 t = cluster_sum2(g, num, den);
    return t.x / (t.y + 1e-30f);
}

// Coupled Newton-Schulz on the cluster's SPD A (`_ns_sqrt_both`): the Y
// iterate times sqrt(norm) into out_y (sqrt(A)), the Z iterate over
// sqrt(norm) into out_z (A^{-1/2}), either null; w[0..4] scratch panels.
// The last step forms only the products its outputs need.
template <int TR, int NC>
__device__ void pns(PanelCtx& g, const float* A, float* out_y, float* out_z, int iters,
                    float* const* w) {
    const float nrm = norm_ub(g, A);
    const float sq = sqrtf(nrm);
    float* Y = w[0];
    float* Z = w[1];
    float* Tm = w[2];
    float* Y2 = w[3];
    float* Z2 = w[4];
    each_local(g, [=](int gi, int j, int o) {
        Y[o] = A[o] / nrm;
        Z[o] = gi == j ? 1.f : 0.f;
    });
    pn_flush(g, Y);
    pn_flush(g, Z);
    for (int it = 0; it < iters; ++it) {
        const bool last = it + 1 == iters;
        pn_sync();
        pmm<TR, NC>(g, Z, Y, Tm,
                    [](int gi, int j, float acc) { return 0.5f * ((gi == j ? 3.f : 0.f) - acc); });
        pn_sync();
        if (!last || out_y != nullptr)
            pmm<TR, NC>(g, Y, Tm, last ? out_y : Y2,
                        [=](int, int, float acc) { return last ? acc * sq : acc; });
        if (!last || out_z != nullptr)
            pmm<TR, NC>(g, Tm, Z, last ? out_z : Z2,
                        [=](int, int, float acc) { return last ? acc / sq : acc; });
        float* tmp = Y; Y = Y2; Y2 = tmp;
        tmp = Z; Z = Z2; Z2 = tmp;
    }
    if (iters == 0) {
        each_local(g, [=](int, int, int o) {
            if (out_y != nullptr) out_y[o] = Y[o] * sq;
            if (out_z != nullptr) out_z[o] = Z[o] / sq;
        });
        if (out_y != nullptr) pn_flush(g, out_y);
        if (out_z != nullptr) pn_flush(g, out_z);
    }
}

// Newton-Hotelling inverse of the cluster's SPD A (`_newton_inv`) into out;
// w[0..2] scratch panels.
template <int TR, int NC>
__device__ void pnewton(PanelCtx& g, const float* A, float* out, int iters, float* const* w) {
    const float inv_ub = 1.f / norm_ub(g, A);
    float* X = iters > 0 ? w[0] : out;
    float* Tm = w[1];
    float* X2 = w[2];
    each_local(g, [=](int gi, int j, int o) { X[o] = gi == j ? inv_ub : 0.f; });
    pn_flush(g, X);
    for (int it = 0; it < iters; ++it) {
        pn_sync();
        pmm<TR, NC>(g, A, X, Tm,
                    [](int gi, int j, float acc) { return (gi == j ? 2.f : 0.f) - acc; });
        pn_sync();
        float* dst = it + 1 < iters ? X2 : out;
        pmm<TR, NC>(g, X, Tm, dst, Plain());
        X2 = X;
        X = dst;
    }
}

// dst = scale * X_r Y^T over all of D: X (xrows, d), Y (yrows, d) in device
// memory (row stride d; rows past xrows / yrows count as zero; a peer may
// have written them in this launch, behind a cluster barrier), X_r this
// block's rows of X, staged 128 columns at a time (Y transposed).  Each
// entry is one fused multiply-add chain over d ascending, then the scale.
template <int TR, int NC>
__device__ void gram(const PanelCtx& g, const float* X, int xrows, const float* Y, int yrows,
                     int d, float scale, float* dst) {
    PnAcc<TR, NC> acc = {};
    for (int d0 = 0; d0 < d; d0 += PN_SLAB) {
        const int kk = min(PN_SLAB, pn_round4(d - d0));
        pn_stage(g.sa, PN_SA_LD, X, d, g.row0, g.R, min(g.nr, xrows - g.row0), d0, kk);
        pn_stage(g.fb, PN_SA_LD, Y, d, 0, g.ld, yrows, d0, kk);
        mm_acc<TR, NC, true>(g.sa, PN_SA_LD, g.fb, PN_SA_LD, kk, g.R - 1, g.n, g.ld - 4, acc);
        __syncthreads();
    }
    store_panel<TR, NC>(g, dst, acc, [=](int, int, float a) { return a * scale; });
    __syncthreads();
}

// For this block's rows gi < mrows and every column col < d:
// e1(gi, col, sum_k S1[gi][k] X[k][col]) and, with S2, e2 likewise; k <
// xrows, X (xrows, d) in device memory, S1, S2 local panels; the two
// products share each staged 128-column slab of X.
template <int TR, int NC, class E1, class E2>
__device__ void rowprod2(const PanelCtx& g, const float* S1, const float* S2, const float* X,
                         int xrows, int d, int mrows, E1 e1, E2 e2) {
    const int x4 = pn_round4(xrows);
    for (int d0 = 0; d0 < d; d0 += PN_SLAB) {
        const int w = min(PN_SLAB, d - d0);
        pn_stage(g.fb, PN_SLAB, X, d, 0, x4, xrows, d0, pn_round4(w));
        PnAcc<TR, NC> a1 = {}, a2 = {};
        mm_acc<TR, NC>(S1, g.ld, g.fb, PN_SLAB, x4, g.R - 1, w, PN_SLAB - 4, a1);
        if (S2 != nullptr)
            mm_acc<TR, NC>(S2, g.ld, g.fb, PN_SLAB, x4, g.R - 1, w, PN_SLAB - 4, a2);
        const int nr = min(g.nr, mrows - g.row0);
        each_tile<TR, NC>(a1, nr, w, [&](int i, int c, float a) { e1(g.row0 + i, d0 + c, a); });
        if (S2 != nullptr)
            each_tile<TR, NC>(a2, nr, w, [&](int i, int c, float a) { e2(g.row0 + i, d0 + c, a); });
        __syncthreads();
    }
}

// Set the launch attributes of a panel kernel once: the dynamic shared
// memory opt-in (up to `smem` bytes) and the non-portable cluster of 16.
template <class Kern>
cudaError_t pn_attributes(Kern kern, size_t smem, int* set_bytes) {
    if ((int)smem <= *set_bytes) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *set_bytes = (int)smem;
    return cudaSuccess;
}

inline cudaLaunchConfig_t pn_config(int reps, size_t smem, cudaStream_t stream,
                                    cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(PN_RANKS, reps, 1);
    cfg.blockDim = dim3(PN_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = PN_RANKS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// How many clusters of PN_RANKS blocks with `smem` bytes each the card can
// hold at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
template <class Kern>
long long pn_max_clusters(Kern kern, size_t smem, int* set_bytes) {
    cudaError_t err = pn_attributes(kern, smem, set_bytes);
    if (err != cudaSuccess) return -(long long)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = pn_config(1, smem, nullptr, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return -(long long)err;
    return clusters;
}

}  // namespace
