// Exact (Cholesky) small space of the eps-coordinate GSM update (K4a), the
// kernel template; eps_chol.cu holds the entry and the instantiation for
// B <= 32 (T = 4), eps_chol_b64.cu the one for 32 < B <= 64 (T = 8).
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_update_core` (:350)
// with `_cholt_inplace` (:142) and `_triu_inv_inplace` (:170): the body of
// `gsm_eps_update_fused(method="chol")` (`_update_kernel`, :421) and of
// `make_fused_eps_step(method="chol")` (:586).  With Z^T = [-e; c]/sqrt(B)
// and (F Z)^T = [a; bm]/sqrt(B) (2B rows each), the update is
//   G = Z^T Z (+ jitter (tr G / 2B + 1) I),  Lg^T = chol(G)^T,
//   K = I + Lg^T J Lg (J = diag(+1 x B, -1 x B)),  M = Lg^{-T},
//   Ck^T = chol(K)^T with its minimum pivot (good = minpiv > 0),
//   S2 = M (Ck^T - I)^T M^T,  F' = F + (F Z) S2 Z^T.
// The caller runs vf = v F and t = vf F^T on the split-k thin product
// (thin_gemm.cu) before, and the fat apply with the factor select
// (gemm.cu) after; everything between is this one launch.
//
// What bounds it on an H100: not FLOPs (27 MFLOP at B=32, D=256) and not
// bytes, but the sequential small space: two (2B)-step Cholesky sweeps and
// a (2B)-step substitution, each step a dependent chain through shared
// memory, and three dense (2B)^3 products between them.  The design before
// this one took 393 us in the small space at B=32 (NVIDIA H100, phase
// stamps): one output per thread with j = idx % 2B across a warp, so each
// product's B-operand load `L[j * 2B + m]` fell in one bank 32 ways (71 us
// a product), the inverse's column dots 16 ways (69 us), and the two sweeps'
// 2 block barriers a column 38 us each.
//
// Design: one cluster of S = thin_split(D) blocks of 256 threads.
// - Rows and Gram (every rank, over its columns [r k_per, (r+1) k_per)):
//   the row scalars' partial dots (a warp per row), summed over the ranks
//   in rank order through distributed shared memory; then, 32 columns at a
//   time, Z^T and (F Z)^T to global memory and the rank's part of G =
//   Z^T Z in register tiles; the S parts of each G row are summed in rank
//   order by the rank that owns the row and stored into rank 0's W.
// - The small space (rank 0, the other ranks wait at a cluster barrier):
//   every (2B, 2B) matrix in shared memory with a padded row ld = 16 T + 4
//   (ld = 4 mod 8).  The three products are all of the form C = A Bt^T
//   (both operands read along rows, float4 along k): thread (ty, tx) owns
//   rows ty T + a and columns tx + 16 b, so a quarter warp reads 8
//   consecutive rows of Bt, 4 ld apart: 8 distinct 16-byte bank groups, no
//   conflict, and one broadcast row of A; T x T outputs per thread (T = 4
//   for 2B <= 64, 8 for 2B <= 128).  The Cholesky sweeps are blocked in
//   panels of CH_NB = 16 columns: one warp factors the panel's 16 rows in
//   registers (lane l holds columns l, l + 32, ...; the pivot and the
//   factor entries by shuffles; the 16 steps one branch-free block of code,
//   the pivot's reciprocal root rsqrt_nr), then all threads apply the
//   panel's rank-16 update to the upper trailing block in 4 x 4 tiles: 2
//   block barriers a panel, where the sweep before took 2 a column.  Each
//   entry still gets the same fused multiply-adds in the same order as the
//   right-looking sweep column by column.  The inverse runs from the bottom in blocks of
//   16 rows: the part of each row's dot over the rows below the block as a
//   product (rows of M read along columns: consecutive lanes, consecutive
//   addresses), then a thread per column substitutes the block's 16 rows
//   in registers, each solved row's terms added to the dots above it at
//   once: 2 barriers a block.
// - w = S2 Z^T and the mean (every rank, its columns): S2 copied from rank
//   0, Z^T staged 32 columns at a time, 4 x 4 register tiles.
// Sum orders: G's entries are chains over each rank's columns summed in
// rank order (G is symmetric bit for bit: both triangles sum the same
// products in the same order, so it needs no symmetrisation, nor does K);
// every small-space product and the sweeps' updates are single ascending
// chains, as the design before; the inverse's dot is the chain over the
// rows below the block, then the block's own rows descending.  The pivots'
// reciprocal roots and the inverse's reciprocals (rsqrt_nr, rcp_nr) are
// within an ulp of the IEEE quotients the design before took.
//
// NaN: a NaN score makes G, and then K, NaN.  The minimum pivot folds with a
// NaN-propagating compare (fminf would drop the NaN) and the pivot clamp
// max(piv, 1e-30) keeps a NaN, so a NaN pivot gives good = 0, as
// `jnp.minimum`/`jnp.maximum` do on the TPU.
#pragma once

#include <cooperative_groups.h>

#include "smallspace.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CH_THREADS = 256;
constexpr int CH_MAXB = 64;
constexpr int CH_MAX_RANKS = 8;      // the portable cluster size
constexpr int CH_NB = 16;            // panel width of the sweeps and the inverse
constexpr int CH_SLAB = 32;          // columns of D staged at a time
constexpr int CH_SLD = CH_SLAB + 4;  // staged slab row: 36 = 4 (mod 8)
constexpr int CH_MISC = 8;

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel chol, through the entry's `_phases`
// twin): thread 0 of rank 0 writes the global timer (ns) at CH_PHASE(k).
constexpr int CH_STAMPS = 10;
#ifdef GSMVI_PHASE_STAMPS
__device__ long long ch_phase_ns[CH_STAMPS];
#define CH_PHASE(k)                                                               \
    do {                                                                          \
        if (threadIdx.x == 0 && rank == 0) {                                      \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            ch_phase_ns[k] = t_;                                                  \
        }                                                                         \
    } while (0)
#else
#define CH_PHASE(k) \
    do {            \
    } while (0)
#endif

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

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

// 1/sqrt(x) and 1/x from the hardware's approximations (rsqrt.approx,
// rcp.approx: a few ulp) and one Newton step each, within an ulp of the
// correctly rounded value and without the IEEE routines' slow-path
// branches, which split a sweep's steps into blocks the compiler cannot
// overlap.  A NaN stays a NaN.
__device__ __forceinline__ float rsqrt_nr(float x) {
    const float y = rsqrtf(x);
    return fmaf(0.5f * y, fmaf(-x * y, y, 1.f), y);
}

__device__ __forceinline__ float rcp_nr(float x) {
    const float y = __fdividef(1.f, x);
    return fmaf(y, fmaf(-x, y, 1.f), y);
}

__device__ __forceinline__ void ld4(float (&r)[4], const float* ptr) {
    const float4 v = *reinterpret_cast<const float4*>(ptr);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

// (2B, 2B) matrices at tile T: R = 16 T rows held (2B <= R), row ld.
template <int T>
struct ChShape {
    static constexpr int R = 16 * T;
    static constexpr int LD = R + 4;
    static constexpr int Q = R / 32;   // columns a lane holds in a panel
};

struct CholArgs {
    const float* e;       // (B, D) draws
    const float* v;       // (B, D) scores
    const float* vf;      // (B, D) v F
    const float* t;       // (B, D) vf F^T
    const float* ef;      // (B, D) e F^T
    const float* mean_in;
    float* mean_out;      // may equal mean_in
    int* good;            // (1,) minpiv > 0
    int* nacc;            // optional (1,): += good
    float* zt;            // (2B, D) Z^T rows
    float* fzt;           // (2B, D) (F Z)^T rows, the fat apply's first operand
    float* w;             // (2B, D) S2 Z^T, the fat apply's second operand
    int n, d, k_per;
    float jitter;
};

template <int T>
constexpr size_t chol_smem_floats() {
    return 3 * (size_t)ChShape<T>::R * ChShape<T>::LD + 6 * CH_MAXB + CH_MISC;
}

// C[i][j] = epi(i, j, sum_m A'[i][m] Bt[j][m]) for i, j < k, m ascending
// over [0, round4(k)) (the padding adds exact zeros); A'[i][m] = A[i][m],
// times J_m = (m < npos ? 1 : -1) when SIGN.  C aliases neither operand.
template <int T, bool SIGN, class Epi>
__device__ void tmm_nt(const float* A, const float* Bt, float* C, int k, int npos, Epi epi) {
    constexpr int LD = ChShape<T>::LD;
    const int i0 = (threadIdx.x >> 4) * T, tx = threadIdx.x & 15;
    if (i0 < k) {
        float acc[T][T];
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int b = 0; b < T; ++b) acc[a][b] = 0.f;
        const int kr = (k + 3) & ~3;
#pragma unroll 2
        for (int m = 0; m < kr; m += 4) {
            float av[T][4], bv[T][4];
#pragma unroll
            for (int a = 0; a < T; ++a) ld4(av[a], A + (i0 + a) * LD + m);
#pragma unroll
            for (int b = 0; b < T; ++b) ld4(bv[b], Bt + (tx + 16 * b) * LD + m);
            if (SIGN) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float s = m + q < npos ? 1.f : -1.f;
#pragma unroll
                    for (int a = 0; a < T; ++a) av[a][q] *= s;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int a = 0; a < T; ++a)
#pragma unroll
                    for (int b = 0; b < T; ++b) acc[a][b] = fmaf(av[a][q], bv[b][q], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int b = 0; b < T; ++b) {
                const int i = i0 + a, j = tx + 16 * b;
                if (i < k && j < k) C[i * LD + j] = epi(i, j, acc[a][b]);
            }
    }
    __syncthreads();
}

// One warp factors the panel rows j0 .. j0 + 15 of W (columns from j0 on)
// into Lt, rows written whole, and folds the pivots into minpiv.  Lane l
// holds columns l + 32 q of the panel's rows in registers; all 16 columns
// of the panel lie in group q0, so the pivot and the factor entries of the
// panel's later rows come by shuffles.  Without TAIL the panel lies inside
// the matrix and the 16 steps are one branch-free block of code, so that a
// step's pivot chain may overlap the previous step's row updates.
template <int T, bool TAIL>
__device__ __forceinline__ float chol_panel(const float* W, float* Lt, int k, int j0,
                                            float minpiv) {
    constexpr int LD = ChShape<T>::LD, Q = ChShape<T>::Q;
    const int lane = threadIdx.x & 31;
    float s[CH_NB][Q];
#pragma unroll
    for (int jj = 0; jj < CH_NB; ++jj)
#pragma unroll
        for (int q = 0; q < Q; ++q)
            s[jj][q] = (!TAIL || j0 + jj < k) ? W[(j0 + jj) * LD + lane + 32 * q] : 0.f;
    const int q0 = j0 >> 5;
    // own: this lane's entry of the next pivot row in group q0; at lane
    // j & 31 the pivot, updated by the lane's own factor entry (the same
    // fmaf as the row's update below), so that the pivot's chain waits on
    // no shuffle but its own.
    float own = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q)
        if (q == q0) own = s[0][q];
#pragma unroll
    for (int jj = 0; jj < CH_NB; ++jj) {
        const int j = j0 + jj;
        if (TAIL && j >= k) break;
        const float piv = __shfl_sync(0xffffffffu, own, j & 31);
        minpiv = nan_min(minpiv, piv);
        const float inv = rsqrt_nr(nan_max(piv, 1e-30f));
        float lt[Q];
        float lt0 = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            lt[q] = (c >= j && c < k) ? s[jj][q] * inv : 0.f;
            Lt[j * LD + c] = lt[q];
            if (q == q0) lt0 = lt[q];
        }
        if (jj + 1 < CH_NB) {
            float next = 0.f;
#pragma unroll
            for (int q = 0; q < Q; ++q)
                if (q == q0) next = s[jj + 1][q];
            own = fmaf(-lt0, lt0, next);
        }
        // W[r][c] -= Lt[j][r] Lt[j][c] for the panel's later rows.
#pragma unroll
        for (int rr = jj + 1; rr < CH_NB; ++rr) {
            const float lr = __shfl_sync(0xffffffffu, lt0, (j0 + rr) & 31);
#pragma unroll
            for (int q = 0; q < Q; ++q) s[rr][q] = fmaf(-lr, lt[q], s[rr][q]);
        }
    }
    return minpiv;
}

// Right-looking Cholesky of the (k, k) SPD W in place (`_cholt_inplace`),
// blocked: the transposed factor L^T (upper) into Lt, rows j < k written
// whole (zeros left of the diagonal and from column k on); W's upper
// triangle destroyed.  Returns the minimum pivot, NaN when any pivot is
// NaN; scratch[0] carries it to every thread.
template <int T>
__device__ float chol_blocked(float* W, float* Lt, int k, float* scratch) {
    constexpr int LD = ChShape<T>::LD;
    float minpiv = INFINITY;
    for (int j0 = 0; j0 < k; j0 += CH_NB) {
        if (threadIdx.x < 32)
            minpiv = j0 + CH_NB <= k ? chol_panel<T, false>(W, Lt, k, j0, minpiv)
                                     : chol_panel<T, true>(W, Lt, k, j0, minpiv);
        __syncthreads();
        // The panel's rank-16 update of the upper trailing block, rows and
        // columns [base, k), in 4 x 4 tiles (tile row tr <= tile column tc):
        // consecutive threads take consecutive tile columns of one tile
        // row, so a warp's W and Lt row reads are consecutive float4s.
        const int base = j0 + CH_NB;
        if (base < k) {
            const int nt = (k - base + 3) >> 2;
            const int ntri = nt * (nt + 1) / 2;
            for (int idx = threadIdx.x; idx < ntri; idx += CH_THREADS) {
                // idx = i (i + 1) / 2 + j with j <= i; tr = nt-1-i, tc = nt-1-j.
                int i = (int)((sqrtf(8.f * (float)idx + 1.f) - 1.f) * 0.5f);
                while (i * (i + 1) / 2 > idx) --i;
                while ((i + 1) * (i + 2) / 2 <= idx) ++i;
                const int tr = nt - 1 - i, tc = nt - 1 - (idx - i * (i + 1) / 2);
                const int r0 = base + 4 * tr, c0 = base + 4 * tc;
                float wv[4][4];
#pragma unroll
                for (int a = 0; a < 4; ++a) ld4(wv[a], W + (r0 + a) * LD + c0);
#pragma unroll
                for (int jj = 0; jj < CH_NB; ++jj) {
                    float lr[4], lc[4];
                    ld4(lr, Lt + (j0 + jj) * LD + r0);
                    ld4(lc, Lt + (j0 + jj) * LD + c0);
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b) wv[a][b] = fmaf(-lr[a], lc[b], wv[a][b]);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        if (r0 + a < k && c0 + b < k) W[(r0 + a) * LD + c0 + b] = wv[a][b];
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) scratch[0] = minpiv;
    __syncthreads();
    const float out = scratch[0];
    __syncthreads();
    return out;
}

// The substitution of rows j0 .. j1 - 1 of M (thread = column): row j's
// dot starts from its part over the rows below the block (in M), row j =
// (e_j - dot) / Lt[j, j], and its terms go into the dots above it at once,
// so that a row waits only on its own scaling.  Without TAIL the block is
// 16 rows and the steps are one branch-free block of code.
template <int T, bool TAIL>
__device__ __forceinline__ void triu_inv_near(const float* Lt, float* M, int k, int j0, int j1) {
    constexpr int LD = ChShape<T>::LD;
    const int col = threadIdx.x;
    float rcp[CH_NB], dot[CH_NB];
#pragma unroll
    for (int jj = 0; jj < CH_NB; ++jj) {
        const bool in = !TAIL || j0 + jj < j1;
        rcp[jj] = in ? rcp_nr(Lt[(j0 + jj) * LD + j0 + jj]) : 0.f;
        dot[jj] = (in && j1 < k) ? M[(j0 + jj) * LD + col] : 0.f;
    }
#pragma unroll
    for (int jj = CH_NB - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        if (TAIL && j >= j1) continue;
        float lcol[CH_NB];
#pragma unroll
        for (int jr = 0; jr < jj; ++jr) lcol[jr] = Lt[(j0 + jr) * LD + j];
        dot[jj] = ((col == j ? 1.f : 0.f) - dot[jj]) * rcp[jj];
#pragma unroll
        for (int jr = 0; jr < jj; ++jr) dot[jr] = fmaf(lcol[jr], dot[jj], dot[jr]);
    }
#pragma unroll
    for (int jj = 0; jj < CH_NB; ++jj)
        if (!TAIL || j0 + jj < j1) M[(j0 + jj) * LD + col] = dot[jj];
}

// Inverse of the (k, k) upper triangle Lt into M (upper; M zero on entry)
// by backward substitution (`_triu_inv_inplace`): row j of M = (e_j -
// Lt[j, j+1:] M[j+1:]) times the reciprocal of Lt[j, j] (rcp_nr: within an
// ulp of the division, and off the chain), in blocks of CH_NB rows from the
// bottom.  Each row's dot is the chain over the rows below its block (m
// ascending, a product with every thread), then the block's own later rows
// from the block's bottom up: a thread per column keeps the block's 16 dots
// in registers and adds row m's term to every dot above it as soon as row m
// is solved (triu_inv_near).
template <int T>
__device__ void triu_inv_blocked(const float* Lt, float* M, int k) {
    constexpr int R = ChShape<T>::R, LD = ChShape<T>::LD;
    constexpr int CG = R / 4;                          // 4-column groups
    constexpr int RT = CH_NB * CG / CH_THREADS;        // rows a thread
    static_assert(RT * CH_THREADS == CH_NB * CG, "the far part's tiles cover the block");
    const int kr = (k + 3) & ~3;
    const int nblk = (k + CH_NB - 1) / CH_NB;
    for (int blk = nblk - 1; blk >= 0; --blk) {
        const int j0 = blk * CH_NB, j1 = min(j0 + CH_NB, k);
        if (j1 < k) {
            const int c0 = 4 * (threadIdx.x % CG), jr = j0 + RT * (threadIdx.x / CG);
            float acc[RT][4];
#pragma unroll
            for (int a = 0; a < RT; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
            for (int m = j1; m < kr; m += 4) {
                float av[RT][4], bv[4][4];
#pragma unroll
                for (int a = 0; a < RT; ++a) ld4(av[a], Lt + (jr + a) * LD + m);
#pragma unroll
                for (int q = 0; q < 4; ++q) ld4(bv[q], M + (m + q) * LD + c0);
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int a = 0; a < RT; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a][q], bv[q][b], acc[a][b]);
            }
#pragma unroll
            for (int a = 0; a < RT; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) M[(jr + a) * LD + c0 + b] = acc[a][b];
        }
        __syncthreads();
        if ((int)threadIdx.x < k) {
            if (j1 == j0 + CH_NB) triu_inv_near<T, false>(Lt, M, k, j0, j1);
            else triu_inv_near<T, true>(Lt, M, k, j0, j1);
        }
        __syncthreads();
    }
}

template <int T>
__global__ void __launch_bounds__(CH_THREADS, 1) eps_chol_kernel(CholArgs p) {
    constexpr int R = ChShape<T>::R, LD = ChShape<T>::LD;
    extern __shared__ __align__(16) float smem[];
    float* W = smem;
    float* L = W + R * LD;
    float* N = L + R * LD;
    float* s_part = N + R * LD;                  // the rank's partial row dots, 3 x CH_MAXB
    float* s_inv1r = s_part + 3 * CH_MAXB;
    float* s_wden = s_inv1r + CH_MAXB;
    float* s_gamma = s_wden + CH_MAXB;
    float* s_misc = s_gamma + CH_MAXB;           // [0] good, [1] trace / sweep scratch, [2] good
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), nrank = (int)cluster.num_blocks();
    const int n = p.n, k = 2 * n, d = p.d;
    const int c0 = rank * p.k_per, c1 = min(d, c0 + p.k_per);
    const int kr = (k + 3) & ~3;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    CH_PHASE(0);

    for (int i = threadIdx.x; i < 3 * R * LD / 4; i += CH_THREADS)
        reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // The rank's part of each row's vsv, mv, w (fused_step.py:285-296): a
    // warp per row, lane chains over the rank's columns, a butterfly.
#pragma unroll 4
    for (int r = warp; r < n; r += CH_THREADS / 32) {
        float vsv = 0.f, mv = 0.f, wsum = 0.f;
        for (int col = c0 + lane; col < c1; col += 32) {
            const size_t o = (size_t)r * d + col;
            const float vv = __ldg(p.v + o), tt = __ldg(p.t + o), a = -__ldg(p.ef + o);
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
            s_part[r] = vsv;
            s_part[CH_MAXB + r] = mv;
            s_part[2 * CH_MAXB + r] = wsum;
        }
    }
    cluster_sync_all();
    if ((int)threadIdx.x < n) {
        const int r = threadIdx.x;
        float vsv = 0.f, mv = 0.f, wsum = 0.f;
#pragma unroll
        for (int q = 0; q < CH_MAX_RANKS; ++q) {
            if (q >= nrank) break;
            const float* pq = cluster.map_shared_rank(s_part, q);
            vsv += pq[r];
            mv += pq[CH_MAXB + r];
            wsum += pq[2 * CH_MAXB + r];
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

    // Z^T = [-e; c] / sqrt(B) and (F Z)^T = [a; bm] / sqrt(B) (a = -ef,
    // bm = a + dmu_b), 32 columns at a time, and the rank's part of G.
    {
        float* slab = L;                         // R x CH_SLD
        const float scale = 1.f / sqrtf((float)n);
        const int i0 = (threadIdx.x >> 4) * T, tx = threadIdx.x & 15;
        float acc[T][T];
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int b = 0; b < T; ++b) acc[a][b] = 0.f;
        for (int s0 = c0; s0 < c1; s0 += CH_SLAB) {
            // Row b's column: Z^T rows b and B + b, (F Z)^T rows b and B + b
            // (rows from 2B on stay zero, as the buffer was set).
#pragma unroll 4
            for (int q = threadIdx.x; q < n * CH_SLAB; q += CH_THREADS) {
                const int b = q / CH_SLAB, cc = q % CH_SLAB, col = s0 + cc;
                float z0 = 0.f, z1 = 0.f;
                if (col < c1) {
                    const size_t o = (size_t)b * d + col, o1 = (size_t)(n + b) * d + col;
                    const float ee = __ldg(p.e + o), efv = __ldg(p.ef + o);
                    const float vfv = __ldg(p.vf + o), tv = __ldg(p.t + o), a = -efv;
                    const float c = -ee * s_gamma[b] + vfv * s_inv1r[b];
                    const float dmu_b = ((tv + efv) + efv * s_wden[b]) * s_inv1r[b];
                    z0 = -ee * scale;
                    z1 = c * scale;
                    p.zt[o] = z0;
                    p.zt[o1] = z1;
                    p.fzt[o] = a * scale;
                    p.fzt[o1] = (a + dmu_b) * scale;
                }
                slab[b * CH_SLD + cc] = z0;
                slab[(n + b) * CH_SLD + cc] = z1;
            }
            __syncthreads();
#pragma unroll 2
            for (int m = 0; m < CH_SLAB; m += 4) {
                float av[T][4], bv[T][4];
#pragma unroll
                for (int a = 0; a < T; ++a) ld4(av[a], slab + (i0 + a) * CH_SLD + m);
#pragma unroll
                for (int b = 0; b < T; ++b) ld4(bv[b], slab + (tx + 16 * b) * CH_SLD + m);
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int a = 0; a < T; ++a)
#pragma unroll
                        for (int b = 0; b < T; ++b) acc[a][b] = fmaf(av[a][q], bv[b][q], acc[a][b]);
            }
            __syncthreads();
        }
        float* part = N;                         // the rank's G part, R x LD
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
            for (int b = 0; b < T; ++b) part[(i0 + a) * LD + tx + 16 * b] = acc[a][b];
    }
    cluster_sync_all();
    {
        // G's rows [rank rr, (rank + 1) rr), each entry the S parts in rank
        // order, into rank 0's W.
        const int rr = (k + nrank - 1) / nrank;
        float* w0 = cluster.map_shared_rank(W, 0);
        const float* peer[CH_MAX_RANKS];
#pragma unroll
        for (int q = 0; q < CH_MAX_RANKS; ++q) peer[q] = cluster.map_shared_rank(N, q < nrank ? q : 0);
        // Four entries (a float4 of a row) a thread; columns k .. round4(k)
        // of the parts are zeros, as W's padding must be.
        const int r0 = rank * rr, nq = max(0, min(rr, k - r0)) * (kr / 4);
        for (int idx = threadIdx.x; idx < nq; idx += CH_THREADS) {
            const int at = (r0 + idx / (kr / 4)) * LD + 4 * (idx % (kr / 4));
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int q = 0; q < CH_MAX_RANKS; ++q)
                if (q < nrank) {
                    const float4 v = *reinterpret_cast<const float4*>(peer[q] + at);
                    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
                }
            *reinterpret_cast<float4*>(w0 + at) = sum;
        }
    }
    cluster_sync_all();

    if (rank == 0) {
        // W = G + jitter (tr G / 2B + 1) I  (fused_step.py:398-402); the
        // trace a chain per lane of warp 0, then a butterfly.
        if (warp == 0) {
            float tr = 0.f;
            for (int i = lane; i < k; i += 32) tr += W[i * LD + i];
            for (int o = 16; o > 0; o >>= 1) tr += __shfl_xor_sync(0xffffffffu, tr, o);
            if (lane == 0) s_misc[1] = tr;
        }
        for (int i = threadIdx.x; i < 2 * R * LD / 4; i += CH_THREADS)
            reinterpret_cast<float4*>(L)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
        const float jit = p.jitter * (s_misc[1] / (float)k + 1.f);
        if ((int)threadIdx.x < k) W[threadIdx.x * LD + threadIdx.x] += jit;
        __syncthreads();
        CH_PHASE(1);
        chol_blocked<T>(W, L, k, s_misc + 1);                      // L = Lg^T
        CH_PHASE(2);
        tmm_nt<T, true>(L, L, W, k, n, [](int i, int j, float acc) {
            return (i == j ? 1.f : 0.f) + acc;                       // K = I + Lg^T J Lg
        });
        CH_PHASE(3);
        triu_inv_blocked<T>(L, N, k);                              // N = Lg^{-T}
        CH_PHASE(4);
        const float minpiv = chol_blocked<T>(W, L, k, s_misc + 1); // L = Ck^T
        if ((int)threadIdx.x < k) L[threadIdx.x * LD + threadIdx.x] -= 1.f;
        if (threadIdx.x == 0) s_misc[0] = minpiv > 0.f ? 1.f : 0.f;
        __syncthreads();
        CH_PHASE(5);
        // S2 = M (Ck^T - I)^T M^T: X = M (Ck^T - I)^T into W, X M^T into L.
        tmm_nt<T, false>(N, L, W, k, 0, Plain());
        CH_PHASE(6);
        tmm_nt<T, false>(W, N, L, k, 0, Plain());
        CH_PHASE(7);
    }
    cluster_sync_all();

    // Every rank: S2 from rank 0 into W, then w = S2 Z^T over its columns
    // and the mean (selected) of its columns.
    {
        const float* s2 = cluster.map_shared_rank(L, 0);
        const int nq = k * (kr / 4);
        for (int base = threadIdx.x; base < nq; base += 4 * CH_THREADS) {
            float4 val[4];
            int at[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int idx = min(base + u * CH_THREADS, nq - 1);
                at[u] = (idx / (kr / 4)) * LD + 4 * (idx % (kr / 4));
                val[u] = *reinterpret_cast<const float4*>(s2 + at[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (base + u * CH_THREADS < nq) *reinterpret_cast<float4*>(W + at[u]) = val[u];
        }
        if (threadIdx.x == 0) s_misc[2] = cluster.map_shared_rank(s_misc, 0)[0];
    }
    __syncthreads();
    cluster_arrive();                            // done with rank 0's shared memory
    const bool good = s_misc[2] != 0.f;
    {
        float* slab = N;                         // Z^T rows m < round4(2B), 32 columns
        const int i0 = 4 * (threadIdx.x >> 3), j0 = 4 * (threadIdx.x & 7);
        for (int s0 = c0; s0 < c1; s0 += CH_SLAB) {
            for (int q = threadIdx.x; q < kr * CH_SLAB; q += CH_THREADS) {
                const int m = q / CH_SLAB, cc = q % CH_SLAB, col = s0 + cc;
                slab[m * CH_SLD + cc] = (m < k && col < c1) ? p.zt[(size_t)m * d + col] : 0.f;
            }
            __syncthreads();
            if (i0 < k) {
                float acc[4][4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
                for (int m = 0; m < kr; m += 4) {
                    float av[4][4], bv[4][4];
#pragma unroll
                    for (int a = 0; a < 4; ++a) ld4(av[a], W + (i0 + a) * LD + m);
#pragma unroll
                    for (int q = 0; q < 4; ++q) ld4(bv[q], slab + (m + q) * CH_SLD + j0);
#pragma unroll
                    for (int q = 0; q < 4; ++q)
#pragma unroll
                        for (int a = 0; a < 4; ++a)
#pragma unroll
                            for (int b = 0; b < 4; ++b)
                                acc[a][b] = fmaf(av[a][q], bv[q][b], acc[a][b]);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int i = i0 + a, col = s0 + j0 + b;
                        if (i < k && col < c1) p.w[(size_t)i * d + col] = acc[a][b];
                    }
            }
            __syncthreads();
        }
    }
    // mean_out = mean_in + mean_b dmu_b where good, dmu_b = (t + ef + ef
    // w/den) / (1 + rho): a thread per column sums the rows in order.
    for (int col = c0 + (int)threadIdx.x; col < c1; col += CH_THREADS) {
        float s = 0.f;
#pragma unroll 8
        for (int b = 0; b < n; ++b) {
            const size_t o = (size_t)b * d + col;
            const float e = __ldg(p.ef + o);
            s += ((__ldg(p.t + o) + e) + e * s_wden[b]) * s_inv1r[b];
        }
        const float m = p.mean_in[col];
        p.mean_out[col] = good ? m + s / (float)n : m;
    }
    if (rank == 0 && threadIdx.x == 0) {
        *p.good = good ? 1 : 0;
        if (p.nacc != nullptr) *p.nacc += good ? 1 : 0;
    }
    CH_PHASE(8);
    cluster_wait();                              // no block leaves while a peer reads its memory
    CH_PHASE(9);
}

template <int T>
cudaError_t launch_chol(const CholArgs& p, int split, cudaStream_t stream) {
    // Above 48 KB needs the opt-in, a function attribute, set once.
    static bool smem_opt_in = false;
    const size_t bytes = sizeof(float) * chol_smem_floats<T>();
    if (!smem_opt_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            eps_chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        smem_opt_in = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(CH_THREADS, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, eps_chol_kernel<T>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// One instantiation's C entry: args points to a CholArgs.  With
// GSMVI_PHASE_STAMPS, name_phases copies its phase timestamps into out.
#ifdef GSMVI_PHASE_STAMPS
#define GSMVI_EPS_CHOL_PHASES(name)                                                           \
    extern "C" int name##_phases(long long* out) {                                           \
        return (int)cudaMemcpyFromSymbol(out, ch_phase_ns, sizeof(ch_phase_ns));              \
    }
#else
#define GSMVI_EPS_CHOL_PHASES(name)
#endif
#define GSMVI_EPS_CHOL_ENTRY(name, T)                                                         \
    extern "C" int name(const void* args, int split, void* stream) {                         \
        return (int)launch_chol<T>(*static_cast<const CholArgs*>(args), split,                \
                                   static_cast<cudaStream_t>(stream));                        \
    }                                                                                         \
    GSMVI_EPS_CHOL_PHASES(name)
