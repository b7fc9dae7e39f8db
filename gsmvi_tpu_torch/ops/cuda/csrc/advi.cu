// The whole-step ADVI kernels K9 (analytic gradient) and K10 (STL gradient
// with a Newton-tracked inverse), launched per sub-step by
// gsmvi_tpu_torch/ops/advi_fused.py, which captures a full block of them
// into one CUDA graph.
//
// Replaces gsmvi_tpu/ops/pallas/advi_fused.py:
//   K9  `make_fused_advi_multistep` (:121, the body at :151-187), three
//       launches a sub-step: x = loc + e L^T on the split-k thin product
//       (thin_gemm.cu), the score (K3), and gsmvi_advi_update: the lower
//       32x32 tiles of dL = tril(-S^T E - B diag(1/L_ii)) with Adam on
//       (L, mL, vL) in the tile's epilogue, the diagonal tiles also forming
//       dloc = -sum_b s_b (rows in order) with Adam on (loc, mloc, vloc).
//   K10 `make_fused_advi_stl_multistep` (:249, the body at :295-351), nine
//       launches a sub-step at two sweeps: the residual R = I - L A
//       (gsmvi_advi_residual) with the first-residual gate (:300-306) in its
//       last block, the sweep A' = A + A R (gsmvi_advi_sweep) into a second
//       buffer, the second residual and sweep, x and P = E A'
//       (gsmvi_advi_rows), the score, gsmvi_advi_stl_grad (the lower tiles
//       of dL = tril(-(S + P)^T E) and dloc = -1^T (S + P), both flagging a
//       nonfinite entry) and gsmvi_advi_stl_apply (the nonfinite gate
//       :322-331, Adam on loc, L and the moments and A <- A', all only if
//       consumed, and the block's counts in its last block).
//
// What bounds it on an H100: at D=256, B=32 a K9 sub-step is 8.4 MFLOP on a
// lower-triangular L (x 2.1, the Gaussian score 4.2, dL 2.1), a K10
// sub-step 33 MFLOP (four triangular products 22.6, x, P and dL 6.3, the
// score 4.2): 0.13-0.5 us of the card's float32 rate, so both are bound by
// launch latency and the latency of each launch's loads, not by FLOPs or
// bytes.  Design:
// - The host: a full block is one CUDA-graph replay, and the per-step
//   learning rates and bias corrections are read from a (3, spc) float32
//   table on the device (`sc`: lr, 1/(1-b1^t), 1/(1-b2^t) of sub-step j),
//   so that no launch carries a value that changes from block to block.
// - Triangles: L, A, R = I - L A and A + A R are lower triangular, so the
//   (D, D, D) products compute only the T (T + 1) / 2 lower 32x32 tiles of
//   their output (T = ceil(D / 32)), and tile (I, J) walks only the k slabs
//   J..I, where the operands are not both zero above or left of the
//   diagonal: D (D + 1) (D + 2) / 6 FMA in place of D^3.  The upper
//   triangle of an output is never written (its buffer holds zeros).
// - Filling the card: each lower tile is a cluster of S = min(8, T) blocks
//   of 64 threads (thin_gemm.cuh's slab loads and 4x4 register tiles), rank
//   r taking the tile's slabs s with s % S == r in ascending order, two
//   deep with cp.async; after a cluster barrier rank r sums the S partial
//   tiles of rows r, r + S, ... through distributed shared memory in rank
//   order.  At D=256 that is 36 tiles and 120 busy blocks.  Which rank adds
//   slab s depends on s and D alone, so the skipped slabs add exact zeros
//   to a full product's sums taken the same way: for lower-triangular
//   operands with finite entries the tiles equal, bit for bit up to the
//   sign of a zero, those of the whole product in the same order
//   (tests/test_torch_advi_blocks.py emulates it).
// - The gate: each residual tile writes, per row, the sum of |R| over its
//   columns (a warp reduction in a fixed order); the last block of the
//   launch, found by an integer ticket, sums each row's tile partials in
//   tile order and takes their max.  The apply's last block, by a second
//   ticket, writes the block's counts (consume, n_done, stiff): every block
//   reads the report before it takes its ticket, and only the last one
//   writes, so no block of the launch reads a word another one writes.  No
//   float atomics: the gates reproduce from run to run.
// - Sum orders: K10's x and P (gsmvi_advi_rows) keep the order, and so the
//   bits, of the 32x32 template they ran on before: each output one fmaf
//   chain over ascending k in the thin product's register tiles, the slabs
//   staged four deep.  dL and dloc sum the B rows in order, as before.
//   Adam turns a gradient at rounding level into a step of +-lr: at
//   D=1024, B=16 one entry of dL lies at float32 rounding level
//   (tools/advi_k10_probe.py), and x and P on the split-k thin product gave
//   it the other sign than the plain version (PERF.md, K9/K10 findings).  K9's x runs
//   on the split-k thin product (thin_gemm.cu), as K1's rows do.
// - The row Grams (dL) are 32x32 lower tiles of 1024 threads (one output
//   each, so each thread's epilogue is one Adam step) with the B rows
//   staged in 32-row slabs; K10's G = S + P is formed on load.  A diagonal
//   tile has its 32 columns of G staged already: its first warp sums them,
//   rows in order, into dloc, so no launch re-reads S.
// A halted block (the report's `stiff` word set) makes every later K10
// launch a no-op, the row products included.
#include "thin_gemm.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWGRAM_THREADS = TILE * TILE;   // one thread per output of a tile
constexpr int APPLY_THREADS = 256;
constexpr int ROWS_STAGES = 4;
constexpr int APPLY_MAX_BLOCKS = 1024;

// K10 report (float32), the layout of ops/advi_fused.py's REP_* indices.
constexpr int REP_NDONE = 0, REP_STIFF = 1, REP_CONSUME = 2, REP_BAD = 3, REP_NONFINITE = 4,
              REP_RNORM = 5;

// optax.adam's constants: b1, 1 - b1, b2, 1 - b2 (float32) and eps.
struct AdamConsts {
    float b1, omb1, b2, omb2, eps;
};

// One sub-step's learning rate and bias corrections, from the (3, spc) table.
struct AdamStep {
    float lr, bc1, bc2;
};

__device__ __forceinline__ AdamStep adam_step(const float* sc, int j, int spc) {
    return AdamStep{sc[j], sc[spc + j], sc[2 * spc + j]};
}

// m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2; p -= lr (m bc1) / (sqrt(v bc2) + eps),
// every operation rounded on its own (no FMA contraction), as the plain torch
// version (ops/advi_fused.py `_adam_apply`) evaluates it: the same gradient gives
// the same bits.
__device__ __forceinline__ void adam_apply(float& p, float& m, float& v, float g,
                                           const AdamStep& s, const AdamConsts& c) {
    m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
    v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
    const float step = __fdiv_rn(__fmul_rn(s.lr, __fmul_rn(m, s.bc1)),
                                 __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.bc2)), c.eps));
    p = __fsub_rn(p, step);
}

// Lower tile t of the triangle, row-major: t = I (I + 1) / 2 + J, J <= I
// (tests/test_torch_advi_blocks.py mirrors it up to D=8192).
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tj) {
    int i = static_cast<int>((sqrtf(8.f * static_cast<float>(t) + 1.f) - 1.f) * 0.5f);
    while (i * (i + 1) / 2 > t) --i;
    while ((i + 1) * (i + 2) / 2 <= t) ++i;
    ti = i;
    tj = t - i * (i + 1) / 2;
}

// acc += sum_b G[b, m0 + ty] E[b, n0 + tx], b ascending (one fmaf each), G
// = s (+ p with SUM2, added on load); s, p, e (B, D).  With `diag` (a
// diagonal tile), warp 0 also sums its column of G, b ascending: colsum +=
// G[b, m0 + tx].  1024 threads, one output each; block-uniform.
template <bool SUM2>
__device__ __forceinline__ void rowgram(const float* s, const float* p, const float* e, int b,
                                        int d, int m0, int n0, float& acc, bool diag,
                                        float& colsum) {
    __shared__ float gs[TILE][TILE + 1];   // [row b][column m]
    __shared__ float es[TILE][TILE + 1];   // [row b][column n]
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    for (int k0 = 0; k0 < b; k0 += TILE) {
        const int gk = k0 + ty;   // thread (ty, tx) stages row ty, column tx
        float gv = 0.f, ev = 0.f;
        if (gk < b) {
            const size_t row = static_cast<size_t>(gk) * d;
            if (m0 + tx < d) {
                gv = s[row + m0 + tx];
                if (SUM2) gv = __fadd_rn(gv, p[row + m0 + tx]);
            }
            if (n0 + tx < d) ev = e[row + n0 + tx];
        }
        gs[ty][tx] = gv;
        es[ty][tx] = ev;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TILE; ++kk) acc = fmaf(gs[kk][ty], es[kk][tx], acc);
        if (diag && ty == 0) {   // warp 0: the rows past B add +0
            for (int kk = 0; kk < TILE; ++kk) colsum = __fadd_rn(colsum, gs[kk][tx]);
        }
        __syncthreads();
    }
}

struct UpdateArgs {
    const float* s;
    const float* e;
    const float* sc;
    float *loc, *l, *mloc, *vloc, *ml, *vl;
    int j, spc, b, d;
    float bf;
    AdamConsts adam;
};

// K9: one block per lower tile of dL, Adam on (L, mL, vL) in its epilogue;
// a diagonal tile's warp 0 also forms dloc over its 32 columns and applies
// Adam on (loc, mloc, vloc).  The epilogue's operands are loaded before the
// product, so their latency overlaps its loads.
__global__ void __launch_bounds__(ROWGRAM_THREADS) advi_update_kernel(UpdateArgs a) {
    int ti, tj;
    tri_tile(blockIdx.x, ti, tj);
    const int m0 = ti * TILE, n0 = tj * TILE;
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    const int gm = m0 + ty, gn = n0 + tx;
    const bool diag = ti == tj;
    // The upper triangle is never written.
    const bool mine = gm < a.d && gn < a.d && gm >= gn;
    const size_t o = static_cast<size_t>(gm) * a.d + gn;
    float pl = 0.f, pm = 0.f, pv = 0.f;
    if (mine) {
        pl = a.l[o];
        pm = a.ml[o];
        pv = a.vl[o];
    }
    float ploc = 0.f, pmloc = 0.f, pvloc = 0.f;
    if (diag && ty == 0 && gn < a.d) {
        ploc = a.loc[gn];
        pmloc = a.mloc[gn];
        pvloc = a.vloc[gn];
    }
    const AdamStep st = adam_step(a.sc, a.j, a.spc);
    float acc = 0.f, colsum = 0.f;
    rowgram<false>(a.s, nullptr, a.e, a.b, a.d, m0, n0, acc, diag, colsum);
    if (diag && ty == 0 && gn < a.d) {
        adam_apply(ploc, pmloc, pvloc, -colsum, st, a.adam);
        a.loc[gn] = ploc;
        a.mloc[gn] = pmloc;
        a.vloc[gn] = pvloc;
    }
    if (!mine) return;
    float g = -acc;
    if (gm == gn) g = __fsub_rn(g, __fmul_rn(a.bf, __fdiv_rn(1.f, pl)));
    adam_apply(pl, pm, pv, g, st, a.adam);
    a.l[o] = pl;
    a.ml[o] = pm;
    a.vl[o] = pv;
}

struct RowsArgs {
    const float* a;       // rows (m, d)
    const float* b;       // F (d, d)
    const float* mu;      // X: x = mu + out
    float* c;
    float* c2;
    const float* halt;
    int m, d;
};

// K10's x = loc + e L^T (TB, X) and P = E A' (neither): out = rows @ F^T or
// rows @ F on 32x32 output tiles, one block of 64 threads each (the thin
// product's 4x4 register tiles and slab loads, thin_gemm.cuh) walking all
// of k itself: each output one fmaf chain over ascending k, the 32x32
// template's order and bits.  The slabs are staged ROWS_STAGES deep, so
// the chain waits on one slab's latency, not on every slab's.  No-op while
// *halt != 0.
template <bool TB, bool X, bool VEC>
__global__ void __launch_bounds__(TG_THREADS) advi_rows_kernel(RowsArgs p) {
    __shared__ __align__(16) Slab slab[ROWS_STAGES];
    if (p.halt != nullptr && *p.halt != 0.f) return;
    const int m0 = blockIdx.y * TG_BM, n0 = blockIdx.x * TG_BN;
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
    const int nslab = (p.d + TG_BK - 1) / TG_BK;
    ThinArgs la{};   // the slab loads' bounds
    la.m = p.m;
    la.d = p.d;
    auto load = [&](int stage, int sl) {
        const int k0 = sl * TG_BK;
        load_slab<TB, PRO_NONE, VEC>(slab[stage], la, p.a, p.b, nullptr, m0, n0, k0,
                                     min(p.d, k0 + TG_BK));
    };
#pragma unroll
    for (int st = 0; st < ROWS_STAGES - 1; ++st) {
        if (st < nslab) load(st, st);
        cp_async_commit();
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int sl = 0; sl < nslab; ++sl) {
        const int ahead = sl + ROWS_STAGES - 1;
        if (ahead < nslab) load(ahead % ROWS_STAGES, ahead);
        cp_async_commit();
        cp_async_wait<ROWS_STAGES - 1>();
        __syncthreads();
        const Slab& sb = slab[sl % ROWS_STAGES];
#pragma unroll
        for (int kk = 0; kk < TG_BK; kk += 4) {
            float av[4][4], bq[4][4];   // av[row][k], bq[k][col]
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 q = *reinterpret_cast<const float4*>(&sb.a[ty * 4 + i][kk]);
                av[i][0] = q.x; av[i][1] = q.y; av[i][2] = q.z; av[i][3] = q.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (TB) {   // column tx + 8 j
                    const float4 q = *reinterpret_cast<const float4*>(&sb.b[tx + 8 * j][kk]);
                    bq[0][j] = q.x; bq[1][j] = q.y; bq[2][j] = q.z; bq[3][j] = q.w;
                } else {    // columns 4 tx .. 4 tx + 3
                    const float4 q = *reinterpret_cast<const float4*>(&sb.b[kk + j][tx * 4]);
                    bq[j][0] = q.x; bq[j][1] = q.y; bq[j][2] = q.z; bq[j][3] = q.w;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][q], bq[q][j], acc[i][j]);
        }
        __syncthreads();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty * 4 + i;
        if (gm >= p.m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + (TB ? tx + 8 * j : tx * 4 + j);
            if (gn >= p.d) continue;
            const size_t o = static_cast<size_t>(gm) * p.d + gn;
            p.c[o] = acc[i][j];
            if (X) p.c2[o] = p.mu[gn] + acc[i][j];
        }
    }
}

enum { TRI_EYE_MINUS = 0, TRI_ADD = 1 };

struct TriArgs {
    const float* a;       // left operand (D, D), lower triangular
    const float* b;       // right operand (D, D), lower triangular
    const float* c_in;    // TRI_ADD: c = c_in + a b
    float* c;             // TRI_EYE_MINUS: c = I - a b
    float* partial;       // (D, T): row sums of |c| per tile, and the gate; or null
    float* rep;           // the K10 report (its stiff word halts the launch)
    int* ticket;
    float gate_first;
    int d, t, split;
};

// C = epi(A B) on the lower tiles; a cluster of `split` blocks per tile.
template <int EPI, bool VEC>
__global__ void __launch_bounds__(TG_THREADS) tri_kernel(TriArgs p) {
    __shared__ __align__(16) Slab slab[2];
    __shared__ __align__(16) float part[TG_BM * TG_BN];
    __shared__ int last;
    if (p.rep[REP_STIFF] != 0.f) return;   // the same for every block

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    int ti, tj;
    tri_tile(blockIdx.x / p.split, ti, tj);
    const int m0 = ti * TILE, n0 = tj * TILE;
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
    ThinArgs la{};   // the slab loads' bounds: rows and columns in [0, d)
    la.m = p.d;
    la.d = p.d;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    // This rank's slabs: s in [tj, ti] with s % split == rank, ascending.
    const int first = tj + ((rank - tj % p.split) % p.split + p.split) % p.split;
    auto load = [&](Slab& sl, int s) {
        const int k0 = s * TG_BK;
        load_slab<false, PRO_NONE, VEC>(sl, la, p.a, p.b, nullptr, m0, n0, k0,
                                        min(p.d, k0 + TG_BK));
    };
    int buf = 0;
    if (first <= ti) load(slab[0], first);
    cp_async_commit();
    for (int s = first; s <= ti; s += p.split) {
        if (s + p.split <= ti) load(slab[buf ^ 1], s + p.split);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const Slab& sl = slab[buf];
#pragma unroll
        for (int kk = 0; kk < TG_BK; kk += 4) {
            float av[4][4], bq[4][4];   // av[row][k], bq[k][col]
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 q = *reinterpret_cast<const float4*>(&sl.a[ty * 4 + i][kk]);
                av[i][0] = q.x; av[i][1] = q.y; av[i][2] = q.z; av[i][3] = q.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {   // columns 4 tx .. 4 tx + 3
                const float4 q = *reinterpret_cast<const float4*>(&sl.b[kk + j][tx * 4]);
                bq[j][0] = q.x; bq[j][1] = q.y; bq[j][2] = q.z; bq[j][3] = q.w;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][q], bq[q][j], acc[i][j]);
        }
        __syncthreads();
        buf ^= 1;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(ty * 4 + i) * TG_BN + tx * 4 + j] = acc[i][j];
    cluster.sync();

    // Rank r finishes rows r, r + split, ... of the tile: the partials summed
    // in rank order, then the epilogue.  A warp holds one row (lane = column).
    const float* peer[TG_MAX_SPLIT];
    for (int q = 0; q < p.split; ++q) peer[q] = cluster.map_shared_rank(part, q);
    const int nrows = (TG_BM - rank + p.split - 1) / p.split;
    for (int idx = tid; idx < nrows * TG_BN; idx += TG_THREADS) {
        const int i = rank + p.split * (idx / TG_BN), j = idx % TG_BN;
        const int gm = m0 + i, gn = n0 + j;
        if (gm >= p.d) continue;   // the whole warp shares the row
        float ab = 0.f;
        if (gn < p.d && gn <= gm) {
            float sum = 0.f;
            for (int q = 0; q < p.split; ++q) sum += peer[q][i * TG_BN + j];
            const size_t o = static_cast<size_t>(gm) * p.d + gn;
            if (EPI == TRI_EYE_MINUS) {
                const float val = (gm == gn ? 1.f : 0.f) - sum;
                p.c[o] = val;
                ab = fabsf(val);
            } else {
                p.c[o] = p.c_in[o] + sum;
            }
        }
        if (EPI == TRI_EYE_MINUS && p.partial != nullptr) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) ab += __shfl_xor_sync(0xffffffffu, ab, o);
            if (j == 0) p.partial[static_cast<size_t>(gm) * p.t + tj] = ab;
        }
    }
    cluster.sync();   // no block leaves while a peer reads its partials
    if (EPI != TRI_EYE_MINUS || p.partial == nullptr) return;

    // The gate, in the launch's last block: r_norm = max over rows of the
    // row's tile partials summed in tile order; bad = r_norm nonfinite or
    // above gate_first.  Also clears the sub-step's nonfinite-gradient flag.
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float mx = 0.f;
    int nf = 0;
    for (int i = tid; i < p.d; i += TG_THREADS) {
        float rs = 0.f;
        const float* row = p.partial + static_cast<size_t>(i) * p.t;
        for (int q = 0; q <= i / TILE; ++q) rs += __ldcg(row + q);
        if (isfinite(rs)) mx = fmaxf(mx, rs);
        else nf = 1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        nf |= __shfl_xor_sync(0xffffffffu, nf, o);
    }
    __shared__ float wmax[TG_THREADS / 32];
    __shared__ int wnf[TG_THREADS / 32];
    if (tid % 32 == 0) {
        wmax[tid / 32] = mx;
        wnf[tid / 32] = nf;
    }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < TG_THREADS / 32; ++w) {
            mx = fmaxf(mx, wmax[w]);
            nf |= wnf[w];
        }
        p.rep[REP_RNORM] = nf ? __int_as_float(0x7fc00000) : mx;
        p.rep[REP_BAD] = (nf || mx > p.gate_first) ? 1.f : 0.f;
        p.rep[REP_NONFINITE] = 0.f;
        *p.ticket = 0;
    }
}

struct GradArgs {
    const float* s;
    const float* pr;
    const float* e;
    float* gl;
    float* gloc;
    float* rep;
    int b, d;
};

// K10: one block per lower tile of gl = tril(-(S + P)^T E); a diagonal
// tile's warp 0 also forms gloc = -1^T (S + P) over its 32 columns.  A
// nonfinite entry sets the report's flag (a plain store of one value).
__global__ void __launch_bounds__(ROWGRAM_THREADS) advi_stl_grad_kernel(GradArgs a) {
    if (a.rep[REP_STIFF] != 0.f) return;
    int ti, tj;
    tri_tile(blockIdx.x, ti, tj);
    const int m0 = ti * TILE, n0 = tj * TILE;
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    const int gm = m0 + ty, gn = n0 + tx;
    const bool diag = ti == tj;
    float acc = 0.f, colsum = 0.f;
    rowgram<true>(a.s, a.pr, a.e, a.b, a.d, m0, n0, acc, diag, colsum);
    if (diag && ty == 0 && gn < a.d) {
        a.gloc[gn] = -colsum;
        if (!isfinite(colsum)) a.rep[REP_NONFINITE] = 1.f;
    }
    if (gm >= a.d || gn >= a.d || gm < gn) return;
    const float g = -acc;
    a.gl[static_cast<size_t>(gm) * a.d + gn] = g;
    if (!isfinite(g)) a.rep[REP_NONFINITE] = 1.f;
}

struct ApplyArgs {
    float* rep;
    int* ticket;
    const float* gl;
    const float* gloc;
    float *l, *ml, *vl, *loc, *mloc, *vloc;
    const float* a_new;
    float* a;
    const float* sc;
    int j, spc, d;
    AdamConsts adam;
};

// K10: consume = no gate tripped and the whole gradient finite; if consumed,
// Adam on the lower triangle of L and its moments and on loc, and A <- A'
// (lower triangle).  Elements [0, d*d) are L's, [d*d, d*d+d) loc's.  The
// launch's last block (by ticket) writes consume and n_done, or stiff,
// which halts the rest of the block.
__global__ void __launch_bounds__(APPLY_THREADS) advi_stl_apply_kernel(ApplyArgs a) {
    __shared__ int last;
    if (a.rep[REP_STIFF] != 0.f) return;   // the same for every block
    const bool bad = a.rep[REP_BAD] != 0.f || a.rep[REP_NONFINITE] != 0.f;
    if (!bad) {
        const AdamStep st = adam_step(a.sc, a.j, a.spc);
        const size_t dd = static_cast<size_t>(a.d) * a.d;
        const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
        for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
             idx < dd + a.d; idx += stride) {
            if (idx < dd) {
                if (idx % a.d > idx / a.d) continue;   // the upper triangle is never written
                float p = a.l[idx], m = a.ml[idx], v = a.vl[idx];
                adam_apply(p, m, v, a.gl[idx], st, a.adam);
                a.l[idx] = p;
                a.ml[idx] = m;
                a.vl[idx] = v;
                a.a[idx] = a.a_new[idx];
            } else {
                const size_t j = idx - dd;
                float p = a.loc[j], m = a.mloc[j], v = a.vloc[j];
                adam_apply(p, m, v, a.gloc[j], st, a.adam);
                a.loc[j] = p;
                a.mloc[j] = m;
                a.vloc[j] = v;
            }
        }
    }
    __syncthreads();   // every thread of this block has read the report
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    if (bad) {
        a.rep[REP_STIFF] = 1.f;
        a.rep[REP_CONSUME] = 0.f;
    } else {
        a.rep[REP_CONSUME] = 1.f;
        a.rep[REP_NDONE] += 1.f;
    }
    *a.ticket = 0;
}

inline int tiles(int d) { return (d + TILE - 1) / TILE; }
inline int ntri(int d) { return tiles(d) * (tiles(d) + 1) / 2; }
inline int tri_split(int d) { return min(TG_MAX_SPLIT, tiles(d)); }

template <int EPI>
cudaError_t launch_tri(TriArgs p, cudaStream_t stream) {
    p.t = tiles(p.d);
    p.split = tri_split(p.d);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ntri(p.d) * p.split, 1, 1);
    cfg.blockDim = dim3(TG_THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool vec = p.d % 4 == 0 && aligned16(p.a) && aligned16(p.b);
    const cudaError_t err = vec ? cudaLaunchKernelEx(&cfg, tri_kernel<EPI, true>, p)
                                : cudaLaunchKernelEx(&cfg, tri_kernel<EPI, false>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K10's row products: out = rows @ F^T (trans_f 1; with x_out also x_out =
// mu + out) or rows @ F (trans_f 0); rows (m, d), F (d, d).  No-op while
// *halt != 0 (halt may be null).
int gsmvi_advi_rows(const float* rows, const float* f, const float* mu, float* out, float* x_out,
                    const float* halt, int m, int d, int trans_f, void* stream) {
    if (m < 1 || d < 1 || (m + TILE - 1) / TILE > 65535) return (int)cudaErrorInvalidValue;
    if (x_out != nullptr && !trans_f) return (int)cudaErrorInvalidValue;
    RowsArgs p{rows, f, mu, out, x_out, halt, m, d};
    const dim3 grid((d + TG_BN - 1) / TG_BN, (m + TG_BM - 1) / TG_BM);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0 && aligned16(rows) && aligned16(f);
    if (!trans_f) {
        if (vec) advi_rows_kernel<false, false, true><<<grid, TG_THREADS, 0, s>>>(p);
        else advi_rows_kernel<false, false, false><<<grid, TG_THREADS, 0, s>>>(p);
    } else if (x_out != nullptr) {
        if (vec) advi_rows_kernel<true, true, true><<<grid, TG_THREADS, 0, s>>>(p);
        else advi_rows_kernel<true, true, false><<<grid, TG_THREADS, 0, s>>>(p);
    } else {
        if (vec) advi_rows_kernel<true, false, true><<<grid, TG_THREADS, 0, s>>>(p);
        else advi_rows_kernel<true, false, false><<<grid, TG_THREADS, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}

// K9, one sub-step after the score: s, e (B, D); sc (3, spc); loc, mloc,
// vloc (D,), l, ml, vl (D, D) updated in place (lower triangles).
int gsmvi_advi_update(const float* s, const float* e, const float* sc, int j, int spc,
                      float* loc, float* l, float* mloc, float* vloc, float* ml, float* vl,
                      int b, int d, float b1, float omb1, float b2, float omb2, float eps,
                      float bf, void* stream) {
    if (b < 1 || d < 1 || j < 0 || j >= spc) return (int)cudaErrorInvalidValue;
    UpdateArgs a{s, e, sc, loc, l, mloc, vloc, ml, vl, j, spc, b, d, bf,
                 AdamConsts{b1, omb1, b2, omb2, eps}};
    advi_update_kernel<<<ntri(d), ROWGRAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// K10: r = I - l @ a on the lower tiles; with partial (D * ceil(D/32),) and
// ticket, also the first-residual gate into rep.  No-op while rep's stiff
// word is set.
int gsmvi_advi_residual(const float* l, const float* a, float* r, float* partial, float* rep,
                        int* ticket, int d, float gate_first, void* stream) {
    if (d < 1 || (partial != nullptr && ticket == nullptr)) return (int)cudaErrorInvalidValue;
    TriArgs p{};
    p.a = l; p.b = a; p.c = r; p.partial = partial; p.rep = rep; p.ticket = ticket;
    p.gate_first = gate_first; p.d = d;
    return (int)launch_tri<TRI_EYE_MINUS>(p, static_cast<cudaStream_t>(stream));
}

// K10: a_out = a + a @ r on the lower tiles (a_out distinct from a and r).
// No-op while rep's stiff word is set.
int gsmvi_advi_sweep(const float* a, const float* r, float* a_out, float* rep, int d,
                     void* stream) {
    if (d < 1 || a_out == a || a_out == r) return (int)cudaErrorInvalidValue;
    TriArgs p{};
    p.a = a; p.b = r; p.c = a_out; p.c_in = a; p.rep = rep; p.d = d;
    return (int)launch_tri<TRI_ADD>(p, static_cast<cudaStream_t>(stream));
}

// K10: gl = tril(-(s + p)^T e), gloc = -1^T (s + p); s, p, e (B, D).
int gsmvi_advi_stl_grad(const float* s, const float* p, const float* e, float* gl, float* gloc,
                        float* rep, int b, int d, void* stream) {
    if (b < 1 || d < 1) return (int)cudaErrorInvalidValue;
    GradArgs a{s, p, e, gl, gloc, rep, b, d};
    advi_stl_grad_kernel<<<ntri(d), ROWGRAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// K10: the decision and, if consumed, Adam and A <- a_new (sub-step j of
// the (3, spc) table sc).
int gsmvi_advi_stl_apply(float* rep, int* ticket, const float* gl, const float* gloc, float* l,
                         float* ml, float* vl, float* loc, float* mloc, float* vloc,
                         const float* a_new, float* a, const float* sc, int j, int spc, int d,
                         float b1, float omb1, float b2, float omb2, float eps, void* stream) {
    if (d < 1 || j < 0 || j >= spc) return (int)cudaErrorInvalidValue;
    const size_t n = static_cast<size_t>(d) * d + d;
    const size_t need = (n + APPLY_THREADS - 1) / APPLY_THREADS;
    const int blocks = static_cast<int>(need < APPLY_MAX_BLOCKS ? need : APPLY_MAX_BLOCKS);
    ApplyArgs args{rep, ticket, gl, gloc, l, ml, vl, loc, mloc, vloc, a_new, a, sc, j, spc, d,
                   AdamConsts{b1, omb1, b2, omb2, eps}};
    advi_stl_apply_kernel<<<blocks, APPLY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args);
    return (int)cudaGetLastError();
}

}  // extern "C"
