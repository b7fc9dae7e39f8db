// The eps-NS GSM update's small space for 128 < B <= 512 as one persistent
// cooperative launch per update, its (B, B) matrices in device memory
// (L2-resident), the whole chain a table of phases with a grid barrier
// between two phases.
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_smallspace_ns` (:231)
// from the row work at :287 to the stacked rows at :345, with `_ns_sqrt`
// (:198), `_newton_inv` (:214), `_spd_norm_ub` (:189), both residual gates
// (tol 3e-3) and the mean half of the select: the body of K1
// `gsm_eps_update_fused` (:461) and, through the same launch, of K2 (:685),
// K4 (:586) and K6 (batch_fused.py:54) at these batches.  It takes the place
// of a chain of ~146 host-enqueued grid launches on a 32x32 GEMM template.
//
// What bounds it on an H100: at the long NS profile (8, 6, 9, 10, 6) the
// chains are 97 dependent (B, B) x (B, B) products, 2 B^3 FLOP each (26
// GFLOP at B=512, 0.39 ms at 67 TFLOP/s), plus 8 products with the (B, D)
// rows; the dependency chain puts a grid-wide barrier between every two of
// its 71 phases.  So the FFMA rate of the whole card in each phase, and the
// barriers, bound it.  Measured (PERF.md): ~1.3 us a barrier; at B=512 a
// product phase is bound by the workers' instruction issue (the loads'
// index work beside the FFMA), at B=256 by their latency (a few units an
// SM), well above the FFMA bound.
//
// Design:
// - The schedule is a table built in Python (gsmvi_tpu_torch/ops/
//   grid_schedule.py, which says what each op computes), a function of
//   (B, NS profile) alone, read from device memory: per phase its ops, each
//   a product (out = epilogue(A' B')), a symmetric tile pair, or row work.
//   The ops of a phase are independent: the two inverse chains of phase 1
//   run in lockstep, the residual products, e c^T, Q's product and the row
//   work beside the chains, so 71 phases carry the 105 products.  The last
//   Z iterate of each Newton-Schulz chain is never read and not formed.
// - Persistent blocks of 256 threads, as many as the card holds at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, read once per
//   batch by the wrapper), launched cooperatively so that all are resident
//   or the launch is refused.  Each block is a few workers (named barriers
//   1-4): four of 64 threads at T = 16, two of 128 at T = 32 (twice the
//   warps on a tile: a phase with few units per SM is latency-bound, and
//   128 threads took the B=256 small space on 32 x 32 tiles from 1.69 to
//   1.13 ms); a phase's units (output tiles of its ops x the K
//   replicas, then the row work) are dealt to the workers in a fixed order,
//   unit u to block u mod G first, so that a phase with few units spreads
//   over the SMs.  A grid barrier (a counter in the launch's sync words:
//   every block adds one after a fence and waits for (phase + 1) x G) ends
//   each phase; the last block out sets the words back to 0, so a CUDA
//   graph replays the launch.
// - Products: a T x T output tile per worker (2 x 4 outputs a thread at T =
//   32; 2 x 2 at T = 16, the smaller batches), k in slabs of 16 (T =
//   32) or 32 (T = 16) depths staged in shared memory through registers,
//   two slabs' loads in flight while one is multiplied (the first sweeps'
//   operands, the identity, I/nrm and (I +- G)/nrm, are formed between the
//   load and the store, which cp.async cannot do); 8- and 16-byte shared
//   loads one depth ahead of their 8 (4) FFMA.  One fused multiply-add
//   chain per output, k ascending: the 32x32 template's order, so each
//   product's bits depend on B alone, and e e^T and Xi~^T Xi~ come out
//   exactly symmetric.  FP32 FFMA only, no TF32.
// - No elementwise pass: the symmetrisations of Gu and Gv are exact no-ops
//   (their products are symmetric bit for bit); S1 and S2 are formed
//   symmetric by the last sweep's tile pairs, 0.5 (a + b) of a tile and its
//   mirror, which also write I + S and I + S1 + Gu for the inverse chains;
//   (I +- G)/nrm, I/nrm and x sqrt(nrm) are folded into the operands'
//   loads and the epilogues, Q = Xi~^T w1row^T - cuiec^T into its product's
//   epilogue, cv = -X into w2row's (the negated chain, bit for bit).
// - Norm seeds and residuals without float atomics: the producing epilogue
//   writes per tile the row sums of |I + X| (each thread's columns in
//   order, then a butterfly over the 8 threads of a row), and the last
//   tile of a row block (an integer ticket) sums them over the column
//   tiles in ascending order and takes the block's row max; a consumer
//   takes the max over the row blocks.  The residuals' tile sums are
//   summed by the last tile in tile order.  The row sums' order is no
//   longer column ascending; it depends on B alone, never on the grid, D
//   or K, and the tickets are 0 again after each launch.
// - Replicas: the units of K replicas share the phases; replica z's
//   operands, workspace and sync words lie apart, and nothing it computes
//   depends on the others, so it equals a launch on replica z alone.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gsmvi_grid {

constexpr int GR_THREADS = 256;
constexpr int GR_MAXB = 512;
constexpr int GR_NMAT = 11;
constexpr int GR_NSETS = 5;
constexpr int GR_NRES = 2;
constexpr int GR_MAXNT = 32;          // tiles a side: B = 512 at T = 16
constexpr int GR_OPW = 18;            // ints per op record
constexpr int GR_SYNC = 168;          // sync words per replica
constexpr int GR_TK_RES = GR_NSETS * GR_MAXNT;   // the residuals' tickets
constexpr int GR_BAR = 164;           // the grid barrier's two words (replica 0)
constexpr int GR_MAXPH = 256;

// The table's codes (grid_schedule.py holds the same numbers).
enum { K_GEMM = 0, K_PAIR, K_ROWSCAL, K_CROWS, K_MEANSUM, K_SELECT };
enum { O_PLAIN = 0, O_TRANS, O_EYE, O_EYE_INV, O_NS_PLUS, O_NS_MINUS };
enum { E_NONE = 0, E_STORE, E_SCALE_B, E_SCALE_ZC, E_NS_T, E_INV_T, E_XIM, E_SU2,
       E_RES_PLUS, E_RES_MINUS, E_SUB_AUXT, E_NEG };
enum { P_NONE = 0, P_PLUS, P_MINUS };
enum { S_E = 0, S_V, S_VF, S_T, S_EF, S_C, S_XIM, S_SU_LO, S_SU_HI, S_SW_LO, S_SW_HI,
       S_M0 = 16 };
enum { F_KIND = 0, F_EPI, F_OUT, F_M, F_N, F_K, F_A, F_AMODE, F_OUT2, F_B, F_BMODE, F_OUT3,
       F_NRM, F_PSET, F_PEXPR, F_PSET2, F_AUX, F_RES };

// A replica's workspace (floats): the (B, B) matrices, the row scalars
// (gamma, 1/(1+rho), w/den), the norm sets' row partials (set, column
// tile, row) and row-block maxima, the residuals' tile partials (num, den)
// and values.
__host__ __device__ inline long long gr_ntmax(int b) { return (b + 15) / 16; }
__host__ __device__ inline long long gr_off_rs(int b) { return (long long)GR_NMAT * b * b; }
__host__ __device__ inline long long gr_off_npart(int b) { return gr_off_rs(b) + 3LL * b; }
__host__ __device__ inline long long gr_off_rbmax(int b) {
    return gr_off_npart(b) + GR_NSETS * gr_ntmax(b) * b;
}
__host__ __device__ inline long long gr_off_rpart(int b) {
    return gr_off_rbmax(b) + GR_NSETS * gr_ntmax(b);
}
__host__ __device__ inline long long gr_off_res(int b) {
    return gr_off_rpart(b) + 2LL * GR_NRES * gr_ntmax(b) * gr_ntmax(b);
}
__host__ __device__ inline long long gr_ws_floats(int b) {
    return (gr_off_res(b) + GR_NRES + 3) & ~3LL;
}

// The worker of tile side T = 8 R: WT = 32 R threads (a 4R x 8 grid), each
// with RM x RN = 2 x R outputs; k slabs of BK depths, NE loads a thread and
// operand a slab.
template <int R>
struct Tile {
    static constexpr int T = 8 * R;                     // output tile side
    static constexpr int WT = 32 * R;                   // threads of a worker
    static constexpr int WORKERS = GR_THREADS / WT;
    static constexpr int RM = 2, RN = R;                // outputs a thread: rows, columns
    static constexpr int BK = R == 2 ? 32 : 16;         // k slab
    static constexpr int LDS = T + 4;                    // staged slab row
    static constexpr int NE = T * BK / WT;               // slab elements a thread loads
    static constexpr int SLAB = BK * LDS;
    static constexpr int STAGE = T * (T + 1);            // a tile pair's halves
    static constexpr int WORKER = 4 * SLAB + 2 * STAGE + 8;
    static constexpr size_t SMEM = sizeof(float) * (size_t)WORKERS * WORKER;
};

struct GridArgs {
    const float* e;       // (B, D) draws, replicas e_stride apart
    const float* v;       // (B, D) scores
    const float* vf;      // (B, D) v F
    const float* t;       // (B, D) vf F^T
    const float* ef;      // (B, D) e F^T
    const float* mean_in;
    float* mean_out;      // may equal mean_in
    int* good;
    int* nacc;            // optional: += good
    float* su;            // (2B, D) stack_u
    float* sw;            // (2B, D) stack_w
    float* c;             // (B, D) scratch: downdate rows, then the mean's sums
    float* xim;           // (B, D) scratch: Xi~^T
    float* ws;            // gr_ws_floats(B) per replica
    int* sync;            // GR_SYNC per replica, 0 on entry and on exit
    const int* table;     // grid_schedule.encode
    int nphases, b, d, reps;
    long long e_stride;
    float tol;
};

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel large): thread 0 of block 0 writes
// the global timer (ns) when each phase starts, thread 0 of every block
// when its work in a phase ends (before the barrier), and each block sums
// the ns its workers spend in the tickets' reductions in the phase (of the
// last launch, as the stamps).
#ifdef GSMVI_PHASE_STAMPS
constexpr int GR_STAMP_BLOCKS = 1056;
namespace {   // each tile's source keeps its own
__device__ long long gr_stamp_start[GR_MAXPH + 1];
__device__ long long gr_stamp_end[GR_STAMP_BLOCKS * GR_MAXPH];
__device__ unsigned long long gr_stamp_red[GR_STAMP_BLOCKS * GR_MAXPH];
}  // namespace
__device__ __forceinline__ long long gr_now() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define GR_STAMP(arr, idx)                                                        \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.x < GR_STAMP_BLOCKS) arr[idx] = gr_now(); \
    } while (0)
#else
#define GR_STAMP(arr, idx) \
    do {                   \
    } while (0)
#endif

__device__ __forceinline__ float gr_nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// The barrier of a worker's n threads (named barrier id).
__device__ __forceinline__ void wsync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Every block adds one to bar[0] and waits until all G blocks of this
// barrier (the ph-th of the launch, target (ph + 1) G) have.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(bar, 1u);
        while (ld_acquire(bar) < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

// The last block out sets both words back to 0: every other block has
// passed its last wait before it adds to bar[1].
__device__ __forceinline__ void grid_exit(unsigned* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
            bar[0] = 0;
            bar[1] = 0;
            __threadfence();
        }
    }
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int opf(const int* op, int f) { return __ldg(op + f); }

__device__ __forceinline__ int dim_of(int v, int d) { return v < 0 ? d : v; }

__device__ inline int op_units(const int* op, int b, int d, int T, int wt) {
    switch (opf(op, F_KIND)) {
        case K_GEMM:
            return cdiv(dim_of(opf(op, F_M), d), T) * cdiv(dim_of(opf(op, F_N), d), T);
        case K_PAIR: {
            const int nt = cdiv(b, T);
            return nt * (nt + 1) / 2;
        }
        case K_ROWSCAL: return cdiv(b, wt / 32);
        case K_CROWS: return b;
        case K_MEANSUM: return cdiv(d, wt);
        default: return 1;
    }
}

// Replica z's operands, formed from the kernel's parameters where they are
// used (kept as pointers they would hold some thirty registers through the
// products).
struct Rep {
    const GridArgs* p;
    int z;
    __device__ __forceinline__ long long rows() const { return (long long)p->b * p->d; }
    __device__ __forceinline__ const float* e() const { return p->e + z * p->e_stride; }
    __device__ __forceinline__ const float* v() const { return p->v + z * rows(); }
    __device__ __forceinline__ const float* vf() const { return p->vf + z * rows(); }
    __device__ __forceinline__ const float* t() const { return p->t + z * rows(); }
    __device__ __forceinline__ const float* ef() const { return p->ef + z * rows(); }
    __device__ __forceinline__ float* c() const { return p->c + z * rows(); }
    __device__ __forceinline__ float* xim() const { return p->xim + z * rows(); }
    __device__ __forceinline__ float* su() const { return p->su + 2 * z * rows(); }
    __device__ __forceinline__ float* sw() const { return p->sw + 2 * z * rows(); }
    __device__ __forceinline__ float* ws() const { return p->ws + z * gr_ws_floats(p->b); }
    __device__ __forceinline__ int* sync() const { return p->sync + (long long)z * GR_SYNC; }
    __device__ __forceinline__ const float* mean_in() const {
        return p->mean_in + (long long)z * p->d;
    }
    __device__ __forceinline__ float* mean_out() const { return p->mean_out + (long long)z * p->d; }
    __device__ __forceinline__ int* good() const { return p->good + z; }
    __device__ __forceinline__ int* nacc() const {
        return p->nacc == nullptr ? nullptr : p->nacc + z;
    }
};

// A source of the table: its pointer and leading dimension.
__device__ __forceinline__ float* src_of(int b, int d, const Rep& r, int id, int& ld) {
    const long long rows = (long long)b * d;
    ld = d;
    switch (id) {
        case S_E: return const_cast<float*>(r.e());
        case S_V: return const_cast<float*>(r.v());
        case S_VF: return const_cast<float*>(r.vf());
        case S_T: return const_cast<float*>(r.t());
        case S_EF: return const_cast<float*>(r.ef());
        case S_C: return r.c();
        case S_XIM: return r.xim();
        case S_SU_LO: return r.su();
        case S_SU_HI: return r.su() + rows;
        case S_SW_LO: return r.sw();
        case S_SW_HI: return r.sw() + rows;
        default:
            if (id < S_M0) return nullptr;
            ld = b;
            return r.ws() + (long long)(id - S_M0) * b * b;
    }
}

// The norm bound of a set: max over its nt <= 32 row blocks' maxima, +
// 1e-30, a row block a lane; every thread of a warp gets it.
__device__ __forceinline__ float norm_of(const Rep& r, int b, int set, int nt, int lt) {
    const float* rb = r.ws() + gr_off_rbmax(b) + set * gr_ntmax(b);
    const int lane = lt & 31;
    float m = lane < nt ? __ldcg(rb + lane) : 0.f;
    for (int o = 16; o > 0; o >>= 1) m = gr_nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
    return m + 1e-30f;
}

// A product's operand as the loader sees it, along the tile index X (A's
// row, B's column) and the depth K: the value at (X, K) is
//   (cd [X == K] + c1 src[X sx + K sk]) / div
// (the division only where div is the norm), every mode of the table one
// choice of the coefficients (make_opnd), so the loader has no branch on
// the mode.  Each sum and product with a coefficient 0 or 1 is exact, so
// the value is the mode's own expression bit for bit.
struct Opnd {
    const float* p;
    int sx, sk;
    int xlim, klim;
    bool has_src, along_k, has_div;
    float cd, c1, div;
};

// Where slab element q of a thread's loads sits: x along the tile, kk the
// depth.  Sources contiguous along k take 8 depths of 4 tiles' rows a warp
// (one 32-byte sector per 8 lanes; with LDS = 36 or 20 the stores are free
// of bank conflicts); the others run along x.
template <int T>
__device__ __forceinline__ void slab_pos(bool along_k, int q, int& x, int& kk) {
    if (along_k) {
        kk = (q & 7) + ((q / (8 * T)) << 3);
        x = (q >> 3) % T;
    } else {
        x = q % T;
        kk = q / T;
    }
}

// A thread's loads of an operand's slab, and their transforms into shared
// memory.  Plain (L1-cached) loads: no phase reads what it writes, and the
// fence at the end of every grid barrier invalidates the SM's L1 (it
// compiles to MEMBAR.SC.GPU and CCTL.IVALL), so no load sees a line of an
// earlier phase.  What is written and
// read within a phase, the tickets' partials, is read past L1 (__ldcg).
template <int R>
struct Loader {
    using TL = Tile<R>;
    static constexpr int T = TL::T;
    static constexpr int NE = TL::NE;
    float r[NE];

    __device__ __forceinline__ void fetch(const Opnd& o, int x0, int k0, int lt) {
#pragma unroll
        for (int e = 0; e < NE; ++e) {
            int x, kk;
            slab_pos<T>(o.along_k, e * TL::WT + lt, x, kk);
            const int xg = x0 + x, kg = k0 + kk;
            const bool in = xg < o.xlim && kg < o.klim;
            r[e] = (in && o.has_src) ? o.p[xg * o.sx + kg * o.sk] : 0.f;
        }
    }

    __device__ __forceinline__ void store(const Opnd& o, int x0, int k0, int lt,
                                          float* S) const {
#pragma unroll
        for (int e = 0; e < NE; ++e) {
            int x, kk;
            slab_pos<T>(o.along_k, e * TL::WT + lt, x, kk);
            const int xg = x0 + x, kg = k0 + kk;
            float v = o.cd * (xg == kg ? 1.f : 0.f) + o.c1 * r[e];
            if (o.has_div) v = v / o.div;
            S[kk * TL::LDS + x] = (xg < o.xlim && kg < o.klim) ? v : 0.f;
        }
    }
};

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[N]) {
    if constexpr (N == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x;
        v[1] = q.y;
    }
}

// acc += the slab's products, each depth's A and B fragments loaded one
// depth ahead of their multiply-adds.
template <int R>
__device__ __forceinline__ void mma_slab(const float* a_s, int ty, int tx,
                                         float (&acc)[Tile<R>::RM][Tile<R>::RN]) {
    using TL = Tile<R>;
    constexpr int RM = TL::RM, RN = TL::RN;
    const float* b_s = a_s + TL::SLAB;
    float av[2][RM], bv[2][RN];
    ld_vec<RM>(a_s + ty * RM, av[0]);
    ld_vec<RN>(b_s + tx * RN, bv[0]);
#pragma unroll
    for (int kk = 0; kk < TL::BK; ++kk) {
        if (kk + 1 < TL::BK) {
            ld_vec<RM>(a_s + (kk + 1) * TL::LDS + ty * RM, av[(kk + 1) & 1]);
            ld_vec<RN>(b_s + (kk + 1) * TL::LDS + tx * RN, bv[(kk + 1) & 1]);
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < RN; ++c)
                acc[r][c] = fmaf(av[kk & 1][r], bv[kk & 1][c], acc[r][c]);
    }
}

// acc = A'[r0:r0+T, :] B'[:, c0:c0+T], one fmaf chain per output over k
// ascending (the slabs in order, each slab's depths in order).  Two slabs'
// loads are in flight while one is computed: slab s + 2 is fetched into
// registers before slab s is multiplied from shared memory and stored after
// slab s + 1 is, through two register sets and two shared buffers.  Ends
// with the worker's barrier: its shared memory is free again.
template <int R>
__device__ __forceinline__ void gemm_tile(const Opnd& A, const Opnd& B, int K, int r0, int c0,
                                          float* sm, int lt, int bar,
                                          float (&acc)[Tile<R>::RM][Tile<R>::RN]) {
    using TL = Tile<R>;
    constexpr int BK = TL::BK;
#pragma unroll
    for (int r = 0; r < TL::RM; ++r)
#pragma unroll
        for (int s = 0; s < TL::RN; ++s) acc[r][s] = 0.f;
    const int ty = lt >> 3, tx = lt & 7;
    float* buf0 = sm;
    float* buf1 = sm + 2 * TL::SLAB;
    Loader<R> la0, la1, lb0, lb1;
    const int ns = cdiv(K, BK);
    la0.fetch(A, r0, 0, lt);
    lb0.fetch(B, c0, 0, lt);
    if (ns > 1) {
        la1.fetch(A, r0, BK, lt);
        lb1.fetch(B, c0, BK, lt);
    }
    la0.store(A, r0, 0, lt, buf0);
    lb0.store(B, c0, 0, lt, buf0 + TL::SLAB);
    wsync(bar, TL::WT);
    for (int s = 0; s < ns; s += 2) {
        // Slab s in buf0, slab s + 1 in the second register set.
        if (s + 2 < ns) {
            la0.fetch(A, r0, (s + 2) * BK, lt);
            lb0.fetch(B, c0, (s + 2) * BK, lt);
        }
        mma_slab<R>(buf0, ty, tx, acc);
        if (s + 1 < ns) {
            la1.store(A, r0, (s + 1) * BK, lt, buf1);
            lb1.store(B, c0, (s + 1) * BK, lt, buf1 + TL::SLAB);
        }
        wsync(bar, TL::WT);
        if (s + 1 >= ns) break;
        // Slab s + 1 in buf1, slab s + 2 in the first register set.
        if (s + 3 < ns) {
            la1.fetch(A, r0, (s + 3) * BK, lt);
            lb1.fetch(B, c0, (s + 3) * BK, lt);
        }
        mma_slab<R>(buf1, ty, tx, acc);
        if (s + 2 < ns) {
            la0.store(A, r0, (s + 2) * BK, lt, buf0);
            lb0.store(B, c0, (s + 2) * BK, lt, buf0 + TL::SLAB);
        }
        wsync(bar, TL::WT);
    }
}

// The worker takes a ticket of `total`; true in every thread for the last
// to arrive, which also sets the ticket back to 0.
__device__ inline bool take_ticket(int* ticket, int total, int lt, int bar, int wt, int* flag) {
    wsync(bar, wt);
    if (lt == 0) {
        __threadfence();
        const bool last = atomicAdd(ticket, 1) == total - 1;
        if (last) {
            *ticket = 0;
            __threadfence();
        }
        *flag = last ? 1 : 0;
    }
    wsync(bar, wt);
    return *flag != 0;
}

// The last tile of row block rb of a norm set: each row's partials summed
// over the nt column tiles in order, the block's row max into rbmax.
static __device__ __noinline__ void reduce_row_block(const Rep r, int b, int set, int rb, int T, int nt,
                                        int lt) {
    if (lt >= 32) return;
    const long long ntm = gr_ntmax(b);
    const float* part = r.ws() + gr_off_npart(b) + set * ntm * b;
    const int i = rb * T + lt;
    float rs = 0.f;
    if (lt < T && i < b)
        for (int j = 0; j < nt; ++j) rs += __ldcg(part + (long long)j * b + i);
    for (int o = 16; o > 0; o >>= 1) rs = gr_nan_max(rs, __shfl_xor_sync(0xffffffffu, rs, o));
    if (lt == 0) r.ws()[gr_off_rbmax(b) + set * ntm + rb] = rs;
}

// Sum over a worker (fixed order: a warp butterfly, then the warps in
// order); the result in every thread.
__device__ inline float worker_sum(float x, float* red, int lt, int bar, int wt) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if ((lt & 31) == 0) red[lt >> 5] = x;
    wsync(bar, wt);
    float s = red[0];
    for (int w = 1; w < wt / 32; ++w) s += red[w];
    wsync(bar, wt);
    return s;
}

// What a worker's unit reads besides its shared memory (which the hot
// functions take as a pointer of their own, so that the compiler sees it
// is shared): the batch, D, the gate, its replica's operands, its op.
struct Unit {
    int b, d;
    float tol;
    Rep r;
    const int* op;
    int lt, bar, wt;      // the thread in its worker, the worker's barrier and size
#ifdef GSMVI_PHASE_STAMPS
    unsigned long long* red_ns;
#endif
};

// The operand of source `id` in `mode` for a product's side (is_a: A'
// (xlim rows, klim depth); else B' (klim depth, xlim columns)).
__device__ __forceinline__ Opnd make_opnd(const Unit& u, bool is_a, int id, int mode, int xlim,
                                          int klim, float nrm) {
    Opnd o;
    int ld = 0;
    o.p = src_of(u.b, u.d, u.r, id, ld);
    o.xlim = xlim;
    o.klim = klim;
    // The source's strides along X and K: row-major A (X, K) and B (K, X),
    // or transposed.
    const bool x_rows = is_a != (mode == O_TRANS);   // the source's rows run along X
    o.sx = x_rows ? ld : 1;
    o.sk = x_rows ? 1 : ld;
    o.along_k = o.sk == 1;
    o.has_src = mode != O_EYE && mode != O_EYE_INV;
    o.has_div = mode == O_NS_PLUS || mode == O_NS_MINUS;
    o.div = nrm;
    o.cd = mode == O_EYE_INV ? 1.f / nrm
           : (mode == O_EYE || mode == O_NS_PLUS || mode == O_NS_MINUS) ? 1.f : 0.f;
    o.c1 = !o.has_src ? 0.f : mode == O_NS_MINUS ? -1.f : 1.f;
    return o;
}

__device__ __forceinline__ float part_val(int form, float dg, float x) {
    return form == P_PLUS ? fabsf(dg + x) : fabsf(dg - x);
}

// Row sums of the tile's partial values `rowabs` over the 8 threads of a
// row, written by the row's first thread into set `set`, column tile ct.
template <int R>
__device__ inline void write_row_partials(const Unit& u, int set, int ct, int r0, int M,
                                          float (&rowabs)[Tile<R>::RM]) {
    const int b = u.b;
    float* part = u.r.ws() + gr_off_npart(b) + set * gr_ntmax(b) * b + (long long)ct * b;
    const int ty = u.lt >> 3, tx = u.lt & 7;
#pragma unroll
    for (int r = 0; r < Tile<R>::RM; ++r) {
        float x = rowabs[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        const int i = r0 + ty * Tile<R>::RM + r;
        if (tx == 0 && i < M) part[i] = x;
    }
}

template <int R>
__device__ __forceinline__ void run_gemm(const Unit& u, int tile, float* sm) {
    using TL = Tile<R>;
    constexpr int T = TL::T;
    const int* op = u.op;
    const int b = u.b, d = u.d;
    const int M = dim_of(opf(op, F_M), d), N = dim_of(opf(op, F_N), d),
              K = dim_of(opf(op, F_K), d);
    const int ntn = cdiv(N, T);
    const int ti = tile / ntn, tj = tile % ntn;
    const int r0 = ti * T, c0 = tj * T;
    const int nset = opf(op, F_NRM);
    const float nrm = nset >= 0 ? norm_of(u.r, b, nset, cdiv(b, T), u.lt) : 1.f;
    const Opnd A = make_opnd(u, true, opf(op, F_A), opf(op, F_AMODE), M, K, nrm);
    const Opnd B = make_opnd(u, false, opf(op, F_B), opf(op, F_BMODE), N, K, nrm);
    constexpr int RM = TL::RM, RN = TL::RN;
    float acc[RM][RN];
    gemm_tile<R>(A, B, K, r0, c0, sm, u.lt, u.bar, acc);

    const int epi = opf(op, F_EPI);
    const int pset = opf(op, F_PSET), pform = opf(op, F_PEXPR);
    int ldo = 0, lda = 0;
    float* out = src_of(u.b, u.d, u.r, opf(op, F_OUT), ldo);
    const float* aux = src_of(u.b, u.d, u.r, opf(op, F_AUX), lda);
    const float zc = 1.f / sqrtf((float)b);
    const float inv_b = 1.f / (float)b;
    const float* gam = u.r.ws() + gr_off_rs(b);
    const float* inv1r = gam + b;
    const int ty = u.lt >> 3, tx = u.lt & 7;
    float rowabs[RM];
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        rowabs[r] = 0.f;
        const int i = r0 + ty * RM + r;
#pragma unroll
        for (int s = 0; s < RN; ++s) {
            const int j = c0 + tx * RN + s;
            if (i >= M || j >= N) continue;
            const float a = acc[r][s];
            const float dg = i == j ? 1.f : 0.f;
            const long long o = (long long)i * ldo + j;
            if (epi == E_RES_PLUS || epi == E_RES_MINUS) {
                const float g = __ldcg(aux + (long long)i * lda + j);
                const float ref = epi == E_RES_PLUS ? dg + g : dg - g;
                const float df = a - ref;
                num = fmaf(df, df, num);
                den = fmaf(ref, ref, den);
                continue;
            }
            float val;
            switch (epi) {
                case E_SCALE_B: val = a * inv_b; break;
                case E_SCALE_ZC: val = a * zc; break;
                case E_NS_T: val = 0.5f * ((i == j ? 3.f : 0.f) - a); break;
                case E_INV_T: val = (i == j ? 2.f : 0.f) - a; break;
                case E_XIM: val = (__ldcg(u.r.c() + o) - a) * zc; break;
                case E_SUB_AUXT: val = a - __ldcg(aux + (long long)j * lda + i); break;
                case E_NEG: val = -a; break;
                case E_SU2:
                    val = (-__ldcg(gam + i) * __ldg(u.r.ef() + o) + __ldcg(inv1r + i) * __ldg(u.r.t() + o)
                           + a) * zc;
                    break;
                default: val = a; break;
            }
            out[o] = val;
            if (pset >= 0) rowabs[r] += part_val(pform, dg, val);
        }
    }
    float* red = sm + 4 * TL::SLAB + 2 * TL::STAGE;
    int* flag = reinterpret_cast<int*>(red + 4);
    if (epi == E_RES_PLUS || epi == E_RES_MINUS) {
        const int res = opf(op, F_RES);
        const int ntm = cdiv(M, T);
        num = worker_sum(num, red, u.lt, u.bar, u.wt);
        den = worker_sum(den, red, u.lt, u.bar, u.wt);
        float* rpart = u.r.ws() + gr_off_rpart(b) + (long long)res * gr_ntmax(b) * gr_ntmax(b) * 2;
        if (u.lt == 0) {
            rpart[2 * tile] = num;
            rpart[2 * tile + 1] = den;
        }
        if (take_ticket(u.r.sync() + GR_TK_RES + res, ntm * ntn, u.lt, u.bar, u.wt, flag)) {
#ifdef GSMVI_PHASE_STAMPS
            const long long t0 = gr_now();
#endif
            float sn = 0.f, sd = 0.f;
            for (int q = u.lt; q < ntm * ntn; q += u.wt) {
                sn += __ldcg(rpart + 2 * q);
                sd += __ldcg(rpart + 2 * q + 1);
            }
            sn = worker_sum(sn, red, u.lt, u.bar, u.wt);
            sd = worker_sum(sd, red, u.lt, u.bar, u.wt);
            if (u.lt == 0) u.r.ws()[gr_off_res(b) + res] = sn / (sd + 1e-30f);
#ifdef GSMVI_PHASE_STAMPS
            if (u.lt == 0) atomicAdd(u.red_ns, (unsigned long long)(gr_now() - t0));
#endif
        }
        return;
    }
    if (pset >= 0) {
        write_row_partials<R>(u, pset, tj, r0, M, rowabs);
        if (take_ticket(u.r.sync() + pset * GR_MAXNT + ti, ntn, u.lt, u.bar, u.wt, flag)) {
#ifdef GSMVI_PHASE_STAMPS
            const long long t0 = gr_now();
#endif
            reduce_row_block(u.r, b, pset, ti, T, ntn, u.lt);
#ifdef GSMVI_PHASE_STAMPS
            if (u.lt == 0) atomicAdd(u.red_ns, (unsigned long long)(gr_now() - t0));
#endif
        }
    }
}

// The last Newton-Schulz sweep as a symmetric pair: tiles (I, J) and (J, I)
// of P = Y T, I <= J, into S = 0.5 (P sqrt(nrm) + (P sqrt(nrm))^T) for both
// tiles, and I + S (out2) and (I + S) + aux (out3, where given), the
// inverse chains' operands, with the row sums of |I + S| (pset) and |(I + S)
// + aux| (pset2).
template <int R>
__device__ __forceinline__ void run_pair(const Unit& u, int tile, float* sm) {
    using TL = Tile<R>;
    constexpr int T = TL::T;
    const int* op = u.op;
    const int b = u.b;
    const int nt = cdiv(b, T);
    int ti = 0, rem = tile;
    while (rem >= nt - ti) {
        rem -= nt - ti;
        ++ti;
    }
    const int tj = ti + rem;
    const float nrm = norm_of(u.r, b, opf(op, F_NRM), nt, u.lt);
    const float sq = sqrtf(nrm);
    const Opnd A = make_opnd(u, true, opf(op, F_A), opf(op, F_AMODE), b, b, nrm);
    const Opnd B = make_opnd(u, false, opf(op, F_B), opf(op, F_BMODE), b, b, nrm);
    float* p1 = sm + 4 * TL::SLAB;
    float* p2 = p1 + TL::STAGE;
    float* red = p2 + TL::STAGE;
    int* flag = reinterpret_cast<int*>(red + 4);
    const int ty = u.lt >> 3, tx = u.lt & 7;
    constexpr int RM = TL::RM, RN = TL::RN;
    float acc[RM][RN];
    for (int h = 0; h < (ti == tj ? 1 : 2); ++h) {
        const int r0 = (h == 0 ? ti : tj) * T, c0 = (h == 0 ? tj : ti) * T;
        gemm_tile<R>(A, B, b, r0, c0, sm, u.lt, u.bar, acc);
        float* st = h == 0 ? p1 : p2;
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int s = 0; s < RN; ++s)
                st[(ty * RM + r) * (T + 1) + tx * RN + s] = acc[r][s] * sq;
    }
    if (ti == tj) p2 = p1;
    wsync(u.bar, u.wt);
    int ldo = 0, ld2 = 0, ld3 = 0, lda = 0;   // all b: (B, B) matrices
    float* out = src_of(u.b, u.d, u.r, opf(op, F_OUT), ldo);
    float* out2 = src_of(u.b, u.d, u.r, opf(op, F_OUT2), ld2);
    float* out3 = src_of(u.b, u.d, u.r, opf(op, F_OUT3), ld3);
    const float* aux = src_of(u.b, u.d, u.r, opf(op, F_AUX), lda);
    const int pset = opf(op, F_PSET), pset2 = opf(op, F_PSET2);
    for (int h = 0; h < (ti == tj ? 1 : 2); ++h) {
        const float* own = h == 0 ? p1 : p2;      // this tile's P
        const float* mir = h == 0 ? p2 : p1;      // its mirror's
        const int r0 = (h == 0 ? ti : tj) * T, c0 = (h == 0 ? tj : ti) * T;
        float rowabs[RM], rowabs2[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
            rowabs[r] = 0.f;
            rowabs2[r] = 0.f;
            const int a = ty * RM + r, i = r0 + a;
#pragma unroll
            for (int s = 0; s < RN; ++s) {
                const int c = tx * RN + s, j = c0 + c;
                if (i >= b || j >= b) continue;
                const float v = 0.5f * (own[a * (T + 1) + c] + mir[c * (T + 1) + a]);
                const long long o = (long long)i * ldo + j;
                const float w = (i == j ? 1.f : 0.f) + v;
                out[o] = v;
                out2[o] = w;
                rowabs[r] += fabsf(w);
                if (pset2 >= 0) {
                    const float w2 = w + __ldcg(aux + (long long)i * lda + j);
                    out3[o] = w2;
                    rowabs2[r] += fabsf(w2);
                }
            }
        }
        write_row_partials<R>(u, pset, c0 / T, r0, b, rowabs);
        if (pset2 >= 0) write_row_partials<R>(u, pset2, c0 / T, r0, b, rowabs2);
    }
    for (int h = 0; h < (ti == tj ? 1 : 2); ++h) {
        const int rb = h == 0 ? ti : tj;
        if (take_ticket(u.r.sync() + pset * GR_MAXNT + rb, nt, u.lt, u.bar, u.wt, flag)) {
#ifdef GSMVI_PHASE_STAMPS
            const long long t0 = gr_now();
#endif
            reduce_row_block(u.r, b, pset, rb, T, nt, u.lt);
            if (pset2 >= 0) reduce_row_block(u.r, b, pset2, rb, T, nt, u.lt);
#ifdef GSMVI_PHASE_STAMPS
            if (u.lt == 0) atomicAdd(u.red_ns, (unsigned long long)(gr_now() - t0));
#endif
        }
    }
}

// Row scalars of row (WT / 32) unit + warp (fused_step.py:285-296):
// 1/(1+rho), w/den, gamma; a warp per row over D.
static __device__ __noinline__ void run_rowscal(const Unit u, int unit) {
    const int b = u.b, d = u.d;
    const int lane = u.lt & 31;
    const int i = unit * (u.wt / 32) + (u.lt >> 5);
    if (i >= b) return;
    const size_t r0 = (size_t)i * d;
    float vsv = 0.f, mv = 0.f, wsum = 0.f;
    for (int col = lane; col < d; col += 32) {
        const float vv = __ldg(u.r.v() + r0 + col), tt = __ldg(u.r.t() + r0 + col),
                    a = -__ldg(u.r.ef() + r0 + col);
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
        float* rs = u.r.ws() + gr_off_rs(b);
        rs[i] = 1.f - (1.f + wden) * inv1r;    // gamma
        rs[b + i] = inv1r;
        rs[2 * b + i] = wden;
    }
}

// Row i: the downdate row c = -e gamma + vf / (1 + rho), and u1row = ef /
// sqrt(B) (stack_u's first half).
static __device__ __noinline__ void run_crows(const Unit u, int i) {
    const int b = u.b, d = u.d;
    const float* rs = u.r.ws() + gr_off_rs(b);
    const float g = __ldcg(rs + i), r = __ldcg(rs + b + i);
    const float zc = 1.f / sqrtf((float)b);
    const size_t r0 = (size_t)i * d;
    for (int col = u.lt; col < d; col += u.wt) {
        const size_t q = r0 + col;
        u.r.c()[q] = -__ldg(u.r.e() + q) * g + __ldg(u.r.vf() + q) * r;
        u.r.su()[q] = __ldg(u.r.ef() + q) * zc;
    }
}

// The mean's column sums sum_b dmu_b, dmu_b = (t + ef + ef w/den) / (1 +
// rho), rows in order, into c's first row.
static __device__ __noinline__ void run_meansum(const Unit u, int unit) {
    const int b = u.b, d = u.d;
    const int col = unit * u.wt + u.lt;
    if (col >= d) return;
    const float* rs = u.r.ws() + gr_off_rs(b);
    float s = 0.f;
    for (int k = 0; k < b; ++k) {
        const size_t o = (size_t)k * d + col;
        const float e = __ldg(u.r.ef() + o);
        s += ((__ldg(u.r.t() + o) + e) + e * __ldcg(rs + 2 * b + k)) * __ldcg(rs + b + k);
    }
    u.r.c()[col] = s;
}

// The gates, good and nacc, and the mean with its select.
static __device__ __noinline__ void run_select(const Unit u) {
    const int b = u.b, d = u.d;
    const float* res = u.r.ws() + gr_off_res(b);
    const bool good = (__ldcg(res) < u.tol) && (__ldcg(res + 1) < u.tol);
    for (int col = u.lt; col < d; col += u.wt) {
        const float m = u.r.mean_in()[col];
        u.r.mean_out()[col] = good ? m + __ldcg(u.r.c() + col) / (float)b : m;
    }
    if (u.lt == 0) {
        *u.r.good() = good ? 1 : 0;
        if (u.r.nacc() != nullptr) *u.r.nacc() += good ? 1 : 0;
    }
}

template <int R>
__global__ void __launch_bounds__(GR_THREADS, 1) eps_grid_kernel(const __grid_constant__ GridArgs p) {
    extern __shared__ float4 gr_smem4[];
    using TL = Tile<R>;
    const int slot = threadIdx.x / TL::WT;
    float* const sm = reinterpret_cast<float*>(gr_smem4) + slot * TL::WORKER;
    Unit u;
    u.b = p.b;
    u.d = p.d;
    u.tol = p.tol;
    u.lt = threadIdx.x % TL::WT;
    u.bar = 1 + slot;
    u.wt = TL::WT;
    const int* starts = p.table;
    const int* ops = p.table + p.nphases + 1;
    unsigned* bar = reinterpret_cast<unsigned*>(p.sync + GR_BAR);
    const int G = gridDim.x;
    for (int ph = 0; ph < p.nphases; ++ph) {
#ifdef GSMVI_PHASE_STAMPS
        if (blockIdx.x == 0) GR_STAMP(gr_stamp_start, ph);
        u.red_ns = gr_stamp_red + (size_t)min((int)blockIdx.x, GR_STAMP_BLOCKS - 1) * GR_MAXPH + ph;
        if (threadIdx.x == 0) *u.red_ns = 0;
        __syncthreads();
#endif
        const int o0 = __ldg(starts + ph), o1 = __ldg(starts + ph + 1);
        int total = 0;
        for (int o = o0; o < o1; ++o)
            total += op_units(ops + o * GR_OPW, p.b, p.d, TL::T, TL::WT) * p.reps;
        for (int w = slot * G + (int)blockIdx.x; w < total; w += TL::WORKERS * G) {
            int rem = w, o = o0, n = 0;
            for (;; ++o) {
                n = op_units(ops + o * GR_OPW, p.b, p.d, TL::T, TL::WT) * p.reps;
                if (rem < n) break;
                rem -= n;
            }
            const int per = n / p.reps;
            u.op = ops + o * GR_OPW;
            u.r = Rep{&p, rem / per};
            const int unit = rem % per;
            switch (opf(u.op, F_KIND)) {
                case K_GEMM: run_gemm<R>(u, unit, sm); break;
                case K_PAIR: run_pair<R>(u, unit, sm); break;
                case K_ROWSCAL: run_rowscal(u, unit); break;
                case K_CROWS: run_crows(u, unit); break;
                case K_MEANSUM: run_meansum(u, unit); break;
                default: run_select(u); break;
            }
            wsync(u.bar, TL::WT);
        }
#ifdef GSMVI_PHASE_STAMPS
        __syncthreads();
        GR_STAMP(gr_stamp_end, (size_t)blockIdx.x * GR_MAXPH + ph);
#endif
        if (ph + 1 < p.nphases) grid_sync(bar, (unsigned)(ph + 1) * (unsigned)G);
    }
#ifdef GSMVI_PHASE_STAMPS
    if (blockIdx.x == 0) {
        __syncthreads();
        GR_STAMP(gr_stamp_start, p.nphases);
    }
#endif
    grid_exit(bar);
}

// The shared-memory opt-in set so far for each tile, in bytes.
template <int R>
inline size_t& gr_smem_set() {
    static size_t bytes = 0;
    return bytes;
}

template <int R>
inline cudaError_t gr_attributes() {
    if (gr_smem_set<R>() == Tile<R>::SMEM) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        eps_grid_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<R>::SMEM);
    if (err == cudaSuccess) gr_smem_set<R>() = Tile<R>::SMEM;
    return err;
}

// Blocks of the tile's kernel the card holds at once (blocks per SM x SMs),
// or minus a CUDA error code.  Sets the kernel's shared-memory attribute,
// so it is called before any launch and outside a stream capture.
template <int R>
long long grid_blocks() {
    cudaError_t err = gr_attributes<R>();
    if (err != cudaSuccess) return -(long long)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eps_grid_kernel<R>, GR_THREADS,
                                                        Tile<R>::SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(long long)err;
    return (long long)per_sm * sms;
}

template <int R>
cudaError_t grid_launch(const GridArgs& a, int blocks, cudaStream_t stream) {
    cudaError_t err = gr_attributes<R>();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(GR_THREADS, 1, 1);
    cfg.dynamicSmemBytes = Tile<R>::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, eps_grid_kernel<R>, a);
    // A refused launch (more blocks than the card holds at once: error 720)
    // is returned here and cleared, so that it does not fail the caller's
    // next launch.
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return err;
    }
    return cudaGetLastError();
}

}  // namespace gsmvi_grid
