// The logistic-regression posterior's score of the zoo (K11b-logreg) in
// one cluster launch on the thin product's primitives (thin_gemm.cuh), the
// score launch of the whole-step paths (K2, K4, K6, K8-K10) on logistic
// regression targets.
//
// Replaces `logreg_score_kernel` (gsmvi_tpu/ops/pallas/fused_step.py :869),
// which the TPU traced into its whole-step kernels:
//     v = (y - 1/(1 + e^{-w X^T})) X - w/ps^2.
// Every parameter stays in device memory (X, y, 1/ps^2): a launch never
// waits for the host.  The sigmoid saturates to 0 or 1 for |z| > ~100
// (e^{-z} is 0 or inf), with no NaN.
//
// What bounds it on an H100: two products of 2 B N D FLOP each (6.55 MFLOP
// at B=32, N=200, D=256) over 200 KB of data, so latency bounds it, as the
// thin product: how many SMs share the work and how many launches and
// round trips through memory it takes.  Before, it ran as two launches of
// the 32x32 tile template with resid (B, N) through L2 (28.1 us).
//
// Design: one cluster of S = min(8, max(ceil(N/32), ceil(D/32))) blocks per
// 16-row block of w (16 rows, not 32: the FFMA of both products on a row
// block's S SMs is the largest part of the time, so a thinner row block
// puts twice the SMs on it).  A block is 8 one-warp groups; for each 16x32
// output tile, warp g walks the k slabs g, g + 8, g + 16, ... with its own
// 4x4 register tiles and its own two-deep cp.async staging (stage_a,
// stage_b, walk_slabs on a 16-row SlabT), and the eight partial tiles are
// summed in group order in the tile's epilogue: eight walks at once keep 8
// warps busy on an SM where one keeps 1.
// - Phase 1: rank r owns N tiles [r T, (r+1) T), T = ceil(ceil(N/32)/S);
//   for each it walks k over all of D, z = w X^T, and forms resid =
//   y - 1/(1 + e^{-z}) in its epilogue, kept in its own shared memory
//   (columns past N as 0).
// - A cluster barrier.
// - Phase 2: rank r computes the 32-column tiles r, r + S, ... of
//   resid X over k = N: slab t of resid comes from rank t / T's shared
//   memory through distributed shared memory as the slab is staged, X's
//   by cp.async; the epilogue subtracts w/ps^2.
// - A last cluster barrier, so that no block leaves while a peer reads it.
// Where the cluster's shared memory cannot hold resid (T 32-column tiles
// of 16 rows a rank: N above 8 x 58 x 32 = 14,848), the same kernel keeps
// resid in an L2 scratch instead (the `resid` argument), written in phase 1
// and read back in phase 2 by the same cluster: still one launch.
// Sum orders: every z and every output is the sum, in group order, of eight
// fmaf chains over ascending k, chain g over the k slabs g mod 8 (of D for
// z, of N for the output, the slabs of resid read from whichever rank
// holds them).  That depends on the k extent alone, not on S, the route or
// M: K stacked replicas' rows equal each replica's own, bit for bit.
#include "thin_gemm.cuh"

namespace {

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel zoo, through gsmvi_logreg_phases):
// thread 0 of each block of row block 0 writes the global timer (ns) at
// ZL_PHASE(k), k < ZL_PHASES.  Without the macro ZL_PHASE is empty.
constexpr int ZL_PHASES = 6;
#ifdef GSMVI_PHASE_STAMPS
__device__ long long zl_phase_ns[TG_MAX_SPLIT * ZL_PHASES];
#define ZL_PHASE(k)                                                               \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.y == 0) {                                \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            zl_phase_ns[blockIdx.x * ZL_PHASES + (k)] = t_;                       \
        }                                                                         \
    } while (0)
#else
#define ZL_PHASE(k) \
    do {            \
    } while (0)
#endif

// w (m, d), xdata (n, d), y (n,), inv_ps2 (1,); v (m, d) out.  resid null:
// resid in shared memory; else an (ceil(m/16) 16, ceil(n/32) 32) scratch.
struct LogregArgs {
    const float* w;
    const float* xdata;
    const float* y;
    const float* inv_ps2;
    float* v;
    float* resid;
    int m, d, n, split, npt;
};

constexpr int LR_BM = 16;                              // rows of w a cluster takes
constexpr int LR_GROUPS = 8;                           // walks a block runs at once
constexpr int LR_THREADS = LR_GROUPS * 32;             // a warp a walk
using LSlab = SlabT<LR_BM>;
constexpr int LR_SLABS_FLOATS = LR_GROUPS * 2 * (int)(sizeof(LSlab) / sizeof(float));
static_assert(LR_GROUPS * LR_BM * TG_BN <= LR_SLABS_FLOATS, "the groups' tiles fit the slabs");

// The row stride of a rank's resid in shared memory (16-byte rows).
__host__ __device__ constexpr int lr_ld(int npt) { return npt * TG_BN + 4; }

size_t lr_smem_bytes(int npt, bool shared) {
    return sizeof(float) * (LR_SLABS_FLOATS + (shared ? (size_t)LR_BM * lr_ld(npt) : 0));
}

// The groups' partial tiles summed in group order, then epi(row, col, sum)
// over the 16x32 tile by the whole block.  `red` lies over the slabs, so
// it waits for every walk first, and the next walk for every read.
template <bool TB, class Epi>
__device__ __forceinline__ void reduce_groups(float* red, const float (&acc)[4][4], int g, int lt,
                                              Epi epi) {
    const int ty = lt >> 3, tx = lt & 7;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            red[(g * LR_BM + ty * 4 + i) * TG_BN + tile_col<TB>(tx, j)] = acc[i][j];
    __syncthreads();
    for (int e = threadIdx.x; e < LR_BM * TG_BN; e += LR_THREADS) {
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < LR_GROUPS; ++h) sum += red[h * LR_BM * TG_BN + e];
        epi(e / TG_BN, e % TG_BN, sum);
    }
    __syncthreads();
}

template <bool VEC, bool SHARED>
__global__ void __launch_bounds__(LR_THREADS) logreg_kernel(LogregArgs q) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, g = tid / 32, lt = tid % 32;
    LSlab (&slab)[2] = reinterpret_cast<LSlab(*)[2]>(smem)[g];
    float* red = smem;                    // (LR_GROUPS, 16, 32), over the slabs
    float* rs = smem + LR_SLABS_FLOATS;   // (16, lr_ld(npt)): this rank's resid

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int split = q.split, npt = q.npt;
    const int m0 = blockIdx.y * LR_BM;
    const int ntn = (q.n + TG_BN - 1) / TG_BN, ntd = (q.d + TG_BN - 1) / TG_BN;
    const int rld = lr_ld(npt);
    const size_t gld = (size_t)ntn * TG_BN;   // the L2 scratch's row stride
    const int kbeg = g * TG_BK, kstep = LR_GROUPS * TG_BK;   // group g's slabs
    float acc[4][4];
    ZL_PHASE(0);

    // Phase 1: z = w X^T over this rank's N tiles, resid in the epilogue.
    for (int tl = 0; tl < npt; ++tl) {
        const int nt = rank * npt + tl;
        if (nt >= ntn) break;
        const int n0 = nt * TG_BN;
        walk_slabs<true, PRO_NONE>(
            slab,
            [&](LSlab& s, int k0) {
                stage_a<PRO_NONE, VEC, 32>(s, lt, q.w, q.d, q.m, nullptr, m0, k0, q.d);
                stage_b<true, VEC, 32>(s.b, lt, q.xdata, q.d, q.n, n0, k0, q.d);
            },
            kbeg, q.d, kstep, WarpSync(), lt, acc);
        if (tl == 0) ZL_PHASE(1);
        reduce_groups<true>(red, acc, g, lt, [&](int row, int col, float z) {
            const int gn = n0 + col;
            const float r = gn < q.n ? q.y[gn] - 1.f / (1.f + expf(-z)) : 0.f;
            if (SHARED) rs[row * rld + tl * TG_BN + col] = r;
            else q.resid[(size_t)(m0 + row) * gld + gn] = r;
        });
    }
    ZL_PHASE(2);
    cluster.sync();   // every rank's resid written
    ZL_PHASE(3);

    // Phase 2: v = resid X - w/ps^2 over this rank's D tiles, k = N; the
    // slab of resid at k0 comes from the rank that holds it.
    constexpr int NQ = LR_BM * TG_BK / 4 / 32;   // float4s a thread stages
    const float inv = q.inv_ps2[0];
    for (int c = rank; c < ntd; c += split) {
        const int c0 = c * TG_BN;
        walk_slabs<false, PRO_NONE>(
            slab,
            [&](LSlab& s, int k0) {
                stage_b<false, VEC, 32>(s.b, lt, q.xdata, q.d, q.d, c0, k0, q.n);
                const int nt = k0 / TG_BK;
                const bool in = k0 < q.n;   // else a group with no slab: never read
                const float* peer = SHARED && in
                                        ? cluster.map_shared_rank(rs, nt / npt) + (nt % npt) * TG_BN
                                        : nullptr;
#pragma unroll
                for (int i = 0; i < NQ; ++i) {
                    const int qq = lt + i * 32, r = qq >> 3, kc = (qq & 7) * 4;
                    if (SHARED) {
                        if (in)
                            *reinterpret_cast<float4*>(&s.a[r][kc]) =
                                *reinterpret_cast<const float4*>(peer + r * rld + kc);
                    } else {
                        const float* src = q.resid + (size_t)(m0 + r) * gld + k0 + kc;
                        cp_async16(&s.a[r][kc], in ? src : q.resid, in);
                    }
                }
            },
            kbeg, q.n, kstep, WarpSync(), lt, acc);
        if (c == rank) ZL_PHASE(4);
        reduce_groups<false>(red, acc, g, lt, [&](int row, int col, float sum) {
            const int gm = m0 + row, gc = c0 + col;
            if (gm >= q.m || gc >= q.d) return;
            const size_t o = (size_t)gm * q.d + gc;
            q.v[o] = sum - __fmul_rn(q.w[o], inv);
        });
    }
    cluster.sync();   // no block leaves while a peer reads its resid
    ZL_PHASE(5);
}

template <bool VEC, bool SHARED>
cudaError_t launch_logreg(const LogregArgs& q, cudaStream_t stream) {
    const size_t smem = lr_smem_bytes(q.npt, SHARED);
    // Above 48 KB (always: the slabs alone take 110 KiB) needs the opt-in, a
    // function attribute, set at the first launch to the most a block may
    // take.
    static bool opted_in = false;
    if (!opted_in) {
        int dev = 0, most = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(logreg_kernel<VEC, SHARED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        opted_in = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(q.split, (q.m + LR_BM - 1) / LR_BM, 1);
    cfg.blockDim = dim3(LR_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = q.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, logreg_kernel<VEC, SHARED>, q);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef GSMVI_PHASE_STAMPS
// The phase timestamps of the last launch: TG_MAX_SPLIT x ZL_PHASES.
int gsmvi_logreg_phases(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, zl_phase_ns, sizeof(zl_phase_ns));
}
#endif

// Logistic-regression score of the (m, d) weight rows w into v: xdata (n,
// d), y (1, n), inv_ps2 (1, 1).  One cluster launch of `split` blocks per 16
// rows, each rank holding `npt` of the ceil(n/32) resid tiles: in shared
// memory when resid is null, else in resid, an (ceil(m/16) 16, ceil(n/32)
// 32) scratch.
int gsmvi_logreg_score(const float* w, const float* xdata, const float* y,
                       const float* inv_ps2, float* resid, float* v, int m, int d, int n,
                       int split, int npt, void* stream) {
    const int ntn = (n + TG_BN - 1) / TG_BN;
    if (m < 1 || d < 1 || n < 1 || split < 1 || split > TG_MAX_SPLIT || npt < 1 ||
        (long long)split * npt < ntn || (m + LR_BM - 1) / LR_BM > 65535)
        return (int)cudaErrorInvalidValue;
    LogregArgs q{w, xdata, y, inv_ps2, v, resid, m, d, n, split, npt};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0 && aligned16(w) && aligned16(xdata);
    if (resid == nullptr)
        return (int)(vec ? launch_logreg<true, true>(q, s) : launch_logreg<false, true>(q, s));
    return (int)(vec ? launch_logreg<true, false>(q, s) : launch_logreg<false, false>(q, s));
}

}  // extern "C"
