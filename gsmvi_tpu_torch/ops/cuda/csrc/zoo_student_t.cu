// The multivariate-t score of the zoo (K11a-student_t) in one launch on the
// split-k thin product (thin_gemm.cuh), the score launch of the whole-step
// paths (K2, K4, K6, K8-K10) on Student-t targets.
//
// Replaces `student_t_score_kernel` (gsmvi_tpu/ops/pallas/fused_step.py
// :831), which the TPU traced into its whole-step kernels:
//     P = (x - loc) Prec, maha = rowsum(P o (x - loc)),
//     v = -(df + D) / (df + maha) P.
// The parameters stay in device memory (loc, Prec, [df, D]): a launch never
// waits for the host.
//
// What bounds it on an H100: at the zoo path's shape (B=32, D=256) it is
// K3's product, 2 B D^2 = 4.2 MFLOP over a 256 KiB matrix (0.000098 ms of
// bytes), plus O(B D) row work, so latency bounds it: how many SMs share
// the k walk, and how many launches and grid-wide steps the row work
// takes.  Before, it ran on the 32x32 tile template (8 blocks, each walking
// all 8 k-slabs, 18.5 us) and then a warp-per-row scale kernel.
//
// Design, one launch:
// - Each 32x32 tile of P is a cluster of S = thin_split(D) blocks, exactly
//   K3's partition (gsmvi_thin_score): block r walks its k range, x - loc
//   formed as A's slab is consumed (PRO_A_MINUS_VEC), and after a cluster
//   barrier rank r sums the S partial tiles of rows r, r + S, ... through
//   distributed shared memory in rank order.
// - In the same epilogue a warp per row stores the tile's unscaled P and
//   forms the tile's part of maha, sum over its 32 columns of P (x - loc)
//   (x and loc re-read at the output columns), by a butterfly in a fixed
//   order, into a (ceil(D/32), M) scratch.
// - Rows r, r + S, ... of every tile are written by the clusters' rank-r
//   blocks alone, so each rank-r block then takes an integer ticket of its
//   (32-row block, rank); the last to arrive stages its rows' partials in
//   shared memory, sums each row's in tile order, scales its rows of P in
//   place (every load of a thread issued before its stores) and sets the
//   ticket back to 0.  Its cluster barrier is split: a block signals that
//   it has read its peers' partials before its ticket and waits for its
//   peers' signal only at its end, so no barrier stands between the stores
//   and the scale.  No float atomics and no grid barrier: the result
//   reproduces from run to run, and the tickets are 0 again after every
//   launch, so a CUDA graph can replay it.
// Sum orders: each element of P is K3's (a fmaf chain over ascending k
// within a rank, the ranks summed in rank order); maha sums 32-column tiles
// in ascending tile order.  S, k_per and the tiles depend on D alone, so a
// row's score does not depend on M: K stacked replicas' rows equal each
// replica's own, bit for bit.
#include "thin_gemm.cuh"

namespace {

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel zoo, through
// gsmvi_student_t_phases): thread 0 of each block of row block 0 writes
// the global timer (ns) at ZT_PHASE(k), k < ZT_PHASES.  Without the macro
// ZT_PHASE is empty.
constexpr int ZT_PHASES = 6;
constexpr int ZT_MAX_BLOCKS = 256 * TG_MAX_SPLIT;   // D = 8192
#ifdef GSMVI_PHASE_STAMPS
__device__ long long zt_phase_ns[ZT_MAX_BLOCKS * ZT_PHASES];
#define ZT_PHASE(k)                                                               \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.y == 0) {                                \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            zt_phase_ns[blockIdx.x * ZT_PHASES + (k)] = t_;                       \
        }                                                                         \
    } while (0)
#else
#define ZT_PHASE(k) \
    do {            \
    } while (0)
#endif

// x (m, d), loc (d,), prec (d, d) symmetric, dfd = [df, D]; v (m, d) out;
// partial (ceil(d/32), m) and ticket (ceil(m/32), split) scratch, the
// tickets 0 on entry and on exit.
struct StudentArgs {
    const float* x;
    const float* loc;
    const float* prec;
    const float* dfd;
    float* v;
    float* partial;
    int* ticket;
    int m, d, split, k_per;
};

// The last rank-r block of row block m0 / 32: rows r, r + S, ... (nrows of
// them) have every tile's P and maha partial in place.  Their partials go
// to `stage` (nrows x ntiles <= 32 x 32 at every D, thin_split) while each
// thread's first U vectors of P are read, each row's maha is summed in tile
// order, and the rows are scaled in place.
template <bool VEC>
__device__ __forceinline__ void scale_rows(const StudentArgs& q, float* stage, int rank,
                                           int split, int nrows, int ntiles, int m0) {
    const int tid = threadIdx.x;
    const int nv = VEC ? q.d / 4 : q.d;   // a row's vectors
    constexpr int U = 4;
    float4 val[U];
    auto at = [&](int e) -> float* {     // vector e of the rows, or null
        const int gm = m0 + rank + split * (e / nv);
        if (e >= nrows * nv || gm >= q.m) return nullptr;
        return q.v + (size_t)gm * q.d + (size_t)(e % nv) * (VEC ? 4 : 1);
    };
    auto load = [&](int e0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const float* a = at(e0 + u * TG_THREADS);
            if (a == nullptr) continue;
            if (VEC) val[u] = __ldcg(reinterpret_cast<const float4*>(a));
            else val[u].x = __ldcg(a);
        }
    };
    load(tid);
    for (int e = tid; e < nrows * ntiles; e += TG_THREADS) {
        const int gm = m0 + rank + split * (e / ntiles);
        stage[e] = gm < q.m ? __ldcg(q.partial + (size_t)(e % ntiles) * q.m + gm) : 0.f;
    }
    __syncthreads();
    __shared__ float scale[TG_BM];
    if (tid < nrows) {
        float maha = 0.f;
        for (int t = 0; t < ntiles; ++t) maha += stage[tid * ntiles + t];
        const float df = q.dfd[0], dd = q.dfd[1];
        scale[tid] = -(df + dd) / (df + maha);
    }
    __syncthreads();
    for (int e0 = tid; e0 < nrows * nv; e0 += U * TG_THREADS) {
        if (e0 != tid) load(e0);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * TG_THREADS;
            float* a = at(e);
            if (a == nullptr) continue;
            const float c = scale[e / nv];
            if (VEC) {
                *reinterpret_cast<float4*>(a) =
                    make_float4(c * val[u].x, c * val[u].y, c * val[u].z, c * val[u].w);
            } else {
                *a = c * val[u].x;
            }
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(TG_THREADS) student_t_kernel(StudentArgs q) {
    __shared__ __align__(16) Slab slab[2];
    __shared__ __align__(16) float part[TG_BM * TG_BN];
    __shared__ float stage[TG_BM * TG_BN];
    __shared__ int last;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int split = q.split;
    const int m0 = blockIdx.y * TG_BM;
    const int tile = blockIdx.x / split, ntiles = gridDim.x / split;
    const int n0 = tile * TG_BN;
    const int kbeg = rank * q.k_per;
    const int kend = min(q.d, kbeg + q.k_per);
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

    ZT_PHASE(0);
    ThinArgs p{};
    p.m = q.m; p.d = q.d;
    float acc[4][4];
    thin_walk<false, PRO_A_MINUS_VEC, VEC>(slab, p, q.x, q.prec, q.loc, m0, n0, kbeg, kend, acc);
    ZT_PHASE(1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(ty * 4 + i) * TG_BN + tile_col<false>(tx, j)] = acc[i][j];
    cluster.sync();
    ZT_PHASE(2);

    // Rank r finishes rows r, r + S, ... of the tile, a warp per row (a lane
    // per column): P summed in rank order and stored unscaled, then the
    // tile's part of maha, sum over its columns of P (x - loc), by a
    // butterfly.
    const int nrows = (TG_BM - rank + split - 1) / split;
    const float* rp[TG_MAX_SPLIT];   // the ranks' partials, held in registers
#pragma unroll
    for (int r = 0; r < TG_MAX_SPLIT; ++r) rp[r] = cluster.map_shared_rank(part, r < split ? r : 0);
    for (int idx = tid; idx < nrows * TG_BN; idx += TG_THREADS) {
        const int i = rank + split * (idx / TG_BN), j = idx % TG_BN;
        const int gm = m0 + i, gn = n0 + j;
        if (gm >= q.m) continue;   // the whole warp shares the row
        float t = 0.f;
        if (gn < q.d) {
            float sum = 0.f;   // rank order; every read issued first
#pragma unroll
            for (int r = 0; r < TG_MAX_SPLIT; ++r)
                if (r < split) sum += rp[r][i * TG_BN + j];
            const size_t o = (size_t)gm * q.d + gn;
            q.v[o] = sum;
            t = sum * (q.x[o] - q.loc[gn]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (j == 0) q.partial[(size_t)tile * q.m + gm] = t;
    }
    ZT_PHASE(3);
    // This block has read its peers' partials: it signals so now and waits
    // for the peers' signal (that they have read its own) only at its end.
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

    // Rows r, r + S, ... of every tile of the row block are written by the
    // rank-r blocks alone, so the rank-r block that arrives last, by its
    // ticket, scales them.
    __syncthreads();
    if (tid == 0) {   // an acquire-release add: the block's stores go first
        int before;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(before)
                     : "l"(q.ticket + (size_t)blockIdx.y * split + rank)
                     : "memory");
        last = before == ntiles - 1;
    }
    __syncthreads();
    ZT_PHASE(4);
    if (last) {   // thread 0's acquire and the barrier order the reads after
        scale_rows<VEC>(q, stage, rank, split, nrows, ntiles, m0);
        if (tid == 0) q.ticket[(size_t)blockIdx.y * split + rank] = 0;
    }
    ZT_PHASE(5);
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" {

#ifdef GSMVI_PHASE_STAMPS
// The phase timestamps of the last launch: ZT_MAX_BLOCKS x ZT_PHASES.
int gsmvi_student_t_phases(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, zt_phase_ns, sizeof(zt_phase_ns));
}
#endif

// Student-t score of the (m, d) rows x into v: loc (d,), prec (d, d)
// symmetric, dfd = [df, D] (1, 2); partial (ceil(d/32), m) floats and
// ticket (ceil(m/32), split) ints of scratch, the tickets 0 (and left 0).  One
// cluster launch: a cluster of `split` blocks per 32x32 tile of the
// output, (split, k_per) = thin_split(d).
int gsmvi_student_t_score(const float* x, const float* loc, const float* prec,
                          const float* dfd, float* v, float* partial, int* ticket, int m,
                          int d, int split, int k_per, void* stream) {
    if (m < 1 || !split_ok(d, split, k_per)) return (int)cudaErrorInvalidValue;
    const int ntn = (d + TG_BN - 1) / TG_BN, ntm = (m + TG_BM - 1) / TG_BM;
    if (ntm > 65535) return (int)cudaErrorInvalidValue;
    StudentArgs q{x, loc, prec, dfd, v, partial, ticket, m, d, split, k_per};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ntn * split, ntm, 1);
    cfg.blockDim = dim3(TG_THREADS, 1, 1);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool vec = d % 4 == 0 && aligned16(x) && aligned16(prec);
    const cudaError_t err = vec ? cudaLaunchKernelEx(&cfg, student_t_kernel<true>, q)
                                : cudaLaunchKernelEx(&cfg, student_t_kernel<false>, q);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
