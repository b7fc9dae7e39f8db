// The thin product C = epi(A' B') on a thread-block cluster with split k:
// A (M, D) with M small, B' the (D, D) factor or its transpose, D large.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, `gaussian_score_kernel`
// (:778, K3: v = (mu_t - x) prec) and the eps-NS step's row products
// `ef = e F^T` with `x = mu + ef` (:622/:727), `vf = v F` (:450/:732) and
// `t = vf F^T` (:286), which the TPU kernels ran as Precision.HIGHEST dots in
// their own bodies.  K1, K2, K4, K6 and batched K1 (ops/fused_step.py) run
// their row products here, and so do K7 and K8 (ops/bam_fused.py: vf, t,
// ef with x = mu + ef, and the mean matvecs gbar F', (gbar F') F'^T of
// gsmvi_tpu/ops/pallas/bam_fused.py :265/:312/:467/:329-330), and K5's
// T = V S0 with the dense update's row dot products in its epilogue
// (gsm_step.cu); ADVI, K4a and the zoo keep the 32x32 tile template of
// gemm.cuh.  The kernel and its primitives live here; thin_gemm.cu holds
// the ns route's and K3's entry points, gsm_step.cu K5's.
//
// What bounds it on an H100: at the main path's shape (M=32, D=256) the
// product is 2 M FMA over a 256 KiB matrix, 0.000098 ms of bytes, so it is
// bound by latency: how many SMs share the k walk and how long each waits on
// its loads.  The 32x32 tile template ran 8 blocks that each walked all 8
// k-slabs with two barriers per slab and no prefetch (18 us on the device).
// Design: a 32x32 output tile per cluster of S blocks; block r of the
// cluster walks its own k range [r k_per, (r+1) k_per) (S = 8 and one
// 32-deep slab each at D=256: 64 blocks at M=32), staging slabs with
// cp.async (16-byte copies where D and the operands allow, 4-byte ones
// otherwise) two deep, so one slab's load overlaps the previous slab's FMAs.
// 64 threads each hold a 4x4 register tile and read operands with 128-bit
// shared loads (8 FMA per load).  After a cluster barrier, rank r sums the
// S partial tiles for rows r, r+S, ... through distributed shared memory in
// rank order 0..S-1 and applies the epilogue: no atomics, no second launch.
// Plain f32 FFMA; each output's k order is ascending within a rank.
//
// Determinism: S and k_per depend on D only (the caller's `thin_split`), so
// an output row's sum does not depend on M, on its tile or on the replica
// count: replica z of a K-replica launch equals a launch on replica z alone,
// and K stacked replicas' score rows equal each replica's own, bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TG_BM = 32;
constexpr int TG_BN = 32;
constexpr int TG_BK = 32;
constexpr int TG_LD = TG_BK + 4;       // padded slab row (16-byte aligned rows)
constexpr int TG_THREADS = 64;         // 8 x 8 threads, a 4 x 4 output tile each
constexpr int TG_MAX_SPLIT = 8;        // the portable cluster size

enum { PRO_NONE = 0, PRO_VEC_MINUS_A = 1 };
enum { EPI_STORE = 0, EPI_STORE_AND_ADD_VEC = 1, EPI_STORE_AND_ROW_DOTS = 2 };

// C(m, n) = epi(sum_k A'(m, k) B'(k, n)), A'(m, k) = a[m lda + k] (minus
// from pro_vec[k] under PRO_VEC_MINUS_A), B'(k, n) = TB ? b[n ld + k] :
// b[k ld + n]; lda = ld = ldc = d.  EPI_STORE_AND_ADD_VEC also writes
// c2 = epi_vec[n] + C.  EPI_STORE_AND_ROW_DOTS (K5's T = V S0, with a = v,
// rows2 = x laid out as a, epi_vec = mu0) also writes, per row m and
// 32-column tile n0/32, the tile's three dot products of the dense update
// into c2 (ceil(d/32), 3, m): sum v C, sum (mu0 - x) v and
// sum v (C - (mu0 - x)).  Replica z = blockIdx.z starts sa, sb, sc, svec
// elements further on (c2 of ROW_DOTS ceil(d/32) 3 m further on).  A
// non-null halt makes the launch a no-op while *halt != 0.
struct ThinArgs {
    const float* a;
    const float* b;
    const float* pro_vec;
    const float* epi_vec;
    const float* rows2;
    float* c;
    float* c2;
    const float* halt;
    int m, d, split, k_per;
    long long sa, sb, sc, svec;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Slab {
    float a[TG_BM][TG_LD];             // rows m, k contiguous
    float b[TG_BK][TG_LD];             // TB: rows n, k contiguous; else rows k, n contiguous
    float v[TG_BK];                    // pro_vec over the slab's k
};

// Stage the k-slab at k0 (columns up to kend) of the tile (m0, n0).
// Out-of-range elements are zero-filled.
template <bool TB, int PRO, bool VEC>
__device__ __forceinline__ void load_slab(Slab& s, const ThinArgs& p, const float* pa,
                                          const float* pb, const float* pro_vec, int m0,
                                          int n0, int k0, int kend) {
    const int tid = threadIdx.x;
    if (VEC) {
        // 32 rows x 8 chunks of 4 floats per operand; D % 4 == 0, so a chunk is
        // wholly in or out of range.
#pragma unroll
        for (int i = 0; i < TG_BM * TG_BK / 4 / TG_THREADS; ++i) {
            const int q = tid + i * TG_THREADS;
            const int r = q >> 3, kc = (q & 7) * 4;
            const int gm = m0 + r, gk = k0 + kc;
            const bool in = gm < p.m && gk < kend;
            cp_async16(&s.a[r][kc], in ? pa + (size_t)gm * p.d + gk : pa, in);
            if (TB) {
                const int gn = n0 + r;
                const bool inb = gn < p.d && gk < kend;
                cp_async16(&s.b[r][kc], inb ? pb + (size_t)gn * p.d + gk : pb, inb);
            } else {
                const int gkb = k0 + r, gn = n0 + kc;
                const bool inb = gkb < kend && gn < p.d;
                cp_async16(&s.b[r][kc], inb ? pb + (size_t)gkb * p.d + gn : pb, inb);
            }
        }
    } else {
#pragma unroll 4
        for (int i = 0; i < TG_BM * TG_BK / TG_THREADS; ++i) {
            const int q = tid + i * TG_THREADS;
            const int r = q >> 5, kc = q & 31;
            const int gm = m0 + r, gk = k0 + kc;
            const bool in = gm < p.m && gk < kend;
            cp_async4(&s.a[r][kc], in ? pa + (size_t)gm * p.d + gk : pa, in);
            if (TB) {
                const int gn = n0 + r;
                const bool inb = gn < p.d && gk < kend;
                cp_async4(&s.b[r][kc], inb ? pb + (size_t)gn * p.d + gk : pb, inb);
            } else {
                const int gkb = k0 + r, gn = n0 + kc;
                const bool inb = gkb < kend && gn < p.d;
                cp_async4(&s.b[r][kc], inb ? pb + (size_t)gkb * p.d + gn : pb, inb);
            }
        }
    }
    if (PRO != PRO_NONE && tid < TG_BK) {
        const bool in = k0 + tid < kend;
        cp_async4(&s.v[tid], in ? pro_vec + k0 + tid : pro_vec, in);
    }
}

template <bool TB, int PRO, int EPI, bool VEC>
__global__ void __launch_bounds__(TG_THREADS) thin_kernel(ThinArgs p) {
    __shared__ __align__(16) Slab slab[2];
    __shared__ __align__(16) float part[TG_BM * TG_BN];
    if (p.halt != nullptr && *p.halt != 0.f) return;   // the same for every block

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long z = blockIdx.z;
    const float* pa = p.a + z * p.sa;
    const float* pb = p.b + z * p.sb;
    const float* pro_vec = p.pro_vec + z * p.svec;
    const int m0 = blockIdx.y * TG_BM;
    const int n0 = (blockIdx.x / p.split) * TG_BN;
    const int kbeg = rank * p.k_per;
    const int kend = min(p.d, kbeg + p.k_per);
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    int buf = 0;
    load_slab<TB, PRO, VEC>(slab[0], p, pa, pb, pro_vec, m0, n0, kbeg, kend);
    cp_async_commit();
    for (int k0 = kbeg; k0 < kend; k0 += TG_BK) {
        if (k0 + TG_BK < kend)
            load_slab<TB, PRO, VEC>(slab[buf ^ 1], p, pa, pb, pro_vec, m0, n0, k0 + TG_BK, kend);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const Slab& s = slab[buf];
#pragma unroll
        for (int kk = 0; kk < TG_BK; kk += 4) {
            float a[4][4], bq[4][4];   // a[row][k], bq[k][col]
            const float4 v = PRO == PRO_VEC_MINUS_A
                                 ? *reinterpret_cast<const float4*>(&s.v[kk])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 t = *reinterpret_cast<const float4*>(&s.a[ty * 4 + i][kk]);
                a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
                if (PRO == PRO_VEC_MINUS_A) {
                    a[i][0] = v.x - a[i][0]; a[i][1] = v.y - a[i][1];
                    a[i][2] = v.z - a[i][2]; a[i][3] = v.w - a[i][3];
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (TB) {   // column tx + 8 j: conflict-free rows
                    const float4 t = *reinterpret_cast<const float4*>(&s.b[tx + 8 * j][kk]);
                    bq[0][j] = t.x; bq[1][j] = t.y; bq[2][j] = t.z; bq[3][j] = t.w;
                } else {    // columns 4 tx .. 4 tx + 3
                    const float4 t = *reinterpret_cast<const float4*>(&s.b[kk + j][tx * 4]);
                    bq[j][0] = t.x; bq[j][1] = t.y; bq[j][2] = t.z; bq[j][3] = t.w;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][q], bq[q][j], acc[i][j]);
        }
        __syncthreads();
        buf ^= 1;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = TB ? tx + 8 * j : tx * 4 + j;
            part[(ty * 4 + i) * TG_BN + col] = acc[i][j];
        }
    cluster.sync();

    // Rank r finishes rows r, r + S, ... of the tile: the S partials summed in
    // rank order, then the epilogue.
    const float* peer[TG_MAX_SPLIT];
    for (int q = 0; q < p.split; ++q) peer[q] = cluster.map_shared_rank(part, q);
    float* pc = p.c + z * p.sc;
    float* c2 = p.c2 + z * p.sc;
    const float* epi_vec = p.epi_vec + z * p.svec;
    const int nrows = (TG_BM - rank + p.split - 1) / p.split;
    if (EPI == EPI_STORE_AND_ROW_DOTS) {
        // A warp per row (TG_BN = 32 lanes, one column each): the row's
        // sums, then its three dot products over the tile's columns by a
        // butterfly in a fixed order.
        const float* x = p.rows2 + z * p.sa;
        const int ntiles = gridDim.x / p.split;
        const float* rp[TG_MAX_SPLIT];   // the ranks' partials, held in registers
#pragma unroll
        for (int q = 0; q < TG_MAX_SPLIT; ++q) rp[q] = q < p.split ? peer[q] : part;
        float* dots = p.c2 + (z * ntiles + n0 / TG_BN) * 3 * (long long)p.m;
        for (int idx = tid; idx < nrows * TG_BN; idx += TG_THREADS) {
            const int i = rank + p.split * (idx / TG_BN), j = idx % TG_BN;
            const int gm = m0 + i, gn = n0 + j;
            if (gm >= p.m) continue;   // the whole warp shares the row
            float vsv = 0.f, mv = 0.f, w = 0.f;
            if (gn < p.d) {
                float sum = 0.f;   // rank order; every read issued first
#pragma unroll
                for (int q = 0; q < TG_MAX_SPLIT; ++q)
                    if (q < p.split) sum += rp[q][i * TG_BN + j];
                const size_t o = (size_t)gm * p.d + gn;
                pc[o] = sum;
                const float vv = pa[o], a = epi_vec[gn] - x[o];
                vsv = vv * sum;
                mv = a * vv;
                w = vv * (sum - a);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                vsv += __shfl_xor_sync(0xffffffffu, vsv, o);
                mv += __shfl_xor_sync(0xffffffffu, mv, o);
                w += __shfl_xor_sync(0xffffffffu, w, o);
            }
            if (j == 0) {
                dots[gm] = vsv;
                dots[p.m + gm] = mv;
                dots[2 * p.m + gm] = w;
            }
        }
    } else {
        for (int idx = tid; idx < nrows * TG_BN; idx += TG_THREADS) {
            const int i = rank + p.split * (idx / TG_BN), j = idx % TG_BN;
            const int gm = m0 + i, gn = n0 + j;
            if (gm >= p.m || gn >= p.d) continue;
            float sum = 0.f;
            for (int q = 0; q < p.split; ++q) sum += peer[q][i * TG_BN + j];
            const size_t o = (size_t)gm * p.d + gn;
            pc[o] = sum;
            if (EPI == EPI_STORE_AND_ADD_VEC) c2[o] = epi_vec[gn] + sum;
        }
    }
    cluster.sync();   // no block leaves while a peer reads its partials
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <bool TB, int PRO, int EPI>
cudaError_t launch_thin(const ThinArgs& p, int reps, bool vec, cudaStream_t stream) {
    const int ntn = (p.d + TG_BN - 1) / TG_BN, ntm = (p.m + TG_BM - 1) / TG_BM;
    if (ntm > 65535 || reps > 65535) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ntn * p.split, ntm, reps);
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
    const cudaError_t err = vec ? cudaLaunchKernelEx(&cfg, thin_kernel<TB, PRO, EPI, true>, p)
                                : cudaLaunchKernelEx(&cfg, thin_kernel<TB, PRO, EPI, false>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The split must cover [0, n) with no empty rank: k_per a whole number of
// slabs, (split - 1) k_per < n <= split k_per.
bool split_ok(int n, int split, int k_per) {
    return n >= 1 && split >= 1 && split <= TG_MAX_SPLIT && k_per >= TG_BK && k_per % TG_BK == 0 &&
           (long long)(split - 1) * k_per < n && (long long)split * k_per >= n;
}

}  // namespace
