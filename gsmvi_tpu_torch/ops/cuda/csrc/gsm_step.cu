// K5: the dense GSM update on Hopper, for one fit or K replicas.
//
// Replaces gsmvi_tpu/ops/pallas/gsm_step.py `gsm_update_fused` (:76; body
// `_gsm_kernel` :44-72, pallas_call :91):
//   a = mu0 - x,  t = V S0,  vsv, mv, rho, eps0 = t - a, w,
//   dmu_b = (eps0 - a (w / (1 + rho + mv))) / (1 + rho),  Bm = a + dmu_b,
//   mu = mu0 + sum_b dmu_b / B,  S = S0 + sym((A^T A - Bm^T Bm) / B).
// The TPU kernel is one program with the whole working set in VMEM.  Here
// it is two thread-block-cluster launches on the current stream:
//   A. T = V S0 on the split-k thin product (thin_gemm.cuh, the split
//      thin_split(D)), whose epilogue also writes, per row and 32-column
//      tile of T, the tile's three dot products vsv = v.t, mv = a.v and
//      w = v.(t - a) into a (K, ceil(D/32), 3, B) scratch;
//   B. the Gram, the mean and S (gram_kernel below): a cluster of S <= 8
//      blocks per 32x32 tile (I, J) of S with I <= J, block r of the
//      cluster walking the sample rows [r k_per, (r+1) k_per) (the split
//      gram_split(B), in ops/gsm_step.py) in 32-row slabs.  For each slab
//      it sums each row's tile partials in ascending tile order into wden =
//      w / (1 + rho + mv) and 1 / (1 + rho), stages x and t of both tiles'
//      columns with cp.async two deep, and forms A = mu0 - x, dmu and
//      Bm = A + dmu in shared memory (A and Bm never reach device memory).
//      Each of 64 threads holds a 4x4 register tile of ds(I, J) = A_I^T A_J
//      - Bm_I^T Bm_J, one accumulator per output: fma(a_p, a_q) then
//      fma(-bm_p, bm_q) for each row k, k ascending.  After a cluster
//      barrier, rank r sums the S partial tiles through distributed shared
//      memory in rank order for rows r, r+S, ... and writes S = S0 + ds (1/B)
//      at (I, J) and, off the diagonal, the same sums at (J, I); the S0
//      rows it needs were staged into the free slab buffer while the last
//      slab was multiplied.  On a diagonal tile each rank also sums dmu down
//      its 32 columns, rows ascending, and rank 0 sums those partials in
//      rank order into mu = mu0 + sum (1/B).  No atomics, no grid barrier.
// Symmetry: off the diagonal, S(i, j) and S(j, i) are written from the same
// sum.  On a diagonal tile, ds(p, q) and ds(q, p) take the same products
// (fmaf(a_p, a_q, c) == fmaf(a_q, a_p, c), and -(bm_p) bm_q == -(bm_q)
// bm_p exactly) in the same k order and the same rank order.  So ds is
// symmetric bit for bit, the TPU kernel's 0.5 (ds + ds^T) would change
// nothing, and S is exactly symmetric whenever S0 is.
//
// Determinism: A's split depends on D alone and B's on B alone, so a
// replica's row sums, Gram sums and mean do not depend on K: replica z of
// a K-replica launch equals a launch on replica z alone, bit for bit.
//
// What bounds it on an H100: 2 B D^2 FLOPs for T and 2 B D^2 for the
// Gram's upper half (D^2 FMA pairs over B rows, half of them mirrored):
// 8.4 MFLOP at B=32, D=256 (0.13 us at 67 TFLOP/s in float32) and 134
// MFLOP at B=512 (2.0 us), against ~0.6 / 1.6 MB moved (x, v, S0 read, S
// written; 0.18 / 0.48 us at 3.35 TB/s).  At these shapes latency bounds
// it: the launches, the slabs' load latency, the cluster barriers.  Plain
// f32 FFMA, no TF32 (Precision.HIGHEST on the TPU).  No shared-memory
// budget depends on B or D, so B runs to 65536 and D to 8192
// (GSM_STEP_BATCH_RANGE / GSM_STEP_DIM_RANGE in ops/gsm_step.py: 2 B D <
// 2^31 element offsets), and blockIdx.z carries the replica for fit_batch.
#include "thin_gemm.cuh"

namespace {

constexpr int GR_ROWS = TG_BK;          // sample rows per slab
constexpr int GR_LD = TG_BN + 4;        // padded slab row (16-byte aligned rows)
constexpr int GR_PLD = TG_BN + 1;       // the partial tile's row: conflict-free columns

// Phase times, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel k5, which reads them through
// gsmvi_gram_phases): every thread reads the global timer (ns) at each
// phase boundary, summing over the slabs, and thread 0 of each block of
// replica 0 stores its block's sums.  Without the macro the stamps are empty.
constexpr int GR_PHASES = 8;
constexpr int GR_STAMP_BLOCKS = 4096;
#ifdef GSMVI_PHASE_STAMPS
__device__ long long gram_phase_ns[GR_STAMP_BLOCKS * GR_PHASES];
__device__ __forceinline__ long long gr_now() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define GR_PHASE_INIT                      \
    long long gr_ns[GR_PHASES] = {};       \
    long long gr_last = gr_now()
#define GR_PHASE(k)                        \
    do {                                   \
        const long long t_ = gr_now();     \
        gr_ns[k] += t_ - gr_last;          \
        gr_last = t_;                      \
    } while (0)
#define GR_PHASE_STORE                                                                 \
    do {                                                                               \
        if (threadIdx.x == 0 && blockIdx.z == 0 && blockIdx.x < GR_STAMP_BLOCKS)       \
            for (int k_ = 0; k_ < GR_PHASES; ++k_)                                     \
                gram_phase_ns[blockIdx.x * GR_PHASES + k_] = gr_ns[k_];                \
    } while (0)
#else
#define GR_PHASE_INIT \
    do {              \
    } while (0)
#define GR_PHASE(k) \
    do {            \
    } while (0)
#define GR_PHASE_STORE \
    do {               \
    } while (0)
#endif

struct GramArgs {
    const float* x;      // (reps, b, d)
    const float* t;      // (reps, b, d): V S0
    const float* mu0;    // (reps, d)
    const float* s0;     // (reps, d, d)
    const float* dots;   // (reps, nt, 3, b): launch A's tile partials
    float* mu;           // (reps, d)
    float* s;            // (reps, d, d)
    int b, d, nt, split, k_per;
};

// One slab: x and t of the sample rows [k0, k0 + 32) at the columns of
// tile I and of tile J, turned in place into A and Bm.  On a diagonal tile
// J = I is not loaded and xj holds dmu_I instead.  During the last slab
// the other buffer takes the S0 rows of the epilogue (load_s0_rows).
struct GramSlab {
    float xi[GR_ROWS][GR_LD];
    float ti[GR_ROWS][GR_LD];
    float xj[GR_ROWS][GR_LD];
    float tj[GR_ROWS][GR_LD];
};

// Stage a (32 rows, 32 columns) block of a (b, d) array at (k0, c0); rows
// from kend on and columns from d on are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_block(float (*dst)[GR_LD], const float* src, int k0, int kend,
                                           int c0, int d) {
    const int tid = threadIdx.x;
    if (VEC) {   // d % 4 == 0: a 4-float chunk is wholly in or out of range
#pragma unroll
        for (int i = 0; i < GR_ROWS * TG_BN / 4 / TG_THREADS; ++i) {
            const int q = tid + i * TG_THREADS;
            const int r = q >> 3, c = (q & 7) * 4;
            const int gr = k0 + r, gc = c0 + c;
            const bool in = gr < kend && gc < d;
            cp_async16(&dst[r][c], in ? src + (size_t)gr * d + gc : src, in);
        }
    } else {
#pragma unroll 4
        for (int i = 0; i < GR_ROWS * TG_BN / TG_THREADS; ++i) {
            const int q = tid + i * TG_THREADS;
            const int r = q >> 5, c = q & 31;
            const int gr = k0 + r, gc = c0 + c;
            const bool in = gr < kend && gc < d;
            cp_async4(&dst[r][c], in ? src + (size_t)gr * d + gc : src, in);
        }
    }
}

// Stage the S0 values this rank finishes: row m < nrows of dst holds S0's
// row r0 + rank + split m at the columns [c0, c0 + 32); rows and columns
// from d on are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_s0_rows(float (*dst)[GR_LD], const float* s0, int r0,
                                             int rank, int split, int nrows, int c0, int d) {
    const int tid = threadIdx.x;
    if (VEC) {
        for (int q = tid; q < nrows * TG_BN / 4; q += TG_THREADS) {
            const int m = q >> 3, c = (q & 7) * 4;
            const int gr = r0 + rank + split * m, gc = c0 + c;
            const bool in = gr < d && gc < d;
            cp_async16(&dst[m][c], in ? s0 + (size_t)gr * d + gc : s0, in);
        }
    } else {
        for (int q = tid; q < nrows * TG_BN; q += TG_THREADS) {
            const int m = q >> 5, c = q & 31;
            const int gr = r0 + rank + split * m, gc = c0 + c;
            const bool in = gr < d && gc < d;
            cp_async4(&dst[m][c], in ? s0 + (size_t)gr * d + gc : s0, in);
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(TG_THREADS) gram_kernel(GramArgs p) {
    __shared__ __align__(16) GramSlab slab[2];
    __shared__ float part[TG_BM * GR_PLD];
    __shared__ float mu_part[TG_BN];
    __shared__ float wden[GR_ROWS], ropr[GR_ROWS];
    __shared__ float mus_i[TG_BN], mus_j[TG_BN];

    GR_PHASE_INIT;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long z = blockIdx.z;
    const size_t rows = (size_t)p.b * p.d;
    const float* x = p.x + z * rows;
    const float* t = p.t + z * rows;
    const float* mu0 = p.mu0 + z * p.d;
    const float* s0 = p.s0 + z * (long long)p.d * p.d;
    const float* dots = p.dots + z * (long long)p.nt * 3 * p.b;
    // Tile (I, J), I <= J, the upper triangle in row-major order.
    int tile = blockIdx.x / p.split, ti = 0;
    while (tile >= p.nt - ti) {
        tile -= p.nt - ti;
        ++ti;
    }
    const int tj = ti + tile;
    const bool diag = ti == tj;
    const int c0i = ti * TG_BN, c0j = tj * TG_BN;
    const int kbeg = rank * p.k_per;
    const int kend = min(p.b, kbeg + p.k_per);
    const int nrows = (TG_BM - rank + p.split - 1) / p.split;   // tile rows this rank finishes
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

    int buf = 0;
    load_block<VEC>(slab[0].xi, x, kbeg, kend, c0i, p.d);
    load_block<VEC>(slab[0].ti, t, kbeg, kend, c0i, p.d);
    if (!diag) {
        load_block<VEC>(slab[0].xj, x, kbeg, kend, c0j, p.d);
        load_block<VEC>(slab[0].tj, t, kbeg, kend, c0j, p.d);
    }
    if (tid < TG_BN) {
        cp_async4(&mus_i[tid], c0i + tid < p.d ? mu0 + c0i + tid : mu0, c0i + tid < p.d);
        cp_async4(&mus_j[tid], c0j + tid < p.d ? mu0 + c0j + tid : mu0, c0j + tid < p.d);
    }
    cp_async_commit();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float mu_acc = 0.f;   // thread c < 32 of a diagonal tile: column c's dmu
    GR_PHASE(0);
    for (int k0 = kbeg; k0 < kend; k0 += GR_ROWS) {
        GramSlab& nx = slab[buf ^ 1];
        if (k0 + GR_ROWS < kend) {
            load_block<VEC>(nx.xi, x, k0 + GR_ROWS, kend, c0i, p.d);
            load_block<VEC>(nx.ti, t, k0 + GR_ROWS, kend, c0i, p.d);
            if (!diag) {
                load_block<VEC>(nx.xj, x, k0 + GR_ROWS, kend, c0j, p.d);
                load_block<VEC>(nx.tj, t, k0 + GR_ROWS, kend, c0j, p.d);
            }
        } else {
            // The last slab: the free buffer takes the S0 rows of the
            // epilogue, the direct tile's in xi, the mirror's in ti.
            load_s0_rows<VEC>(nx.xi, s0, c0i, rank, p.split, nrows, c0j, p.d);
            if (!diag) load_s0_rows<VEC>(nx.ti, s0, c0j, rank, p.split, nrows, c0i, p.d);
        }
        cp_async_commit();
        // The slab's row scalars while its copies land: row r's tile
        // partials summed in ascending tile order (read across the warp's
        // rows, the partials lie (tile, 3, B)).
        if (tid < GR_ROWS) {
            const int gr = k0 + tid;
            float wd = 0.f, rop = 1.f;
            if (gr < kend) {
                float vsv = 0.f, mv = 0.f, w = 0.f;
#pragma unroll 8
                for (int q = 0; q < p.nt; ++q) {
                    const float* rd = dots + (size_t)q * 3 * p.b + gr;
                    vsv += rd[0];
                    mv += rd[p.b];
                    w += rd[2 * p.b];
                }
                const float rho = 0.5f * (sqrtf(1.f + 4.f * (vsv + mv * mv)) - 1.f);
                wd = w / (1.f + rho + mv);
                rop = 1.f / (1.f + rho);
            }
            wden[tid] = wd;
            ropr[tid] = rop;
        }
        GR_PHASE(1);
        cp_async_wait<1>();
        __syncthreads();
        GR_PHASE(2);
        GramSlab& s = slab[buf];
        // A = mu0 - x, dmu, Bm = A + dmu in place; rows past kend are zero.
#pragma unroll 4
        for (int i = 0; i < GR_ROWS * TG_BN / TG_THREADS; ++i) {
            const int q = tid + i * TG_THREADS;
            const int r = q >> 5, c = q & 31;
            const bool in = k0 + r < kend;
            const float wd = wden[r], rop = ropr[r];
            {
                const float a = mus_i[c] - s.xi[r][c];
                const float dmu = ((s.ti[r][c] - a) - a * wd) * rop;
                s.xi[r][c] = in ? a : 0.f;
                s.ti[r][c] = in ? a + dmu : 0.f;
                if (diag) s.xj[r][c] = in ? dmu : 0.f;
            }
            if (!diag) {
                const float a = mus_j[c] - s.xj[r][c];
                const float dmu = ((s.tj[r][c] - a) - a * wd) * rop;
                s.xj[r][c] = in ? a : 0.f;
                s.tj[r][c] = in ? a + dmu : 0.f;
            }
        }
        __syncthreads();
        GR_PHASE(3);
        if (diag && tid < TG_BN)
#pragma unroll
            for (int r = 0; r < GR_ROWS; ++r) mu_acc += s.xj[r][tid];
        const float(*aj)[GR_LD] = diag ? s.xi : s.xj;
        const float(*bj)[GR_LD] = diag ? s.ti : s.tj;
#pragma unroll 8
        for (int k = 0; k < GR_ROWS; ++k) {
            const float4 ai4 = *reinterpret_cast<const float4*>(&s.xi[k][ty * 4]);
            const float4 bi4 = *reinterpret_cast<const float4*>(&s.ti[k][ty * 4]);
            const float4 aj4 = *reinterpret_cast<const float4*>(&aj[k][tx * 4]);
            const float4 bj4 = *reinterpret_cast<const float4*>(&bj[k][tx * 4]);
            const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
            const float bi[4] = {-bi4.x, -bi4.y, -bi4.z, -bi4.w};
            const float av[4] = {aj4.x, aj4.y, aj4.z, aj4.w};
            const float bv[4] = {bj4.x, bj4.y, bj4.z, bj4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = fmaf(ai[i], av[j], acc[i][j]);
                    acc[i][j] = fmaf(bi[i], bv[j], acc[i][j]);
                }
        }
        __syncthreads();
        GR_PHASE(4);
        buf ^= 1;
    }
    cp_async_wait<0>();   // the S0 rows, in slab[buf]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(ty * 4 + i) * GR_PLD + tx * 4 + j] = acc[i][j];
    if (diag && tid < TG_BN) mu_part[tid] = mu_acc;
    cluster.sync();
    GR_PHASE(5);

    // Rank r finishes rows r, r + S, ... of the tile and, off the diagonal,
    // of its mirror: this thread's element e is tile row i = rank + S m,
    // column j, with m = idx / 32, j = idx % 32, idx = tid + 64 e.  The S
    // partials summed in rank order (this rank's own read from its shared
    // memory): S(c0i + i, c0j + j) from the partial (i, j) and, mirrored,
    // S(c0j + i, c0i + j) from (j, i).  Each rank's reads are issued
    // together, one rank after another.
    constexpr int EPI_MAX = TG_BM * TG_BN / TG_THREADS;
    float dsum[EPI_MAX], msum[EPI_MAX];
#pragma unroll
    for (int e = 0; e < EPI_MAX; ++e) dsum[e] = msum[e] = 0.f;
    for (int q = 0; q < p.split; ++q) {
        const float* pq = q == rank ? part : cluster.map_shared_rank(part, q);
#pragma unroll
        for (int e = 0; e < EPI_MAX; ++e) {
            const int idx = tid + e * TG_THREADS;
            const int i = rank + p.split * (idx / TG_BN), j = idx % TG_BN;
            if (idx < nrows * TG_BN) {
                dsum[e] += pq[i * GR_PLD + j];
                if (!diag) msum[e] += pq[j * GR_PLD + i];
            }
        }
    }
    GR_PHASE(6);
    const float inv_b = 1.f / static_cast<float>(p.b);
    float* sz = p.s + z * (long long)p.d * p.d;
    const GramSlab& sv = slab[buf];
#pragma unroll
    for (int e = 0; e < EPI_MAX; ++e) {
        const int idx = tid + e * TG_THREADS;
        const int m = idx / TG_BN, j = idx % TG_BN, i = rank + p.split * m;
        if (idx >= nrows * TG_BN) continue;
        if (c0i + i < p.d && c0j + j < p.d)
            sz[(size_t)(c0i + i) * p.d + c0j + j] = sv.xi[m][j] + dsum[e] * inv_b;
        if (!diag && c0j + i < p.d && c0i + j < p.d)
            sz[(size_t)(c0j + i) * p.d + c0i + j] = sv.ti[m][j] + msum[e] * inv_b;
    }
    if (diag && rank == 0 && tid < TG_BN && c0i + tid < p.d) {
        float sum = 0.f;
        for (int q = 0; q < p.split; ++q) sum += cluster.map_shared_rank(mu_part, q)[tid];
        p.mu[z * p.d + c0i + tid] = mu0[c0i + tid] + sum * inv_b;
    }
    cluster.sync();   // no block leaves while a peer reads its partials
    GR_PHASE(7);
    GR_PHASE_STORE;
}

}  // namespace

extern "C" {

// (mu_out, s_out) = the dense GSM update of (x, v, mu0, s0) for `reps`
// replicas stored one after another: x, v, t (reps, B, D); mu0, mu_out
// (reps, D); s0, s_out (reps, D, D), s_out distinct from s0; dots (reps, B,
// ceil(D/32), 3, B).  t and dots are scratch.  (t_split, t_kper) splits D for
// launch A (thin_split(D)), (g_split, g_kper) splits B for launch B
// (gram_split(B)).
int gsmvi_gsm_update(const float* x, const float* v, const float* mu0, const float* s0,
                     float* t, float* dots, float* mu_out, float* s_out, int b, int d, int reps,
                     int t_split, int t_kper, int g_split, int g_kper, void* stream) {
    if (b < 1 || d < 1 || reps < 1 || reps > 65535 || !split_ok(d, t_split, t_kper) ||
        !split_ok(b, g_split, g_kper))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    ThinArgs p{};
    p.a = v; p.b = s0; p.c = t; p.c2 = dots; p.rows2 = x; p.epi_vec = mu0;
    p.m = b; p.d = d; p.split = t_split; p.k_per = t_kper;
    p.sa = (long long)b * d; p.sb = (long long)d * d; p.sc = p.sa; p.svec = d;
    const bool vec_a = d % 4 == 0 && aligned16(v) && aligned16(s0);
    cudaError_t err = launch_thin<false, PRO_NONE, EPI_STORE_AND_ROW_DOTS>(p, reps, vec_a, st);
    if (err != cudaSuccess) return (int)err;

    const int nt = (d + TG_BN - 1) / TG_BN;
    GramArgs g{};
    g.x = x; g.t = t; g.mu0 = mu0; g.s0 = s0; g.dots = dots; g.mu = mu_out; g.s = s_out;
    g.b = b; g.d = d; g.nt = nt; g.split = g_split; g.k_per = g_kper;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(nt * (nt + 1) / 2 * g_split), 1, reps);
    cfg.blockDim = dim3(TG_THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool vec_b = d % 4 == 0 && aligned16(x) && aligned16(t) && aligned16(s0);
    err = vec_b ? cudaLaunchKernelEx(&cfg, gram_kernel<true>, g)
                : cudaLaunchKernelEx(&cfg, gram_kernel<false>, g);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

#ifdef GSMVI_PHASE_STAMPS
// The Gram launch's phase sums (ns) of its first GR_STAMP_BLOCKS blocks,
// GR_PHASES each.
int gsmvi_gram_phases(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, gram_phase_ns, sizeof(gram_phase_ns));
}
#endif

}  // extern "C"
