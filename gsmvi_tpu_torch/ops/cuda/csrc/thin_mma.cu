// The split-k thin product on bf16 tensor cores: the "bf16" and "high"
// (bf16x3) precisions of the eps step's row products.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, the row products that
// the TPU kernels run at big_prec when pallas_precision is "bf16"
// (Precision.DEFAULT, 1 pass) or "high" (Precision.HIGH, 3 passes):
// `ef = e F^T` with `x = mu + ef` (:622/:727), `vf = v F` (:450/:732) and
// `t = vf F^T` (:286), in K1, K2, K4 and K6 (the replica axis of
// gsmvi_tpu/ops/pallas/batch_fused.py :71-91).  The float32 route keeps
// thin_gemm.cu's FFMA kernel unchanged.
//
// Design: thin_gemm.cuh's partition, loads and epilogues, with the FFMA
// tile swapped for mma.sync.  A 32 x 32 output tile per cluster of S =
// thin_split(D) blocks, block r walking its own k range of whole 32-deep
// slabs, staged two deep with cp.async in float32 (zero-filled past the
// ragged edges of M, D and k, so a k tail pads with zeros); each of the 64
// threads' two warps takes 16 rows x 32 columns: per 16-deep k step one A
// fragment and four B fragments, rounded to bf16 (hi, and lo for bf16x3)
// as they load from shared memory, and four (twelve) m16n8k16 mma.  The S
// float32 partial tiles are summed in rank order through distributed
// shared memory, then x = mu + out where asked: the sum order is a function
// of D alone, so replica z of a K-replica launch equals a launch on it
// alone.  Bounds on an H100 at (M, D) = (32, 256): 256 KiB of F,
// 0.000098 ms of bytes, against 2 M FMA at the 989 TFLOP/s bf16 rate
// (3x for bf16x3): latency-bound like the float32 kernel.  Warp-level
// mma.sync is the first tensor-core form; wgmma and TMA are later work.
#include "mma_bf16.cuh"
#include "thin_gemm.cuh"

namespace {

// acc += A' B' over one staged slab on the warp's 16 rows r0..r0+15 and the
// tile's 32 columns (four 8-column n tiles), lane = 4 g + t.
template <bool TB, int MODE>
__device__ __forceinline__ void slab_mma(const Slab& s, float (&acc)[4][4], int r0, int g,
                                         int t) {
#pragma unroll
    for (int kk = 0; kk < TG_BK; kk += 16) {
        const int k = kk + 2 * t;
        const float2 xa[4] = {*reinterpret_cast<const float2*>(&s.a[r0 + g][k]),
                              *reinterpret_cast<const float2*>(&s.a[r0 + g + 8][k]),
                              *reinterpret_cast<const float2*>(&s.a[r0 + g][k + 8]),
                              *reinterpret_cast<const float2*>(&s.a[r0 + g + 8][k + 8])};
        uint32_t ah[4], al[4];
        frag_a<MODE>(xa, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = 8 * j + g;
            float2 b0, b8;
            if (TB) {   // s.b[n][k]: k pairs contiguous
                b0 = *reinterpret_cast<const float2*>(&s.b[n][k]);
                b8 = *reinterpret_cast<const float2*>(&s.b[n][k + 8]);
            } else {    // s.b[k][n]
                b0 = make_float2(s.b[k][n], s.b[k + 1][n]);
                b8 = make_float2(s.b[k + 8][n], s.b[k + 9][n]);
            }
            uint32_t bh[2], bl[2];
            frag_b<MODE>(b0, b8, bh, bl);
            mma_acc<MODE>(acc[j], ah, al, bh, bl);
        }
    }
}

template <bool TB, int EPI, bool VEC, int MODE>
__global__ void __launch_bounds__(TG_THREADS) thin_mma_kernel(ThinArgs p) {
    __shared__ __align__(16) Slab slab[2];
    __shared__ __align__(16) float part[TG_BM * TG_BN];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long z = blockIdx.z;
    const float* pa = p.a + z * p.sa;
    const float* pb = p.b + z * p.sb;
    const int m0 = blockIdx.y * TG_BM;
    const int n0 = (blockIdx.x / p.split) * TG_BN;
    const int kbeg = rank * p.k_per;
    const int kend = min(p.d, kbeg + p.k_per);
    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = (tid >> 5) * 16;

    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    int buf = 0;
    load_slab<TB, PRO_NONE, VEC>(slab[0], p, pa, pb, nullptr, m0, n0, kbeg, kend);
    cp_async_commit();
    for (int k0 = kbeg; k0 < kend; k0 += TG_BK) {
        if (k0 + TG_BK < kend)
            load_slab<TB, PRO_NONE, VEC>(slab[buf ^ 1], p, pa, pb, nullptr, m0, n0, k0 + TG_BK,
                                         kend);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        slab_mma<TB, MODE>(slab[buf], acc, r0, g, t);
        __syncthreads();
        buf ^= 1;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t;
        part[(r0 + g) * TG_BN + c] = acc[j][0];
        part[(r0 + g) * TG_BN + c + 1] = acc[j][1];
        part[(r0 + g + 8) * TG_BN + c] = acc[j][2];
        part[(r0 + g + 8) * TG_BN + c + 1] = acc[j][3];
    }
    cluster.sync();

    // Rank r finishes rows r, r + S, ... of the tile: the S partials summed in
    // rank order, then the epilogue (thin_kernel's).
    const float* peer[TG_MAX_SPLIT];
    for (int q = 0; q < p.split; ++q) peer[q] = cluster.map_shared_rank(part, q);
    float* pc = p.c + z * p.sc;
    float* c2 = p.c2 + z * p.sc;
    const float* epi_vec = p.epi_vec + z * p.svec;
    const int nrows = (TG_BM - rank + p.split - 1) / p.split;
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
    cluster.sync();   // no block leaves while a peer reads its partials
}

template <bool TB, int EPI, int MODE>
cudaError_t launch_thin_mma(const ThinArgs& p, int reps, bool vec, cudaStream_t stream) {
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
    const cudaError_t err =
        vec ? cudaLaunchKernelEx(&cfg, thin_mma_kernel<TB, EPI, true, MODE>, p)
            : cudaLaunchKernelEx(&cfg, thin_mma_kernel<TB, EPI, false, MODE>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int MODE>
cudaError_t thin_rows_mma(const ThinArgs& p, int trans_f, bool add_vec, int reps, bool vec,
                          cudaStream_t s) {
    if (!trans_f) return launch_thin_mma<false, EPI_STORE, MODE>(p, reps, vec, s);
    if (add_vec) return launch_thin_mma<true, EPI_STORE_AND_ADD_VEC, MODE>(p, reps, vec, s);
    return launch_thin_mma<true, EPI_STORE, MODE>(p, reps, vec, s);
}

}  // namespace

extern "C" {

// gsmvi_thin_rows (thin_gemm.cu) at mode 1 (bf16) or 2 (bf16x3): out =
// rows @ F (trans_f 0) or rows @ F^T (trans_f 1), rows (m, d), F (d, d);
// with x_out (trans_f 1 only), also x_out = mu + out.  Replica z's rows
// start z * rows_stride elements in, its F, mu, out and x_out are packed.
int gsmvi_thin_rows_mma(const float* rows, const float* f, const float* mu, float* out,
                        float* x_out, int m, int d, int trans_f, int reps,
                        long long rows_stride, int split, int k_per, int mode, void* stream) {
    if (m < 1 || reps < 1 || !split_ok(d, split, k_per)) return (int)cudaErrorInvalidValue;
    if ((x_out != nullptr && !trans_f) || (mode != MMA_BF16 && mode != MMA_BF16X3))
        return (int)cudaErrorInvalidValue;
    ThinArgs p{};
    p.a = rows; p.b = f; p.c = out; p.c2 = x_out; p.epi_vec = mu;
    p.m = m; p.d = d; p.split = split; p.k_per = k_per;
    p.sa = rows_stride; p.sb = (long long)d * d; p.sc = (long long)m * d; p.svec = d;
    const bool vec = d % 4 == 0 && rows_stride % 4 == 0 && aligned16(rows) && aligned16(f);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool add_vec = x_out != nullptr;
    return (int)(mode == MMA_BF16 ? thin_rows_mma<MMA_BF16>(p, trans_f, add_vec, reps, vec, s)
                                  : thin_rows_mma<MMA_BF16X3>(p, trans_f, add_vec, reps, vec, s));
}

}  // extern "C"
