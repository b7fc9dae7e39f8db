// The thin product on bf16 tensor cores: the "bf16" and "high" (bf16x3)
// precisions of the eps step's row products.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, the row products that
// the TPU kernels run at big_prec when pallas_precision is "bf16"
// (Precision.DEFAULT, 1 pass) or "high" (Precision.HIGH, 3 passes):
// `ef = e F^T` with `x = mu + ef` (:622/:727), `vf = v F` (:450/:732) and
// `t = vf F^T` (:286), in K1, K2, K4 and K6 (the replica axis of
// gsmvi_tpu/ops/pallas/batch_fused.py :71-91).  The float32 route keeps
// thin_gemm.cu's FFMA kernel unchanged.
//
// What bounds it on an H100: at (M, D) = (32, 256) it is 2 M multiply-adds
// (0.0042 us at the 989 TFLOP/s bf16 rate, 3x at bf16x3) over 256 KiB of F,
// 0.000098 ms of bytes: the launch and the loads' latency set its time, not
// the tensor cores.  Its first form put mma.sync into thin_gemm.cu's
// split-k FFMA skeleton (a cluster of 8 blocks at D = 256, each one 32-deep
// slab, two cluster barriers and an 8-way exchange through distributed
// shared memory, every fragment rounded as it was read) and ran at the
// float32 kernel's time, behind torch.mm.  Design now:
// - One block per output tile and no cluster: ThinS, 16 x 16 tiles, below
//   THIN_MMA_LARGE_D = 768 (32 blocks at M = 32, D = 256); ThinL, 32 x 32,
//   from it on.  The host picks the plan by D alone (fs.thin_mma_tile).
// - The W warps of a block split k among themselves: k is cut into KC-deep
//   chunks, and warp w takes chunks w, w + W, w + 2W, ... over the whole
//   tile (ThinS: W = 8, KC = 32; ThinL: W = 4, KC = 32).  Each warp stages
//   its own chunks (16-byte global loads into registers, rounded to bf16
//   once as they are stored: hi, and lo = bf16(x - hi) at bf16x3), so the
//   k loop has no block barrier; at D <= 256 every warp loads its one
//   chunk at once, and above, the next chunk's loads are in flight while
//   the current one runs.  (Chosen on an H100 among W = 4, 8, 16 and KC =
//   16-64: at (32, 256) eight warps of one 32-deep chunk cut the loads a
//   lane and the dependent mma chain; at (512, 1024) four warps of 32 x 32
//   tiles led.)
// - Shared rows are k-contiguous for A and for B of rows @ F^T (plain
//   ldmatrix) and n-contiguous for B of rows @ F (ldmatrix .trans), padded
//   to an odd number of 16-byte units: conflict-free fragment loads.
// - m16n8k16 mma into float32 accumulators (bf16x3: a_lo b_hi, a_hi b_lo,
//   a_hi b_hi each step), then the W warps' partial tiles are summed in
//   warp order through shared memory under one barrier, and out (and x =
//   mu + out) written a float4 at a time.
//
// Determinism: the plan, and with it the chunks, their owners and the sum
// order of every output, is a function of D alone, so an output row does
// not depend on M, on its tile or on the replica count: replica z of a
// K-replica launch (blockIdx.z) equals a launch on replica z alone.
#include <cuda_runtime.h>
#include <stddef.h>

#include "apply.cuh"   // load4, store4, aligned16
#include "mma_bf16.cuh"

namespace {

// BM x BN output tiles, W warps a block each summing its own KC-deep
// chunks of k.
template <int BM_, int BN_, int KC_, int W_>
struct ThinMmaPlan {
    static constexpr int BM = BM_, BN = BN_, KC = KC_, W = W_, THREADS = 32 * W;
    static constexpr int MT = BM / 16, NT = BN / 8;   // mma tiles a warp
    // bf16 pitches: KC + 8 for k-contiguous rows (A; B of rows @ F^T), BN + 8
    // for n-contiguous ones (B of rows @ F): an odd number of 16-byte units,
    // so the eight rows of an ldmatrix matrix fall in eight distinct bank
    // groups.
    static constexpr int LK = KC + 8, LN = BN + 8;
    static constexpr int A_EL = BM * LK;
    static constexpr int B_EL = BN * LK > KC * LN ? BN * LK : KC * LN;
    // float4s a lane loads of one chunk: A's, and B's.
    static constexpr int CA = BM * KC / 4 / 32, CB = BN * KC / 4 / 32;
    // The partial tiles' float pitch: 16-byte rows, conflict-free float2
    // stores of the accumulator fragments.
    static constexpr int LC = BN + 8;
    static_assert(BM % 16 == 0 && BN % 16 == 0 && KC % 16 == 0, "mma tiling");
    static_assert(CA * 128 == BM * KC && CB * 128 == BN * KC, "whole float4s a lane");
    static_assert(LK % 16 == 8 && LN % 16 == 8 && LC % 4 == 0, "pitches");
};
using ThinS = ThinMmaPlan<16, 16, 32, 8>;
using ThinL = ThinMmaPlan<32, 32, 32, 4>;

struct ThinMmaArgs {
    const float* a;   // rows (m, d) of replica z at a + z sa
    const float* b;   // F (d, d), packed per replica
    const float* mu;  // (d,) per replica, with x
    float* c;         // out (m, d), packed per replica
    float* x;         // x = mu + out, or null
    int m, d;
    long long sa;
};

template <class P, bool TB, bool ADD_MU, bool VEC, int MODE>
__global__ void __launch_bounds__(P::THREADS) thin_mma_kernel(ThinMmaArgs p) {
    constexpr int PARTS = MODE == MMA_BF16X3 ? 2 : 1;   // hi, and lo at bf16x3
    constexpr int PART_EL = P::A_EL + P::B_EL, WARP_EL = PARTS * PART_EL;
    constexpr int OPER_BYTES = P::W * WARP_EL * 2;
    constexpr int C_BYTES = P::W * P::BM * P::LC * 4;
    // Each warp's [part][A rows | B rows]; the partial tiles reuse them
    // after the k loop.
    __shared__ __align__(16) unsigned char smem[OPER_BYTES > C_BYTES ? OPER_BYTES : C_BYTES];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long z = blockIdx.z;
    const float* pa = p.a + z * p.sa;
    const float* pb = p.b + z * (long long)p.d * p.d;
    const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
    __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(smem) + warp * WARP_EL;
    __nv_bfloat16* lo = hi + PART_EL;
    const int nchunk = (p.d + P::KC - 1) / P::KC;

    // Chunk c of the warp's A rows (k contiguous) and B: F's rows n (k
    // contiguous) for rows @ F^T, F's rows k (n contiguous) for rows @ F;
    // zeros past M and D.
    float4 ra[P::CA], rb[P::CB];
    auto load = [&](int c) {
        const int k0 = c * P::KC;
#pragma unroll
        for (int i = 0; i < P::CA; ++i) {
            const int q = lane + 32 * i, r = q / (P::KC / 4), kc = (q % (P::KC / 4)) * 4;
            ra[i] = load4<VEC>(pa, m0 + r, p.m, k0 + kc, p.d);
        }
#pragma unroll
        for (int i = 0; i < P::CB; ++i) {
            const int q = lane + 32 * i;
            if (TB) {
                const int r = q / (P::KC / 4), kc = (q % (P::KC / 4)) * 4;
                rb[i] = load4<VEC>(pb, n0 + r, p.d, k0 + kc, p.d);
            } else {
                const int r = q / (P::BN / 4), nc = (q % (P::BN / 4)) * 4;
                rb[i] = load4<VEC>(pb, k0 + r, p.d, n0 + nc, p.d);
            }
        }
    };
    auto store = [&]() {
#pragma unroll
        for (int i = 0; i < P::CA; ++i) {
            const int q = lane + 32 * i;
            const int o = (q / (P::KC / 4)) * P::LK + (q % (P::KC / 4)) * 4;
            put4<MODE>(hi + o, lo + o, ra[i]);
        }
#pragma unroll
        for (int i = 0; i < P::CB; ++i) {
            const int q = lane + 32 * i;
            const int o = P::A_EL + (TB ? (q / (P::KC / 4)) * P::LK + (q % (P::KC / 4)) * 4
                                        : (q / (P::BN / 4)) * P::LN + (q % (P::BN / 4)) * 4);
            put4<MODE>(hi + o, lo + o, rb[i]);
        }
    };

    float acc[P::MT][P::NT][4];
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
        for (int j = 0; j < P::NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    // The staged chunk's first kn k (16-deep steps; a step past D adds the
    // zeros staged there, so the last step may be partial).
    auto compute = [&](int kn) {
#pragma unroll
        for (int kb = 0; kb < P::KC; kb += 16) {
            if (kb >= kn) break;
            uint32_t ah[P::MT][4], al[P::MT][4];
#pragma unroll
            for (int mt = 0; mt < P::MT; ++mt) {
                const int o = (16 * mt + (lane & 15)) * P::LK + kb + ((lane >> 4) << 3);
                ldsm_x4(ah[mt], hi + o);
                if (MODE == MMA_BF16X3) ldsm_x4(al[mt], lo + o);
                else al[mt][0] = al[mt][1] = al[mt][2] = al[mt][3] = 0u;
            }
#pragma unroll
            for (int j = 0; j < P::NT; j += 2) {   // two 8-column tiles an ldmatrix
                uint32_t bh[4], bl[4] = {0u, 0u, 0u, 0u};
                if (TB) {
                    const int o = P::A_EL +
                                  (8 * j + (lane & 7) + ((lane >> 4) << 3)) * P::LK + kb +
                                  (((lane >> 3) & 1) << 3);
                    ldsm_x4(bh, hi + o);
                    if (MODE == MMA_BF16X3) ldsm_x4(bl, lo + o);
                } else {
                    const int o = P::A_EL + (kb + (lane & 15)) * P::LN + 8 * j + ((lane >> 4) << 3);
                    ldsm_x4_trans(bh, hi + o);
                    if (MODE == MMA_BF16X3) ldsm_x4_trans(bl, lo + o);
                }
                const uint32_t b0h[2] = {bh[0], bh[1]}, b1h[2] = {bh[2], bh[3]};
                const uint32_t b0l[2] = {bl[0], bl[1]}, b1l[2] = {bl[2], bl[3]};
#pragma unroll
                for (int mt = 0; mt < P::MT; ++mt) {
                    mma_acc<MODE>(acc[mt][j], ah[mt], al[mt], b0h, b0l);
                    mma_acc<MODE>(acc[mt][j + 1], ah[mt], al[mt], b1h, b1l);
                }
            }
        }
    };

    // Warp w's chunks w, w + W, ...: store (rounding once), then the next
    // chunk's loads go out before this one's mma.
    int c = warp;
    if (c < nchunk) load(c);
    for (; c < nchunk; c += P::W) {
        store();
        __syncwarp();
        if (c + P::W < nchunk) load(c + P::W);
        compute(min(P::KC, p.d - c * P::KC));
        __syncwarp();
    }

    // The warps' partial tiles (lane 4 g + t: rows g and g + 8, columns 2t,
    // 2t + 1 of each mma tile), summed in warp order.
    __syncthreads();   // every warp is done with its staged chunks
    float* cs = reinterpret_cast<float*>(smem);
    {
        float* mine = cs + warp * P::BM * P::LC;
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
            for (int j = 0; j < P::NT; ++j) {
                const int row = 16 * mt + g, col = 8 * j + 2 * t;
                *reinterpret_cast<float2*>(&mine[row * P::LC + col]) =
                    make_float2(acc[mt][j][0], acc[mt][j][1]);
                *reinterpret_cast<float2*>(&mine[(row + 8) * P::LC + col]) =
                    make_float2(acc[mt][j][2], acc[mt][j][3]);
            }
    }
    __syncthreads();
    float* pc = p.c + z * (long long)p.m * p.d;
    for (int e = threadIdx.x; e < P::BM * P::BN / 4; e += P::THREADS) {
        const int row = e / (P::BN / 4), col = (e % (P::BN / 4)) * 4;
        if (m0 + row >= p.m) continue;
        float4 s = *reinterpret_cast<const float4*>(&cs[row * P::LC + col]);
#pragma unroll
        for (int w = 1; w < P::W; ++w) {
            const float4 v = *reinterpret_cast<const float4*>(&cs[(w * P::BM + row) * P::LC + col]);
            s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
        }
        store4<VEC>(pc, m0 + row, n0 + col, p.d, s);
        if (ADD_MU) {
            const float4 mu = load4<VEC>(p.mu + z * p.d, 0, 1, n0 + col, p.d);
            store4<VEC>(p.x + z * (long long)p.m * p.d, m0 + row, n0 + col, p.d,
                        make_float4(mu.x + s.x, mu.y + s.y, mu.z + s.z, mu.w + s.w));
        }
    }
}

template <class P, bool TB, bool ADD_MU, int MODE>
void launch_plan(const ThinMmaArgs& p, int reps, bool vec, cudaStream_t s) {
    const dim3 grid((p.d + P::BN - 1) / P::BN, (p.m + P::BM - 1) / P::BM, reps);
    if (vec)
        thin_mma_kernel<P, TB, ADD_MU, true, MODE><<<grid, P::THREADS, 0, s>>>(p);
    else
        thin_mma_kernel<P, TB, ADD_MU, false, MODE><<<grid, P::THREADS, 0, s>>>(p);
}

template <class P, int MODE>
void launch_products(const ThinMmaArgs& p, int trans_f, int reps, bool vec, cudaStream_t s) {
    if (!trans_f)
        launch_plan<P, false, false, MODE>(p, reps, vec, s);
    else if (p.x != nullptr)
        launch_plan<P, true, true, MODE>(p, reps, vec, s);
    else
        launch_plan<P, true, false, MODE>(p, reps, vec, s);
}

template <int MODE>
bool launch_tile(const ThinMmaArgs& p, int trans_f, int reps, bool vec, int tile_m, int tile_n,
                 cudaStream_t s) {
    if (tile_m == ThinS::BM && tile_n == ThinS::BN)
        launch_products<ThinS, MODE>(p, trans_f, reps, vec, s);
    else if (tile_m == ThinL::BM && tile_n == ThinL::BN)
        launch_products<ThinL, MODE>(p, trans_f, reps, vec, s);
    else
        return false;
    return true;
}

}  // namespace

extern "C" {

// gsmvi_thin_rows (thin_gemm.cu) at mode 1 (bf16) or 2 (bf16x3): out =
// rows @ F (trans_f 0) or rows @ F^T (trans_f 1), rows (m, d), F (d, d);
// with x_out (trans_f 1 only), also x_out = mu + out.  Replica z's rows
// start z * rows_stride elements in, its F, mu, out and x_out are packed.
// (tile_m, tile_n) is one of the plans above (fs.thin_mma_tile), else
// cudaErrorInvalidValue.
int gsmvi_thin_rows_mma(const float* rows, const float* f, const float* mu, float* out,
                        float* x_out, int m, int d, int trans_f, int reps,
                        long long rows_stride, int tile_m, int tile_n, int mode, void* stream) {
    if (m < 1 || d < 1 || reps < 1 || reps > 65535 || tile_m < 1 ||
        (m + tile_m - 1) / tile_m > 65535)
        return (int)cudaErrorInvalidValue;
    if ((x_out != nullptr && (!trans_f || mu == nullptr)) ||
        (mode != MMA_BF16 && mode != MMA_BF16X3))
        return (int)cudaErrorInvalidValue;
    const ThinMmaArgs p{rows, f, mu, out, x_out, m, d, rows_stride};
    const bool vec = d % 4 == 0 && rows_stride % 4 == 0 && aligned16(rows) && aligned16(f) &&
                     aligned16(out) && aligned16(x_out) && aligned16(mu);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool ok = mode == MMA_BF16
                        ? launch_tile<MMA_BF16>(p, trans_f, reps, vec, tile_m, tile_n, s)
                        : launch_tile<MMA_BF16X3>(p, trans_f, reps, vec, tile_m, tile_n, s);
    if (!ok) return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
