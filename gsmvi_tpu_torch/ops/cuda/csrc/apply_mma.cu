// The fat apply of the eps GSM step on bf16 tensor cores, with its select:
// F' = F + su^T sw where good[z], else F, at the "bf16" and "high" (bf16x3)
// precisions.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, the big_prec
// contraction `f + t_mm(stack_u, stack_w, bp)` (:346) with the
// accept/revert select (:454-455/:738-739) when pallas_precision is "bf16"
// (Precision.DEFAULT) or "high" (Precision.HIGH): K1, K2, K4 and K6 (over
// K replicas, gsmvi_tpu/ops/pallas/batch_fused.py :71-91).  The float32
// route runs apply_f32.cu.
//
// Design: apply_f32.cu's tile plan (apply.cuh: 16 x 32 tiles of four warps
// below D = 768, 64 x 64 tiles of eight from it on), each warp 16 rows by 8 NT
// columns of m16n8k16 mma tiles.  su and sw are staged in KS-deep slabs
// (the whole k extent in one pass for 2B <= 64 on ApplyS; above, two buffers
// with the next slab's global loads in flight while the tensor cores run
// the current one), rounded to bf16 once as they are stored: hi = bf16(x),
// and lo = bf16(x - hi) at bf16x3, round to nearest even as torch's
// .to(torch.bfloat16).  They stay k-major (m or n contiguous), rows padded
// to an odd number of 16-byte units, so each fragment is one conflict-free
// ldmatrix .trans (x4 for A, x2 for each 8-column B tile).  At bf16x3 each
// k step runs a_lo b_hi, a_hi b_lo, then a_hi b_hi into the float32
// accumulator.  F is read (float4 along D) before the k loop; the epilogue
// passes the accumulators through shared memory so that F is read and
// written with 16-byte accesses, F + acc where `good`, else F.  Kernel and
// plain version (fs.mm_prec) round the same operands alike, so they differ
// only in float32 sum order.  Replica z (blockIdx.z) offsets every operand
// by its own stride and keeps the tiles and k order of a single launch.
//
// Bounds on an H100 at (2B, D) = (64, 256): 8.4 MFLOP (25.2 at bf16x3), at
// 989 TFLOP/s 0.0085 us (0.025), against 640 KiB of F, su and sw read and
// written, 0.196 us at 3.35 TB/s: bytes- and latency-bound, so the tensor
// cores' share of its time is small; what it saves over apply_f32.cu is
// the FMA chain.
#include <cuda_runtime.h>
#include <stddef.h>

#include "apply.cuh"
#include "mma_bf16.cuh"

namespace {

template <class T, int WARPS_, int KS>
struct MmaPlan {
    static constexpr int BM = T::BM, BN = T::BN, WARPS = WARPS_, TH = 32 * WARPS;
    static constexpr int WM = BM / 16;             // warps along m, 16 rows each
    static constexpr int WN = WARPS / WM;          // warps along n
    static constexpr int NT = BN / (8 * WN);       // 8-column mma tiles a warp
    // bf16 row pitches: the width + 8, an odd number of 16-byte units, so the
    // eight rows of an ldmatrix matrix fall in eight distinct bank groups;
    // the float epilogue tile's pitch is 8 mod 32 words (conflict-free
    // float2 stores of the accumulator fragments).
    static constexpr int LA = BM + 8, LB = BN + 8, LC = BN + 8;
    // float4 chunks a thread: su's and sw's of a slab, and F's.
    static constexpr int CA = KS * BM / 4 / TH, CB = KS * BN / 4 / TH, CF = BM * BN / 4 / TH;
    static_assert(WM * WN == WARPS && NT * 8 * WN == BN && KS % 16 == 0, "warp tiling");
    static_assert(CA * 4 * TH == KS * BM && CB * 4 * TH == KS * BN && CF * 4 * TH == BM * BN,
                  "whole chunks a thread");
    static_assert(LA % 16 == 8 && LB % 16 == 8 && LC % 32 == 8, "pitches");
};

template <class T, int WARPS, int KS, int MODE, bool VEC>
__global__ void __launch_bounds__(32 * WARPS) apply_mma_kernel(ApplyArgs p) {
    using P = MmaPlan<T, WARPS, KS>;
    constexpr int BM = P::BM, BN = P::BN, TH = P::TH;
    constexpr int PARTS = MODE == MMA_BF16X3 ? 2 : 1;     // hi, and lo at bf16x3
    constexpr int A_EL = KS * P::LA, B_EL = KS * P::LB;   // bf16 of one part
    constexpr int PART_EL = A_EL + B_EL, BUF_EL = PARTS * PART_EL;
    constexpr int OPER_BYTES = 2 * BUF_EL * 2, C_BYTES = BM * P::LC * 4;
    // Two buffers of [part][A rows | B rows]; the epilogue's float tile
    // reuses them after the last slab.
    __shared__ __align__(16) unsigned char smem[OPER_BYTES > C_BYTES ? OPER_BYTES : C_BYTES];
    __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(smem);

    const long long z = blockIdx.z;
    const float* su = p.su + z * (long long)p.k * p.d;
    const float* sw = p.sw + z * (long long)p.k * p.d;
    const float* f_in = p.f_in + z * (long long)p.d * p.d;
    float* f_out = p.f_out + z * (long long)p.d * p.d;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int wm = (warp % P::WM) * 16, wn = (warp / P::WM) * (8 * P::NT);
    const int nslab = (p.k + KS - 1) / KS;

    float4 ra[P::CA], rb[P::CB];
    auto load = [&](int s) {
        const int k0 = s * KS;
#pragma unroll
        for (int i = 0; i < P::CA; ++i) {
            const int c = tid + i * TH, kk = c / (BM / 4), col = (c % (BM / 4)) * 4;
            ra[i] = load4<VEC>(su, k0 + kk, p.k, m0 + col, p.d);
        }
#pragma unroll
        for (int i = 0; i < P::CB; ++i) {
            const int c = tid + i * TH, kk = c / (BN / 4), col = (c % (BN / 4)) * 4;
            rb[i] = load4<VEC>(sw, k0 + kk, p.k, n0 + col, p.d);
        }
    };
    auto store = [&](int b) {
        __nv_bfloat16* hi = ops + b * BUF_EL;
        __nv_bfloat16* lo = hi + PART_EL;
#pragma unroll
        for (int i = 0; i < P::CA; ++i) {
            const int c = tid + i * TH, o = (c / (BM / 4)) * P::LA + (c % (BM / 4)) * 4;
            put4<MODE>(hi + o, lo + o, ra[i]);
        }
#pragma unroll
        for (int i = 0; i < P::CB; ++i) {
            const int c = tid + i * TH, o = A_EL + (c / (BN / 4)) * P::LB + (c % (BN / 4)) * 4;
            put4<MODE>(hi + o, lo + o, rb[i]);
        }
    };

    float acc[P::NT][4];
#pragma unroll
    for (int j = 0; j < P::NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    auto compute = [&](int b, int kn) {
        const __nv_bfloat16* hi = ops + b * BUF_EL;
        const __nv_bfloat16* lo = hi + PART_EL;
        const int q = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kb = 0; kb < KS; kb += 16) {
            if (kb >= kn) break;
            const int ao = (kb + r + ((q >> 1) << 3)) * P::LA + wm + ((q & 1) << 3);
            uint32_t ah[4], al[4] = {0u, 0u, 0u, 0u};
            ldsm_x4_trans(ah, hi + ao);
            if (MODE == MMA_BF16X3) ldsm_x4_trans(al, lo + ao);
#pragma unroll
            for (int j = 0; j < P::NT; ++j) {
                const int bo = A_EL + (kb + (lane & 15)) * P::LB + wn + 8 * j;
                uint32_t bh[2], bl[2] = {0u, 0u};
                ldsm_x2_trans(bh, hi + bo);
                if (MODE == MMA_BF16X3) ldsm_x2_trans(bl, lo + bo);
                mma_acc<MODE>(acc[j], ah, al, bh, bl);
            }
        }
    };

    load(0);
    // F's chunks of this thread (row-major float4s of the tile), read while
    // the first slab loads.
    float4 f[P::CF];
#pragma unroll
    for (int e = 0; e < P::CF; ++e) {
        const int c = tid + e * TH;
        f[e] = load4<VEC>(f_in, m0 + c / (BN / 4), p.d, n0 + (c % (BN / 4)) * 4, p.d);
    }
    const bool take = p.good[z] != 0;
    store(0);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
        if (s + 1 < nslab) load(s + 1);
        compute(s & 1, min(KS, p.k - s * KS));
        if (s + 1 < nslab) store((s + 1) & 1);
        __syncthreads();
    }

    // The accumulators (lane 4 g + t: rows g and g + 8, columns 2t, 2t + 1
    // of each n tile) into the float tile, then F + acc a float4 at a time.
    float* cs = reinterpret_cast<float*>(smem);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < P::NT; ++j) {
        const int col = wn + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(&cs[(wm + g) * P::LC + col]) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(&cs[(wm + g + 8) * P::LC + col]) =
            make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < P::CF; ++e) {
        const int c = tid + e * TH, row = c / (BN / 4), col = (c % (BN / 4)) * 4;
        if (m0 + row >= p.d) continue;
        const float4 a = *reinterpret_cast<const float4*>(&cs[row * P::LC + col]);
        store4<VEC>(f_out, m0 + row, n0 + col, p.d, select_add(take, f[e], a));
    }
}

template <class T, int WARPS, int KS, int MODE>
void launch_mma(const ApplyArgs& p, int reps, cudaStream_t s) {
    const dim3 grid = apply_grid<T>(p.d, reps);
    if (apply_vec(p))
        apply_mma_kernel<T, WARPS, KS, MODE, true><<<grid, 32 * WARPS, 0, s>>>(p);
    else
        apply_mma_kernel<T, WARPS, KS, MODE, false><<<grid, 32 * WARPS, 0, s>>>(p);
}

template <int MODE>
bool launch_tile(const ApplyArgs& p, int reps, int tile_m, int tile_n, cudaStream_t s) {
    if (tile_m == ApplyS::BM && tile_n == ApplyS::BN)
        launch_mma<ApplyS, 4, 64, MODE>(p, reps, s);
    else if (tile_m == ApplyL::BM && tile_n == ApplyL::BN)
        launch_mma<ApplyL, 8, 32, MODE>(p, reps, s);
    else
        return false;
    return true;
}

}  // namespace

extern "C" {

// gsmvi_factor_apply (apply_f32.cu) at mode 1 (bf16) or 2 (bf16x3): f_out =
// f_in + su^T @ sw if good[z] else f_in, su, sw (k, d), f (d, d), for
// `reps` replicas stored one after another (good (reps,)); f_out may be
// f_in.  (tile_m, tile_n) is one of apply.cuh's plans (fs.apply_tile).
int gsmvi_factor_apply_mma(const float* su, const float* sw, const float* f_in,
                           float* f_out, const int* good, int k, int d, int reps, int mode,
                           int tile_m, int tile_n, void* stream) {
    if (!apply_args_ok(k, d, reps) || (mode != MMA_BF16 && mode != MMA_BF16X3))
        return (int)cudaErrorInvalidValue;
    const ApplyArgs p{su, sw, f_in, f_out, good, k, d};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool ok = mode == MMA_BF16 ? launch_tile<MMA_BF16>(p, reps, tile_m, tile_n, s)
                                     : launch_tile<MMA_BF16X3>(p, reps, tile_m, tile_n, s);
    if (!ok) return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
