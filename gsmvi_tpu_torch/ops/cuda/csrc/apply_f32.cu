// The fat apply in float32: the eps GSM step's, F' = F + su^T sw where
// good[z], else F, and BaM's, F' = F + su^T sw with each tile's sums of
// squares of F' and F, for each replica z.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py, the Precision.HIGHEST
// contraction `f + t_mm(stack_u, stack_w, bp)` (:346; the chol route's
// `f + t_mm(fzt, mm(s2, zt))` at :417) with the accept/revert select
// (:454-455/:738-739): K1, K2, K4, K4a's chol route and K6 (K replicas,
// gsmvi_tpu/ops/pallas/batch_fused.py :118).  In
// gsmvi_tpu/ops/pallas/bam_fused.py, BaM's `f + t_mm(stack_u, stack_w)`
// (:319) with the trace screen's `jnp.sum(f_new * f_new)` (:323) as
// per-tile partials (gsmvi_bam_apply, K7, K8 and K7 over K replicas).  It
// takes the place of gemm.cuh's 32x32 template for both; the template's
// epilogues stay as this kernel's bit-for-bit oracles (gemm.cu,
// gsmvi_factor_apply_oracle and gsmvi_bam_apply_oracle).
//
// Numerics: each output is the template's own chain, acc = 0, then
// acc = fmaf(su[k][m], sw[k][n], acc) for k = 0, 1, ..., 2B-1 in order, then
// F + acc: float32 FFMA, no TF32, no split k.  The template pads k to whole
// 32-deep slabs with zeros, and fmaf(0, 0, acc) = acc + 0 (it turns -0 into
// +0 and changes nothing else), so a k that is not a multiple of 32 ends
// with one acc + 0.  The result equals the template's bit for bit on every
// shape, and replica z equals a launch on replica z alone (the tiles and k
// order do not depend on the replica count).
//
// What bounds it on an H100: at (2B, D) = (64, 256) it is 8.4 MFLOP (0.125
// us at 67 TFLOP/s) over 640 KiB read and written (0.196 us at 3.35 TB/s),
// so the launch, the loads' latency and the 64-deep FMA chain set its time.
// At 2B = 64 it sits near the ridge (16 FLOP a byte) at every D; at large 2B
// and D it is FLOP-bound.  Design (tile plans in apply.cuh):
// - su and sw are staged in KS-deep slabs through a three-stage cp.async
//   ring (16-byte copies along D where D % 4 == 0 and the operands are
//   aligned, masked 4-byte copies otherwise); two slabs are in flight before
//   the first FMA, so 2B <= 128 (ApplyS, KS = 64) or 64 (ApplyL, KS = 32)
//   is staged in one pass, under one barrier a slab.
// - Each thread's outputs of F are read into registers (float4 along D)
//   while the slabs land, and written once after the k loop.
// - ApplyS: 64 threads of 2 x 4 outputs (a float2 and a float4 shared load
//   per 8 FMA); ApplyL: 128 threads of 4 x 8 (three float4 loads per 32
//   FMA), so FFMA, not shared memory, bounds the inner loop at large D.
// - BaM's epilogue (APPLY_SUMSQ): no select, f_out distinct from f_in; each
//   thread sums f_out^2 and f_in^2 over its outputs (rows, then column
//   groups, then columns, by fmaf), the block's warps by a fixed butterfly,
//   then thread 0 adds the warps' sums in warp order into the tile's pair
//   of `partial` (tiles row-major, replica after replica), which the
//   finalize (bam_smallspace.cu) reduces in a fixed order: the accept flag
//   reproduces from run to run.  With a non-null halt the launch does
//   nothing while *halt != 0 (a stopped K8 block).
#include "apply.cuh"
#include "gemm.cuh"   // the template's slab depth, GEMM_BK

namespace {

constexpr int APPLY_STAGES = 3;

// The epilogues: the eps step's select, and BaM's sums of squares.
enum { APPLY_SELECT = 0, APPLY_SUMSQ = 1 };

// cp.async of four consecutive floats of row `row` from column `col` of a
// (rows, d) array into shared memory, zero-filled outside it: one 16-byte
// copy where VEC, else four masked 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void copy4(float* dst, const float* src, int row, int rows, int col,
                                      int d) {
    if (VEC) {
        const bool in = row < rows && col < d;
        cp_async16(dst, in ? src + (size_t)row * d + col : src, in);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool in = row < rows && col + e < d;
            cp_async4(dst + e, in ? src + (size_t)row * d + col + e : src, in);
        }
    }
}

// Thread (tm, tn) of an RM x RN register tile owns rows tm RM .. tm RM +
// RM - 1 and columns j BN/2 + 4 tn + c (RN / 4 float4 groups j, c < 4) of
// the block's tile, so that a warp's shared and global accesses of one
// group are contiguous.
template <class T, int RM, int RN, int KS, bool VEC, int EPI>
__global__ void __launch_bounds__((T::BM / RM) * (T::BN / RN)) apply_f32_kernel(ApplyArgs p) {
    constexpr int BM = T::BM, BN = T::BN, NST = APPLY_STAGES;
    constexpr int TM = BM / RM, TN = BN / RN, NJ = RN / 4, TH = TM * TN;
    static_assert(RM == 2 || RM == 4, "rows a thread: a float2 or a float4");
    static_assert(RN == 4 || RN == 8, "float4 groups of columns a thread");
    static_assert((KS * BM / 4) % TH == 0 && (KS * BN / 4) % TH == 0, "whole chunks a thread");
    __shared__ __align__(16) float as[NST][KS][BM];   // as[.][kk][m] = su[k0 + kk][m0 + m]
    __shared__ __align__(16) float bs[NST][KS][BN];   // bs[.][kk][n] = sw[k0 + kk][n0 + n]
    if (EPI == APPLY_SUMSQ && p.halt != nullptr && *p.halt != 0.f) return;

    const long long z = blockIdx.z;
    const float* su = p.su + z * (long long)p.k * p.d;
    const float* sw = p.sw + z * (long long)p.k * p.d;
    const float* f_in = p.f_in + z * (long long)p.d * p.d;
    float* f_out = p.f_out + z * (long long)p.d * p.d;
    const int tid = threadIdx.x, tm = tid / TN, tn = tid % TN;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nslab = (p.k + KS - 1) / KS;
    auto col_of = [&](int j) { return j * (BN / 2) + 4 * tn; };

    auto stage = [&](int s) {
        const int k0 = s * KS, st = s % NST;
#pragma unroll
        for (int c = tid; c < KS * BM / 4; c += TH) {
            const int kk = c / (BM / 4), col = (c % (BM / 4)) * 4;
            copy4<VEC>(&as[st][kk][col], su, k0 + kk, p.k, m0 + col, p.d);
        }
#pragma unroll
        for (int c = tid; c < KS * BN / 4; c += TH) {
            const int kk = c / (BN / 4), col = (c % (BN / 4)) * 4;
            copy4<VEC>(&bs[st][kk][col], sw, k0 + kk, p.k, n0 + col, p.d);
        }
    };

#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
        if (s < nslab) stage(s);
        cp_async_commit();
    }
    // F's outputs of this thread, read while the slabs land.
    float4 f[RM][NJ];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            f[r][j] = load4<VEC>(f_in, m0 + tm * RM + r, p.d, n0 + col_of(j), p.d);
    const bool take = EPI == APPLY_SUMSQ || p.good[z] != 0;

    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

    auto fma_row = [&](int st, int kk) {
        float a[RM];
        if constexpr (RM == 2) {
            const float2 v = *reinterpret_cast<const float2*>(&as[st][kk][2 * tm]);
            a[0] = v.x; a[1] = v.y;
        } else {
            const float4 v = *reinterpret_cast<const float4*>(&as[st][kk][4 * tm]);
            a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(&bs[st][kk][col_of(j)]);
#pragma unroll
            for (int r = 0; r < RM; ++r) {
                acc[r][4 * j] = fmaf(a[r], b.x, acc[r][4 * j]);
                acc[r][4 * j + 1] = fmaf(a[r], b.y, acc[r][4 * j + 1]);
                acc[r][4 * j + 2] = fmaf(a[r], b.z, acc[r][4 * j + 2]);
                acc[r][4 * j + 3] = fmaf(a[r], b.w, acc[r][4 * j + 3]);
            }
        }
    };

    for (int s = 0; s < nslab; ++s) {
        cp_async_wait<NST - 2>();   // slab s has landed
        __syncthreads();            // ... for every thread; slab s - 1's stage is free
        if (s + NST - 1 < nslab) stage(s + NST - 1);
        cp_async_commit();
        const int st = s % NST, kn = min(KS, p.k - s * KS);
        if (kn == KS) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) fma_row(st, kk);
        } else {
            for (int kk = 0; kk < kn; ++kk) fma_row(st, kk);
        }
    }
    cp_async_wait<0>();

    const bool pad = p.k % gsmvi::GEMM_BK != 0;   // the template's zero FMAs: acc + 0
    float s_new = 0.f, s_old = 0.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        const int m = m0 + tm * RM + r;
        if (m >= p.d) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            float4 a = make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                                   acc[r][4 * j + 3]);
            if (pad) {
                a.x = __fadd_rn(a.x, 0.f); a.y = __fadd_rn(a.y, 0.f);
                a.z = __fadd_rn(a.z, 0.f); a.w = __fadd_rn(a.w, 0.f);
            }
            const float4 v = select_add(take, f[r][j], a);
            store4<VEC>(f_out, m, n0 + col_of(j), p.d, v);
            if constexpr (EPI == APPLY_SUMSQ) {
                const int n = n0 + col_of(j);
                const float nv[4] = {v.x, v.y, v.z, v.w};
                const float ov[4] = {f[r][j].x, f[r][j].y, f[r][j].z, f[r][j].w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if (n + c >= p.d) continue;
                    s_new = fmaf(nv[c], nv[c], s_new);
                    s_old = fmaf(ov[c], ov[c], s_old);
                }
            }
        }
    }
    if constexpr (EPI == APPLY_SUMSQ) {
        // The warps' sums pass through the first stage's slab (ApplyL's
        // ring fills the 48 KiB of static shared memory), once every
        // thread is done reading it.
        constexpr int WARPS = TH / 32;
        float* red = &as[0][0][0];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s_new += __shfl_xor_sync(0xffffffffu, s_new, o);
            s_old += __shfl_xor_sync(0xffffffffu, s_old, o);
        }
        __syncthreads();
        if ((tid & 31) == 0) {
            red[tid >> 5] = s_new;
            red[WARPS + (tid >> 5)] = s_old;
        }
        __syncthreads();
        if (tid == 0) {
            float a = red[0], b = red[WARPS];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) {
                a += red[w];
                b += red[WARPS + w];
            }
            const size_t blk = ((size_t)z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
            p.partial[2 * blk] = a;
            p.partial[2 * blk + 1] = b;
        }
    }
}

template <class T, int RM, int RN, int KS, int EPI>
void launch_epi(const ApplyArgs& p, int reps, cudaStream_t s) {
    const dim3 grid = apply_grid<T>(p.d, reps);
    constexpr int threads = (T::BM / RM) * (T::BN / RN);
    if (apply_vec(p))
        apply_f32_kernel<T, RM, RN, KS, true, EPI><<<grid, threads, 0, s>>>(p);
    else
        apply_f32_kernel<T, RM, RN, KS, false, EPI><<<grid, threads, 0, s>>>(p);
}

template <class T, int RM, int RN, int KS>
void launch_f32(const ApplyArgs& p, int reps, int epi, cudaStream_t s) {
    if (epi == APPLY_SUMSQ)
        launch_epi<T, RM, RN, KS, APPLY_SUMSQ>(p, reps, s);
    else
        launch_epi<T, RM, RN, KS, APPLY_SELECT>(p, reps, s);
}

// One of apply.cuh's plans (fs.apply_tile), else false.
bool launch_plan(const ApplyArgs& p, int reps, int epi, int tile_m, int tile_n,
                 cudaStream_t s) {
    if (tile_m == ApplyS::BM && tile_n == ApplyS::BN)
        launch_f32<ApplyS, 2, 4, 64>(p, reps, epi, s);
    else if (tile_m == ApplyL::BM && tile_n == ApplyL::BN)
        launch_f32<ApplyL, 4, 8, 32>(p, reps, epi, s);
    else
        return false;
    return true;
}

}  // namespace

extern "C" {

// f_out = f_in + su^T @ sw if good[z] else f_in: su, sw (k, d) rows, f
// (d, d), for each of `reps` replicas stored one after another (su, sw
// (reps, k, d), f (reps, d, d), good (reps,)); f_out may be f_in.  The tile
// (tile_m, tile_n) is one of apply.cuh's plans (fs.apply_tile), else
// cudaErrorInvalidValue.
int gsmvi_factor_apply(const float* su, const float* sw, const float* f_in, float* f_out,
                       const int* good, int k, int d, int reps, int tile_m, int tile_n,
                       void* stream) {
    if (!apply_args_ok(k, d, reps)) return (int)cudaErrorInvalidValue;
    const ApplyArgs p{su, sw, f_in, f_out, good, k, d, nullptr, nullptr};
    if (!launch_plan(p, reps, APPLY_SELECT, tile_m, tile_n, static_cast<cudaStream_t>(stream)))
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// BaM's fat apply: f_out = f_in + su^T @ sw, su, sw (k, d), f (d, d), f_out
// distinct from f_in, and partial[2 t], partial[2 t + 1] = (sum f_out^2,
// sum f_in^2) over output tile t = y ceil(d / tile_n) + x of the plan
// (tile_m, tile_n) (fs.apply_tile; ceil(d / tile_m) ceil(d / tile_n)
// tiles).  No-op while *halt != 0.  For `reps` replicas stored one after
// another (su, sw (reps, k, d), f (reps, d, d), partial (reps, 2 tiles));
// halt only with one.
int gsmvi_bam_apply(const float* su, const float* sw, const float* f_in, float* f_out,
                    float* partial, const float* halt, int k, int d, int reps, int tile_m,
                    int tile_n, void* stream) {
    if (!apply_args_ok(k, d, reps) || (reps > 1 && halt != nullptr))
        return (int)cudaErrorInvalidValue;
    const ApplyArgs p{su, sw, f_in, f_out, nullptr, k, d, halt, partial};
    if (!launch_plan(p, reps, APPLY_SUMSQ, tile_m, tile_n, static_cast<cudaStream_t>(stream)))
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
