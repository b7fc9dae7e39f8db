// The fat apply's tile plan, shared by its float32 kernel (apply_f32.cu) and
// its bf16/bf16x3 twin (apply_mma.cu): F' = F + su^T sw where good[z], else
// F, su and sw (2B, D) rows contiguous in D, F (D, D), for each replica z.
//
// Two plans, chosen by D alone on the host (fs.apply_tile) and passed to the
// entry points as (tile_m, tile_n); 2B only sets how many passes the k
// staging makes:
// - ApplyS, D < 768: 16 x 32 output tiles (128 blocks at D = 256, where the
//   32 x 32 template ran 64 on 132 SMs);
// - ApplyL, D >= 768: 64 x 64 output tiles.
// Each kernel sets its own threads from its register tile (apply_f32.cu:
// 64 and 128 threads; apply_mma.cu: four and eight warps).  The grid is
// (ceil(D / tile_n), ceil(D / tile_m), replicas); every output of every
// replica has one owner thread, which reads it and writes it, so f_out may
// be f_in.  The sizes were chosen on an H100 among 16 x 16 to 128 x 128
// tiles, 1 x 4 to 8 x 8 register tiles and 16- to 128-deep slabs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "thin_gemm.cuh"   // cp.async and aligned16

namespace {

template <int BM_, int BN_>
struct ApplyTile {
    static constexpr int BM = BM_;
    static constexpr int BN = BN_;
};
using ApplyS = ApplyTile<16, 32>;
using ApplyL = ApplyTile<64, 64>;

struct ApplyArgs {
    const float* su;   // (k, d): A(m, kk) = su[kk d + m]
    const float* sw;   // (k, d): B(kk, n) = sw[kk d + n]
    const float* f_in;
    float* f_out;
    const int* good;
    int k, d;
};

// 16-byte accesses along D: D % 4 == 0 and every operand 16-byte aligned
// (each replica then starts on a 16-byte boundary too).
inline bool apply_vec(const ApplyArgs& p) {
    return p.d % 4 == 0 && aligned16(p.su) && aligned16(p.sw) && aligned16(p.f_in) &&
           aligned16(p.f_out);
}

inline bool apply_args_ok(int k, int d, int reps) {
    return k >= 1 && d >= 1 && reps >= 1 && reps <= 65535;
}

template <class T>
inline dim3 apply_grid(int d, int reps) {
    return dim3((d + T::BN - 1) / T::BN, (d + T::BM - 1) / T::BM, reps);
}

// Four consecutive floats of row `row` from column `col` of a (rows, d)
// array, zeros outside [0, rows) x [0, d): one 16-byte load where VEC (then
// col % 4 == 0 and the chunk lies wholly inside or outside d).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* src, int row, int rows, int col, int d) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= rows) return v;
    const float* s = src + (size_t)row * d + col;
    if (VEC) {
        if (col < d) v = *reinterpret_cast<const float4*>(s);
    } else {
        if (col < d) v.x = s[0];
        if (col + 1 < d) v.y = s[1];
        if (col + 2 < d) v.z = s[2];
        if (col + 3 < d) v.w = s[3];
    }
    return v;
}

// The counterpart store of load4 (row < d is the caller's).
template <bool VEC>
__device__ __forceinline__ void store4(float* dst, int row, int col, int d, float4 v) {
    float* s = dst + (size_t)row * d + col;
    if (VEC) {
        if (col < d) *reinterpret_cast<float4*>(s) = v;
    } else {
        if (col < d) s[0] = v.x;
        if (col + 1 < d) s[1] = v.y;
        if (col + 2 < d) s[2] = v.z;
        if (col + 3 < d) s[3] = v.w;
    }
}

// The epilogue's select: F + acc where the update is taken, else F.
__device__ __forceinline__ float4 select_add(bool take, float4 f, float4 acc) {
    return take ? make_float4(f.x + acc.x, f.y + acc.y, f.z + acc.z, f.w + acc.w) : f;
}

}  // namespace
