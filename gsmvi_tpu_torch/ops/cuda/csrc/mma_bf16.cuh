// bf16 tensor-core primitives of the "bf16" and "high" products: operand
// rounding and the warp-level mma.sync.aligned.m16n8k16 bf16 product with
// float32 accumulation (the split-k thin product's variant, thin_mma.cu,
// and the fat apply's, apply_mma.cu, which stages its operands as bf16 and
// loads fragments with ldmatrix).
//
// The precisions are those of the JAX package's big_prec
// (gsmvi_tpu/ops/pallas/fused_step.py:247-282): "bf16" (MODE 1) rounds both
// operands to bfloat16, round to nearest even (__floats2bfloat162_rn, as
// torch's .to(torch.bfloat16)), the TPU's 1-pass Precision.DEFAULT; "high"
// (MODE 2) is bf16x3, x_hi = bf16(x), x_lo = bf16(x - x_hi), and
// a_hi b_hi + a_hi b_lo + a_lo b_hi, the TPU's 3-pass Precision.HIGH.
// Every product of two bfloat16 values is exact in float32; the sums run in
// the tensor core's float32 accumulator.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16
// with floating point type"), lane = 4 g + t:
//   A (16 x 16, row): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                     a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9);
//   B (16 x 8, col):  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g);
//   C (16 x 8, f32):  c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1);
// each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { MMA_BF16 = 1, MMA_BF16X3 = 2 };

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// The pair (x0, x1) as bf16x2 (x0 in the low half): hi = bf16(x), and for
// bf16x3 lo = bf16(x - hi).
template <int MODE>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi = bf16_bits(h);
    if (MODE == MMA_BF16X3) {
        const float2 hf = __bfloat1622float2(h);
        lo = bf16_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    } else {
        lo = 0u;
    }
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B in MODE: one pass (bf16) or three (bf16x3, the small terms first).
template <int MODE>
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
    if (MODE == MMA_BF16X3) {
        mma_bf16_16816(c, al, bh);
        mma_bf16_16816(c, ah, bl);
    }
    mma_bf16_16816(c, ah, bh);
}

// A's fragment from four (row, k-pair) float pairs in fragment order.
template <int MODE>
__device__ __forceinline__ void frag_a(const float2 (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair<MODE>(x[i].x, x[i].y, hi[i], lo[i]);
}

// B's fragment from its two k pairs (k 2t..2t+1 and 2t+8..2t+9 of column g).
template <int MODE>
__device__ __forceinline__ void frag_b(float2 k0, float2 k8, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
    split_pair<MODE>(k0.x, k0.y, hi[0], lo[0]);
    split_pair<MODE>(k8.x, k8.y, hi[1], lo[1]);
}

// Fragments from bf16 staged k-major (row k holds 8 contiguous m or n values
// at each 16-byte row address): ldmatrix .trans hands lane 4 g + t the
// elements (k 2t, 2t+1) of column g of each 8 x 8 matrix, which is A's and
// B's fragment order above.  x4: A's four matrices (lanes 8q..8q+7 address
// rows k = 8 (q / 2) + 0..7 at columns 8 (q % 2)); x2: B's two (lanes
// 0..15 address rows k = 0..15).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(s)
                 : "memory");
}

}  // namespace
