// C entry points of the f32 GEMM template (gemm.cuh): the two fat applies
// as the port ran them until apply_f32.cu took their places, kept as the
// oracles of that redesign.
//
// gsmvi_factor_apply_oracle is the template's select epilogue: the eps
// step's fat apply (gsmvi_tpu/ops/pallas/fused_step.py :346/:417 with the
// select at :454-455/:738-739).  gsmvi_bam_apply_oracle is its sums-of-
// squares epilogue: BaM's fat apply `f + t_mm(stack_u, stack_w)`
// (gsmvi_tpu/ops/pallas/bam_fused.py :319) with the trace screen's sums as
// 32x32-tile partials.  No wrapper calls either: chip_smoke.py and
// tests/test_torch_gpu.py hold apply_f32.cu's kernels to them (F' bit for
// bit, the tile sums to a reordering bound) and time them beside them.
// Bounds and design: see gemm.cuh.  Every entry returns cudaGetLastError().
#include "gemm.cuh"

using namespace gsmvi;

extern "C" {

// f_out = f_in + su^T @ sw if *good else f_in: su, sw (R, D) with R = 2B,
// f (D, D), for each of `reps` replicas stored one after another (su, sw
// (reps, R, D), f (reps, D, D), good (reps,)).  f_out may be f_in (in
// place: each element is read and written by the one thread that owns it).
int gsmvi_factor_apply_oracle(const float* su, const float* sw, const float* f_in,
                              float* f_out, const int* good, int k, int d, int reps,
                              void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.good = good;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    p.batch = reps; p.sa = p.sb = (long long)k * d; p.sc = (long long)d * d; p.sgood = 1;
    return launch_gemm<EPI_SELECT_ADD>(p, static_cast<cudaStream_t>(stream));
}

// BaM fat apply on the template: f_out = f_in + su^T @ sw, su, sw (K, D), f
// (D, D), f_out distinct from f_in; partial (2 * ceil(D/32)^2,) gets each
// 32x32 output tile's (sum f_out^2, sum f_in^2).  No-op while *halt != 0.
// For `reps` replicas stored one after another (su, sw (reps, K, D), f
// (reps, D, D), partial (reps, 2 * ceil(D/32)^2)); halt only with one.
int gsmvi_bam_apply_oracle(const float* su, const float* sw, const float* f_in,
                           float* f_out, float* partial, const float* halt, int k, int d,
                           int reps, void* stream) {
    if (reps < 1 || reps > 65535 || (reps > 1 && halt != nullptr))
        return (int)cudaErrorInvalidValue;
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.partial = partial; p.halt = halt;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    p.batch = reps; p.sa = p.sb = (long long)k * d; p.sc = (long long)d * d;
    return launch_gemm<EPI_ADD_SUMSQ>(p, static_cast<cudaStream_t>(stream));
}

const char* gsmvi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
