// C entry points of the f32 GEMM template (gemm.cuh) at the fat applies of
// the eps GSM step and of BaM.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py:
//   gsmvi_factor_apply   `F + t_mm(stack_u, stack_w)` at :346 (and the chol
//                        route's `f + t_mm(fzt, mm(s2, zt))` at :417)
//                        together with the accept/revert select at
//                        :454-455/:738-739, also over K replicas (the
//                        batched K1 and K6 of
//                        gsmvi_tpu/ops/pallas/batch_fused.py :118),
// and, in gsmvi_tpu/ops/pallas/bam_fused.py (K7/K8):
//   gsmvi_bam_apply      the fat apply `f + t_mm(stack_u, stack_w)` at :319
//                        with the tile sums of squares of the trace screen
// (every row product of both steps runs on the split-k thin product,
// thin_gemm.cu).  Bounds and design: see gemm.cuh.  Every entry returns
// cudaGetLastError().
#include "gemm.cuh"

using namespace gsmvi;

extern "C" {

// f_out = f_in + su^T @ sw if *good else f_in: su, sw (R, D) with R = 2B,
// f (D, D), for each of `reps` replicas stored one after another (su, sw
// (reps, R, D), f (reps, D, D), good (reps,)).  f_out may be f_in (in
// place: each element is read and written by the one thread that owns it).
int gsmvi_factor_apply(const float* su, const float* sw, const float* f_in,
                       float* f_out, const int* good, int k, int d, int reps,
                       void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.good = good;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    p.batch = reps; p.sa = p.sb = (long long)k * d; p.sc = (long long)d * d; p.sgood = 1;
    return launch_gemm<EPI_SELECT_ADD>(p, static_cast<cudaStream_t>(stream));
}

// BaM fat apply: f_out = f_in + su^T @ sw, su, sw (K, D), f (D, D), f_out
// distinct from f_in; partial (2 * ceil(D/32)^2,) gets each output tile's
// (sum f_out^2, sum f_in^2).  No-op while *halt != 0.
int gsmvi_bam_apply(const float* su, const float* sw, const float* f_in, float* f_out,
                    float* partial, const float* halt, int k, int d, void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.partial = partial; p.halt = halt;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<EPI_ADD_SUMSQ>(p, static_cast<cudaStream_t>(stream));
}

const char* gsmvi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
