// C entry points of the f32 GEMM template (gemm.cuh) at the products of the
// eps-NS GSM step and of the dense-Gaussian score.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py:
//   gsmvi_rows           `ef = e F^T` (+ `x = mu + ef`) at :622/:727,
//                        `t = vf F^T` in `_eps_smallspace_ns` at :286 and
//                        `vf = v F` at :450/:732
//   gsmvi_factor_apply   `F + t_mm(stack_u, stack_w)` at :346 together with
//                        the accept/revert select at :454-455/:738-739
//   gsmvi_gaussian_score `gaussian_score_kernel` at :778 (K3)
// and, in gsmvi_tpu/ops/pallas/bam_fused.py (K7/K8):
//   gsmvi_rows           `ef` (+ `x`) at :467, the `vf`/`t` rows behind
//                        `q_t`/`qf` (:265/:312) and the mean matvecs :329-330
//   gsmvi_bam_apply      the fat apply `f + t_mm(stack_u, stack_w)` at :319
//                        with the tile sums of squares of the trace screen
// Bounds and design: see gemm.cuh.  Every entry returns cudaGetLastError().
#include "gemm.cuh"

using namespace gsmvi;

extern "C" {

// v = (mu_t - x) @ prec: x (B, D), mu_t (D,), prec (D, D).
int gsmvi_gaussian_score(const float* x, const float* mu_t, const float* prec,
                         float* v, int b, int d, void* stream) {
    GemmArgs p{};
    p.a = x; p.b = prec; p.c = v; p.pro_vec = mu_t;
    p.m = b; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<false, false, PRO_VEC_MINUS_A, EPI_STORE>(p, static_cast<cudaStream_t>(stream));
}

// f_out = f_in + su^T @ sw if *good else f_in: su, sw (K, D) with K = 2B,
// f (D, D).  f_out may be f_in (in place: each element is read and written
// by the one thread that owns it).
int gsmvi_factor_apply(const float* su, const float* sw, const float* f_in,
                       float* f_out, const int* good, int k, int d, void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.good = good;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<true, false, PRO_NONE, EPI_SELECT_ADD>(p, static_cast<cudaStream_t>(stream));
}

// out = rows @ F (trans_f 0) or rows @ F^T (trans_f 1), rows (m, D),
// F (D, D); with x_out (trans_f 1 only), also x_out = mu + out.  No-op
// while *halt != 0 (halt may be null).
int gsmvi_rows(const float* rows, const float* f, const float* mu, float* out, float* x_out,
               const float* halt, int m, int d, int trans_f, void* stream) {
    GemmArgs p{};
    p.a = rows; p.b = f; p.c = out; p.halt = halt;
    p.m = m; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!trans_f) {
        if (x_out != nullptr) return (int)cudaErrorInvalidValue;
        return launch_gemm<false, false, PRO_NONE, EPI_STORE>(p, s);
    }
    if (x_out != nullptr) {
        p.epi_vec = mu; p.c2 = x_out;
        return launch_gemm<false, true, PRO_NONE, EPI_STORE_AND_ADD_VEC>(p, s);
    }
    return launch_gemm<false, true, PRO_NONE, EPI_STORE>(p, s);
}

// BaM fat apply: f_out = f_in + su^T @ sw, su, sw (K, D), f (D, D), f_out
// distinct from f_in; partial (2 * ceil(D/32)^2,) gets each output tile's
// (sum f_out^2, sum f_in^2).  No-op while *halt != 0.
int gsmvi_bam_apply(const float* su, const float* sw, const float* f_in, float* f_out,
                    float* partial, const float* halt, int k, int d, void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.partial = partial; p.halt = halt;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<true, false, PRO_NONE, EPI_ADD_SUMSQ>(p, static_cast<cudaStream_t>(stream));
}

const char* gsmvi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
