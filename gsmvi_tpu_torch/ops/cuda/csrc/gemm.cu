// C entry points of the f32 GEMM template (gemm.cuh) at the products of the
// eps GSM step and of BaM.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py:
//   gsmvi_rows           `t = vf F^T` (:286) and `vf = v F` (:450) of the
//                        Cholesky variant K4a (`_eps_update_core` :350); the
//                        NS route's row products and K3 run on the split-k
//                        thin product (thin_gemm.cu)
//   gsmvi_factor_apply   `F + t_mm(stack_u, stack_w)` at :346 together with
//                        the accept/revert select at :454-455/:738-739
// the same products over K replicas (gsmvi_rows, gsmvi_factor_apply with
// k > 1: the batched K1 and K6 of gsmvi_tpu/ops/pallas/batch_fused.py :118),
// and, in gsmvi_tpu/ops/pallas/bam_fused.py (K7/K8):
//   gsmvi_bam_apply      the fat apply `f + t_mm(stack_u, stack_w)` at :319
//                        with the tile sums of squares of the trace screen
// (BaM's `ef`, `vf`/`t` rows and mean matvecs run on the split-k thin
// product, thin_gemm.cu).
// Bounds and design: see gemm.cuh.  Every entry returns cudaGetLastError().
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
    return launch_gemm<true, false, EPI_SELECT_ADD>(p, static_cast<cudaStream_t>(stream));
}

// out = rows @ F (trans_f 0) or rows @ F^T (trans_f 1), rows (m, D),
// F (D, D); with x_out (trans_f 1 only), also x_out = mu + out.  No-op
// while *halt != 0 (halt may be null).  For `reps` replicas: replica z's
// rows start z * rows_stride elements in (a view into a larger block may
// be wider apart than m * D), its F, mu, out and x_out are packed (D * D,
// D, m * D apart).
int gsmvi_rows(const float* rows, const float* f, const float* mu, float* out, float* x_out,
               const float* halt, int m, int d, int trans_f, int reps,
               long long rows_stride, void* stream) {
    GemmArgs p{};
    p.a = rows; p.b = f; p.c = out; p.halt = halt;
    p.m = m; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    p.batch = reps; p.sa = rows_stride; p.sb = (long long)d * d;
    p.sc = (long long)m * d; p.svec = d;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!trans_f) {
        if (x_out != nullptr) return (int)cudaErrorInvalidValue;
        return launch_gemm<false, false, EPI_STORE>(p, s);
    }
    if (x_out != nullptr) {
        p.epi_vec = mu; p.c2 = x_out;
        return launch_gemm<false, true, EPI_STORE_AND_ADD_VEC>(p, s);
    }
    return launch_gemm<false, true, EPI_STORE>(p, s);
}

// BaM fat apply: f_out = f_in + su^T @ sw, su, sw (K, D), f (D, D), f_out
// distinct from f_in; partial (2 * ceil(D/32)^2,) gets each output tile's
// (sum f_out^2, sum f_in^2).  No-op while *halt != 0.
int gsmvi_bam_apply(const float* su, const float* sw, const float* f_in, float* f_out,
                    float* partial, const float* halt, int k, int d, void* stream) {
    GemmArgs p{};
    p.a = su; p.b = sw; p.c = f_out; p.c_in = f_in; p.partial = partial; p.halt = halt;
    p.m = d; p.n = d; p.k = k; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<true, false, EPI_ADD_SUMSQ>(p, static_cast<cudaStream_t>(stream));
}

const char* gsmvi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
