// C entry points of the f32 GEMM template (gemm.cuh) at the products of the
// eps-NS GSM step and of the dense-Gaussian score.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py:
//   gsmvi_rows_ft        `ef = e F^T` (+ `x = mu + ef`) at :622/:727 and
//                        `t = vf F^T` in `_eps_smallspace_ns` at :286
//   gsmvi_rows_f         `vf = v F` at :450/:732
//   gsmvi_factor_apply   `F + t_mm(stack_u, stack_w)` at :346 together with
//                        the accept/revert select at :454-455/:738-739
//   gsmvi_gaussian_score `gaussian_score_kernel` at :778 (K3)
// Bounds and design: see gemm.cuh.  Every entry returns cudaGetLastError().
#include "gemm.cuh"

using namespace gsmvi;

extern "C" {

// out = rows @ F^T, rows (B, D), F (D, D); with x_out, also x_out = mu + out.
int gsmvi_rows_ft(const float* rows, const float* f, const float* mu, float* out,
                  float* x_out, int b, int d, void* stream) {
    GemmArgs p{};
    p.a = rows; p.b = f; p.c = out;
    p.m = b; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_out != nullptr) {
        p.epi_vec = mu; p.c2 = x_out;
        return launch_gemm<false, true, PRO_NONE, EPI_STORE_AND_ADD_VEC>(p, s);
    }
    return launch_gemm<false, true, PRO_NONE, EPI_STORE>(p, s);
}

// out = rows @ F, rows (B, D), F (D, D).
int gsmvi_rows_f(const float* rows, const float* f, float* out, int b, int d,
                 void* stream) {
    GemmArgs p{};
    p.a = rows; p.b = f; p.c = out;
    p.m = b; p.n = d; p.k = d; p.lda = d; p.ldb = d; p.ldc = d;
    return launch_gemm<false, false, PRO_NONE, EPI_STORE>(p, static_cast<cudaStream_t>(stream));
}

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

const char* gsmvi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
