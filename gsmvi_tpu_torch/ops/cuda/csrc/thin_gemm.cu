// The split-k thin product's entry points: the ns route's row products and
// K3 (the kernel and its design note: thin_gemm.cuh).
#include "thin_gemm.cuh"

extern "C" {

// K3: v = (mu_t - x) @ prec, x (m, d), mu_t (d,), prec (d, d).
int gsmvi_thin_score(const float* x, const float* mu_t, const float* prec, float* v, int m,
                     int d, int split, int k_per, void* stream) {
    if (m < 1 || !split_ok(d, split, k_per)) return (int)cudaErrorInvalidValue;
    ThinArgs p{};
    p.a = x; p.b = prec; p.pro_vec = mu_t; p.c = v;
    p.m = m; p.d = d; p.split = split; p.k_per = k_per;
    const bool vec = d % 4 == 0 && aligned16(x) && aligned16(prec);
    return (int)launch_thin<false, PRO_VEC_MINUS_A, EPI_STORE>(p, 1, vec,
                                                               static_cast<cudaStream_t>(stream));
}

// out = rows @ F (trans_f 0) or rows @ F^T (trans_f 1), rows (m, d), F (d, d);
// with x_out (trans_f 1 only), also x_out = mu + out.  No-op while *halt != 0
// (halt may be null).  Replica z's rows start z * rows_stride elements in,
// its F, mu, out and x_out are packed (d * d, d, m * d apart).
int gsmvi_thin_rows(const float* rows, const float* f, const float* mu, float* out,
                    float* x_out, const float* halt, int m, int d, int trans_f, int reps,
                    long long rows_stride, int split, int k_per, void* stream) {
    if (m < 1 || reps < 1 || !split_ok(d, split, k_per)) return (int)cudaErrorInvalidValue;
    if (x_out != nullptr && !trans_f) return (int)cudaErrorInvalidValue;
    ThinArgs p{};
    p.a = rows; p.b = f; p.c = out; p.c2 = x_out; p.epi_vec = mu; p.halt = halt;
    p.m = m; p.d = d; p.split = split; p.k_per = k_per;
    p.sa = rows_stride; p.sb = (long long)d * d; p.sc = (long long)m * d; p.svec = d;
    const bool vec = d % 4 == 0 && rows_stride % 4 == 0 && aligned16(rows) && aligned16(f);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!trans_f) return (int)launch_thin<false, PRO_NONE, EPI_STORE>(p, reps, vec, s);
    if (x_out != nullptr)
        return (int)launch_thin<true, PRO_NONE, EPI_STORE_AND_ADD_VEC>(p, reps, vec, s);
    return (int)launch_thin<true, PRO_NONE, EPI_STORE>(p, reps, vec, s);
}

}  // extern "C"
