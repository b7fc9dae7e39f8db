// C entry of K4a's exact (Cholesky) small space (eps_chol.cuh, which says
// what it computes and how): the argument check and the dispatch by batch
// to the kernel's tile sizes, and the instantiation for B <= 32 (T = 4).
#include "eps_chol.cuh"

extern "C" int gsmvi_eps_chol_b64(const void* args, int split, void* stream);

GSMVI_EPS_CHOL_ENTRY(gsmvi_eps_chol_b32, 4)

// After the row products vf = v F and t = vf F^T: one cluster launch of
// `split` blocks, block r over the columns [r k_per, (r+1) k_per) of D
// ((split, k_per) = the thin product's split of D), which writes the mean
// (selected), `good` (and nacc += good), zt = Z^T, fzt = (F Z)^T and
// w = S2 Z^T ((2B, D) each); the caller's fat apply F + fzt^T w with the
// select follows.
extern "C" int gsmvi_eps_chol(const float* e, const float* v, const float* vf, const float* t,
                              const float* ef, const float* mean_in, float* mean_out, int* good,
                              int* nacc, float* zt, float* fzt, float* w, int b, int d, int split,
                              int k_per, float jitter, void* stream) {
    if (b < 1 || b > CH_MAXB || d < 1 || split < 1 || split > CH_MAX_RANKS ||
        k_per < CH_SLAB || k_per % CH_SLAB != 0 || (long long)(split - 1) * k_per >= d ||
        (long long)split * k_per < d)
        return (int)cudaErrorInvalidValue;
    CholArgs p{e, v, vf, t, ef, mean_in, mean_out, good, nacc, zt, fzt, w, b, d, k_per, jitter};
    if (b <= 32) return gsmvi_eps_chol_b32(&p, split, stream);
    return gsmvi_eps_chol_b64(&p, split, stream);
}
