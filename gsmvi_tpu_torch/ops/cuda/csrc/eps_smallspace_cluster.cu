// C entry of the eps-NS small space on a thread-block cluster
// (eps_smallspace_cluster.cuh, which says what it computes and how): the
// argument check and the dispatch by batch to the kernel's tile sizes, and
// the instantiation for 16 < B <= 32 (T = 2), the main path's.
#include "eps_smallspace_cluster.cuh"

extern "C" int gsmvi_eps_cluster_b16(const void* args, int ranks, int reps, void* stream);
extern "C" int gsmvi_eps_cluster_b64(const void* args, int ranks, int reps, void* stream);

GSMVI_EPS_CLUSTER_ENTRY(gsmvi_eps_cluster_b32, 2)

// The arguments of the one-block small space, plus the cluster's shape:
// `ranks` blocks per replica, `cols` columns each ((ranks - 1) cols < d <=
// ranks cols, so no block is empty).
extern "C" int gsmvi_eps_smallspace_cluster(
    const float* e, const float* v, const float* vf, const float* t, const float* ef,
    const float* mean_in, float* mean_out, int* good, int* nacc, float* su, float* sw, float* c,
    float* xim, int b, int d, int it0, int it1, int it2, int it3, int it4, float tol, int reps,
    long long e_stride, int ranks, int cols, void* stream) {
    if (b < 1 || b > CL_MAXB || d < 1 || reps < 1 || reps > 65535 || ranks < 1 ||
        ranks > CL_MAX_RANKS || cols < 1 || (long long)(ranks - 1) * cols >= d ||
        (long long)ranks * cols < d)
        return (int)cudaErrorInvalidValue;
    ClusterArgs p{e, v, vf, t, ef, mean_in, mean_out, good, nacc, e_stride, su, sw, c, xim,
                  b, d, cols, it0, it1, it2, it3, it4, tol};
    if (b <= 16) return gsmvi_eps_cluster_b16(&p, ranks, reps, stream);
    if (b <= 32) return gsmvi_eps_cluster_b32(&p, ranks, reps, stream);
    return gsmvi_eps_cluster_b64(&p, ranks, reps, stream);
}
