// C entry of the BaM small space on a thread-block cluster
// (bam_smallspace_cluster.cuh, which says what it computes and how): the
// argument check and the dispatch by chain tile, and the instantiation for
// T = 3 (kpad 33-48), the main path's (B = 32, kpad = 40).
#include "bam_smallspace_cluster.cuh"

extern "C" int gsmvi_bam_cluster_t1(const void* args, int ranks, int reps, void* stream);
extern "C" int gsmvi_bam_cluster_t2(const void* args, int ranks, int reps, void* stream);
extern "C" int gsmvi_bam_cluster_t4(const void* args, int ranks, int reps, void* stream);

GSMVI_BAM_CLUSTER_ENTRY(gsmvi_bam_cluster_t3, 3)

// The arguments of the row-panel BaM small space (bam_smallspace_panel.cu)
// without its workspace, plus the cluster's shape: `ranks` blocks, `cols`
// columns each ((ranks - 1) cols < d <= ranks cols, so no block is empty),
// and the chain tile (kpad = b + 8 <= 16 tile); then `reps` replicas, their
// operands packed one after another, and an optional tier table `tier`
// (reps rows of BAM_TIER_STRIDE floats) that overrides the scalars' sweep
// counts and gates replica by replica.
extern "C" int gsmvi_bam_smallspace_cluster(
    const float* e, const float* v, const float* vf, const float* t, const float* ef,
    const float* mean_in, float* rows, float* su, float* sw, float* vec, float* ss,
    const float* halt, int b, int d, float reg, int it0, int it1, int it2, int it3, int it4,
    float lmax_gate, float gu_gate, float tol, int ranks, int cols, int tile,
    const float* tier, int reps, void* stream) {
    if (b < 1 || tile < 1 || tile > 4 || b + 8 > 16 * tile || b + 8 > BC_MAXK || d < 1 ||
        ranks < 1 || ranks > CL_MAX_RANKS || cols < 1 || (long long)(ranks - 1) * cols >= d ||
        (long long)ranks * cols < d || reps < 1 || reps > 65535 || (reps > 1 && halt != nullptr))
        return (int)cudaErrorInvalidValue;
    BamClusterArgs p{e, v, vf, t, ef, mean_in, rows, su, sw, vec, ss, halt, b, d, cols, reg,
                     it0, it1, it2, it3, it4, lmax_gate, gu_gate, tol, tier};
    switch (tile) {
        case 1: return gsmvi_bam_cluster_t1(&p, ranks, reps, stream);
        case 2: return gsmvi_bam_cluster_t2(&p, ranks, reps, stream);
        case 3: return gsmvi_bam_cluster_t3(&p, ranks, reps, stream);
        default: return gsmvi_bam_cluster_t4(&p, ranks, reps, stream);
    }
}
