// The BaM cluster small space (bam_smallspace_cluster.cuh) at tile T = 4,
// kpad 49-64 (B 41-56), in its own source so that the build compiles it beside the
// other instantiations.
#include "bam_smallspace_cluster.cuh"

GSMVI_BAM_CLUSTER_ENTRY(gsmvi_bam_cluster_t4, 4)
