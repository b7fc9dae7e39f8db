// The BaM cluster small space (bam_smallspace_cluster.cuh) at tile T = 1,
// kpad <= 16 (B <= 8), in its own source so that the build compiles it beside the
// other instantiations.
#include "bam_smallspace_cluster.cuh"

GSMVI_BAM_CLUSTER_ENTRY(gsmvi_bam_cluster_t1, 1)
