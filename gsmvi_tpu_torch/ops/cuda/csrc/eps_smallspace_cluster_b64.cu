// The eps-NS cluster small space (eps_smallspace_cluster.cuh) at
// 32 < B <= 64 (T = 4), in its own source so that the build compiles it beside the
// other instantiations.
#include "eps_smallspace_cluster.cuh"

GSMVI_EPS_CLUSTER_ENTRY(gsmvi_eps_cluster_b64, 4)
