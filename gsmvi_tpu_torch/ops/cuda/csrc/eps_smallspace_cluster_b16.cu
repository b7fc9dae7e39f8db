// The eps-NS cluster small space (eps_smallspace_cluster.cuh) at
// B <= 16 (T = 1), in its own source so that the build compiles it beside the
// other instantiations.
#include "eps_smallspace_cluster.cuh"

GSMVI_EPS_CLUSTER_ENTRY(gsmvi_eps_cluster_b16, 1)
