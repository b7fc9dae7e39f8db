// K4a's exact small space (eps_chol.cuh) for 32 < B <= 64: T = 8, its three
// (2B, 2B) matrices 198 KiB of shared memory at B = 64.
#include "eps_chol.cuh"

GSMVI_EPS_CHOL_ENTRY(gsmvi_eps_chol_b64, 8)
