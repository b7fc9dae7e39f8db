// The replica axis of BaM's small spaces (K7 over stacked replicas,
// FactorBaM.fit_batch): what a block of a K-replica launch reads to find its
// replica.  Shared by bam_smallspace_cluster.cuh and
// bam_smallspace_panel.cuh, whose argument structs name their operands
// alike.
#pragma once

namespace {

// Floats a replica owns in `ss` and in a tier table (ops/bam_fused.py's
// SS_STRIDE and TIER_STRIDE): a tier row is the five NS sweep counts,
// lmax_gate and gu_gate.
constexpr int BAM_SS_STRIDE = 8, BAM_TIER_STRIDE = 8;

// This block's replica (blockIdx.y) of a K-replica launch: the operands'
// pointers moved to replica z and, with a tier table, its NS sweep counts
// and gates in place of the launch's.  The BaM row-panel small space
// (bam_smallspace_panel.cuh) takes its replica the same way, its panels'
// mirrors too.
template <class Args>
__device__ __forceinline__ void bam_take_replica(Args& p) {
    const long long z = blockIdx.y, rows = (long long)p.b * p.d, m = p.b + 1;
    p.e += z * rows; p.v += z * rows; p.vf += z * rows; p.t += z * rows; p.ef += z * rows;
    p.mean_in += z * p.d;
    p.rows += 4 * z * m * p.d;
    p.su += 2 * z * m * p.d; p.sw += 2 * z * m * p.d;
    p.vec += 2 * z * p.d;
    p.ss += z * BAM_SS_STRIDE;
    if (p.tier != nullptr) {
        const float* tr = p.tier + z * BAM_TIER_STRIDE;
        p.it0 = (int)tr[0]; p.it1 = (int)tr[1]; p.it2 = (int)tr[2];
        p.it3 = (int)tr[3]; p.it4 = (int)tr[4];
        p.lmax_gate = tr[5]; p.gu_gate = tr[6];
    }
}

}  // namespace
