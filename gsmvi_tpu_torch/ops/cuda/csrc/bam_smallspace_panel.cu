// C entries of BaM's small space on row panels over a thread-block cluster
// (bam_smallspace_panel.cuh, which says what it computes and how): the
// argument check, the placement query and the dispatch to the kernel's two
// thread tiles by kpad, and the (1, 1) instantiation (up to 8 rows, kpad <=
// 128; bam_smallspace_panel_t22.cu holds the (2, 2) one).
#include "bam_smallspace_panel.cuh"

extern "C" int gsmvi_bam_panel_t22(const void* args, int reps, void* stream);
extern "C" long long gsmvi_bam_panel_t22_clusters(int b);

GSMVI_BAM_PANEL_ENTRY(gsmvi_bam_panel_t11, 1, 1)

namespace {

static_assert(pn_rows(128) <= 8 && pn_rows(PB_MAXB + 8) <= 16 && PB_MAXB + 8 <= 256,
              "the (1, 1) and (2, 2) tiles cover every panel");

bool bam_panel_shape_ok(int b) { return b >= PB_MINB && b <= PB_MAXB; }

// The (2, 2) tile above kpad = 128: 9 rows a block, 136 columns.
bool bam_panel_wide(int b) { return b + 8 > 128; }

}  // namespace

extern "C" {

// Workspace floats per replica of gsmvi_bam_smallspace_panel at batch b:
// the mirrors of its panels.
long long gsmvi_bam_panel_ws(int b) { return pn_ws_floats(b + 8, PB_NMAT); }

// How many clusters of BaM's panel small space at batch b the card holds
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
long long gsmvi_bam_panel_clusters(int b) {
    if (!bam_panel_shape_ok(b)) return -(long long)cudaErrorInvalidValue;
    return bam_panel_wide(b) ? gsmvi_bam_panel_t22_clusters(b) : gsmvi_bam_panel_t11_clusters(b);
}

// The arguments of gsmvi_bam_smallspace_cluster without the cluster's
// column split and tile, plus `ws` (gsmvi_bam_panel_ws(b) floats per
// replica): one cluster of PN_RANKS blocks per replica, ceil((B + 8) / 16)
// rows each (the last blocks may hold none); `tier` and `reps` as there.
int gsmvi_bam_smallspace_panel(const float* e, const float* v, const float* vf, const float* t,
                               const float* ef, const float* mean_in, float* rows, float* su,
                               float* sw, float* vec, float* ss, const float* halt, float* ws,
                               int b, int d, float reg, int it0, int it1, int it2, int it3,
                               int it4, float lmax_gate, float gu_gate, float tol,
                               const float* tier, int reps, void* stream) {
    if (!bam_panel_shape_ok(b) || d < 1 || reps < 1 || reps > 65535 ||
        (reps > 1 && halt != nullptr))
        return (int)cudaErrorInvalidValue;
    const PanelBamArgs p{e, v, vf, t, ef, mean_in, rows, su, sw, vec, ss, halt, ws, b, d, reg,
                         it0, it1, it2, it3, it4, lmax_gate, gu_gate, tol, tier};
    return bam_panel_wide(b) ? gsmvi_bam_panel_t22(&p, reps, stream)
                             : gsmvi_bam_panel_t11(&p, reps, stream);
}

}  // extern "C"
