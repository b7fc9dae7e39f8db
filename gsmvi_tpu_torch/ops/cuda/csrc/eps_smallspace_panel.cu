// C entries of the eps-NS small space on row panels over a thread-block
// cluster (eps_smallspace_panel.cuh, which says what it computes and how):
// the argument check, the placement query and the launch, on the
// one-row-group thread tile (up to 8 rows per block: 16 blocks at B 65-128).
#include "eps_smallspace_panel.cuh"

namespace {

// The shared-memory opt-in set so far (cudaFuncSetAttribute), in bytes.
int eps_panel_smem = 0;

static_assert(pn_rows(PE_MAXB) <= 8, "the (1, 1) tile covers 8 rows a block");

bool eps_panel_shape_ok(int b) { return b >= PE_MINB && b <= PE_MAXB; }

}  // namespace

GSMVI_PANEL_PHASES(gsmvi_eps_panel)

extern "C" {

// Workspace floats per replica of gsmvi_eps_smallspace_panel at batch b:
// the mirrors of its panels.
long long gsmvi_eps_panel_ws(int b) { return pn_ws_floats(b, PE_NMAT); }

// How many clusters of the eps panel small space at batch b the card holds
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
long long gsmvi_eps_panel_clusters(int b) {
    if (!eps_panel_shape_ok(b)) return -(long long)cudaErrorInvalidValue;
    return pn_max_clusters(eps_panel_kernel<1, 1>, pe_smem_bytes(b), &eps_panel_smem);
}

// The arguments of gsmvi_eps_smallspace_cluster without the cluster's
// column split, plus `ws` (gsmvi_eps_panel_ws(b) floats per replica): one
// cluster of PN_RANKS blocks per replica, ceil(B / 16) rows each (the last
// blocks may hold none).
int gsmvi_eps_smallspace_panel(const float* e, const float* v, const float* vf, const float* t,
                               const float* ef, const float* mean_in, float* mean_out, int* good,
                               int* nacc, float* su, float* sw, float* c, float* xim, float* ws,
                               int b, int d, int it0, int it1, int it2, int it3, int it4,
                               float tol, int reps, long long e_stride, void* stream) {
    if (!eps_panel_shape_ok(b) || d < 1 || reps < 1 || reps > 65535)
        return (int)cudaErrorInvalidValue;
    const PanelEpsArgs p{e, v, vf, t, ef, mean_in, mean_out, good, nacc, e_stride, su, sw, c,
                         xim, ws, b, d, it0, it1, it2, it3, it4, tol};
    const size_t smem = pe_smem_bytes(b);
    cudaError_t err = pn_attributes(eps_panel_kernel<1, 1>, smem, &eps_panel_smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = pn_config(reps, smem, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, eps_panel_kernel<1, 1>, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
