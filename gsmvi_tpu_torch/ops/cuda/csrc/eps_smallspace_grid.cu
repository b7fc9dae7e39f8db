// C entries of the large-batch eps-NS small space (eps_smallspace_grid.cuh,
// which says what it computes and how): its workspace and sync words, the
// occupancy query and the cooperative launch.  The 32x32 tile is
// instantiated here, the 16x16 tile of the smaller batches in
// eps_smallspace_grid_t16.cu, so that the two build in parallel.
#include "eps_smallspace_grid.cuh"

namespace gsmvi_grid {
extern template long long grid_blocks<2>();
extern template cudaError_t grid_launch<2>(const GridArgs&, int, cudaStream_t);
template long long grid_blocks<4>();
template cudaError_t grid_launch<4>(const GridArgs&, int, cudaStream_t);
}  // namespace gsmvi_grid

using namespace gsmvi_grid;

#ifdef GSMVI_PHASE_STAMPS
// The 32x32 tile's phase stamps (tools/smallspace_phases.py --kernel large).
extern "C" int gsmvi_eps_grid_phases_t32(long long* start, long long* end,
                                         unsigned long long* red) {
    cudaError_t err = cudaMemcpyFromSymbol(start, gr_stamp_start, sizeof(gr_stamp_start));
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(end, gr_stamp_end, sizeof(gr_stamp_end));
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(red, gr_stamp_red, sizeof(gr_stamp_red));
    return (int)err;
}
#endif

extern "C" {

// Workspace floats per replica of gsmvi_eps_smallspace_large at batch b.
long long gsmvi_eps_large_ws(int b) { return gr_ws_floats(b); }

// Sync words (int32) per replica, 0 before the first launch; every launch
// leaves them 0.
long long gsmvi_eps_large_sync(int b) {
    return b >= 1 ? GR_SYNC : -(long long)cudaErrorInvalidValue;
}

// Blocks of the tile's kernel the card holds at once, or minus a CUDA
// error code; sets the kernel's shared-memory attribute (outside a capture).
long long gsmvi_eps_grid_blocks(int tile) {
    if (tile == 32) return grid_blocks<4>();
    if (tile == 16) return grid_blocks<2>();
    return -(long long)cudaErrorInvalidValue;
}

// K1's small space for 1 <= B <= 512 (the wrappers send it B > 128): the
// arguments of gsmvi_eps_smallspace_cluster but the cluster's shape, plus
// `ws` (gsmvi_eps_large_ws(b) floats per replica), `sync`
// (gsmvi_eps_large_sync(b) words per replica), the schedule `table` of
// `nphases` phases (grid_schedule.encode for (b, NS profile)), the tile
// (32 or 16) and the grid (at most gsmvi_eps_grid_blocks(tile) blocks).
// One cooperative launch; a refused launch returns its error.
int gsmvi_eps_smallspace_large(const float* e, const float* v, const float* vf, const float* t,
                               const float* ef, const float* mean_in, float* mean_out,
                               int* good, int* nacc, float* su, float* sw, float* c,
                               float* xim, float* ws, int* sync, const int* table, int nphases,
                               int b, int d, float tol, int reps, long long e_stride, int tile,
                               int blocks, void* stream) {
    if (b < 1 || b > GR_MAXB || d < 1 || reps < 1 || nphases < 1 || nphases > GR_MAXPH
        || blocks < 1 || ws == nullptr || sync == nullptr || table == nullptr)
        return (int)cudaErrorInvalidValue;
    const GridArgs a{e,  v,  vf, t,    ef,    mean_in, mean_out, good, nacc,     su,
                     sw, c,  xim, ws,  sync,  table,   nphases,  b,    d,        reps,
                     e_stride, tol};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tile == 32) return (int)grid_launch<4>(a, blocks, st);
    if (tile == 16) return (int)grid_launch<2>(a, blocks, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
