// The 16x16-tile instantiation of the large-batch eps-NS small space
// (eps_smallspace_grid.cuh), for the batches whose 32x32 tiles would leave
// most SMs idle; its own source, so that it builds beside
// eps_smallspace_grid.cu, whose C entries launch it.
#include "eps_smallspace_grid.cuh"

namespace gsmvi_grid {
template long long grid_blocks<2>();
template cudaError_t grid_launch<2>(const GridArgs&, int, cudaStream_t);
}  // namespace gsmvi_grid

#ifdef GSMVI_PHASE_STAMPS
// The 16x16 tile's phase stamps (tools/smallspace_phases.py --kernel large).
extern "C" int gsmvi_eps_grid_phases_t16(long long* start, long long* end,
                                         unsigned long long* red) {
    using namespace gsmvi_grid;
    cudaError_t err = cudaMemcpyFromSymbol(start, gr_stamp_start, sizeof(gr_stamp_start));
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(end, gr_stamp_end, sizeof(gr_stamp_end));
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(red, gr_stamp_red, sizeof(gr_stamp_red));
    return (int)err;
}
#endif
