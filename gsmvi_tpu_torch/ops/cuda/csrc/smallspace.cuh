// Device functions shared by the small-space kernels: the NaN-propagating
// maximum and block reductions.  The chains' products run on
// smallspace_tiled.cuh's register tiles in the cluster kernels, on
// smallspace_panel.cuh's row panels and in eps_smallspace_grid.cuh's
// workers; K4a's exact small space has its own (eps_chol.cuh).  Every
// reduction is called by all threads of the block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ float block_sum(float x, float* red) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[w] = x;
    __syncthreads();
    float r = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
    return r;
}

__device__ float block_max(float x, float* red) {
    for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[w] = x;
    __syncthreads();
    float r = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, o));
    return r;
}

struct Plain {
    __device__ float operator()(int, int, float acc) const { return acc; }
};

}  // namespace
