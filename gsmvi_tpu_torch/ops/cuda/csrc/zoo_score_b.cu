// In-kernel analytic score of the Gaussian-mixture zoo target (K11b), the
// score launch of the whole-step paths (K2, K4, K6, K8-K10) on mixtures.
// The logistic-regression score, K11b's other, is two products and runs as
// one cluster launch on the thin product's primitives: zoo_logreg.cu.
//
// Replaces, in gsmvi_tpu/ops/pallas/fused_step.py (a score function traced
// into the TPU's whole-step kernels):
//   gsmvi_mixture_score  `mixture_score_kernel` (:848)
//       r = softmax_k(x . m_k - ||m_k||^2/2 + logmask_k), v = r M - x
// written from that math, with the TPU kernel's order of operations so that
// the plain torch twin (ops/fused_step.py `mixture_score_reference`) agrees
// to rounding.  Every parameter stays in device memory (means, logmask): a
// launch never waits for the host.  A -1e30 logmask entry (the JAX target's
// padding of K to 8) gives e^{-1e30 - max} = 0, zero weight, as on the TPU;
// it is added once per component, after the partial logits are summed.
//
// What bounds it on an H100: it reads x and M and writes v once, O(B D +
// K D) bytes (68.6 KB at B=32, D=256, K=3: 0.02 us at 3.35 TB/s) for 4 B K D
// FLOP, so latency bounds it: how many SMs share the walk over D, and how
// many dependent steps each takes.  Before, a warp per row (4 blocks on 4
// SMs at B=32), each block forming every ||m_k||^2 again and each warp its K
// dot products over D one after another, then reading M K times a column
// for v: 4.6-4.9 us on the device.  D spread over a cluster of 8 blocks
// (each reading its slab of x and M once, the partials summed in rank order
// through distributed shared memory) took as long or longer (4.8-5.4 us):
// its cluster barrier and the reads of the peers' partials after it cost
// 2.4 of its 4.8 us span.
//
// Design, one launch, no cluster: a row over the S = thin_split(D) warps of
// one block (warp r over the columns [r k_per, (r+1) k_per) of the thin
// product's partition), floor(8 / S) rows a block (one at D >= 225: 32
// blocks at B=32).
// - Each warp reads its columns of the row of x and of M once (lane l the
//   columns l, l + 32, ...) and forms, four components at a time, each
//   component's partial logit x . m_k (a lane's fmaf chain over its
//   columns, then a butterfly in a fixed order); the warps of the block's
//   first row also form the partial ||m_k||^2 the same way.  logmask is
//   read at the start, beside them.
// - After the block's one barrier every warp of a row sums the S warps'
//   partials in warp order (lanes over k; each warp the same sums):
//   logit = sum - ||m_k||^2/2 + logmask_k, then max, exp, sum and divide,
//   and writes its columns of v = r M - x (a fmaf chain over ascending k;
//   x and M from L1).
// No scratch and no atomics: the result reproduces from run to run and
// under a CUDA graph's replay, and a row's score depends on D and K alone,
// never on the row count M.
#include <math.h>

#include "thin_gemm.cuh"

namespace {

// Phase timestamps, compiled in only with -DGSMVI_PHASE_STAMPS
// (tools/smallspace_phases.py --kernel zoo, through gsmvi_mixture_phases):
// thread 0 of block 0 writes the global timer (ns) at MX_PHASE(k), k <
// MX_PHASES.  Without the macro MX_PHASE is empty.
constexpr int MX_PHASES = 5;
#ifdef GSMVI_PHASE_STAMPS
__device__ long long mx_phase_ns[MX_PHASES];
#define MX_PHASE(k)                                                               \
    do {                                                                          \
        if (threadIdx.x == 0 && blockIdx.x == 0) {                                \
            long long t_;                                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
            mx_phase_ns[k] = t_;                                                  \
        }                                                                         \
    } while (0)
#else
#define MX_PHASE(k) \
    do {            \
    } while (0)
#endif

constexpr int MIX_THREADS = 256;
constexpr int MIX_WARPS = MIX_THREADS / 32;
constexpr int MIX_CHUNK = 4;   // components a pass over the columns
constexpr int MIX_MAX_K = 1024;
constexpr int MIX_LOGMASK = MIX_MAX_K / MIX_THREADS;   // logmask entries a thread

// Shared memory: each warp's partial logits (MIX_WARPS x K), the first
// row's warps' partial norms (S x K), each warp's copy of its row's
// responsibilities (MIX_WARPS x K) and logmask (K): 100 KiB at K = 1024.
inline size_t mix_smem_bytes(int k) { return (size_t)(3 * MIX_WARPS + 1) * k * sizeof(float); }

__device__ __forceinline__ float warp_sum(float s) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

__global__ void __launch_bounds__(MIX_THREADS) mixture_score_kernel(
        const float* x, const float* means, const float* logmask, float* v, int m, int d,
        int k, int split, int k_per) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rows = MIX_WARPS / split;   // rows a block
    const int g = warp / split, rank = warp - g * split;
    const long long row = (long long)blockIdx.x * rows + g;
    const bool live = g < rows && row < m;
    float* part = smem;                        // [warp][k]
    float* npart = part + MIX_WARPS * k;       // [rank][k], the first row's warps
    float* resp = npart + MIX_WARPS * k;       // [warp][k]
    float* lmask = resp + MIX_WARPS * k;       // [k]
    const int c0 = rank * k_per;
    const int c1 = min(d, c0 + k_per);
    const float* xr = x + row * d;

    MX_PHASE(0);
    // logmask is read here, and kept in shared memory only after the
    // partials, so that its load overlaps theirs.
    float lm[MIX_LOGMASK];
#pragma unroll
    for (int j = 0; j < MIX_LOGMASK; ++j) {
        const int t = threadIdx.x + j * MIX_THREADS;
        lm[j] = t < k ? logmask[t] : 0.f;
    }
    if (live) {
        const bool norms = g == 0;
        for (int k0 = 0; k0 < k; k0 += MIX_CHUNK) {
            const int nk = min(MIX_CHUNK, k - k0);
            float a[MIX_CHUNK], b[MIX_CHUNK];
#pragma unroll
            for (int j = 0; j < MIX_CHUNK; ++j) a[j] = b[j] = 0.f;
            for (int c = c0 + lane; c < c1; c += 32) {
                const float xc = xr[c];
#pragma unroll
                for (int j = 0; j < MIX_CHUNK; ++j) {
                    if (j < nk) {
                        const float mc = means[(size_t)(k0 + j) * d + c];
                        a[j] = fmaf(xc, mc, a[j]);
                        if (norms) b[j] = fmaf(mc, mc, b[j]);
                    }
                }
            }
            // The chunk's butterflies level by level, so that their
            // shuffles issue together (a value past nk, or a norm outside
            // the first row, is a zero and is never stored).
            for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
                for (int j = 0; j < MIX_CHUNK; ++j) {
                    a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
                    b[j] += __shfl_xor_sync(0xffffffffu, b[j], o);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int j = 0; j < MIX_CHUNK; ++j) {
                    if (j < nk) {
                        part[warp * k + k0 + j] = a[j];
                        if (norms) npart[rank * k + k0 + j] = b[j];
                    }
                }
            }
        }
    }
#pragma unroll
    for (int j = 0; j < MIX_LOGMASK; ++j) {
        const int t = threadIdx.x + j * MIX_THREADS;
        if (t < k) lmask[t] = lm[j];
    }
    MX_PHASE(1);
    __syncthreads();
    MX_PHASE(2);

    // Every warp of a row: the S warps' partials summed in warp order, lanes
    // over k, and the softmax (each warp of the row the same sums in the
    // same order); then its columns of v.
    if (live) {
        float* ri = resp + warp * k;
        const float* pg = part + (g * split) * k;
        float mx = -INFINITY;
        for (int kk = lane; kk < k; kk += 32) {
            float s = 0.f, h = 0.f;
#pragma unroll
            for (int r = 0; r < TG_MAX_SPLIT; ++r) {
                if (r < split) {
                    s += pg[r * k + kk];
                    h += npart[r * k + kk];
                }
            }
            // (s - ||m_k||^2 / 2) + logmask_k, the half product rounded on
            // its own as in the plain version (no contraction into a fma).
            const float logit = (s - __fmul_rn(0.5f, h)) + lmask[kk];
            ri[kk] = logit;
            mx = fmaxf(mx, logit);
        }
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int kk = lane; kk < k; kk += 32) {
            const float e = expf(ri[kk] - mx);
            ri[kk] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        for (int kk = lane; kk < k; kk += 32) ri[kk] = ri[kk] / sum;
        __syncwarp();
        MX_PHASE(3);
        float* vr = v + row * d;
        for (int c = c0 + lane; c < c1; c += 32) {
            float acc = 0.f;
            for (int kk = 0; kk < k; ++kk) acc = fmaf(ri[kk], means[(size_t)kk * d + c], acc);
            vr[c] = acc - xr[c];
        }
    }
    MX_PHASE(4);
}

}  // namespace

extern "C" {

#ifdef GSMVI_PHASE_STAMPS
// The phase timestamps of the last launch: MX_PHASES.
int gsmvi_mixture_phases(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, mx_phase_ns, sizeof(mx_phase_ns));
}
#endif

// Mixture score of the (m, d) rows x into v: means (k, d), logmask (1, k);
// k <= 1024.  A row over `split` warps of a block, (split, k_per) =
// thin_split(d).
int gsmvi_mixture_score(const float* x, const float* means, const float* logmask,
                        float* v, int m, int d, int k, int split, int k_per, void* stream) {
    if (m < 1 || k < 1 || k > MIX_MAX_K || !split_ok(d, split, k_per))
        return (int)cudaErrorInvalidValue;
    // Above 48 KB (K > 491) a block needs the opt-in, a function attribute,
    // set at the first launch to the most a block may take.
    static bool opted_in = false;
    if (!opted_in) {
        int dev = 0, most = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(mixture_score_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return (int)err;
        opted_in = true;
    }
    const int rows = MIX_WARPS / split;
    mixture_score_kernel<<<(unsigned)((m + rows - 1) / rows), MIX_THREADS, mix_smem_bytes(k),
                           static_cast<cudaStream_t>(stream)>>>(x, means, logmask, v, m, d, k,
                                                                split, k_per);
    return (int)cudaGetLastError();
}

}  // extern "C"
