// The finalize that decides a BaM NS step (K7/K8) and the factor select.
//
// Replace the trace gate of gsmvi_tpu/ops/pallas/bam_fused.py
// `_bam_smallspace_ns` (:323-326) and the select and exports of
// `_update_kernel` (:361-374) and of the multistep body (:463-491).  The
// small space before them is bam_smallspace_cluster.cu (B <= 56) or
// bam_smallspace_panel.cu (B 57-128); the
// O(B D^2) products around it run on the split-k thin product
// (thin_gemm.cu), the fat apply on the GEMM template (gemm.cu:
// `gsmvi_bam_apply`).
//
// The select comes after the apply (the trace gate needs ||F'||^2), so the
// fat apply writes F' to a second buffer with per-tile sums of squares, the
// mean matvecs read F', and a one-block finalize reduces the partials in a
// fixed order (no float atomics: the accept flag reproduces), decides
// keep = good & ~stiff, writes the mean and a float32 report; a grid select
// then copies F or F'.  In a multistep block each launch reads the report's
// `stopped` word and does nothing once the block has stopped.  Over K
// stacked replicas (FactorBaM.fit_batch) the finalize runs one block per
// replica and the select one row of blocks per replica, each on its own
// report.
#include "smallspace.cuh"

namespace {

constexpr int FIN_THREADS = 256;
constexpr int SEL_THREADS = 256;

// Report (float32), the layout of ops/bam_fused.py's REP_* indices.
constexpr int REP_KEEP = 0, REP_STIFF = 1, REP_GU = 2, REP_LMAX = 3, REP_NDONE = 4,
              REP_NACC = 5, REP_STOPPED = 6, REP_APPLY = 7, REP_SIZE = 8;
// Floats a replica owns in `ss` (BAM_SS_STRIDE of bam_replica.cuh).
constexpr int SS_STRIDE = 8;
// Small-space results handed to the finalize (BC_SS_* of
// bam_smallspace_cluster.cuh, the row-panel small space's alike).
constexpr int SS_GU = 0, SS_LMAX = 1, SS_RESOK = 2, SS_STIFF = 3, SS_TRA = 4, SS_TRB = 5;

struct FinArgs {
    const float* partial;   // (2 nparts,) tile sums of squares of F', F
    int nparts;
    const float* ss;        // small-space results
    const float* sg;        // (D,) s_gbar = (gbar F') F'^T
    const float* vec;       // (2, D): gbar, xbar
    const float* mean_in;
    float* mean_out;        // may equal mean_in
    float* rep;             // (8,) report
    int multistep, stop_on_reject;
    float reg;
    int d;
};

// Trace gate, keep = good & ~stiff, the mean with its select, and the
// report (bam_fused.py:323-333, :368-374, :477-490).  Block z decides
// replica z of a K-replica update (its operands packed after replica
// z - 1's).
__global__ void __launch_bounds__(FIN_THREADS) bam_finalize_kernel(FinArgs p) {
    __shared__ float red[32];
    {
        const long long z = blockIdx.x;
        p.partial += 2 * z * p.nparts;
        p.ss += z * SS_STRIDE;
        p.sg += z * p.d;
        p.vec += 2 * z * p.d;
        p.mean_in += z * p.d;
        p.mean_out += z * p.d;
        p.rep += z * REP_SIZE;
    }
    if (p.multistep && p.rep[REP_STOPPED] != 0.f) return;
    float a = 0.f, c = 0.f;
    for (int i = threadIdx.x; i < p.nparts; i += blockDim.x) {
        a += p.partial[2 * i];
        c += p.partial[2 * i + 1];
    }
    const float tr_new = block_sum(a, red);
    const float fnorm = block_sum(c, red);
    const float tr_v = (fnorm + 2.f * p.ss[SS_TRA]) + p.ss[SS_TRB];
    const bool good = isfinite(tr_new) && (tr_new <= 1.05f * tr_v + 1e-6f)
                      && p.ss[SS_RESOK] != 0.f;
    const bool stiff = p.ss[SS_STIFF] != 0.f;
    const bool stop_now = p.multistep && (stiff || (p.stop_on_reject && !good));
    const bool apply = good && !stiff && !stop_now;
    const float r1 = p.reg / (1.f + p.reg);
    for (int col = threadIdx.x; col < p.d; col += blockDim.x) {
        const float m0 = p.mean_in[col];
        const float mu_new = m0 / (1.f + p.reg) + r1 * (p.sg[col] + p.vec[p.d + col]);
        p.mean_out[col] = apply ? mu_new : m0;
    }
    if (threadIdx.x == 0) {
        float* r = p.rep;
        r[REP_KEEP] = (good && !stiff) ? 1.f : 0.f;
        r[REP_STIFF] = stiff ? 1.f : 0.f;
        r[REP_GU] = p.ss[SS_GU];
        r[REP_LMAX] = p.ss[SS_LMAX];
        r[REP_APPLY] = apply ? 1.f : 0.f;
        if (p.multistep) {
            if (stop_now) {
                r[REP_STOPPED] = stiff ? 1.f : 2.f;
            } else {
                r[REP_NDONE] += 1.f;
                r[REP_NACC] += good ? 1.f : 0.f;
            }
        } else {
            r[REP_NDONE] = 1.f;
            r[REP_NACC] = apply ? 1.f : 0.f;
            r[REP_STOPPED] = 0.f;
        }
    }
}

// dst = a if the report's apply flag is set else b; dst may equal a or b.
// Replica blockIdx.y of a K-replica update: its report, a, b and dst
// REP_SIZE and n elements after replica blockIdx.y - 1's.
__global__ void __launch_bounds__(SEL_THREADS) bam_select_kernel(const float* rep, const float* a,
                                                                 const float* b, float* dst, int n) {
    const long long z = blockIdx.y;
    rep += z * REP_SIZE;
    a += z * n;
    b += z * n;
    dst += z * n;
    const float* src = rep[REP_APPLY] != 0.f ? a : b;
    if (src == dst) return;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
        dst[i] = src[i];
}

}  // namespace

extern "C" {

// One block per replica: `reps` replicas' operands stored one after
// another (a multistep block has one).
int gsmvi_bam_finalize(const float* partial, int nparts, const float* ss, const float* sg,
                       const float* vec, const float* mean_in, float* mean_out, float* rep,
                       int multistep, int stop_on_reject, float reg, int d, int reps,
                       void* stream) {
    if (reps < 1 || (reps > 1 && multistep)) return (int)cudaErrorInvalidValue;
    FinArgs p{partial, nparts, ss, sg, vec, mean_in, mean_out, rep, multistep,
              stop_on_reject, reg, d};
    bam_finalize_kernel<<<reps, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}

int gsmvi_bam_select(const float* rep, const float* a, const float* b, float* dst, int n,
                     int reps, void* stream) {
    if (reps < 1 || reps > 65535) return (int)cudaErrorInvalidValue;
    int blocks = (n + SEL_THREADS - 1) / SEL_THREADS;
    if (blocks > 1024) blocks = 1024;
    bam_select_kernel<<<dim3(blocks, reps), SEL_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(rep, a, b, dst, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
