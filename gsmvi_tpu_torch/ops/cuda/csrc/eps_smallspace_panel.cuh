// The eps-NS GSM update's small space for 64 < B <= 128 as one
// thread-block-cluster launch per update, its (B, B) matrices in row panels
// over the blocks' shared memory (smallspace_panel.cuh).
//
// Replaces gsmvi_tpu/ops/pallas/fused_step.py `_eps_smallspace_ns` (:231)
// from the row work at :287 to the stacked rows at :345, with `_ns_sqrt`
// (:198), `_newton_inv` (:214), `_spd_norm_ub` (:189), both residual gates
// (tol 3e-3) and the mean half of the select: the body of K1
// `gsm_eps_update_fused` (:461) and, through the same launch, of K2 (:685),
// K4 (:586) and K6 (batch_fused.py:54) at these batches.  It computes what
// the grid small space of B 129-512 computes (eps_smallspace_grid.cuh),
// step for step: the same chains, symmetrisations, norm seeds, residuals
// and stacked rows.
//
// What bounds it on an H100: 99 dependent (B, B) products at the long NS
// profile (8, 6, 9, 10, 6), 2 B^3 FLOP each, 0.42 GFLOP at B=128 (6 us at 67
// TFLOP/s over the whole card): the dependency chain and the cluster's
// barriers, not FLOPs or bytes.  The chain of grid launches it replaced
// spent ~8 us per product, each a launch of 16 tiles on 16 SMs.
// Design: one cluster of P = PN_RANKS = 16 blocks per replica (blockIdx.y =
// replica; P is fixed, so replica z of a K-replica launch equals a launch
// on replica z, bit for bit), block r owning ceil(B/P) <= 8 rows of every
// (B, B) matrix (a non-portable cluster size: at B=128 a call took 0.50 ms
// at P = 16 and 0.60 at the portable P = 8 on an H100 at 700 W, PERF.md).
// - Row work: block r forms the row scalars rho, w/den, gamma and the rows c
//   of its own rows (a warp per row over D); its panels of Gu = e e^T/B and
//   e c^T/B, of Gv = Xi~^T Xi~ and Xi~^T w1row^T over all of D (one fused
//   multiply-add chain per entry, d ascending); and its rows of Xi~^T,
//   w1row, fw1xi^T and cv Xi~^T, from its panels and 128-column slabs of the
//   (B, D) rows staged in shared memory.  The rows live in device memory
//   (L2-resident) and are read after the barrier that follows their
//   writing.
// - Chains: every product stages its right operand from the panels'
//   mirrors in L2, a barrier before each; the norm seeds and residuals are combined
//   over the cluster in rank order, so every block takes the same gate
//   decisions; rank 0 writes good and nacc.
// - The mean's column sums are split over the cluster by columns, summed
//   over b ascending, from every row's scalars gathered from their owners.
// The kernel is a template on smallspace_panel.cuh's thread tile (8 TR rows
// and 128 NC columns per block cover its panel), instantiated in
// eps_smallspace_panel.cu at (1, 1).
// Shared memory (P = 16): eleven (8, 132) panels, a (132, 132) staging
// matrix, an (8, 132) Gram slab and the row scalars: 121,664 bytes at B=128
// (pn_smem_floats); the panels' mirrors in device memory, 11 (132, 132) per
// replica (gsmvi_eps_panel_ws).
#pragma once

#include "smallspace_panel.cuh"

namespace {

constexpr int PE_MINB = 1;
constexpr int PE_MAXB = 128;
constexpr int PE_NMAT = 11;

__host__ __device__ constexpr int pe_extra(int b) { return 3 * pn_rows(b) + 2 * b; }

__host__ __device__ constexpr size_t pe_smem_bytes(int b) {
    return sizeof(float) * (size_t)pn_smem_floats(b, PE_NMAT, pe_extra(b));
}

struct PanelEpsArgs {
    const float* e;      // (B, D) standard-normal draws
    const float* v;      // (B, D) scores at x = mu + e F^T
    const float* vf;     // (B, D) v F
    const float* t;      // (B, D) vf F^T
    const float* ef;     // (B, D) e F^T
    const float* mean_in;
    float* mean_out;     // may equal mean_in
    int* good;           // (1,) 1 iff both residual gates pass
    int* nacc;           // optional (1,): += good
    long long e_stride;  // elements between replicas' e rows (the others are packed)
    float* su;           // (2B, D) stack_u
    float* sw;           // (2B, D) stack_w
    float* c;            // (B, D) scratch: downdate rows
    float* xim;          // (B, D) scratch: Xi~^T
    float* ws;           // the panels' mirrors, pn_ws_floats(B, PE_NMAT) per replica
    int b, d;
    int it0, it1, it2, it3, it4;
    float tol;
};

template <int TR, int NC>
__global__ void __launch_bounds__(PN_THREADS, 1) eps_panel_kernel(PanelEpsArgs p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    {   // This cluster's replica.
        const long long z = blockIdx.y, rows = (long long)p.b * p.d;
        p.e += z * p.e_stride;
        p.v += z * rows; p.vf += z * rows; p.t += z * rows; p.ef += z * rows;
        p.c += z * rows; p.xim += z * rows;
        p.ws += z * pn_ws_floats(p.b, PE_NMAT);
        p.su += 2 * z * rows; p.sw += 2 * z * rows;
        p.mean_in += z * p.d; p.mean_out += z * p.d;
        p.good += z;
        if (p.nacc != nullptr) p.nacc += z;
    }
    const int n = p.b, d = p.d;
    PanelCtx g;
    float* M[PE_NMAT];
    float* ex = pn_setup(g, smem, p.ws, n, PE_NMAT, pe_extra(n), M);
    float* s_gamma = ex;                 // this block's rows
    float* s_inv1r = s_gamma + g.R;
    float* s_wden = s_inv1r + g.R;
    float* all_wden = s_wden + g.R;      // every row's, for the mean
    float* all_inv1r = all_wden + n;
    float* GU = M[0];
    float* EC = M[1];
    float* S = M[2];
    float* CU = M[3];
    float* CUI = M[4];
    float* W0 = M[5];
    float* w[5] = {M[6], M[7], M[8], M[9], M[10]};
    const float zc = 1.f / sqrtf((float)n);
    const float scale2 = 1.f / (float)n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    PN_PHASE(0);

    // Row scalars of this block's rows (fused_step.py:285-296), a warp per
    // row, then the downdate rows c = -e gamma + vf / (1 + rho) and u1row =
    // ef / sqrt(B) of those rows.
    for (int i = warp; i < g.nr; i += PN_THREADS / 32) {
        const size_t r0 = (size_t)(g.row0 + i) * d;
        float vsv = 0.f, mv = 0.f, wsum = 0.f;
        for (int col = lane; col < d; col += 32) {
            const float vv = p.v[r0 + col], tt = p.t[r0 + col], a = -p.ef[r0 + col];
            vsv += vv * tt;
            mv += a * vv;
            wsum += vv * (tt - a);
        }
        for (int o = 16; o > 0; o >>= 1) {
            vsv += __shfl_xor_sync(0xffffffffu, vsv, o);
            mv += __shfl_xor_sync(0xffffffffu, mv, o);
            wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
        }
        if (lane == 0) {
            const float rho = 0.5f * (sqrtf(1.f + 4.f * (vsv + mv * mv)) - 1.f);
            const float den = 1.f + rho + mv;
            const float inv1r = 1.f / (1.f + rho);
            const float wden = wsum / den;
            s_inv1r[i] = inv1r;
            s_wden[i] = wden;
            s_gamma[i] = 1.f - (1.f + wden) * inv1r;
        }
    }
    __syncthreads();
    for (long long q = threadIdx.x; q < (long long)g.nr * d; q += PN_THREADS) {
        const int i = (int)(q / d);
        const size_t o = (size_t)g.row0 * d + q;
        p.c[o] = -p.e[o] * s_gamma[i] + p.vf[o] * s_inv1r[i];
        p.su[o] = p.ef[o] * zc;
    }
    pn_sync();                           // every block's rows of c are written
    PN_PHASE(1);

    // Phase 1 on Gu = e e^T / B; e c^T / B for cuiec.
    gram<TR, NC>(g, p.e, n, p.e, n, d, scale2, w[0]);
    gram<TR, NC>(g, p.e, n, p.c, n, d, scale2, EC);
    pn_sync();
    psym(g, w[0], GU, Plain());
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + GU[o]; });
    PN_PHASE(2);
    pns<TR, NC>(g, W0, CUI, nullptr, p.it0, w);
    pn_sync();
    psym(g, CUI, S, Plain());                                  // S1
    const float res1 = rel_residual<TR, NC>(g, S, W0, w[0]);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + S[o]; });
    PN_PHASE(3);
    pnewton<TR, NC>(g, W0, CU, p.it1, w);
    each_local(g, [=](int gi, int j, int o) {
        W0[o] = ((gi == j ? 1.f : 0.f) + S[o]) + GU[o];
    });
    pnewton<TR, NC>(g, W0, CUI, p.it2, w);
    PN_PHASE(4);

    // cuiec = cui (e c^T / B), and its transpose's panel.
    float* CUIEC = GU;
    float* CUIECT = S;
    pn_sync();
    pmm<TR, NC>(g, CUI, EC, CUIEC, Plain());
    pn_sync();
    ptrans(g, CUIEC, CUIECT);
    PN_PHASE(5);

    // Xi~^T = (c - cuiec^T e) / sqrt(B) and w1row = cu e / sqrt(B), this
    // block's rows.
    {
        const float* c_rows = p.c;
        float* xim = p.xim;
        float* w1 = p.sw;
        rowprod2<TR, NC>(
            g, CUIECT, CU, p.e, n, d, n,
            [=](int gi, int col, float acc) {
                const size_t o = (size_t)gi * d + col;
                xim[o] = (c_rows[o] - acc) * zc;
            },
            [=](int gi, int col, float acc) { w1[(size_t)gi * d + col] = acc * zc; });
    }
    pn_sync();                           // every block's rows of Xi~^T and w1row
    PN_PHASE(6);

    // Phase 2 on I - Gv, Gv = Xi~^T Xi~; and Xi~^T w1row^T for Q.
    float* QA = EC;
    gram<TR, NC>(g, p.xim, n, p.xim, n, d, 1.f, w[0]);
    gram<TR, NC>(g, p.xim, n, p.sw, n, d, 1.f, QA);
    pn_sync();
    psym(g, w[0], W0, [](int gi, int j, float s) { return (gi == j ? 1.f : 0.f) - s; });
    PN_PHASE(7);
    pns<TR, NC>(g, W0, CUI, nullptr, p.it3, w);
    float* S2 = GU;
    pn_sync();
    psym(g, CUI, S2, Plain());
    const float res2 = rel_residual<TR, NC>(g, S2, W0, w[0]);
    each_local(g, [=](int gi, int j, int o) { W0[o] = (gi == j ? 1.f : 0.f) + S2[o]; });
    PN_PHASE(8);
    float* CV = CU;
    pnewton<TR, NC>(g, W0, CV, p.it4, w);
    const bool good = (res1 < p.tol) && (res2 < p.tol);

    // Q = Xi~^T w1row^T - cuiec^T and cv = -(I + S2)^{-1}, so that
    // fw1xi^T = [-gamma ef + t/(1+rho) + Q ef] / sqrt(B)
    //        = ximf^T + (Xi~^T w1row^T) u1row   (fused_step.py:341-342).
    each_local(g, [=](int, int, int o) {
        QA[o] = QA[o] - CUIECT[o];
        CV[o] = -CV[o];
    });
    PN_PHASE(9);
    {
        float* su2 = p.su + (size_t)n * d;
        float* sw2 = p.sw + (size_t)n * d;
        const float* ef = p.ef;
        const float* t = p.t;
        const int row0 = g.row0;
        rowprod2<TR, NC>(
            g, QA, nullptr, p.ef, n, d, n,
            [=](int gi, int col, float acc) {
                const size_t o = (size_t)gi * d + col;
                su2[o] = (-s_gamma[gi - row0] * ef[o] + s_inv1r[gi - row0] * t[o] + acc) * zc;
            },
            [](int, int, float) {});
        rowprod2<TR, NC>(
            g, CV, nullptr, p.xim, n, d, n,
            [=](int gi, int col, float acc) { sw2[(size_t)gi * d + col] = acc; },
            [](int, int, float) {});
    }
    PN_PHASE(10);

    // The mean with its select, the cluster's columns split by block:
    // mu' = mu + mean_b dmu_b where accepted, dmu_b = (t + ef + ef w/den) /
    // (1 + rho), each column's rows in order.
    for (int k = threadIdx.x; k < n; k += PN_THREADS) {
        const int q = k / g.R;
        all_wden[k] = pn_peer(s_wden, q)[k - q * g.R];
        all_inv1r[k] = pn_peer(s_inv1r, q)[k - q * g.R];
    }
    pn_arrive();                         // done reading the peers' shared memory
    __syncthreads();
    {
        const int cols = (d + PN_RANKS - 1) / PN_RANKS;
        const int c1 = min(d, (g.rank + 1) * cols);
        for (int col = g.rank * cols + threadIdx.x; col < c1; col += PN_THREADS) {
            float s = 0.f;
            for (int b = 0; b < n; ++b) {
                const size_t o = (size_t)b * d + col;
                const float e = p.ef[o];
                s += ((p.t[o] + e) + e * all_wden[b]) * all_inv1r[b];
            }
            const float m = p.mean_in[col];
            p.mean_out[col] = good ? m + s / (float)n : m;
        }
    }
    if (g.rank == 0 && threadIdx.x == 0) {
        *p.good = good ? 1 : 0;
        if (p.nacc != nullptr) *p.nacc += good ? 1 : 0;
    }
    PN_PHASE(11);
    pn_wait();                           // no block leaves while a peer reads it
}

}  // namespace
