#!/usr/bin/env python3
"""Drive the PyTorch port's GSM main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (one JSON object per phase on its own line; any failure raises and
the script exits non-zero):

0. device: the card's name and power limit (``nvidia-smi``), and the build
   of the CUDA kernels from ``gsmvi_tpu_torch/ops/cuda/csrc``.
1. kernels: K1 ``gsm_eps_update_fused``, K2 ``make_fused_eps_multistep``
   (spc=8, and nmax < spc) and K3 ``gaussian_score`` against their plain
   torch versions on the same CUDA tensors, at the main path's shape
   (B=32, D=256) and a ragged one (B=8, D=200), plus an input whose update
   the residual gates reject.
2. main path: ``GSM(D=256, ..., device="cuda").fit(seed, batch_size=32,
   niter=N)`` on the dense-Gaussian target; K1's launch count must rise by
   exactly N + 1 and the converged moment errors must be under the bound.
3. headline path: ``FactorGSM(..., fused_score=t.fused_score,
   device="cuda")`` (spc=8); K2 and K3 must launch, the moments converge,
   and its it/s is printed beside the plain version's on the same card.

Then the card's name and power limit, the kernel table, and as the last line
``{"ok": true, "device": {...}}`` with ``count`` 1: everything runs on
device 0.  Without a CUDA device it exits 1 before printing any result.
Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

B, D = 32, 256                # the repo's headline cell (bench.py:39-40)
RAGGED = (8, 200)
TARGET_SEED, FIT_SEED = 0, 0
N_ITER = 3000
# Converged-moment bounds at D=256, B=32, niter=3000 (errors as in
# bench.py:207-211): 1.5 x the largest error of the JAX package's own CPU
# fits of the same target (numpy seed 0, float32) at the same niter and
# batch — 9 dense-route and 9 exact-eps-route fits (PRNG keys 0..8) and 3
# fits on its NS eps step ``gsm_eps_update_ns_xla`` (keys 0..2):
# mean_err <= 1.9887e-3, cov_err <= 5.0331e-4.
MEAN_ERR_BOUND = 1.5 * 1.9887e-3
COV_ERR_BOUND = 1.5 * 5.0331e-4
# Kernel vs plain version (both float32 on the card, sums in other orders):
# the JAX package's kernel-vs-twin bounds, 1e-5 on the mean and
# 1e-5 * max|F| on the factor, for one update; spc=8 chained sub-steps
# compound the rounding, so the multistep comparison allows 1e-4.
MEAN_TOL, F_TOL, MULTI_TOL = 1e-5, 1e-5, 1e-4
SCORE_TOL = 1e-5

SOURCES = {
    "gsm_eps_update_fused": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:461"),
    "make_fused_eps_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/gemm.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:685"),
    "gaussian_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/gemm.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:778"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call between CUDA events (device timeline)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errs(mean, cov, t):
    """(mean_err, cov_err) as bench.py:207-211 defines them."""
    m = float((mean - t.mean).abs().max())
    scale = max(1.0, float(t.cov.abs().max()))
    return m, float((cov - t.cov).abs().max()) / scale


def phase_kernels(fs, dense_gaussian, torch, np):
    """Each kernel against its plain version on the same CUDA tensors."""
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in SOURCES}
    for b, d in ((B, D), RAGGED):
        rng = np.random.default_rng(1000 + d)
        a = rng.standard_normal((d, d))
        f = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
        mu = rng.standard_normal(d).astype(np.float32)
        eps = rng.standard_normal((b, d)).astype(np.float32)
        v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
        cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        eps_t, v_t, mu_t, f_t = cu(eps), cu(v), cu(mu), cu(f)
        fmax = float(np.abs(f).max())

        # Draw rows scaled over three decades make I + Gu so ill-conditioned
        # (~1e6) that the short Newton-Schulz chains cannot converge: the
        # residual gates must reject that update.
        ladder = np.logspace(0.0, 3.0, b, dtype=np.float32)[:, None]
        cases = {"update": eps_t, "update_reject": cu(ladder * eps)}
        for case, e in cases.items():
            for with_ef in (False, True):
                ef = e @ f_t.T if with_ef else None
                m_k, f_k, g_k = fs.gsm_eps_update_fused(e, v_t, mu_t, f_t,
                                                        ef=ef)
                m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(
                    e, v_t, mu_t, f_t, ef_t=ef)
                torch.cuda.synchronize()
                em = float((m_k - m_p).abs().max())
                ef_ = float((f_k - f_p).abs().max())
                rec = {"kernel": "gsm_eps_update_fused", "case": case,
                       "B": b, "D": d, "with_ef": with_ef,
                       "good": [bool(g_k), bool(g_p)], "mean_err": em,
                       "f_err": ef_, "f_tol": F_TOL * fmax,
                       "mean_tol": MEAN_TOL}
                emit({"phase": "kernels", **rec})
                check(bool(g_k) == bool(g_p) == (case == "update"),
                      f"K1 accept flag {rec}")
                if case == "update_reject":
                    check(torch.equal(m_k, mu_t) and torch.equal(f_k, f_t),
                          "K1 rejected update must return the old state")
                check(em <= MEAN_TOL and ef_ <= F_TOL * fmax,
                      f"K1 disagrees with its plain version: {rec}")
                worst["gsm_eps_update_fused"] = max(
                    worst["gsm_eps_update_fused"], em, ef_)

        t = dense_gaussian(TARGET_SEED, d, device=dev)
        score_fn, params = t.fused_score
        spc = 8
        block = cu(rng.standard_normal((spc * b, d)).astype(np.float32))
        step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
        mean0 = torch.zeros(d, device=dev)
        f0 = torch.eye(d, device=dev)
        for nmax in (spc, 3):
            m_k, f_k, n_k = step(nmax, block, mean0, f0, *params)
            m_p, f_p, n_p = fs.eps_multistep_reference(
                fs.gaussian_score_reference, params, nmax, block, mean0, f0,
                batch=b)
            torch.cuda.synchronize()
            em = float((m_k - m_p).abs().max())
            ef_ = float((f_k - f_p).abs().max())
            fscale = float(f_p.abs().max())
            rec = {"kernel": "make_fused_eps_multistep", "B": b, "D": d,
                   "spc": spc, "nmax": nmax, "n_acc": [int(n_k), int(n_p)],
                   "mean_err": em, "f_err": ef_,
                   "f_tol": MULTI_TOL * fscale, "mean_tol": MULTI_TOL}
            emit({"phase": "kernels", **rec})
            check(int(n_k) == int(n_p) == nmax, f"K2 accepted counts {rec}")
            check(em <= MULTI_TOL and ef_ <= MULTI_TOL * fscale,
                  f"K2 disagrees with its plain version: {rec}")
            worst["make_fused_eps_multistep"] = max(
                worst["make_fused_eps_multistep"], em, ef_)

        x = mu_t + eps_t @ f_t.T
        v_k = fs.gaussian_score(x, *params)
        v_p = fs.gaussian_score_reference(x, *params)
        torch.cuda.synchronize()
        vscale = float(v_p.abs().max())
        ev = float((v_k - v_p).abs().max())
        rec = {"kernel": "gaussian_score", "B": b, "D": d, "v_err": ev,
               "v_tol": SCORE_TOL * max(1.0, vscale)}
        emit({"phase": "kernels", **rec})
        check(ev <= SCORE_TOL * max(1.0, vscale),
              f"K3 disagrees with its plain version: {rec}")
        worst["gaussian_score"] = max(worst["gaussian_score"], ev)
    return worst


def phase_times(fs, dense_gaussian, torch, np):
    """Per-call times at the main path's shapes, kernel vs plain version
    (CUDA events; launches here are not counted toward the main path)."""
    dev = torch.device("cuda")
    t = dense_gaussian(TARGET_SEED, D, device=dev)
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(7)
    eps = torch.randn((B, D), generator=gen, device=dev)
    f = torch.eye(D, device=dev)
    mean = torch.zeros(D, device=dev)
    ef = eps @ f.T
    v = t.lp_g(mean + ef)
    spc = 8
    block = torch.randn((spc * B, D), generator=gen, device=dev)
    step = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)
    x = mean + ef
    times = {
        "gsm_eps_update_fused": (
            cuda_ms(lambda: fs.gsm_eps_update_fused(eps, v, mean, f, ef=ef)),
            cuda_ms(lambda: fs.gsm_eps_update_ns_reference(eps, v, mean, f,
                                                           ef_t=ef))),
        "make_fused_eps_multistep": (
            cuda_ms(lambda: step(spc, block, mean, f, *params), reps=20),
            cuda_ms(lambda: fs.eps_multistep_reference(
                fs.gaussian_score_reference, params, spc, block, mean, f,
                batch=B), reps=20)),
        "gaussian_score": (
            cuda_ms(lambda: fs.gaussian_score(x, *params), reps=200),
            cuda_ms(lambda: fs.gaussian_score_reference(x, *params),
                    reps=200)),
    }
    emit({"phase": "times", "B": B, "D": D, "ms_per_call": {
        k: {"kernel": a, "plain": b} for k, (a, b) in times.items()}})
    return times


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    from gsmvi_tpu_torch import GSM, FactorGSM
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.ops import fused_step as fs
    from gsmvi_tpu_torch.ops.cuda._build import load_library

    pin_fp32()
    card = card_line()
    t0 = time.perf_counter()
    lib = load_library()
    ptxas = [ln.strip() for ln in lib.path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": lib.build_seconds, "ptxas": ptxas})

    worst = phase_kernels(fs, dense_gaussian, torch, np)

    dev = torch.device("cuda")
    t = dense_gaussian(TARGET_SEED, D, device=dev)

    # Main path: counts reset just before, read just after phases 2 and 3.
    fs.reset_launch_counts()
    g = GSM(D, t.lp, t.lp_g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, cov = g.fit(FIT_SEED, batch_size=B, niter=N_ITER, verbose=False)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    k1_launches = fs.launch_counts()["gsm_eps_update_fused"]
    em2, ec2 = errs(mean, cov, t)
    fin2 = bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
    emit({"phase": "main_path", "fitter": "GSM", "D": D, "B": B,
          "niter": N_ITER, "k1_launches": k1_launches, "mean_err": em2,
          "cov_err": ec2, "mean_err_bound": MEAN_ERR_BOUND,
          "cov_err_bound": COV_ERR_BOUND, "iters_per_s": (N_ITER + 1) / wall2})
    check(k1_launches == N_ITER + 1, f"K1 launches {k1_launches} != niter+1")
    check(fin2 and tuple(mean.shape) == (D,) and tuple(cov.shape) == (D, D),
          "GSM.fit output shape/finiteness")
    check(em2 < MEAN_ERR_BOUND and ec2 < COV_ERR_BOUND,
          "GSM.fit did not converge under the bound")

    fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    check(fg._fused_mode(B) == "step" and fg.steps_per_call == 8,
          "headline path must run the whole-step kernel at spc=8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fg.fit(FIT_SEED, batch_size=B, niter=N_ITER, verbose=False,
                return_state=True)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    counts = fs.launch_counts()
    em3, ec3 = errs(st.mean, st.cov, t)
    emit({"phase": "headline_path", "fitter": "FactorGSM(fused_score)",
          "D": D, "B": B, "niter": N_ITER, "spc": fg.steps_per_call,
          "launches": counts, "n_accepted": int(st.n_accepted),
          "mean_err": em3, "cov_err": ec3, "iters_per_s": (N_ITER + 1) / wall3})
    check(counts["make_fused_eps_multistep"] > 0
          and counts["gaussian_score"] > 0, "K2/K3 not launched")
    check(counts["gsm_eps_update_fused"] == N_ITER + 1,
          "K1 launched outside the main path's GSM fit")
    check(bool(torch.isfinite(st.mean).all() and torch.isfinite(st.cov).all()),
          "FactorGSM output not finite")
    check(em3 < MEAN_ERR_BOUND and ec3 < COV_ERR_BOUND,
          "FactorGSM(fused_score) did not converge under the bound")

    # it/s of the kernel path vs the plain version, same blocks, same card.
    score_fn, params = t.fused_score
    spc, nblk = 8, 50
    gen = torch.Generator(device=dev).manual_seed(11)
    blocks = [torch.randn((spc * B, D), generator=gen, device=dev)
              for _ in range(nblk)]
    multi = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)

    def run_blocks(fn):
        m, f = torch.zeros(D, device=dev), torch.eye(D, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks:
            m, f, _ = fn(blk, m, f)
        torch.cuda.synchronize()
        return spc * nblk / (time.perf_counter() - t0)

    kern = lambda blk, m, f: multi(spc, blk, m, f, *params)
    plain = lambda blk, m, f: fs.eps_multistep_reference(
        fs.gaussian_score_reference, params, spc, blk, m, f, batch=B)
    rates = [run_blocks(kern), run_blocks(plain), run_blocks(plain),
             run_blocks(kern)]
    emit({"phase": "rates", "D": D, "B": B, "spc": spc,
          "fit_iters_per_s": (N_ITER + 1) / wall3,
          "kernel_iters_per_s": [rates[0], rates[3]],
          "plain_iters_per_s": [rates[1], rates[2]]})

    times = phase_times(fs, dense_gaussian, torch, np)
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": worst[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in SOURCES.items()]})
    # Every phase ran on device 0, the one card this script drives.
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
