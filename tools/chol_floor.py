#!/usr/bin/env python3
"""The float32 rounding floor of K4's exact (chol) step on one NVIDIA GPU.

    python3 tools/chol_floor.py [--seeds 4]

For (B, D) in (8, 200), (32, 256), (64, 256) and each seed, one whole step
of ``make_fused_eps_step`` from (0, I) on ``dense_gaussian(0, D)`` with a
standard-normal draw, on the chol and the ns update: the condition number
of the Gram G = Z^T Z (before its jitter, in float64), and the max-abs
distances on S = F F^T (and on the mean) between the kernel, the plain
float32 version and the plain float64 version on the same input.  One JSON
line per (B, D, seed).  It shows where ``chip_smoke.py``'s chol tolerance
(4x the plain float32 version's distance from float64) comes from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gram_condition(e, v, f):
    """cond(Z^T Z) of the step's rows, float64, before the jitter."""
    import torch

    b = e.shape[0]
    a = -(e @ f.T)
    vf = v @ f
    t = vf @ f.T
    vsv = (v * t).sum(1, keepdim=True)
    mv = (a * v).sum(1, keepdim=True)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    w = (v * (t - a)).sum(1, keepdim=True)
    inv1r = 1.0 / (1.0 + rho)
    gamma = 1.0 - (1.0 + w / (1.0 + rho + mv)) * inv1r
    zt = torch.cat([-e, -e * gamma + vf * inv1r]) / b ** 0.5
    ev = torch.linalg.eigvalsh(zt @ zt.T)
    return float(ev.max() / ev.min())


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chol_floor: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.ops import fused_step as fs

    pin_fp32()
    dev = torch.device("cuda")
    ref = fs.gaussian_score_reference
    cov = lambda f: f.double() @ f.double().T
    dist = lambda x, y: [float((x[0].double() - y[0].double()).abs().max()),
                         float((cov(x[1]) - cov(y[1])).abs().max())]
    for b, d in ((8, 200), (32, 256), (64, 256)):
        t = dense_gaussian(0, d, device=dev)
        score_fn, params = t.fused_score
        p64 = [p.double() for p in params]
        for seed in range(args.seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            e = torch.randn((b, d), generator=gen, device=dev)
            m0, f0 = torch.zeros(d, device=dev), torch.eye(d, device=dev)
            e64, m64, f64 = e.double(), m0.double(), f0.double()
            rec = {"B": b, "D": d, "seed": seed, "cond_G": gram_condition(
                e64, ref(m64 + e64 @ f64.T, *p64), f64)}
            for method in ("ns", "chol"):
                step = fs.make_fused_eps_step(score_fn, len(params), b, d,
                                              external_eps=True,
                                              method=method)
                k = step(e, m0, f0, *params)
                p = fs.eps_step_reference(ref, params, e, m0, f0,
                                          method=method)
                q = fs.eps_step_reference(ref, p64, e64, m64, f64,
                                          method=method)
                rec[method] = {"kernel_vs_plain": dist(k, p),
                               "plain_vs_f64": dist(p, q),
                               "kernel_vs_f64": dist(k, q),
                               "max_S": float(cov(q[1]).abs().max())}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
