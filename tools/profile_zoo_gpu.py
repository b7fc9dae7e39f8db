#!/usr/bin/env python3
"""Where the time of the zoo path and of the large-batch small spaces goes
on one NVIDIA GPU.

    python3 tools/profile_zoo_gpu.py [--steps 64] [--only-zoo | --only-scores]

With ``torch.profiler``, as ``tools/profile_gpu.py`` profiles the GSM
paths (its ``profile_fit`` and ``profile_calls``; one JSON line each: host
wall per step profiled and unprofiled, device busy per step, the device's
idle share, launches per step and device time by kernel name):

- the zoo path, ``FactorGSM(..., fused_score=t.fused_score)`` (K2 with the
  K11a or K11b score inside, spc=8) at D=256, B=32 on ``funnel(256)``,
  ``banana(256)``, ``student_t(0, 256, df=6)``, ``gaussian_mixture(0,
  256)`` and ``logistic_regression(0, 256)``;
- each zoo score alone per call at D=256, B=32 on its target's params
  (``profile_calls``: device µs, kernels and host launches per call),
  beside its library yardsticks, one PyTorch call each for a part of the
  score: ``addmm`` (x - loc) Prec for the Student-t, ``mm`` w X^T and
  ``mm`` resid X (resid of shape (B, N)) for logreg, ``mm`` x M^T for the
  mixture; the funnel, banana and the mixture also at (B, D) = (512, 1024)
  and at K6's (256, 256) (K=8 replicas of B=32, stacked), each with its
  yardstick; and the launch floor, a one-element ``fill_``, the smallest
  kernel PyTorch launches;
- ``FactorGSM(fused_score=...)`` on ``dense_gaussian(0, 256)`` at B=128,
  where K2 runs the row-panel small space (``eps_smallspace_panel``);
- single K1 calls (``gsm_eps_update_fused``) at B=128 (the row-panel small
  space) and B=512 (the grid one, ``eps_smallspace_large``),
  D=256, from (0, I).

``--only-zoo``: the zoo fits and the scores alone, nothing at B=128 or
B=512; ``--only-scores``: the scores alone.  To time another checkout's port with this script, copy it into
that checkout's ``tools/`` and run it from there (``profile_gpu.py``
puts its own checkout first on ``sys.path``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_gpu import profile_calls, profile_fit  # noqa: E402


class AtBatch:
    """``fitter`` with ``fit`` run at batch ``batch`` (``profile_fit``
    drives the headline's B=32)."""

    def __init__(self, fitter, batch: int):
        self.fitter, self.batch = fitter, batch

    def fit(self, seed, batch_size, niter, verbose):
        return self.fitter.fit(seed, batch_size=self.batch, niter=niter,
                               verbose=verbose)


def profile_scores(torch, b: int = 32, d: int = 256) -> None:
    """Each zoo score alone per call at (B, D) on its target's params, and
    its library yardsticks (one PyTorch call each, for a part of it)."""
    from gsmvi_tpu_torch.models import (banana, funnel, gaussian_mixture,
                                        logistic_regression, student_t)

    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((b, d), generator=gen, device="cuda")
    for t in (funnel(d, device="cuda"), banana(d, device="cuda"),
              student_t(0, d, df=6.0, device="cuda"),
              gaussian_mixture(0, d, device="cuda"),
              logistic_regression(0, d, device="cuda")):
        score, params = t.fused_score
        profile_calls(f"{score.__name__} B={b} D={d} ({t.name})",
                      lambda: score(x, *params), 64, torch)
        library = {}
        if score.__name__ == "student_t_score":
            loc, prec = params[0], params[1]
            lp = loc @ prec
            library["addmm (x - loc) prec"] = lambda: torch.addmm(
                lp, x, prec, beta=-1.0)
        elif score.__name__ == "logreg_score":
            xd = params[0]
            resid = torch.randn((b, xd.shape[0]), generator=gen,
                                device="cuda")
            library["mm w X^T"] = lambda: torch.mm(x, xd.T)
            library["mm resid X"] = lambda: torch.mm(resid, xd)
        elif score.__name__ == "mixture_score":
            means = params[0]
            library["mm x M^T"] = lambda: torch.mm(x, means.T)
        for name, fn in library.items():
            profile_calls(f"library {name} for {score.__name__} B={b} D={d}",
                          fn, 64, torch)


def profile_split_scores(torch) -> None:
    """The funnel, banana and the mixture at (512, 1024) and K6's (256,
    256), the mixture beside ``mm`` x M^T; then the launch floor."""
    from gsmvi_tpu_torch.models import banana, funnel, gaussian_mixture

    gen = torch.Generator(device="cuda").manual_seed(20)
    for b, d in ((512, 1024), (256, 256)):
        x = torch.randn((b, d), generator=gen, device="cuda")
        mixture = gaussian_mixture(0, d, device="cuda")
        for t in (funnel(d, device="cuda"), banana(d, device="cuda"),
                  mixture):
            score, params = t.fused_score
            profile_calls(f"{score.__name__} B={b} D={d} ({t.name})",
                          lambda: score(x, *params), 64, torch)
        means = mixture.fused_score[1][0]
        profile_calls(f"library mm x M^T for mixture_score B={b} D={d}",
                      lambda: torch.mm(x, means.T), 64, torch)
    one = torch.empty(1, device="cuda")
    profile_calls("launch floor: fill_ of one element",
                  lambda: one.fill_(1.0), 64, torch)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=64)
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--only-zoo", action="store_true")
    only.add_argument("--only-scores", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_zoo_gpu: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch import FactorGSM
    from gsmvi_tpu_torch.models import (banana, dense_gaussian, funnel,
                                        gaussian_mixture, logistic_regression,
                                        student_t)
    from gsmvi_tpu_torch.ops import fused_step as fs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.only_scores:
        profile_scores(torch)
        profile_split_scores(torch)
        return 0
    for t in (funnel(256, device="cuda"), banana(256, device="cuda"),
              student_t(0, 256, df=6.0, device="cuda"),
              gaussian_mixture(0, 256, device="cuda"),
              logistic_regression(0, 256, device="cuda")):
        profile_fit(f"FactorGSM fused_score on {t.name} (K2+K11, spc=8)",
                    FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                              device="cuda"), args.steps, torch)
    profile_scores(torch)
    profile_split_scores(torch)
    if args.only_zoo:
        return 0
    t = dense_gaussian(0, 256, device="cuda")
    fused = FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                      device="cuda")
    profile_fit("FactorGSM fused_score B=128 (K2 on eps_smallspace_panel "
                "+ K3, spc=8)", AtBatch(fused, 128), args.steps, torch)
    gen = torch.Generator(device="cuda").manual_seed(18)
    mean, f = torch.zeros(256, device="cuda"), torch.eye(256, device="cuda")
    for b in (128, 512):
        e = torch.randn((b, 256), generator=gen, device="cuda")
        v = t.lp_g(mean + e)
        small = "eps_smallspace_panel" if b <= 128 else "eps_smallspace_large"
        profile_calls(f"K1 gsm_eps_update_fused B={b} ({small})",
                      lambda: fs.gsm_eps_update_fused(e, v, mean, f), 16,
                      torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
