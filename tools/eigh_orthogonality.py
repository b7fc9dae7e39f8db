#!/usr/bin/env python3
"""Why FactorGSM's twophase and qr methods decompose their small matrix in
float64 on the card (``gsmvi_tpu_torch/ops/gsm_factor._small_eigh``).

    python3 tools/eigh_orthogonality.py            # one NVIDIA GPU

1. torch's float32 ``eigh`` of near-identity symmetric (k, k) matrices, k
   in {32, 64}, on the CPU (LAPACK) and on the card: the eigenvectors'
   orthogonality error max |Q^T Q - I| and the reconstruction error, and
   ``_small_eigh``'s on the card.
2. ``FactorGSM(method=m)`` for m in twophase and qr at D=256, B=32, 3000
   steps on ``dense_gaussian(0, 256)``, seeds 0 and 1, with the small eigh
   in float32 (torch's, patched in) and as the port runs it: the moment
   errors (as ``bench.py:207-211``) and it/s.

One JSON line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def orthogonality(torch, small_eigh) -> None:
    rng = np.random.default_rng(0)
    for n in (32, 64):
        for trial in range(3):
            a = 0.3 * rng.standard_normal((n, n))
            m = np.eye(n) + 0.5 * (a + a.T) / np.sqrt(n)
            for label, dev, fn in (("cpu", "cpu", torch.linalg.eigh),
                                   ("cuda", "cuda", torch.linalg.eigh),
                                   ("cuda_small_eigh", "cuda", small_eigh)):
                x = torch.tensor(m, dtype=torch.float32, device=dev)
                w, q = fn(x)
                q64, w64 = q.double(), w.double()
                eye = torch.eye(n, dtype=torch.float64, device=dev)
                print(json.dumps({
                    "n": n, "trial": trial, "eigh": label,
                    "orth_err": float((q64.T @ q64 - eye).abs().max()),
                    "recon_err": float(((q64 * w64) @ q64.T
                                        - x.double()).abs().max())}),
                      flush=True)


def fits(torch, ops) -> None:
    from gsmvi_tpu_torch import FactorGSM
    from gsmvi_tpu_torch.models import dense_gaussian

    d, b, niter = 256, 32, 3000
    t = dense_gaussian(0, d, device="cuda")
    mean, cov = (x.double().cpu().numpy() for x in (t.mean, t.cov))
    ported = ops._small_eigh
    for label, eigh in (("float32 eigh", ops.safe_eigh),
                        ("_small_eigh", ported)):
        ops._small_eigh = eigh
        try:
            for method in ("qr", "twophase"):
                for seed in (0, 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st = FactorGSM(d, t.lp, t.lp_g, method=method,
                                   device="cuda").fit(
                        seed, batch_size=b, niter=niter, verbose=False,
                        return_state=True)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    c = st.cov.double().cpu().numpy()
                    print(json.dumps({
                        "eigh": label, "method": method, "seed": seed,
                        "mean_err": float(np.abs(
                            st.mean.double().cpu().numpy() - mean).max()),
                        "cov_err": float(np.abs(c - cov).max())
                        / max(1.0, float(np.abs(cov).max())),
                        "iters_per_s": (niter + 1) / wall}), flush=True)
        finally:
            ops._small_eigh = ported


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("eigh_orthogonality: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import gsmvi_tpu_torch.ops.gsm_factor as ops
    from gsmvi_tpu_torch.config import pin_fp32

    pin_fp32()
    orthogonality(torch, ops._small_eigh)
    fits(torch, ops)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
