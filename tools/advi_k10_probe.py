#!/usr/bin/env python3
"""K10 on the (B=16, D=1024) inputs of
``tests/test_torch_gpu.py::test_advi_k10_matches_plain`` against its plain
version in float32 and in float64, on one NVIDIA GPU.

    python3 tools/advi_k10_probe.py

After 1, 2, 3 and 8 sub-steps of the test's "full" case it prints, per
state tensor, the share of entries within the test's tolerance (1e-5 *
max(1, |x|)) and the largest difference from the float32 plain version,
and at L[371, 355] the first moment ml (0.1 dL after one sub-step) of the
kernel, of the plain version and of float64.  That entry's exact gradient
lies at float32 rounding level; Adam turns it into a step of +-lr either
way, so the sign the kernel's row products give it decides the test
(PERF.md, K9/K10 findings).  One JSON line per sub-step count.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, D, SPC, LR = 16, 1024, 8, 1e-4
ENTRY = (371, 355)
NAMES = ("loc", "l", "ainv", "mloc", "vloc", "ml", "vl")


def inputs(np, torch, dev):
    """The test's ``_advi_inputs(cuda, 16, 1024, 8, seed=1025)``."""
    rng = np.random.default_rng(D + 1)
    l = np.tril(np.eye(D) + 0.02 * rng.standard_normal((D, D)))
    arrays = [np.linspace(-1.0, 1.0, D)[None], np.eye(D),
              0.1 * rng.standard_normal(D), l, np.tril(np.linalg.inv(l)),
              rng.standard_normal((SPC * B, D))]
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in arrays]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("advi_k10_probe: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.ops import advi_fused as af
    from gsmvi_tpu_torch.ops import fused_step as fs

    pin_fp32()
    dev = torch.device("cuda")
    mean_t, prec, loc, l, ainv, block = inputs(np, torch, dev)
    z, zz = torch.zeros(D, device=dev), torch.zeros((D, D), device=dev)
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        0.0, 0.9, 0.999, torch.arange(SPC, dtype=torch.int32)))
    k10 = af.make_fused_advi_stl_multistep(fs.gaussian_score, 2, B, D, SPC)
    for nmax in (1, 2, 3, SPC):
        args = ([LR] * SPC, bc1s, bc2s, nmax, block, loc, l, ainv, z, z, zz,
                zz)
        got = k10(*args, mean_t, prec)[:7]
        want = af.advi_stl_multistep_reference(
            fs.gaussian_score_reference, (mean_t, prec), *args, batch=B)[:7]
        a64 = [x.double() if torch.is_tensor(x) else x for x in args]
        w64 = af.advi_stl_multistep_reference(
            fs.gaussian_score_reference, (mean_t.double(), prec.double()),
            *a64, batch=B)[:7]
        rec = {"B": B, "D": D, "nmax": nmax}
        for name, g, w in zip(NAMES, got, want):
            diff = (g - w).abs()
            ok = diff <= 1e-5 * w.abs().clamp(min=1.0)
            rec[name] = {"frac": float(ok.double().mean()),
                         "max_abs_err": float(diff.max())}
        i, j = ENTRY
        rec[f"ml[{i},{j}]"] = {"kernel": float(got[5][i, j]),
                               "plain": float(want[5][i, j]),
                               "float64": float(w64[5][i, j])}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
