#!/usr/bin/env python3
"""BaM's row-panel small space (K7 at B 57-128) against its plain version
and against the float32 rounding floor of each input, on one NVIDIA GPU.

    python3 tools/bam_panel_floor.py [--shapes 57x1 121x1 121x33 128x1 ...]

For each (B, D) and each of the four designed K7 inputs of
``tests/test_torch_gpu.py`` (benign, stiff_lmax, stiff_gu, reject; the
same seeds, B + 3 D) this runs ``bam_eps_update_fused`` on the card and its
plain version on the same CUDA tensors, and prints one JSON line: the
flags of both, the largest differences of the mean and of F from the plain
version, and the input's float32 floor: the larger distance of the two
plain float32 formulations (K7's, and the small space's stacked rows as
the kernel forms them) from the plain version in float64.  ``ratio`` is
the kernel's distance over that floor; the on-card test holds stiff_gu to
8.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (input kwargs, reg, gate overrides) as tests/test_torch_gpu.py's
# BAM_K7_CASES.
CASES = {
    "benign": ({"v_scale": 0.05}, 0.5, {}),
    "stiff_lmax": ({"score_scale": 300.0}, 20.0, {}),
    "stiff_gu": ({"v_scale": 0.02}, 1e4, {"lmax_gate": float("inf")}),
    "reject": ({}, 3e5, {"lmax_gate": float("inf"), "gu_gate": float("inf")}),
}


def inputs(torch, np, b, d, seed, score_scale=1.0, v_scale=None):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    v = score_scale * -(mu + e @ f.T - rng.standard_normal(d))
    if v_scale is not None:
        v = v_scale * rng.standard_normal((b, d))
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
            for x in (e, v, mu, f)]


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", nargs="*", default=[
        "57x1", "57x33", "121x1", "121x33", "128x1", "128x33", "128x256"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bam_panel_floor: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch.ops import bam_fused as bf
    from gsmvi_tpu_torch.ops import fused_step as fs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dist = lambda a, c: float((a.double() - c.double()).abs().max())
    for shape in args.shapes:
        b, d = map(int, shape.split("x"))
        for name, (kw, reg, gates) in CASES.items():
            e, v, mu, f = inputs(torch, np, b, d, b + 3 * d, **kw)
            vf = v @ f
            rows = (e, v, vf, vf @ f.T, e @ f.T)
            fs.reset_launch_counts()
            k = bf.bam_eps_update_fused(e, v, mu, f, reg, ef=rows[4], **gates)
            panel = fs.launch_counts()["bam_smallspace_panel"]
            p = bf.bam_eps_update_ns_reference(e, v, mu, f, reg, ef=rows[4],
                                               **gates)
            x64 = [x.double() for x in (e, v, mu, f)]
            p64 = bf.bam_eps_update_ns_reference(
                *x64, reg, ef=x64[0] @ x64[3].T, **gates)
            su, sw, vec, _ = bf.bam_smallspace_stacks_reference(
                *rows, mu, reg, batch=b, **gates)
            f_s = f + su.T @ sw
            r1 = reg / (1.0 + reg)
            m_s = mu / (1.0 + reg) + r1 * ((vec[0] @ f_s) @ f_s.T + vec[1])
            err = (dist(k[0], p[0]), dist(k[1], p[1]))
            floor = (max(dist(p[0], p64[0]), dist(m_s, p64[0])),
                     max(dist(p[1], p64[1]), dist(f_s, p64[1])))
            print(json.dumps({
                "B": b, "D": d, "case": name, "panel_launches": panel,
                "keep": [bool(k[2]), bool(p[2])],
                "stiff": [bool(k[3]), bool(p[3])],
                "mean_err": err[0], "f_err": err[1],
                "mean_floor": floor[0], "f_floor": floor[1],
                "mean_scale": float(p[0].abs().max()),
                "f_scale": float(p[1].abs().max()),
                "ratio": [e_ / fl if fl > 0 else None
                          for e_, fl in zip(err, floor)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
