#!/usr/bin/env python3
"""Device time of the BaM cluster small space per chain tile, on one NVIDIA
GPU.

    python3 tools/bam_tiles.py [--shapes 32x256 40x256 25x1024]

The cluster kernel (``ops/cuda/csrc/bam_smallspace_cluster*.cu``) runs its
(kpad, kpad) chain products on a T x T register tile per thread, kpad =
B + 8 <= 16 T; ``ops/bam_fused.bam_cluster_tile`` picks the smallest T.
For each (B, D) this times ``bam_smallspace`` with every tile that holds
kpad (T in 3..4 for kpad 33-48), at the NS profile of tier 0 and of the most
benign tier, in turns (each tile twice, in the order a b b a): device
microseconds per call under ``torch.profiler`` over 30 calls, on rows made
from a seed (``chip_smoke.bam_k7_cases``' benign input), and the largest
difference of the stacked rows from the plain version's.  One JSON line per
(B, D, tier), after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", nargs="*",
                        default=["32x256", "40x256", "25x1024"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bam_tiles: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.ops import bam_fused as bf

    pin_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    chosen = bf.bam_cluster_tile
    for shape in args.shapes:
        b, d = (int(x) for x in shape.split("x"))
        case = cs.bam_k7_cases(np, ((b, d),))[0]
        e, v, mu, f = (torch.from_numpy(x).to(dev) for x in case[3])
        vf = v @ f
        rows = (e, v, vf, vf @ f.T, e @ f.T)
        tiles = [t for t in (1, 2, 3, 4) if b + 8 <= 16 * t][:2]
        for label, (it, gg, lm) in (("tier0", bf.BAM_NS_TIERS[0]),
                                    ("tier3", bf.BAM_NS_TIERS[-1])):
            kw = dict(iters=it, lmax_gate=lm, gu_gate=gg)
            plain = bf.bam_smallspace_stacks_reference(*rows, mu, case[4],
                                                       batch=b, **kw)
            us, err = {}, {}
            for tile in tiles + tiles[::-1]:
                bf.bam_cluster_tile = lambda _, tile=tile: tile
                fn = lambda: bf.bam_smallspace(*rows, mu, case[4], **kw)
                us.setdefault(tile, []).append(
                    1e3 * cs.device_ms(fn, calls=30)[0])
                out = fn()
                err[tile] = max(float((x - y).abs().max())
                                for x, y in zip(out[:2], plain[:2]))
            bf.bam_cluster_tile = chosen
            print(json.dumps({"B": b, "D": d, "kpad": b + 8, "tier": label,
                              "default_tile": chosen(b),
                              "device_us_per_call": us,
                              "max_abs_diff_stacks": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
