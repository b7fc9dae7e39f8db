#!/usr/bin/env python3
"""Where the time of a cluster small space goes, phase by phase, on one
NVIDIA GPU.

    python3 tools/smallspace_phases.py [--kernel eps|bam] [--shapes 32x256 ...]

Builds the eps-NS cluster small space (``ops/cuda/csrc/
eps_smallspace_cluster*.cu``, ``--kernel eps``) or BaM's
(``bam_smallspace_cluster*.cu``, ``--kernel bam``, at the NS profile of
tier 0) a second time with ``-DGSMVI_PHASE_STAMPS``, which makes thread 0
of every block of replica 0 write the global timer at each phase boundary,
into ``gsmvi_tpu_torch/ops/cuda/_build/``.  For each (B, D) it launches
that library 20 times as a warm-up and 200 times between CUDA events (one
replica, from random rows and a well-conditioned factor made on the card),
then prints one JSON line: the card, the mean microseconds per launch, and
the last launch's microseconds per phase in rank 0 and in the last rank of
the cluster.  The stamps cost a few global stores per phase; the kernel the
port runs has none.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("row sums + cluster sync", "row scalars", "pass 1 (c, Gram partials) + sync",
          "S1 = sqrt(I + Gu)", "S1's residual + cu = (I + S1)^-1", "cui = (I + S1 + Gu)^-1",
          "e c^T sum + cuiec", "pass 2 (Xi~, w1row, Gram partials)", "partials + sync",
          "S2 = sqrt(I - Gv)", "S2's residual + cv = -(I + S2)^-1", "Q sum", "pass 3 (stacked rows, mean)",
          "flags + exit barrier")
BAM_PHASES = ("pass 1 (row factors, Gram partials) + sync", "Gu sum + s_u = sqrt(I + Gu)",
              "s_u's residual + cu = (I + s_u)^-1", "Om^T Q sum + cu Om^T Q",
              "pass 2 (y, w1, four Gram partials) + sync", "four Gram sums",
              "trace sums, lmax, I + 4G + cluster wait", "s1 = sqrt(I + 4G)",
              "s1's residual", "p = (I + s1)^-1/2", "p p, res_p", "winv + tau",
              "pass 3 (u2 rows)", "ss + exit")


def build(build_mod, kernel: str) -> Path:
    """The stamped library of ``kernel`` (built once per source hash)."""
    srcs = sorted(build_mod.CSRC.glob(f"{kernel}_smallspace_cluster*.cu"))
    h = hashlib.sha256(b"GSMVI_PHASE_STAMPS" + kernel.encode())
    for p in sorted(build_mod.CSRC.glob("*.cu*")):
        h.update(p.read_bytes())
    so = build_mod.BUILD_DIR / f"phases_{kernel}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build_mod.nvcc_path()
    objs = [so.with_name(f"{so.stem}.{p.stem}.o") for p in srcs]
    logs = [o.with_suffix(".out") for o in objs]
    try:
        build_mod._nvcc_all([[nvcc, *build_mod.NVCC_FLAGS, "-DGSMVI_PHASE_STAMPS", "-c", "-o",
                              str(o), str(p)] for p, o in zip(srcs, objs)], logs)
        subprocess.run([nvcc, *build_mod.ARCH_FLAGS, "-shared", "-o", str(so),
                        *map(str, objs)], check=True)
    finally:
        for path in (*objs, *logs):
            path.unlink(missing_ok=True)
    return so


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--kernel", choices=("eps", "bam"), default="eps")
    parser.add_argument("--shapes", nargs="*", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("smallspace_phases: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch.ops import bam_fused as bf
    from gsmvi_tpu_torch.ops import fused_step as fs
    from gsmvi_tpu_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    lib = ctypes.CDLL(str(build(_build, args.kernel)))
    entry = f"gsmvi_{args.kernel}_smallspace_cluster"
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    names = PHASES if args.kernel == "eps" else BAM_PHASES
    shapes = args.shapes or (["32x256", "8x200", "64x1024"] if args.kernel == "eps"
                             else ["32x256", "12x200", "56x1024"])
    dev = torch.device("cuda")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    for shape in shapes:
        b, d = map(int, shape.split("x"))
        gen = torch.Generator(device=dev).manual_seed(3)
        e = torch.randn((b, d), generator=gen, device=dev)
        v = 0.3 * torch.randn((b, d), generator=gen, device=dev)
        f = torch.eye(d, device=dev) + 0.3 * torch.randn((d, d), generator=gen,
                                                         device=dev) / d ** 0.5
        mean = torch.randn(d, generator=gen, device=dev)
        vf = v @ f
        ranks, cols = fs.cluster_columns(d)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if args.kernel == "eps":
            buf = fs._UpdateBuffers(b, d, dev)
            ptrs = [ptr(x) for x in (e, v, vf, vf @ f.T, e @ f.T, mean,
                                     torch.empty_like(mean), buf.good, None, buf.su,
                                     buf.sw, buf.c, buf.xim)]
            call = lambda: fn(*ptrs, b, d, *fs.ns_iters_for_batch(b), fs.NS_TOL, 1,
                              e.numel(), ranks, cols, stream)
            tile = "b16" if b <= 16 else "b32" if b <= 32 else "b64"
            verdict = lambda: {"good": int(buf.good[0])}
        else:
            buf = bf._BamBuffers(b, d, dev)
            ptrs = [ptr(x) for x in (e, v, vf, vf @ f.T, e @ f.T, mean, buf.rows, buf.su,
                                     buf.sw, buf.vec, buf.ss, None)]
            tile = f"t{bf.bam_cluster_tile(b)}"
            call = lambda: fn(*ptrs, b, d, 0.5, *bf.BAM_NS_ITERS_DEFAULT,
                              bf.LMAX_GATE_DEFAULT, bf.GU_GATE_DEFAULT, bf.NS_TOL, ranks,
                              cols, bf.bam_cluster_tile(b), stream)
            verdict = lambda: {"ss": buf.ss[:bf.SS_SIZE].tolist()}
        for _ in range(20):
            if call() != 0:
                raise RuntimeError("the stamped small space failed to launch")
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            call()
        stop.record()
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * (8 * 15))()
        getattr(lib, f"gsmvi_{args.kernel}_cluster_{tile}_phases")(stamps)
        n = 15
        per_rank = {}
        for rank in sorted({0, ranks - 1}):
            ts = stamps[rank * n:(rank + 1) * n]
            per_rank[f"rank {rank}"] = {
                name: (ts[i + 1] - ts[i]) / 1e3 for i, name in enumerate(names)}
            per_rank[f"rank {rank}"]["total"] = (ts[len(names)] - ts[0]) / 1e3
        print(json.dumps({"card": card, "kernel": args.kernel, "B": b, "D": d,
                          "cluster": [ranks, cols], **verdict(),
                          "us_per_launch": start.elapsed_time(stop) * 1e3 / 200,
                          "us_per_phase": per_rank}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
