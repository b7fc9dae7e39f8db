#!/usr/bin/env python3
"""Where the time of a cluster small space goes, phase by phase, on one
NVIDIA GPU.

    python3 tools/smallspace_phases.py [--kernel eps|bam|panel|large|k5|zoo|chol]
                                       [--shapes 32x256 ...] [--tile 16|32]

Builds the eps-NS cluster small space (``ops/cuda/csrc/
eps_smallspace_cluster*.cu``, ``--kernel eps``), BaM's
(``bam_smallspace_cluster*.cu``, ``--kernel bam``, at the NS profile of
tier 0) or the eps row-panel small space of B 65-128
(``eps_smallspace_panel.cu``, ``--kernel panel``) a second time with
``-DGSMVI_PHASE_STAMPS``, which makes thread 0
of every block of replica 0 write the global timer at each phase boundary,
into ``gsmvi_tpu_torch/ops/cuda/_build/``.  For each (B, D) it launches
that library 20 times as a warm-up and 200 times between CUDA events (one
replica, from random rows and a well-conditioned factor made on the card),
then prints one JSON line: the card, the mean microseconds per launch, and
the last launch's microseconds per phase in rank 0 and in the last rank of
the cluster.  ``--kernel k5``: K5's Gram launch (``gsm_step.cu``,
``gram_kernel``), where every block sums its phase times over its slabs;
each line gives them for the first diagonal tile's rank 0 and last rank
and the first off-diagonal tile's rank 0, beside the mean microseconds per
K5 call (both launches).  ``--kernel zoo``: the zoo's product scores
(``zoo_student_t.cu``, ``zoo_logreg.cu``) and the mixture's
(``zoo_score_b.cu``) on their targets' params (the Student-t at df=6,
logreg at N=200, the mixture at K=3): for the Student-t the phases of the
block of row block 0 that ends last (a last rank-r block, which scales
its rows) and the launch's span from the first block's start to the last
block's end; for logreg rank 0's and the last rank's; for the mixture
block 0's (thread 0, in the first warp of the first row).  ``--kernel large``:
the grid small space of B 129-512 (``eps_smallspace_grid*.cu``, one
cooperative launch on the grid of the port's occupancy query, the tile of
``fs.grid_tile(B)`` unless ``--tile`` names one): for each phase of its
schedule (``grid_schedule.py``), the ops it runs, its work (block 0's
start to the last block's end of work), the grid barrier after it (that
end to the next phase's start) and the longest time a block spent in the
norm and residual tickets' reductions, and the sums over the phases.
``--kernel chol``: K4a, ``gsm_eps_update_fused(method="chol")`` through
the port's wrapper on a whole library built with the stamps (so that the
same command times another checkout's K4a, whatever its launches), at
(32, 256) and (64, 256) by default: the mean microseconds per call (all of
its launches) and, of the last call, the exact small space's phases as
block 0 of ``eps_chol.cu`` stamps them: the Gram and jitter (with the rows
and the Gram where that launch forms them), the first sweep, K, the
inverse, the second sweep, X, S2 and S2 Z^T with the mean, and the wait
before the exit.  The stamps cost a few global stores per phase; the
kernel the port runs has none.
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
PANEL_PHASES = ("row scalars, c + sync", "Gu, e c^T Grams + Gu's symmetrisation",
                "S1 = sqrt(I + Gu), its residual", "cu, cui inverses", "cuiec + its transpose",
                "Xi~, w1row rows + sync", "Gv, Xi~ w1row^T Grams + I - Gv",
                "S2 = sqrt(I - Gv), its residual", "cv inverse + Q", "stacked rows",
                "mean + exit barrier")
BAM_PHASES = ("pass 1 (row factors, Gram partials) + sync", "Gu sum + s_u = sqrt(I + Gu)",
              "s_u's residual + cu = (I + s_u)^-1", "Om^T Q sum + cu Om^T Q",
              "pass 2 (y, w1, four Gram partials) + sync", "four Gram sums",
              "trace sums, lmax, I + 4G + cluster wait", "s1 = sqrt(I + 4G)",
              "s1's residual", "p = (I + s1)^-1/2", "p p, res_p", "winv + tau",
              "pass 3 (u2 rows)", "ss + exit")
ZT_PHASES = ("k walk", "cluster sync", "rank-ordered sums, P and maha partials",
             "barrier arrive + ticket", "the last rank-r block: partials, maha, scale")
ZL_PHASES = ("phase 1 walk (first tile)", "phase 1 group sums + resid (all tiles)",
             "cluster sync", "phase 2 walk (first tile)", "phase 2 group sums + stores + exit sync")
MX_PHASES = ("x, M and partial logits and norms", "barrier", "warp-ordered sums + softmax",
             "v")
CH_PHASES = ("rows, Gram, jitter", "first sweep: chol(G)", "K = I + Lg^T J Lg",
             "inverse M = Lg^-T", "second sweep: chol(K)", "X = M (Ck^T - I)^T", "S2 = X M^T",
             "S2 Z^T + mean", "exit wait")
K5_PHASES = ("prologue: tile, mu0, first slab issued", "row scalars", "slab wait + barrier",
             "A, dmu, Bm in place + barrier", "dmu column sums + FMA + barrier",
             "partials + cluster sync", "rank-ordered sums", "stores, mean + exit sync")


def build(build_mod, kernel: str) -> Path:
    """The stamped library of ``kernel`` (built once per source hash)."""
    pattern = ("*.cu" if kernel == "chol"        # K4a's sources, below
               else "eps_smallspace_panel*.cu" if kernel == "panel"
               else "eps_smallspace_grid*.cu" if kernel == "large"
               else "gsm_step.cu" if kernel == "k5"
               else "zoo_*.cu" if kernel == "zoo"
               else f"{kernel}_smallspace_cluster*.cu")
    srcs = sorted(p for p in build_mod.CSRC.glob(pattern)
                  if (kernel != "zoo" or p.stem in ("zoo_student_t", "zoo_logreg",
                                                     "zoo_score_b"))
                  and (kernel != "chol" or p.stem.startswith("eps_chol")
                       or p.stem in ("thin_gemm", "gemm")))
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
    parser.add_argument("--kernel", choices=("eps", "bam", "panel", "large", "k5",
                                             "zoo", "chol"), default="eps")
    parser.add_argument("--shapes", nargs="*", default=None)
    parser.add_argument("--tile", type=int, choices=(16, 32), default=None)
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
    so = build(_build, args.kernel)
    if args.kernel == "chol":
        return chol_phases(_build, so, card, args.shapes or ["32x256", "64x256"], torch)
    lib = ctypes.CDLL(str(so))
    if args.kernel == "k5":
        return k5_phases(lib, _build, card, args.shapes or ["32x256", "512x256"], torch)
    if args.kernel == "zoo":
        return zoo_phases(lib, _build, card, args.shapes or ["32x256", "512x1024"], torch)
    if args.kernel == "large":
        return large_phases(lib, _build, card, args.shapes or ["256x256", "512x256"],
                            args.tile, torch)
    panel = args.kernel == "panel"
    entry = "gsmvi_eps_smallspace_panel" if panel else f"gsmvi_{args.kernel}_smallspace_cluster"
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    names = {"eps": PHASES, "bam": BAM_PHASES, "panel": PANEL_PHASES}[args.kernel]
    shapes = args.shapes or {"eps": ["32x256", "8x200", "64x1024"],
                             "bam": ["32x256", "12x200", "56x1024"],
                             "panel": ["128x256", "65x256", "128x1024"]}[args.kernel]
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
        n_stamps, phases_entry = 15, None
        if panel:
            ranks, cols, n_stamps = fs.PANEL_RANKS, None, 12
            phases_entry = "gsmvi_eps_panel_phases"
            buf = fs._UpdateBuffers(b, d, dev)
            ptrs = [ptr(x) for x in (e, v, vf, vf @ f.T, e @ f.T, mean,
                                     torch.empty_like(mean), buf.good, None, buf.su,
                                     buf.sw, buf.c, buf.xim, buf.ws)]
            call = lambda: fn(*ptrs, b, d, *fs.ns_iters_for_batch(b), fs.NS_TOL, 1,
                              e.numel(), stream)
            verdict = lambda: {"good": int(buf.good[0])}
        elif args.kernel == "eps":
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
                              cols, bf.bam_cluster_tile(b), None, 1, stream)
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
        stamps = (ctypes.c_longlong * (16 * n_stamps))()
        getattr(lib, phases_entry or f"gsmvi_{args.kernel}_cluster_{tile}_phases")(stamps)
        n = n_stamps
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


def zoo_phases(lib, build_mod, card, shapes, torch) -> int:
    """``--kernel zoo``: the Student-t, logreg and mixture scores at each
    (B, D), each launch by phase."""
    from gsmvi_tpu_torch.models import (gaussian_mixture, logistic_regression,
                                        student_t)
    from gsmvi_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name in ("gsmvi_student_t_score", "gsmvi_logreg_score", "gsmvi_mixture_score"):
        getattr(lib, name).argtypes = build_mod.SIGNATURES[name]
    for shape in shapes:
        b, d = map(int, shape.split("x"))
        x = torch.randn((b, d), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
        loc, prec, dfd = student_t(0, d, df=6.0, device=dev).fused_score[1]
        ntn = -(-d // fs.SLAB)
        partial = torch.empty((ntn, b), device=dev)
        ticket = torch.zeros((-(-b // fs.SLAB), fs.thin_split(d)[0]), dtype=torch.int32,
                             device=dev)
        v = torch.empty_like(x)
        split = fs.thin_split(d)
        t_call = lambda: lib.gsmvi_student_t_score(*map(ptr, (x, loc, prec, dfd, v, partial,
                                                              ticket)), b, d, *split, stream)
        xd, y, inv = logistic_regression(0, d, device=dev).fused_score[1]
        n = xd.shape[0]
        plan = fs.logreg_plan(n, d)
        resid = None if plan[2] else torch.empty(
            (-(-b // fs.LOGREG_ROWS) * fs.LOGREG_ROWS, -(-n // fs.SLAB) * fs.SLAB), device=dev)
        l_call = lambda: lib.gsmvi_logreg_score(*map(ptr, (x, xd, y, inv, resid, v)), b, d, n,
                                                plan[0], plan[1], stream)
        means, logmask = gaussian_mixture(0, d, device=dev).fused_score[1]
        m_call = lambda: lib.gsmvi_mixture_score(*map(ptr, (x, means, logmask, v)), b, d,
                                                 means.shape[0], *split, stream)
        for kernel, call, names, nblocks, entry in (
                ("student_t", t_call, ZT_PHASES, ntn * split[0], "gsmvi_student_t_phases"),
                ("logreg", l_call, ZL_PHASES, plan[0], "gsmvi_logreg_phases"),
                ("mixture", m_call, MX_PHASES, 1, "gsmvi_mixture_phases")):
            for _ in range(20):
                if call() != 0:
                    raise RuntimeError(f"the stamped {kernel} score failed to launch")
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(200):
                call()
            stop.record()
            torch.cuda.synchronize()
            n_st = len(names) + 1
            size = (256 * 8 if kernel == "student_t" else 8) * n_st
            stamps = (ctypes.c_longlong * size)()
            getattr(lib, entry)(stamps)
            rows = [stamps[i * n_st:(i + 1) * n_st] for i in range(nblocks)]
            # A phase a block did not reach in the last launch (a rank with
            # no tile) keeps an older stamp: null.
            phases = lambda ts: {nm: (ts[i + 1] - ts[i]) / 1e3
                                 if ts[0] <= ts[i] <= ts[i + 1] <= ts[-1] else None
                                 for i, nm in enumerate(names)}
            rec = {"card": card, "kernel": kernel, "B": b, "D": d,
                   "us_per_launch": start.elapsed_time(stop) * 1e3 / 200}
            if kernel == "student_t":
                first = min(r[0] for r in rows)
                last = max(rows, key=lambda r: r[-1])   # the block that ends last
                rec.update(us_span=(last[-1] - first) / 1e3,
                           us_to_last_start=(last[0] - first) / 1e3,
                           us_per_phase_last_block=phases(last))
            elif kernel == "logreg":
                rec.update(N=n, plan=list(plan), us_per_phase={
                    f"rank {r}": phases(rows[r]) for r in sorted({0, plan[0] - 1})})
            else:
                rec.update(K=int(means.shape[0]), split=list(split),
                           us_span=(rows[0][-1] - rows[0][0]) / 1e3,
                           us_per_phase=phases(rows[0]))
            print(json.dumps(rec), flush=True)
    return 0


def large_phases(lib, build_mod, card, shapes, tile, torch) -> int:
    """``--kernel large``: the grid small space at each (B, D), phase by
    phase."""
    from gsmvi_tpu_torch.ops import fused_step as fs
    from gsmvi_tpu_torch.ops import grid_schedule as gs

    fn = lib.gsmvi_eps_smallspace_large
    fn.argtypes = build_mod.SIGNATURES["gsmvi_eps_smallspace_large"]
    blocks_of = lib.gsmvi_eps_grid_blocks
    blocks_of.argtypes, blocks_of.restype = [ctypes.c_int], ctypes.c_longlong
    dev = torch.device("cuda")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    maxph, nblk = 256, 1056
    for shape in shapes:
        b, d = map(int, shape.split("x"))
        t_side = tile or fs.grid_tile(b)
        blocks = int(blocks_of(t_side))
        if blocks <= 0:
            raise RuntimeError(f"occupancy query at tile {t_side}: {blocks}")
        gen = torch.Generator(device=dev).manual_seed(3)
        e = torch.randn((b, d), generator=gen, device=dev)
        v = 0.3 * torch.randn((b, d), generator=gen, device=dev)
        f = torch.eye(d, device=dev) + 0.3 * torch.randn((d, d), generator=gen,
                                                         device=dev) / d ** 0.5
        mean = torch.randn(d, generator=gen, device=dev)
        vf = v @ f
        buf = fs._UpdateBuffers(b, d, dev)
        iters = fs.ns_iters_for_batch(b)
        phases = gs.grid_schedule(b, iters)
        table = torch.tensor(gs.encode(phases), dtype=torch.int32, device=dev)
        ptrs = [ptr(x) for x in (e, v, vf, vf @ f.T, e @ f.T, mean, torch.empty_like(mean),
                                 buf.good, None, buf.su, buf.sw, buf.c, buf.xim, buf.ws,
                                 buf.sync, table)]
        call = lambda: fn(*ptrs, len(phases), b, d, fs.NS_TOL, 1, e.numel(), t_side,
                          blocks, stream)
        for _ in range(20):
            if call() != 0:
                raise RuntimeError("the stamped grid small space failed to launch")
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            call()
        stop.record()
        torch.cuda.synchronize()
        st = (ctypes.c_longlong * (maxph + 1))()
        en = (ctypes.c_longlong * (nblk * maxph))()
        rd = (ctypes.c_ulonglong * (nblk * maxph))()
        if getattr(lib, f"gsmvi_eps_grid_phases_t{t_side}")(st, en, rd) != 0:
            raise RuntimeError("gsmvi_eps_grid_phases failed")
        nph, nb = len(phases), min(blocks, nblk)
        rows, tot = [], {"work": 0.0, "barrier": 0.0, "reduction": 0.0}
        for p, ph in enumerate(phases):
            last = max(en[g * maxph + p] for g in range(nb))
            work = (last - st[p]) / 1e3
            barrier = (st[p + 1] - last) / 1e3 if p + 1 < nph else 0.0
            red = max(rd[g * maxph + p] for g in range(nb)) / 1e3
            rows.append({"phase": p, "ops": [label for label, _ in ph], "work_us": work,
                         "barrier_us": barrier, "reduction_us": red})
            tot["work"] += work
            tot["barrier"] += barrier
            tot["reduction"] += red
        print(json.dumps({"card": card, "kernel": "large", "B": b, "D": d, "tile": t_side,
                          "blocks": blocks, "phases": nph, "good": int(buf.good[0]),
                          "us_per_launch": start.elapsed_time(stop) * 1e3 / 200,
                          "us_last_launch": (st[nph] - st[0]) / 1e3,
                          "us_work": tot["work"], "us_barriers": tot["barrier"],
                          "us_reductions": tot["reduction"], "by_phase": rows}), flush=True)
    return 0


def chol_phases(build_mod, so, card, shapes, torch) -> int:
    """``--kernel chol``: K4a at each (B, D) through the port's wrapper on
    the stamped library, its small space by phase."""
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.ops import fused_step as fs

    class Stamped:
        """The stamped library of K4a's sources behind the port's ``call``
        (each entry bound at its first call)."""

        def __init__(self):
            self._lib = ctypes.CDLL(str(so))
            self._lib.gsmvi_error_string.restype = ctypes.c_char_p

        def call(self, name, *args):
            fn = getattr(self._lib, name)
            fn.argtypes, fn.restype = build_mod.SIGNATURES[name], ctypes.c_int
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc} "
                                   f"({self._lib.gsmvi_error_string(rc).decode()})")

    pin_fp32()
    build_mod._LIBRARY = lib = Stamped()
    dev = torch.device("cuda")
    for shape in shapes:
        b, d = map(int, shape.split("x"))
        gen = torch.Generator(device=dev).manual_seed(3)
        e = torch.randn((b, d), generator=gen, device=dev)
        v = 0.3 * torch.randn((b, d), generator=gen, device=dev)
        f = torch.eye(d, device=dev) + 0.3 * torch.randn((d, d), generator=gen,
                                                         device=dev) / d ** 0.5
        mean = torch.randn(d, generator=gen, device=dev)
        call = lambda: fs.gsm_eps_update_fused(e, v, mean, f, method="chol")
        for _ in range(20):
            good = call()[2]
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            call()
        stop.record()
        torch.cuda.synchronize()
        n = len(CH_PHASES) + 1
        stamps = (ctypes.c_longlong * n)()
        # One entry per tile instantiation where the kernel has several.
        names = [f"gsmvi_eps_chol_b{32 if b <= 32 else 64}_phases", "gsmvi_eps_chol_phases"]
        entry = next(getattr(lib._lib, nm) for nm in names if hasattr(lib._lib, nm))
        if entry(stamps) != 0:
            raise RuntimeError("the chol phase stamps could not be read")
        print(json.dumps({"card": card, "kernel": "chol", "B": b, "D": d, "good": bool(good),
                          "us_per_call": start.elapsed_time(stop) * 1e3 / 200,
                          "us_small_space": (stamps[n - 1] - stamps[0]) / 1e3,
                          "us_per_phase": {name: (stamps[i + 1] - stamps[i]) / 1e3
                                           for i, name in enumerate(CH_PHASES)}}), flush=True)
    return 0


def k5_phases(lib, build_mod, card, shapes, torch) -> int:
    """``--kernel k5``: K5 at each (B, D), its Gram launch by phase."""
    from gsmvi_tpu_torch.ops import gsm_step as gs

    fn = lib.gsmvi_gsm_update
    fn.argtypes = build_mod.SIGNATURES["gsmvi_gsm_update"]
    dev = torch.device("cuda")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    for shape in shapes:
        b, d = map(int, shape.split("x"))
        gen = torch.Generator(device=dev).manual_seed(3)
        a = torch.randn((d, d), generator=gen, device=dev)
        s0 = a @ a.T / d + torch.eye(d, device=dev)
        s0 = 0.5 * (s0 + s0.T)
        mu = torch.randn(d, generator=gen, device=dev)
        x = mu + torch.randn((b, d), generator=gen, device=dev)
        v = -(x - torch.randn(d, generator=gen, device=dev))
        t = torch.empty((b, d), device=dev)
        dots = torch.empty((-(-d // 32), 3, b), device=dev)
        mu_out, s_out = torch.empty_like(mu), torch.empty_like(s0)
        plan = gs.k5_launch_plan(b, d)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ptr(z) for z in (x, v, mu, s0, t, dots, mu_out, s_out)]
        call = lambda: fn(*ptrs, b, d, 1, *plan["thin"]["split"], *plan["gram"]["split"],
                          stream)
        for _ in range(20):
            if call() != 0:
                raise RuntimeError("the stamped K5 failed to launch")
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            call()
        stop.record()
        torch.cuda.synchronize()
        n = len(K5_PHASES)
        stamps = (ctypes.c_longlong * (4096 * n))()
        if lib.gsmvi_gram_phases(stamps) != 0:
            raise RuntimeError("gsmvi_gram_phases failed")
        split = plan["gram"]["split"][0]
        blocks = {"diagonal tile, rank 0": 0, f"diagonal tile, rank {split - 1}": split - 1}
        if d > 32:
            blocks["off-diagonal tile, rank 0"] = split
        per_block = {}
        for label, blk in blocks.items():
            ts = stamps[blk * n:(blk + 1) * n]
            per_block[label] = {name: ts[i] / 1e3 for i, name in enumerate(K5_PHASES)}
            per_block[label]["total"] = sum(ts) / 1e3
        print(json.dumps({"card": card, "kernel": "k5", "B": b, "D": d,
                          "gram_split": plan["gram"]["split"],
                          "us_per_call": start.elapsed_time(stop) * 1e3 / 200,
                          "gram_us_per_phase": per_block}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
