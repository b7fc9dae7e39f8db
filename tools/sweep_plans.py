#!/usr/bin/env python3
"""Time other plans of the tensor-core thin product and of BaM's fat apply
on one NVIDIA GPU: the evidence behind the plans in ``thin_mma.cu`` and
``apply_f32.cu``.

    python3 tools/sweep_plans.py          # from the root of a checkout

Each variant is the checkout's source with its plan constants rewritten
(``THIN_VARIANTS``: ThinS's and ThinL's tiles, chunk depth and warps;
``APPLY_VARIANTS``: the small plan's slab depth and ring stages), built
alone with the port's nvcc flags into a shared library under
``scratch_gpu/sweep/`` (git-ignored) and called through its C entry.  It
prints one JSON line per variant build, then per shape each variant's
device ns a call (``tools/ab_kernels.each``: ``torch.profiler``, one
window a shape, marker kernels between functions) beside ``torch.mm`` on bf16 operands, with each
variant's products checked against ``mm_prec`` (phase 24's sum bound) and,
for the applies, F' bit for bit against the checkout's plan.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name: (ThinS (BM, BN, KC, W), ThinL (BM, BN, KC, W))
THIN_VARIANTS = {
    "s16x16k32w8_l32x32k32w4": ((16, 16, 32, 8), (32, 32, 32, 4)),
    "s16x16k64w4_l32x32k32w4": ((16, 16, 64, 4), (32, 32, 32, 4)),
    "s16x16k32w4_l32x32k16w8": ((16, 16, 32, 4), (32, 32, 16, 8)),
    "s16x16k16w16_l16x16k16w16": ((16, 16, 16, 16), (16, 16, 16, 16)),
}
# name: (the 16 x 32 plan's slab depth, ring stages)
APPLY_VARIANTS = {"ks64_st3": (64, 3), "ks80_st3": (80, 3),
                  "ks96_st2": (96, 2)}
THIN_SHAPES = ((32, 256), (8, 200), (128, 256), (512, 1024))
APPLY_K2 = (64, 66, 96, 128, 130, 258)


def build(root, name, source, text, nvcc, flags, csrc):
    d = os.path.join(root, name)
    os.makedirs(d)
    for p in csrc.iterdir():
        if p.suffix == ".cuh":
            shutil.copy(p, d)
    with open(os.path.join(d, source), "w") as f:
        f.write(text)
    return subprocess.Popen([nvcc, *flags, "-shared", "-o",
                             os.path.join(d, "lib.so"),
                             os.path.join(d, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def load(root, name, entry, argtypes):
    fn = getattr(ctypes.CDLL(os.path.join(root, name, "lib.so")), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    from tools.ab_kernels import each
    from tools.profile_gpu import profile_window
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.ops import bam_fused as bf
    from gsmvi_tpu_torch.ops import fused_step as fs
    from gsmvi_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        print("sweep_plans: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    root = os.path.abspath("scratch_gpu/sweep")
    shutil.rmtree(root, ignore_errors=True)
    nvcc, csrc = _build.nvcc_path(), _build.CSRC
    thin_src = (csrc / "thin_mma.cu").read_text()
    apply_src = (csrc / "apply_f32.cu").read_text()
    procs = {}
    for name, (s, l) in THIN_VARIANTS.items():
        text = thin_src
        for key, plan in (("S", s), ("L", l)):
            text = re.sub(rf"using Thin{key} = ThinMmaPlan<[\d, ]+>;",
                          f"using Thin{key} = ThinMmaPlan<"
                          f"{', '.join(map(str, plan))}>;", text)
        procs["thin " + name] = build(root, "thin_" + name, "thin_mma.cu",
                                      text, nvcc, _build.NVCC_FLAGS, csrc)
    for name, (ks, stages) in APPLY_VARIANTS.items():
        text = re.sub(r"launch_f32<ApplyS, 2, 4, \d+>",
                      f"launch_f32<ApplyS, 2, 4, {ks}>", apply_src)
        text = re.sub(r"APPLY_STAGES = \d+;", f"APPLY_STAGES = {stages};",
                      text)
        procs["apply " + name] = build(root, "apply_" + name, "apply_f32.cu",
                                       text, nvcc, _build.NVCC_FLAGS, csrc)
    built = set()
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=900)
        errors = [ln for ln in out.splitlines() if "error" in ln.lower()]
        print(json.dumps({"variant": name, "rc": proc.returncode,
                          "errors": errors[:4]}), flush=True)
        if proc.returncode == 0:
            built.add(name)

    stream = fs._stream(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    thin_fns = {name: load(root, "thin_" + name, "gsmvi_thin_rows_mma",
                           _build.SIGNATURES["gsmvi_thin_rows_mma"])
                for name in THIN_VARIANTS if "thin " + name in built}
    for m, d in THIN_SHAPES:
        rows = torch.randn((m, d), generator=g, device=dev)
        f = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
        mu = torch.randn(d, generator=g, device=dev)
        fns, wrong = {}, []
        for name, fn in thin_fns.items():
            s, l = THIN_VARIANTS[name]
            tile = (s if d < fs.THIN_MMA_LARGE_D else l)[:2]
            for p in ("bf16", "high"):
                for prod in ("vf", "t", "ef"):
                    out = torch.empty((m, d), device=dev)
                    x = torch.empty_like(out) if prod == "ef" else None
                    args = (fs._ptr(rows), fs._ptr(f),
                            fs._ptr(mu if x is not None else None),
                            fs._ptr(out), fs._ptr(x), m, d,
                            int(prod != "vf"), 1, m * d, *tile,
                            fs.MMA_MODE[p], stream)
                    if fn(*args) != 0:
                        wrong.append(f"{name} {prod} {p}: launch")
                        continue
                    torch.cuda.synchronize()
                    fb = f if prod == "vf" else f.T
                    absprod = rows.abs().double() @ fb.abs().double()
                    tol = 4.0 * {"bf16": 1, "high": 3}[p] * d * 2.0 ** -24
                    diff = (out.double()
                            - fs.mm_prec(rows, fb, p).double()).abs()
                    if not bool((diff <= tol * absprod + 1e-30).all()):
                        wrong.append(f"{name} {prod} {p}")
                    fns[f"{name} {prod} {p}"] = lambda fn=fn, a=args: fn(*a)
        r16, f16 = rows.bfloat16(), f.bfloat16()
        fns["mm t"] = lambda: torch.mm(r16, f16.T)
        ns = each(fns, 50 if d <= 256 else 20, torch, profile_window, dev)
        print(json.dumps({"thin_shape": f"{m}x{d}", "wrong": wrong,
                          "ns": ns}), flush=True)

    apply_fns = {name: load(root, "apply_" + name, "gsmvi_bam_apply",
                            _build.SIGNATURES["gsmvi_bam_apply"])
                 for name in APPLY_VARIANTS if "apply " + name in built}
    d, fns, same = 256, {}, {}
    for k2 in APPLY_K2:
        su = torch.randn((k2, d), generator=g, device=dev)
        sw = torch.randn((k2, d), generator=g, device=dev)
        f = torch.randn((d, d), generator=g, device=dev)
        want = bf.bam_apply(su, sw, f)[0]
        for name, fn in apply_fns.items():
            out = torch.empty_like(f)
            part = torch.empty((-(-d // 16) * -(-d // 32), 2), device=dev)
            args = (fs._ptr(su), fs._ptr(sw), fs._ptr(f), fs._ptr(out),
                    fs._ptr(part), None, k2, d, 1, 16, 32, stream)
            if fn(*args) != 0:
                same[f"{name} k{k2}"] = False
                continue
            torch.cuda.synchronize()
            same[f"{name} k{k2}"] = bool(torch.equal(
                out.view(torch.int32), want.view(torch.int32)))
            fns[f"{name} k{k2}"] = lambda fn=fn, a=args: fn(*a)
    ns = each(fns, 50, torch, profile_window, dev)
    print(json.dumps({"bam_apply_d256": ns, "bits_equal": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
