#!/usr/bin/env python3
"""The Philox draw's instructions per normal, counted in its SASS.

    python3 tools/philox_sass.py [--out FILE]

Compiles ``gsmvi_tpu_torch/ops/cuda/csrc/prng.cu`` alone to a cubin with
the library's architecture and optimisation flags, reads it with
``cuobjdump -sass`` and prints one JSON object: for every kernel of the
file its opcode counts, and for the large-draw kernels
(``philox_kernel<NP>``) the fewest instructions, by pipe, that one thread
can execute to write its float4s of normals.

The fewest: the kernel's control-flow graph is built from the SASS
(branches, predicated exits, calls to subroutines and their returns), and
for each pipe a shortest-path search finds the least count of that pipe's
instructions on any path from the entry through the normals' float4 store
to an exit.  The slow paths of ``logf``, ``cosf`` and ``sqrtf`` (the
Payne-Hanek reduction, the subnormal and special-value branches) are
skippable, so they drop out; what stays is what every thread must issue.
A predicated instruction counts as an issue slot but not on its pipe, and
an instruction whose pipe is not certain (moves, the uniform datapath,
conversions on the ALU, half-precision moves) as an issue slot alone.  So
each count is a lower bound of the thread's work, and a bound computed
from them cannot flatter the kernel.

Pipes and their lanes per SM and clock on Hopper (the CUDA programming
guide's throughput table): ``issue`` 128 (one warp instruction a clock on
each of the four schedulers), ``fma`` 128 (FP32 add, multiply and FMA;
integer multiply-adds run on its heavy half), ``imad`` 64, ``alu`` 64
(integer add, logic, shifts, compares, selects), ``xu`` 16
(transcendentals and type conversions).  ``chip_smoke.py`` phase 28
calls ``pipe_counts`` for the Philox ops bound.  Needs ``nvcc`` and
``cuobjdump`` (``$CUDA_HOME/bin``); no GPU.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LANES = {"issue": 128, "fma": 128, "imad": 64, "alu": 64, "xu": 16}
FP32 = ("FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I")
ALU = ("IADD3", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "FSETP", "FSEL",
       "SEL", "LEA", "IABS", "IMNMX", "FMNMX", "PLOP3", "PRMT", "FLO",
       "BREV", "POPC")
XU = ("MUFU", "I2F", "F2I", "F2F", "FRND")
_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def pipes_of(op: str, predicated: bool) -> dict:
    """{pipe: 1} of one instruction (its issue slot always)."""
    out = {"issue": 1}
    if predicated:
        return out
    base = op.split(".")[0]
    if base in FP32:
        out["fma"] = 1
    elif base in ("IMAD", "IMUL"):
        out["fma"] = out["imad"] = 1
    elif base in ALU:
        out["alu"] = 1
    elif base in XU:
        out["xu"] = 1
    return out


def parse(text: str) -> dict:
    """{function: [(address, predicated, opcode, operands), ...]} of a
    ``cuobjdump -sass`` listing."""
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
            continue
        m = _LINE.match(line)
        if name is None or not m:
            continue
        toks = m.group(2).split()
        pred = toks[0].startswith("@")
        if pred:
            toks = toks[1:]
        funcs[name].append((int(m.group(1), 16), pred, toks[0],
                            " ".join(toks[1:])))
    return funcs


def _target(operands: str) -> int:
    return int(operands.replace(",", " ").split()[-1], 16)


def _graph(code):
    """Each instruction's successors: (index, None), (index, entry) for a
    call (the edge to the next instruction carries the least cost of the
    subroutine at ``entry``), or None for an exit."""
    at = {addr: i for i, (addr, *_) in enumerate(code)}
    succ = []
    for i, (addr, pred, op, args) in enumerate(code):
        base = op.split(".")[0]
        nxt = [(i + 1, None)] if i + 1 < len(code) else []
        if base in ("BRX", "JMX", "JMP"):
            raise ValueError(f"indirect branch at {addr:#x}: {op} {args}")
        if base == "BRA":
            tgt = [(at[_target(args)], None)]
            cond = pred or "P" in args.split(",")[0]
            succ.append(tgt + nxt if cond else tgt)
        elif base == "EXIT":
            succ.append([None] + (nxt if pred else []))
        elif base == "RET":
            succ.append([None])
        elif base == "CALL":
            call = [(i + 1, at[_target(args)])]
            succ.append(call + ([(i + 1, None)] if pred else []))
        else:
            succ.append(nxt)
    return succ


def _cost(code, pipe):
    return [pipes_of(op, pred).get(pipe, 0) for _, pred, op, _ in code]


def _shortest(code, succ, cost, sources, sub):
    """Least cost from any of ``sources`` ({index: cost so far}) to each
    instruction (its own cost included) and to an exit; ``sub`` gives a
    call's subroutine cost from its entry index."""
    dist, done = {}, set()
    heap = [(c + cost[i], i) for i, c in sources.items()]
    heapq.heapify(heap)
    best_exit = float("inf")
    while heap:
        d, i = heapq.heappop(heap)
        if i in done:
            continue
        done.add(i)
        dist[i] = d
        for edge in succ[i]:
            if edge is None:
                best_exit = min(best_exit, d)
                continue
            j, call = edge
            extra = sub(call) if call is not None else 0
            nd = d + extra + cost[j]
            if j not in done and nd < dist.get(j, float("inf")):
                dist[j] = nd
                heapq.heappush(heap, (nd, j))
    return dist, best_exit


def _sub_cost(code, succ, cost):
    """A call's least subroutine cost from its entry index (memoized)."""
    memo = {}

    def sub(entry):
        if entry not in memo:
            memo[entry] = float("inf")              # no recursion
            memo[entry] = _shortest(code, succ, cost, {entry: 0}, sub)[1]
        return memo[entry]

    return sub


def _chain(code, succ, cost, through) -> float:
    """Least cost of a path entry -> through[0] -> ... -> an exit."""
    sub = _sub_cost(code, succ, cost)
    at = {0: 0}
    for stop in through:
        dist, _ = _shortest(code, succ, cost, at, sub)
        if stop not in dist:
            raise ValueError(f"instruction {stop} is unreachable")
        at = {stop: dist[stop] - cost[stop]}
    return _shortest(code, succ, cost, at, sub)[1]


def path_counts(code, through) -> dict:
    """{pipe: least count on a path from the entry through the
    instructions ``through`` (in order) to an exit}."""
    succ = _graph(code)
    return {pipe: _chain(code, succ, _cost(code, pipe), through)
            for pipe in LANES}


def histogram(code) -> dict:
    out = {}
    for _, _, op, _ in code:
        out[op] = out.get(op, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def normals_stores(code, np_: int) -> list:
    """Indices of the ``np_`` float4 stores of the normals, in address
    order: the 16-byte global stores that no path reaches with fewer than
    4 MUFU.RSQ (one sqrtf a normal; the words' stores need none), checked
    to need 4 ``np_`` of them together."""
    succ = _graph(code)
    rsq = [1 if op == "MUFU.RSQ" and not pred else 0
           for _, pred, op, _ in code]
    dist, _ = _shortest(code, succ, rsq, {0: 0}, lambda entry: 0)
    stores = [i for i, (_, _, op, _) in enumerate(code)
              if op.startswith("STG") and op.endswith(".128")
              and dist.get(i, 0) >= 4]
    if len(stores) != np_:
        raise ValueError(f"{len(stores)} float4 stores of normals, not "
                         f"{np_}")
    need = _chain(code, succ, rsq, stores)
    if need < 4 * np_:
        raise ValueError(f"a path through the stores takes {need} "
                         f"MUFU.RSQ, not {4 * np_}")
    return stores


def sass_text(cuobjdump: str, cubin: str) -> str:
    return subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout


def compile_sass() -> str:
    """prng.cu compiled alone with the library's flags, as SASS text."""
    from gsmvi_tpu_torch.ops.cuda import _build

    nvcc = _build.nvcc_path()
    dump = Path(nvcc).with_name("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "prng.cubin")
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                        "-cubin", "-o", cubin, str(_build.CSRC / "prng.cu")],
                       check=True, capture_output=True, timeout=300)
        return sass_text(str(dump), cubin)


def pipe_counts(text: str = None) -> dict:
    """{"kernels": {name: opcode counts}, "paths": {NP: {pipe: least count
    a thread}}, "per_normal": {pipe: least count per normal over NP}} of
    prng.cu's SASS (compiled here unless ``text`` is given)."""
    funcs = parse(compile_sass() if text is None else text)
    kernels = {name: histogram(code) for name, code in funcs.items()}
    paths = {}
    for name, code in funcs.items():
        m = re.search(r"philox_kernelILi(\d+)E", name)
        if m:
            np_ = int(m.group(1))
            paths[np_] = path_counts(code, normals_stores(code, np_))
    if not paths:
        raise ValueError("no philox_kernel<NP> in the SASS")
    per_normal = {pipe: min(c[pipe] / (4 * np_) for np_, c in paths.items())
                  for pipe in LANES}
    return {"kernels": kernels, "paths": paths, "per_normal": per_normal,
            "lanes_per_sm_clock": LANES}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--sass", help="read this cuobjdump -sass listing "
                    "instead of compiling prng.cu")
    args = ap.parse_args()
    text = Path(args.sass).read_text() if args.sass else None
    out = json.dumps(pipe_counts(text))
    if args.out:
        Path(args.out).write_text(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
