"""The controls of a cell's comparison: answers that ``correct`` has to refuse.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13
                                 [--program-precision bf16]

For each seed, the fits that the first jobs of a run with that seed run
(``check_fits`` of them, the jobs' own fit seeds) are answered in several
ways, each compared with the plain reference in float64 by ``check.compare``
and judged by ``check.verdict`` under the cell's own limits:

- ``program``: the program as the cell runs it (a sound reading, which has
  to pass);
- ``control_tf32``: the plain reference put in the program's place at TF32,
  the precision one step below the configurations' float32 with TF32 off
  (the control);
- ``half_batch``: the plain reference in the program's place with half of
  each step's batch left out, the mean taken over the rest (a fault);
- with ``--program-precision``, ``program_<p>``: the program with its own
  lower-precision products switched on (FactorGSM's ``pallas_precision``).

The reads before convergence (``check_steps``) start from the program's own
states for every answer.  One JSON line per seed; the last line holds each
number's largest sound reading and each control's smallest readings.  The
exit code is 1 if a sound reading fails or a control passes its limits.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager


@contextmanager
def half_batch(module):
    """The plain fitter ``module``'s update over the first half of each
    step's points."""
    orig = module.update

    def update(mu, cov, x, g, *args):
        b = x.shape[-2] // 2
        return orig(mu, cov, x[..., :b, :], g[..., :b, :], *args)

    module.update = update
    try:
        yield
    finally:
        module.update = orig


def readings(cell: dict, config: dict, seed: int, device,
             program_precision=None) -> dict:
    """{answer: readings} for one seed (the module docstring's answers), and
    "reference_s"."""
    import torch

    from . import check, manifest, seeds
    from .run import Program, step_reads

    job = cell["job"]
    replicas = int(job.get("replicas", 1))
    n_jobs = -(-int(cell["check_fits"]) // replicas)
    job_seeds = [seeds.job_seeds(seed, j, replicas, int(cell["fit_seed_pool"]))
                 for j in range(n_jobs)]
    recipe = manifest.target(config["target"]["recipe"])
    arrays = recipe.arrays(config, device)

    def program_answers(cfg):
        prog = Program(cell, cfg, recipe.program(arrays, device), device)
        chosen = []
        for js in job_seeds:
            means, covs = prog.job(js, int(job["niter"]))
            chosen += [(js, r, means[r], covs[r]) for r in range(replicas)]
        chosen = chosen[:int(cell["check_fits"])]
        reads = step_reads(prog, cell, chosen)
        del prog
        return ((torch.stack([c[2] for c in chosen]),
                 torch.stack([c[3] for c in chosen]),
                 [(n, m, c) for n, _, m, c in reads]),
                [s[r] for s, r, *_ in chosen],
                [(n, starts) for n, starts, *_ in reads])

    got, fit_seeds, starts = program_answers(config)
    t0 = time.perf_counter()
    ref = check.reference(cell, config, arrays, fit_seeds, starts, device)
    out = {"reference_s": time.perf_counter() - t0,
           "program": check.compare(got, ref)}
    out["control_tf32"] = check.compare(
        check.reference(cell, config, arrays, fit_seeds, starts, device,
                        precision="tf32"), ref)
    with half_batch(manifest.reference(config["reference"])):
        out["half_batch"] = check.compare(
            check.reference(cell, config, arrays, fit_seeds, starts, device),
            ref)
    if program_precision:
        cfg = dict(config, fitter="FactorGSM",
                   fitter_kwargs=dict(config.get("fitter_kwargs", {}),
                                      pallas_precision=program_precision))
        out[f"program_{program_precision}"] = check.compare(
            program_answers(cfg)[0], ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program-precision", default=None)
    args = parser.parse_args(argv)

    from .run import set_run_env

    set_run_env()
    import torch

    torch.set_num_threads(1)
    from . import check, manifest

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell, config = manifest.cell(manifest.load(), args.workload)
    limits = cell.get("limits", {})
    largest, smallest, wrong = {}, {}, []
    for seed in args.seeds:
        got = readings(cell, config, seed, torch.device("cuda"),
                       args.program_precision)
        passed = {kind: check.verdict(r, limits) for kind, r in got.items()
                  if kind != "reference_s"}
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "passes_limits": passed}), flush=True)
        for kind, ok in passed.items():
            if ok != (kind == "program"):
                wrong.append((seed, kind))
            for key, value in got[kind].items():
                if kind == "program":
                    largest[key] = max(largest.get(key, 0.0), value)
                else:
                    low = smallest.setdefault(kind, {})
                    low[key] = min(low.get(key, float("inf")), value)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "limits": limits, "program_largest": largest,
                      "smallest": smallest, "wrong_verdicts": wrong}),
          flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
