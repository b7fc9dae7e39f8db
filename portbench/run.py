"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  Set-up makes the configuration's target
arrays, hands them to the program (``gsmvi_tpu_torch``), builds the fitter
and runs one short warm-up fit of the cell's own shapes (the kernel library is
built here on a checkout's first run).  With ``--trace 0`` one client then
submits fit jobs back to back for ``--seconds``: each job fits seeds of the
cell's fixed pool in an order drawn from the seed (``seeds.py``), and is
timed from the call until its answer sits on the host; the window ends when
the last job that started inside ``--seconds`` ends.  With
``--trace 1`` the cell's ``trace_jobs`` jobs run under ``torch.profiler``
instead and the per-layer readers read that record.  After the window a
sample of the fits is fitted again by the plain reference in float64 and
compared, their answers and their first steps (``check.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared`` (each compared
number beside its limit, also the last lines of standard error).

The run fails, printing no result, without a CUDA card (or fewer than the
cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``gsmvi_tpu`` was loaded into the process.  Caches of torch, Triton and
CUDA go to ``.portbench_cache/`` in the checkout; torch's host ops run on
one thread.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "gsmvi_tpu")


def set_run_env(cache: Path = CACHE) -> None:
    """Before torch is imported: every kernel cache torch, Triton or the CUDA
    driver keeps, at fixed paths inside the checkout; and one CPU thread for
    torch's host ops, so that the client is one process with one thread (a
    BaM fit's host loop is a third of its wall, and spinning worker threads
    would compete with it for the machine's cores)."""
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` equal to a forbidden name (compared
    whole: ``gsmvi_tpu_torch`` is not ``gsmvi_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(obj, file=None) -> None:
    print(json.dumps(obj), file=file or sys.stdout, flush=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc.__class__.__name__})"
    return out.stdout.strip() or "not read"


class Program:
    """The system under test: the port's fitter for a cell, built once, and
    its jobs.  ``job(seeds, niter)`` returns the answers on the host,
    (means (K, D), covs (K, D, D)), after the device has finished."""

    def __init__(self, cell: dict, config: dict, target, device):
        import torch

        import gsmvi_tpu_torch as port

        job = cell["job"]
        cls = getattr(port, job.get("fitter", config["fitter"]))
        kwargs = dict(config.get("fitter_kwargs", {}))
        if config.get("fused_score"):
            kwargs["fused_score"] = target.fused_score
        self.fitter = cls(int(config["dim"]), target.lp, target.lp_g,
                          device=device, **kwargs)
        self.method = job.get("method", "fit")
        self.batch = int(job["batch_size"])
        self.kwargs = dict(config.get("fit_kwargs", {}))
        self.kwargs.update(job.get("kwargs", {}))
        if "regf" in self.kwargs:
            kind, reg0 = self.kwargs["regf"]
            self.kwargs["regf"] = getattr(port.Regularizers(), kind)(reg0)
        self._sync = (torch.cuda.synchronize if torch.device(device).type
                      == "cuda" else (lambda: None))

    def job(self, seeds: list, niter: int) -> tuple:
        if self.method == "fit":
            mean, cov = self.fitter.fit(seeds[0], batch_size=self.batch,
                                        niter=niter, verbose=False,
                                        **self.kwargs)
            mean, cov = mean[None], cov[None]
        else:
            mean, cov = getattr(self.fitter, self.method)(
                seeds, batch_size=self.batch, niter=niter, **self.kwargs)
        mean, cov = mean.cpu(), cov.cpu()
        self._sync()
        return mean, cov

    def step(self, seeds: list, n: int) -> tuple:
        """(start, means, covs): the answers after step ``n`` (from 1) of
        the fits seeded with ``seeds``, and the state that step started
        from: None at n = 1 (the fits' own start), else (means, factors)
        after step n - 1, read with ``return_state`` and resumed for one
        step.  Only ``fit`` resumes a state."""
        if n == 1:
            return (None, *self.job(seeds, 0))
        if self.method != "fit":
            raise ValueError(f"{self.method} cannot resume a state: a check "
                             f"step past the first needs method 'fit'")
        st = self.fitter.fit(seeds[0], batch_size=self.batch, niter=n - 2,
                             verbose=False, return_state=True, **self.kwargs)
        factor = st.factor if hasattr(st, "factor") else st.chol
        start = (st.mean[None].cpu(), factor[None].cpu())
        mean, cov = self.fitter.fit(seeds[0], batch_size=self.batch, niter=0,
                                    verbose=False, state=st, **self.kwargs)
        mean, cov = mean[None].cpu(), cov[None].cpu()
        self._sync()
        return start, mean, cov


def closed_loop(program: Program, seed: int, seconds: float, niter: int,
                replicas: int, pool: int, max_jobs=None, label=None) -> tuple:
    """Jobs back to back, each on its fit seeds (``seeds.job_seeds``), while
    ``seconds`` have not passed since the first job started (or ``max_jobs``
    jobs): (jobs as (start, end, steps), answers as (seeds, means,
    covs)).  Python's cyclic garbage collector is off in the window (what
    set-up left is frozen first), so that no collection of objects the
    harness or set-up made lands inside a job."""
    from contextlib import nullcontext

    from . import seeds as seeds_mod

    jobs, answers = [], []
    first = None
    steps = (niter + 1) * replicas
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        while True:
            if max_jobs is not None and len(jobs) >= max_jobs:
                break
            if (max_jobs is None and first is not None
                    and time.perf_counter() - first >= seconds):
                break
            fit_seeds = seeds_mod.job_seeds(seed, len(jobs), replicas, pool)
            span = label() if label is not None else nullcontext()
            start = time.perf_counter()
            with span:
                means, covs = program.job(fit_seeds, niter)
            end = time.perf_counter()
            if first is None:
                first = start
            jobs.append((start, end, steps))
            answers.append((fit_seeds, means, covs))
    finally:
        gc.enable()
        gc.unfreeze()
    return jobs, answers


def sample(cell: dict, answers: list, seed: int) -> list:
    """The fits the check compares, drawn from ``seed``: (job's fit seeds,
    replica, its final mean, its final cov) for each."""
    replicas = int(cell["job"].get("replicas", 1))
    from . import check

    fits = [(j, r) for j in range(len(answers)) for r in range(replicas)]
    return [(answers[j][0], r, answers[j][1][r], answers[j][2][r])
            for j, r in check.sample(fits, int(cell["check_fits"]), seed)]


def step_reads(program: Program, cell: dict, chosen: list) -> list:
    """For each step n of the cell's ``check_steps``: (n, starts, means,
    covs) of the chosen fits, read from the program (``Program.step``)."""
    import torch

    out = []
    for n in cell["check_steps"]:
        got = [program.step(fit_seeds, int(n)) for fit_seeds, *_ in chosen]
        starts = None
        if got[0][0] is not None:
            starts = tuple(torch.cat([g[0][i] for g in got]) for i in (0, 1))
        out.append((int(n), starts,
                    torch.stack([g[1][r] for g, (_, r, *_) in zip(got, chosen)]),
                    torch.stack([g[2][r] for g, (_, r, *_) in zip(got, chosen)])))
    return out


def correctness(cell: dict, config: dict, arrays: dict, chosen: list,
                reads: list, device) -> tuple:
    """(readings, details): the chosen fits' answers and their reads before
    convergence against the plain reference in float64 (``check.py``)."""
    import torch

    from . import check

    fit_seeds = [s[r] for s, r, *_ in chosen]
    got = (torch.stack([c[2] for c in chosen]),
           torch.stack([c[3] for c in chosen]),
           [(n, means, covs) for n, _, means, covs in reads])
    t0 = time.perf_counter()
    ref = check.reference(cell, config, arrays, fit_seeds,
                          [(n, starts) for n, starts, *_ in reads], device)
    return check.compare(got, ref), {
        "checked_fits": len(chosen), "checked_seeds": fit_seeds,
        "checked_steps": [r[0] for r in reads],
        "reference_s": time.perf_counter() - t0}


def run_cell(bench: dict, cell: dict, config: dict, seed: int,
             seconds: float, traced: bool, device="cuda",
             t_start: float = None, chips: int = 1) -> dict:
    """One run of ``cell``; the result object of the last line."""
    import torch

    from . import check, manifest, trace as trace_mod
    from .window import Window

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    job = cell["job"]
    niter, replicas = int(job["niter"]), int(job.get("replicas", 1))
    pool = int(cell["fit_seed_pool"])

    phases = {"imports": time.perf_counter() - t_start}
    recipe = manifest.target(config["target"]["recipe"])
    arrays = recipe.arrays(config, dev)
    sync()
    phases["target"] = time.perf_counter() - t_start
    program = Program(cell, config, recipe.program(arrays, dev), dev)
    phases["fitter"] = time.perf_counter() - t_start
    warm = [s + 1 for s in range(replicas)]
    program.job(warm, int(cell["warmup_niter"]))
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    phases["warm_up"] = setup_s

    name = cell["name"]
    trace = None
    if traced:
        from torch.profiler import record_function

        def window():
            return closed_loop(program, seed, seconds, niter, replicas, pool,
                               max_jobs=int(cell["trace_jobs"]),
                               label=lambda: record_function("portbench.job"))

        prof, (jobs, answers) = trace_mod.profile_window(window)
        device_recs, host_recs, runtime = trace_mod.records(prof)
        del prof
        window_s = max(j[1] for j in jobs) - min(j[0] for j in jobs)
        trace = trace_mod.Trace(
            device=device_recs, host=host_recs, runtime=runtime,
            window_s=window_s, steps=sum(j[2] for j in jobs), jobs=len(jobs),
            cell=cell, config=config, work=manifest.work(config["name"]))
        section, source = "per_layer", trace
    else:
        jobs, answers = closed_loop(program, seed, seconds, niter, replicas,
                                    pool)
        section, source = "end_to_end", Window(jobs, setup_s)
    result_metrics = {}
    for m in manifest.metrics(bench, section, name):
        value = manifest.reader(m["name"])(source)
        if value is not None:
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sync()
    memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0)
    emit({"run": name, "seed": seed, "trace": int(traced),
          "setup_s": setup_s, "setup_phases_s": phases, "jobs": len(jobs),
          "fits": len(jobs) * replicas, "steps": sum(j[2] for j in jobs),
          "job_s": [j[1] - j[0] for j in jobs],
          "card": power_limit() if on_card else "cpu"})

    failed = sum(1 for _, m, c in answers
                 if not (torch.isfinite(m).all() and torch.isfinite(c).all()))
    chosen = sample(cell, answers, seed)
    reads = step_reads(program, cell, chosen)
    del program, answers
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings, details = correctness(cell, config, arrays, chosen, reads, dev)
    limits = cell.get("limits", {})
    correct = check.verdict(readings, limits)
    emit({"check": name, **details})
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in readings.items()}
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()

    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else dev.type),
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": len(jobs), "failed": failed,
              "metrics": result_metrics, "device": dev_info}
    if trace is not None:
        dev_info["busy_s"] = trace_mod.busy_s(trace.device)
        dev_info["window_s"] = trace.window_s
        result["breakdown"] = trace_mod.breakdown(trace)
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    set_run_env()
    import torch

    torch.set_num_threads(1)
    from . import manifest

    bench = manifest.load()
    cell, config = manifest.cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, config, args.seed, args.seconds,
                      bool(args.trace), device="cuda", chips=chips)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
