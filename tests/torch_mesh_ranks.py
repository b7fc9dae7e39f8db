"""The rank processes of ``tests/test_torch_parallel.py``.

``run(rank, world, workdir)`` is one rank of a gloo process group of
``world`` ranks on the CPU, started by ``torch.multiprocessing`` on a
``file://`` store under ``workdir``: it reads the cases' inputs (numpy
arrays, JAX's draws among them) from ``workdir/spec.pt``, runs every case
on the port's meshes and writes its results to
``workdir/result_<world>_<rank>.pt``.  This module imports torch and the
port only.
"""

import contextlib
import os

import numpy as np
import torch

DEV = "cpu"


def _np(x):
    from gsmvi_tpu_torch.parallel.large_d import is_dtensor

    if is_dtensor(x):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _feed(fitter, draws):
    """Hand ``fitter`` the draws of step s from ``draws[s]``."""
    fitter._eps = lambda seed, step, b, d, dtype: torch.from_numpy(
        draws[step]).to(dtype)
    return fitter


@contextlib.contextmanager
def _kernel_routes():
    """The kernel routes (K1, K5, K7) on the CPU: the wrappers run their
    plain versions on CPU tensors."""
    import gsmvi_tpu_torch.bam_factor as bf
    import gsmvi_tpu_torch.gsm as g
    import gsmvi_tpu_torch.gsm_factor as gf

    saved = [(m, m.on_gpu) for m in (g, gf, bf)]
    for m, _ in saved:
        m.on_gpu = lambda device: True
    try:
        yield
    finally:
        for m, fn in saved:
            m.on_gpu = fn


def _state(st, dense: bool):
    return {"mean": _np(st.mean), "mat": _np(st.cov if dense else st.factor),
            "n_accepted": int(st.n_accepted), "step": int(st.step)}


def _collectives():
    """A dispatch mode that records every collective the ranks run, as
    (namespace, op, elements): the ``c10d`` ops that ``torch.distributed``
    calls dispatch to, and the ``_c10d_functional`` ops of DTensor's own
    redistributions (a gather that no ``dist`` call shows).  Its
    ``elements`` are the largest tensor argument's, or a list's total."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def size(a):
        if torch.is_tensor(a):
            return a.numel()
        if isinstance(a, (list, tuple)):
            return sum(size(x) for x in a)
        return 0

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns = func.namespace
            if ns in ("c10d", "_c10d_functional"):
                self.calls.append((ns, func.__name__,
                                   max([size(a) for a in args] + [0])))
            return func(*args, **(kwargs or {}))

    return Collectives()


def case_stats(spec, meshes):
    from gsmvi_tpu_torch.parallel import (sharded_bam_stats,
                                          sharded_gsm_stats,
                                          sharded_score_eval)
    from gsmvi_tpu_torch.parallel.sharded import local_rows

    mesh = meshes["data"]
    t = spec["t64"]
    x, mu0, s0 = (torch.from_numpy(a) for a in spec["stats"])
    rows = local_rows(mesh, "data", x)
    dmu, ds = sharded_gsm_stats(mesh, t.lp_g, rows, mu0, s0)
    bam = sharded_bam_stats(mesh, t.lp_g, rows)
    score = sharded_score_eval(mesh, t.lp_g, rows)
    return {"gsm": [_np(dmu), _np(ds)], "bam": [_np(v) for v in bam],
            "score": _np(score), "score_local_rows": int(score.to_local()
                                                         .shape[0])}


def _fit_pair(mesh, make, fit, draws):
    """(mesh fit, fit without the mesh) of one configuration on ``draws``."""
    return [fit(_feed(make(m), draws)) for m in (mesh, None)]


def case_fits(spec, meshes):
    from gsmvi_tpu_torch import ADVI, GSM, Adam, BaM, FactorBaM, FactorGSM
    from gsmvi_tpu_torch.ops.bam import Regularizers

    d, b, n = spec["fit_dims"]
    t64, t32 = spec["t64"], spec["t32"]
    f64, f32 = torch.float64, torch.float32
    kw = dict(batch_size=b, niter=n, verbose=False, return_state=True)
    bkw = dict(kw, retries=0)
    out = {}
    ds64, ds32 = spec["draws64"], spec["draws32"]

    def pair(name, make, fit, draws, dense):
        got = _fit_pair(meshes["data"], make, fit, draws)
        out[name] = [_state(s, dense) for s in got]

    pair("gsm_dense", lambda m: GSM(d, t64.lp, t64.lp_g, device=DEV,
                                    dtype=f64, use_factor=False, mesh=m),
         lambda g: g.fit(0, **kw), ds64, True)
    pair("factor_plain", lambda m: FactorGSM(d, t64.lp, t64.lp_g, device=DEV,
                                             dtype=f64, mesh=m),
         lambda g: g.fit(0, **kw), ds64, False)
    pair("bam_dense", lambda m: BaM(d, t64.lp, t64.lp_g, device=DEV,
                                    dtype=f64, use_factor=False, mesh=m),
         lambda g: g.fit(0, Regularizers().linear(30.0), **bkw), ds64, True)
    pair("bam_factor_plain",
         lambda m: FactorBaM(d, t64.lp, t64.lp_g, device=DEV, dtype=f64,
                             mesh=m),
         lambda g: g.fit(0, Regularizers().linear(30.0), **bkw), ds64, False)
    with _kernel_routes():
        pair("factor_k1", lambda m: FactorGSM(d, t32.lp, t32.lp_g,
                                              device=DEV, dtype=f32, mesh=m),
             lambda g: g.fit(0, **kw), ds32, False)
        pair("gsm_k5", lambda m: GSM(d, t32.lp, t32.lp_g, device=DEV,
                                     dtype=f32, use_factor=False, mesh=m),
             lambda g: g.fit(0, **kw), ds32, True)
        pair("bam_factor_k7",
             lambda m: FactorBaM(d, t32.lp, t32.lp_g, device=DEV, dtype=f32,
                                 mesh=m),
             lambda g: g.fit(0, Regularizers().linear(30.0), **bkw), ds32,
             False)

    def advi_fit(g):
        st, losses = g.fit(0, Adam(2e-2), niter=n, batch_size=b,
                           verbose=False, return_state=True)
        return st, losses

    got = _fit_pair(meshes["data"],
                    lambda m: ADVI(d, t64.lp, device=DEV, dtype=f64, mesh=m),
                    advi_fit, ds64)
    out["advi"] = [{"loc": _np(st.loc), "scales": _np(st.scales),
                    "losses": losses} for st, losses in got]
    return out


def case_sharded_fit(spec, meshes):
    from gsmvi_tpu_torch import GSM
    from gsmvi_tpu_torch.parallel import sharded_gsm_fit

    d, b, n = spec["fit_dims"]
    t = spec["t64"]
    st = sharded_gsm_fit(meshes["data"], t.lp_g, 5, d, niter=n, batch_size=b,
                         dtype=torch.float64, device=DEV)
    ref = GSM(d, t.lp, t.lp_g, device=DEV, dtype=torch.float64,
              use_factor=False, mesh=meshes["data"]).fit(
                  5, batch_size=b, niter=n, verbose=False, return_state=True)
    return [_state(st, True), _state(ref, True)]


def case_chol(spec, meshes):
    from gsmvi_tpu_torch.parallel import blocked_cholesky, cov_sharding

    sh = cov_sharding(meshes["2d"])
    out = []
    for a, blk in spec["chol"]:
        l = blocked_cholesky(sh.place(torch.from_numpy(a)), blk)
        out.append({"l": _np(l), "local": tuple(l.to_local().shape),
                    "placements": str(tuple(l.placements))})
    return out


def case_cov_sharded(spec, meshes):
    from gsmvi_tpu_torch import GSM, FactorGSM
    from gsmvi_tpu_torch.parallel import cov_sharding

    mesh = meshes["2d"]
    sh = cov_sharding(mesh)
    out = {}
    d, b, n, blk = spec["cov_gsm"]["dims"]
    t = spec["cov_gsm"]["t"]
    draws = spec["cov_gsm"]["draws"]
    g = _feed(GSM(d, t.lp, t.lp_g, device=DEV, dtype=torch.float64,
                  mesh=mesh, cov_sharding=sh, chol_block=blk), draws)
    st = g.fit(0, batch_size=b, niter=n, verbose=False, return_state=True)
    out["gsm"] = _state(st, True)
    out["gsm_local"] = tuple(st.cov.to_local().shape)
    for key, case in spec["cov_factor"].items():
        d, b, n = case["dims"]
        t = case["t"]
        g = _feed(FactorGSM(d, t.lp, t.lp_g, device=DEV, dtype=torch.float64,
                            mesh=mesh, cov_sharding=sh), case["draws"])
        st = g.fit(0, batch_size=b, niter=n, verbose=False,
                   return_state=True)
        mean, cov = g.fit(0, batch_size=b, niter=n, verbose=False)
        out[key] = {**_state(st, False), "cov": _np(cov),
                    "local": tuple(st.factor.to_local().shape)}
    return out


def case_memory(spec, meshes):
    """The column-sharded steps at D = 64 keep every (D, D) matrix a panel,
    send no tensor of D^2 elements and leave DTensor no collective of its
    own to run."""
    from torch.distributed.tensor.debug import CommDebugMode

    from gsmvi_tpu_torch import GSM, FactorGSM
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.parallel import cov_sharding

    d, b = 64, 4
    mesh = meshes["2d"]
    sh = cov_sharding(mesh)
    t = dense_gaussian(3, d, scale=0.5, device=DEV)
    out = {}
    for name, g in (
            ("gsm", GSM(d, t.lp, t.lp_g, device=DEV, mesh=mesh,
                        cov_sharding=sh, chol_block=16)),
            ("factor", FactorGSM(d, t.lp, t.lp_g, device=DEV, mesh=mesh,
                                 cov_sharding=sh))):
        with CommDebugMode() as comm, _collectives() as seen:
            st = g.fit(0, batch_size=b, niter=5, verbose=False,
                       return_state=True)
        mats = [st.cov, st.chol] if name == "gsm" else [st.factor]
        out[name] = {"local": [tuple(m.to_local().shape) for m in mats],
                     "max_sent": max((n for *_, n in seen.calls), default=0),
                     "calls": len(seen.calls),
                     "comm_debug_calls": comm.get_total_counts(),
                     "functional": sorted({op for ns, op, _ in seen.calls
                                           if ns == "_c10d_functional"}),
                     "finite": bool(np.isfinite(_np(mats[0])).all())}
    # The detector sees a DTensor gather: the full factor of the last fit.
    with _collectives() as seen:
        st.factor.full_tensor()
    out["gather_seen"] = sorted({op for ns, op, _ in seen.calls
                                 if ns == "_c10d_functional"})
    return out


def case_routes(spec, meshes):
    from gsmvi_tpu_torch import ADVI, GSM, Adam, BaM, FactorBaM, FactorGSM
    from gsmvi_tpu_torch.ops.bam import Regularizers
    from gsmvi_tpu_torch.parallel import cov_sharding

    mesh, n = meshes["data"], meshes["n"]
    t = spec["t32"]
    d = spec["fit_dims"][0]
    out = {}
    with _kernel_routes():
        fg = FactorGSM(d, t.lp, t.lp_g, device=DEV, mesh=mesh,
                       fused_score=t.fused_score)
        fb = FactorBaM(d, t.lp, t.lp_g, device=DEV, mesh=mesh,
                       fused_score=t.fused_score)
        out["factor_mode"] = fg._fused_mode(16)
        out["bam_mode"] = fb._fused_mode(16)
        out["cov_mode"] = FactorGSM(
            d, t.lp, t.lp_g, device=DEV, mesh=meshes["2d"],
            cov_sharding=cov_sharding(meshes["2d"]))._fused_mode(16)
        out["gsm_hands_mesh"] = GSM(
            d, t.lp, t.lp_g, device=DEV, mesh=mesh)._get_factor_fitter().mesh \
            is mesh
        out["bam_hands_mesh"] = BaM(
            d, t.lp, t.lp_g, device=DEV, mesh=mesh)._get_factor_fitter().mesh \
            is mesh
        out["uneven_raises"] = {}
        for name, g in (("factor", fg), ("bam", fb)):
            try:
                g._fused_mode(n + 1)        # n + 1 rows over n ranks
                out["uneven_raises"][name] = False
            except ValueError as e:
                out["uneven_raises"][name] = "use_fused=False" in str(e)
    # Off the card an uneven split runs the plain step on padded rows.
    b = 6
    st = FactorGSM(d, t.lp, t.lp_g, device=DEV, mesh=mesh).fit(
        0, batch_size=b, niter=20, verbose=False, return_state=True)
    ref = FactorGSM(d, t.lp, t.lp_g, device=DEV).fit(
        0, batch_size=b, niter=20, verbose=False, return_state=True)
    out["uneven_plain"] = [_state(st, False), _state(ref, False)]
    raised = []
    for call in (
            lambda: ADVI(d, t.lp, device=DEV, mesh=mesh,
                         fused_score=t.fused_score).fit_fused(
                             0, niter=2, batch_size=4, verbose=False),
            lambda: FactorGSM(d, t.lp, t.lp_g, device=DEV,
                              mesh=mesh).fit_batch((0, 1), niter=2),
            lambda: BaM(d, t.lp, t.lp_g, device=DEV, mesh=mesh).fit_batch(
                (0, 1), Regularizers().linear(30.0), niter=2),
            lambda: ADVI(d, t.lp, device=DEV, mesh=mesh).fit_batch(
                (0, 1), Adam(1e-2), niter=2)):
        try:
            call()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["refused"] = raised
    return out


CASES = {"stats": case_stats, "fits": case_fits,
         "sharded_fit": case_sharded_fit, "chol": case_chol,
         "cov_sharded": case_cov_sharded, "memory": case_memory,
         "routes": case_routes}


def run(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gsmvi_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                          make_mesh_2d)

    from gsmvi_tpu_torch.models import gaussian_target_from_arrays

    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    target = lambda arrays: gaussian_target_from_arrays(*arrays, device=DEV)
    spec["t64"] = target(spec["target"])
    spec["t32"] = target([a.astype(np.float32) for a in spec["target"]])
    for case in (spec["cov_gsm"], *spec["cov_factor"].values()):
        case["t"] = target(case["target"])
    assert initialize_distributed(f"file://{workdir}/store_{world}", world,
                                  rank, backend="gloo") == (world > 1)
    try:
        meshes = {"data": make_mesh(world, devices="cpu"), "n": world,
                  "2d": make_mesh_2d(*spec["mesh_2d"][world],
                                     devices="cpu")}
        out = {name: fn(spec, meshes) for name, fn in CASES.items()}
        torch.save(out, os.path.join(workdir, f"result_{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_rank_group(rank: int, workdir: str) -> None:
    """``initialize_distributed`` with explicit arguments on a ``file://``
    store: True for two ranks, a second call a no-op, and an all-reduce
    that sees both ranks."""
    import torch.distributed as dist

    from gsmvi_tpu_torch.parallel import initialize_distributed

    ok = initialize_distributed(f"file://{workdir}/store_two", 2, rank,
                                backend="gloo")
    try:
        again = initialize_distributed(auto=True)
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        torch.save({"ok": ok, "again": again,
                    "world": dist.get_world_size(), "sum": float(x)},
                   os.path.join(workdir, f"two_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def misconfigured(rank: int, workdir: str) -> None:
    """Explicit but empty address: must raise, not fall back."""
    from gsmvi_tpu_torch.parallel import initialize_distributed

    try:
        initialize_distributed(coordinator_address="", num_processes=2,
                               process_id=0, backend="gloo")
        out = "silent"
    except (RuntimeError, ValueError) as e:
        out = f"raised {type(e).__name__}"
    torch.save(out, os.path.join(workdir, "misconfigured.pt"))


def torchrun_env(rank: int, workdir: str, port: int) -> None:
    """``auto=True`` in torchrun's environment of a one-rank group."""
    import torch.distributed as dist

    from gsmvi_tpu_torch.parallel import initialize_distributed

    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), LOCAL_RANK="0")
    ok = initialize_distributed(auto=True, backend="gloo")
    up = dist.is_initialized()
    if up:
        dist.destroy_process_group()
    torch.save({"ok": ok, "up": up}, os.path.join(workdir, "auto.pt"))
