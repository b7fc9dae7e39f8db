"""The port's ``parallel`` package and the fitters' ``mesh``/``cov_sharding``
options against the JAX package's meshes.

JAX's side runs here, on its 8 virtual CPU devices (``tests/conftest.py``);
the port's side runs in gloo ranks on the CPU (``tests/torch_mesh_ranks.py``),
one ``torch.multiprocessing`` spawn per world size (1, 2 and 4) on a
``file://`` store under a temporary directory, which computes every case
and writes its results; the tests below read them.  Both sides draw the
same numbers: the port's fits take JAX's own split-chain draws through the
``_eps`` hook.  Every rank draws the whole batch, so a world of one rank
equals the fit without a mesh bit for bit.

Tolerances: float64 statistics 1e-10 (JAX's own, tests/test_sharding.py);
float64 fits 1e-8; float32 fits on the kernel routes JAX's own mesh-vs-
unsharded tolerances (tests/test_sharding.py:230-307): 2e-4 for GSM, 5e-4
for BaM, equal accept counts; the blocked Cholesky 1e-10 * D.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.bam_factor as j_bf
import gsmvi_tpu.gsm_factor as j_gf
from gsmvi_tpu import ADVI as JADVI
from gsmvi_tpu import GSM as JGSM
from gsmvi_tpu import BaM as JBaM
from gsmvi_tpu import FactorBaM as JFactorBaM
from gsmvi_tpu import FactorGSM as JFactorGSM
from gsmvi_tpu import Regularizers as JRegularizers
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.parallel import blocked_cholesky as j_blocked
from gsmvi_tpu.parallel import make_mesh as j_make_mesh
from gsmvi_tpu.parallel.large_d import cov_sharding as j_cov_sharding
from gsmvi_tpu.parallel.large_d import make_mesh_2d as j_make_mesh_2d
from gsmvi_tpu.parallel.sharded import (sharded_bam_stats as j_bam_stats,
                                        sharded_gsm_stats as j_gsm_stats,
                                        sharded_score_eval as j_score_eval)
from gsmvi_tpu_torch.parallel import blocked_cholesky
from gsmvi_tpu_torch.parallel.distributed import launch

WORLDS = (1, 2, 4)
D, B, NITER = 12, 16, 40
MESH_2D = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
CHOL_CASES = ((8, 4), (12, 5), (32, 32), (48, 16), (50, 16), (64, 8))
SPAWN_TIMEOUT_S = 120
GSM_TOL, BAM_TOL = 2e-4, 5e-4


def _target_arrays(seed, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    return rng.standard_normal(d), 0.6 * np.eye(d) + 0.3 * a @ a.T / d


def _jax_target(arrays, dtype=jnp.float64):
    return _gaussian_target(*(jnp.asarray(a, dtype) for a in arrays), "g")


def _split_chain_draws(key, n, b, d, dtype):
    """JAX's mesh-route draws: ``key, ks = split(key)``, ``normal(ks)``."""
    out = []
    for _ in range(n):
        key, ks = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(ks, (b, d), dtype)))
    return np.stack(out)


def _spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + d * np.eye(d)


KEY = 4


def _spec():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(KEY)
    s0 = _spd(rng, D) / D
    spec = {
        "target": _target_arrays(1, D), "fit_dims": (D, B, NITER),
        "mesh_2d": MESH_2D,
        "stats": (rng.standard_normal((B, D)), rng.standard_normal(D), s0),
        "draws64": _split_chain_draws(key, NITER + 1, B, D, jnp.float64),
        "draws32": _split_chain_draws(key, NITER + 1, B, D, jnp.float32),
        "chol": [(_spd(rng, d), blk) for d, blk in CHOL_CASES]
        + [(_spd(rng, 24) - 100.0 * np.eye(24), 8)],
        "cov_gsm": {"dims": (16, 8, NITER, 8),
                    "target": _target_arrays(2, 16),
                    "draws": _split_chain_draws(key, NITER + 1, 8, 16,
                                                jnp.float64)},
        "cov_factor": {
            name: {"dims": (d, b, NITER), "target": _target_arrays(3, d),
                   "draws": _split_chain_draws(key, NITER + 1, b, d,
                                               jnp.float64)}
            for name, (d, b) in (("small_space", (16, 4)),
                                 ("middle", (12, 16)))}}
    return spec


@pytest.fixture(scope="module")
def spec():
    return _spec()


@pytest.fixture(scope="module")
def ranks(spec, tmp_path_factory):
    """{world: [results of rank 0, ...]} of one spawn per world size."""
    import torch_mesh_ranks

    work = tmp_path_factory.mktemp("mesh")
    torch.save(spec, work / "spec.pt")
    out = {}
    for world in WORLDS:
        launch(torch_mesh_ranks.run, world, world, str(work),
               timeout=SPAWN_TIMEOUT_S)
        out[world] = [torch.load(work / f"result_{world}_{r}.pt",
                                 weights_only=False) for r in range(world)]
    return out


def _jax_mesh(n):
    return j_make_mesh(n)


def _jax_state(st, dense):
    return {"mean": np.asarray(st.mean),
            "mat": np.asarray(st.cov if dense else st.factor),
            "n_accepted": int(st.n_accepted)}


@pytest.fixture(scope="module")
def jax_fits(spec, eight_devices):
    """JAX's mesh fits at n = 1, 2, 4 on the split-chain key."""
    t64 = _jax_target(spec["target"])
    t32 = _jax_target(spec["target"], jnp.float32)
    kw = dict(batch_size=B, niter=NITER, verbose=False, return_state=True)
    bkw = dict(kw, retries=0)
    key = jax.random.PRNGKey(KEY)
    out = {}
    for n in WORLDS:
        mesh = _jax_mesh(n)
        res = {
            "gsm_dense": _jax_state(JGSM(D=D, lp=t64.lp, lp_g=t64.lp_g,
                                         mesh=mesh, use_factor=False)
                                    .fit(key, **kw), True),
            "factor_plain": _jax_state(JFactorGSM(D=D, lp=t64.lp,
                                                  lp_g=t64.lp_g, mesh=mesh)
                                       .fit(key, **kw), False),
            "bam_dense": _jax_state(JBaM(D=D, lp=t64.lp, lp_g=t64.lp_g,
                                         mesh=mesh, use_factor=False)
                                    .fit(key, regf=JRegularizers()
                                         .linear(30.0), **bkw), True),
            "bam_factor_plain": _jax_state(
                JFactorBaM(D=D, lp=t64.lp, lp_g=t64.lp_g, mesh=mesh,
                           use_pallas=False)
                .fit(key, JRegularizers().linear(30.0), **bkw), False)}
        import optax

        st, losses = JADVI(D=D, lp=t64.lp, mesh=mesh).fit(
            key, optax.adam(2e-2), batch_size=B, niter=NITER, verbose=False,
            return_state=True)
        res["advi"] = {"loc": np.asarray(st.loc),
                       "scales": np.asarray(st.scales),
                       "losses": np.asarray(losses)}
        out[n] = res
    return out


@pytest.fixture(scope="module")
def jax_kernel_fits(spec, eight_devices):
    """JAX's mesh fits on its update kernels (interpret mode), float32."""
    t32 = _jax_target(spec["target"], jnp.float32)
    key = jax.random.PRNGKey(KEY)
    kw = dict(batch_size=B, niter=NITER, verbose=False, return_state=True)
    out = {}
    saved = (j_gf.on_tpu, j_bf.on_tpu)
    j_gf.on_tpu = j_bf.on_tpu = lambda: True
    try:
        for n in (2, 4):
            mesh = _jax_mesh(n)
            g = JFactorGSM(D=D, lp=t32.lp, lp_g=t32.lp_g, mesh=mesh,
                           dtype=jnp.float32)
            g._interpret = True
            assert g._pallas_mode(B) == "update"
            fb = JFactorBaM(D=D, lp=t32.lp, lp_g=t32.lp_g, mesh=mesh,
                            dtype=jnp.float32)
            fb._interpret = True
            assert fb._pallas_mode(B) == "update"
            out[n] = {"factor_k1": _jax_state(g.fit(key, **kw), False),
                      "bam_factor_k7": _jax_state(
                          fb.fit(key, JRegularizers().linear(30.0),
                                 retries=0, **kw), False)}
    finally:
        j_gf.on_tpu, j_bf.on_tpu = saved
    return out


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _states_close(got, want, tol):
    assert got["n_accepted"] == want["n_accepted"]
    _close(got["mean"], want["mean"], tol, "mean")
    _close(got["mat"], want["mat"], tol, "matrix")


# -- statistics ------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stats_match_jax(ranks, spec, world, eight_devices):
    t = _jax_target(spec["target"])
    x, mu0, s0 = (jnp.asarray(a) for a in spec["stats"])
    mesh = _jax_mesh(world)
    want_gsm = j_gsm_stats(mesh, t.lp_g, x, mu0, s0)
    want_bam = j_bam_stats(mesh, t.lp_g, x)
    want_score = j_score_eval(mesh, t.lp_g, x)
    for r, res in enumerate(ranks[world]):
        got = res["stats"]
        for g, w in zip(got["gsm"], want_gsm):
            _close(g, w, 1e-10, f"gsm stats, rank {r}")
        for g, w in zip(got["bam"], want_bam):
            _close(g, w, 1e-10, f"bam stats, rank {r}")
        _close(got["score"], want_score, 1e-10, "score")
        assert got["score_local_rows"] == B // world


# -- fits against JAX's mesh fits and the port's fits without a mesh -------

FIT_ROUTES = ("gsm_dense", "factor_plain", "bam_dense", "bam_factor_plain")


@pytest.mark.parametrize("route", FIT_ROUTES)
@pytest.mark.parametrize("world", WORLDS)
def test_float64_mesh_fit_matches_jax_mesh_fit(ranks, jax_fits, world,
                                               route):
    got = ranks[world][0]["fits"][route]
    _states_close(got[0], jax_fits[world][route], 1e-8)
    for other in ranks[world][1:]:
        assert all(np.array_equal(other["fits"][route][0][k], got[0][k])
                   for k in ("mean", "mat"))


KERNEL_ROUTES = {"factor_k1": GSM_TOL, "gsm_k5": GSM_TOL,
                 "bam_factor_k7": BAM_TOL}


@pytest.mark.parametrize("route", [*FIT_ROUTES, *KERNEL_ROUTES, "advi"])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_fit_against_the_fit_without_mesh(ranks, world, route):
    """One rank: bit for bit on every route.  More: within the route's
    tolerance (float64 1e-8), the same accept count."""
    mesh_fit, plain = ranks[world][0]["fits"][route]
    keys = ("loc", "scales", "losses") if route == "advi" \
        else ("mean", "mat", "n_accepted")
    if world == 1:
        for k in keys:
            assert np.array_equal(mesh_fit[k], plain[k]), k
        return
    tol = KERNEL_ROUTES.get(route, 1e-8)
    for k in keys:
        if k == "n_accepted":
            assert mesh_fit[k] == plain[k]
        else:
            _close(mesh_fit[k], plain[k], tol, k)


@pytest.mark.parametrize("route", ["factor_k1", "bam_factor_k7"])
@pytest.mark.parametrize("world", (2, 4))
def test_kernel_route_mesh_fit_matches_jax(ranks, jax_kernel_fits, world,
                                           route):
    """K1 and K7 (their plain versions on the CPU) on the gathered rows
    against JAX's interpret-mode kernels under its mesh, float32."""
    _states_close(ranks[world][0]["fits"][route][0],
                  jax_kernel_fits[world][route], KERNEL_ROUTES[route])


@pytest.mark.parametrize("world", WORLDS)
def test_advi_mesh_fit_matches_jax(ranks, jax_fits, world):
    got = ranks[world][0]["fits"]["advi"][0]
    want = jax_fits[world]["advi"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-9)
    for k in ("loc", "scales"):
        _close(got[k], want[k], 1e-8, k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gsm_fit_matches_mesh_fit(ranks, world):
    st, ref = ranks[world][0]["sharded_fit"]
    _states_close(st, ref, 1e-8)
    assert st["step"] == ref["step"] == NITER + 1


# -- the blocked Cholesky ----------------------------------------------------

@pytest.mark.parametrize("case", range(len(CHOL_CASES)))
def test_blocked_cholesky_matches_jax(spec, case):
    a, blk = spec["chol"][case]
    want = np.asarray(j_blocked(jnp.asarray(a), blk))
    got = blocked_cholesky(torch.from_numpy(a), blk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * a.shape[0])


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", range(len(CHOL_CASES)))
def test_sharded_blocked_cholesky_matches_jax(ranks, spec, world, case):
    a, blk = spec["chol"][case]
    want = np.asarray(j_blocked(jnp.asarray(a), blk))
    for res in ranks[world]:
        got = res["chol"][case]
        np.testing.assert_allclose(got["l"], want, rtol=0,
                                   atol=1e-10 * a.shape[0])
        assert "Shard(dim=1)" in got["placements"]
        m = MESH_2D[world][1]
        assert got["local"][0] == a.shape[0]
        assert got["local"][1] <= -(-a.shape[0] // m)


@pytest.mark.parametrize("world", (1, 2, 4))
def test_blocked_cholesky_nan_from_the_bad_block_on(ranks, spec, world):
    """Not positive definite: NaN from the failing block onward, finite
    before it, as JAX's; so the accept decision is JAX's."""
    a, blk = spec["chol"][-1]
    want = np.asarray(j_blocked(jnp.asarray(a), blk))
    got = (blocked_cholesky(torch.from_numpy(a), blk).numpy() if world == 1
           else ranks[world][0]["chol"][-1]["l"])
    bad_cols = ~np.isfinite(want).all(axis=0)
    assert bad_cols.any() and not bool(np.isfinite(got).all())
    first = int(np.argmax(bad_cols))
    assert np.isfinite(got[:, :first]).all()
    assert not np.isfinite(got[:, first:]).all(axis=0).any()
    np.testing.assert_allclose(got[:, :first], want[:, :first], rtol=0,
                               atol=1e-10 * a.shape[0])


# -- the column-sharded covariance -------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_cov_sharded_gsm_matches_jax(ranks, spec, world, eight_devices):
    case = spec["cov_gsm"]
    d, b, n, blk = case["dims"]
    t = _jax_target(case["target"])
    mesh = j_make_mesh_2d(*MESH_2D[world])
    want = JGSM(D=d, lp=t.lp, lp_g=t.lp_g, mesh=mesh,
                cov_sharding=j_cov_sharding(mesh), chol_block=blk).fit(
        jax.random.PRNGKey(KEY), batch_size=b, niter=n, verbose=False,
        return_state=True)
    got = ranks[world][0]["cov_sharded"]
    _states_close(got["gsm"], _jax_state(want, True), 1e-8)
    assert got["gsm_local"] == (d, d // MESH_2D[world][1])


@pytest.mark.parametrize("name", ["small_space", "middle"])
@pytest.mark.parametrize("world", WORLDS)
def test_cov_sharded_factor_gsm_matches_jax(ranks, spec, world, name,
                                            eight_devices):
    case = spec["cov_factor"][name]
    d, b, n = case["dims"]
    t = _jax_target(case["target"])
    mesh = j_make_mesh_2d(*MESH_2D[world])
    want = JFactorGSM(D=d, lp=t.lp, lp_g=t.lp_g, mesh=mesh,
                      cov_sharding=j_cov_sharding(mesh)).fit(
        jax.random.PRNGKey(KEY), batch_size=b, niter=n, verbose=False,
        return_state=True)
    got = ranks[world][0]["cov_sharded"][name]
    _states_close(got, _jax_state(want, False), 1e-8)
    f = np.asarray(want.factor)
    _close(got["cov"], f @ f.T, 1e-8, "cov")
    assert got["local"] == (d, d // MESH_2D[world][1])


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_step_keeps_the_matrices_partitioned(ranks, world):
    """The counterpart of tests/test_sharding.py::test_sharded_step_memory_
    stays_partitioned: on a (1, 2) and a (2, 2) mesh the column-sharded
    GSM (blocked Cholesky) and FactorGSM steps leave every rank a (D, D/2)
    panel of each (D, D) matrix, no collective moves D^2 elements, and
    DTensor runs no collective of its own (its redistributions are
    ``_c10d_functional`` ops; a ``full_tensor`` shows the recorder sees
    them).  Every collective is counted at the dispatcher, below the
    ``torch.distributed`` calls, and CommDebugMode counts as many."""
    d = 64
    for res in ranks[world]:
        mem = res["memory"]
        assert mem["gsm"]["local"] == [(d, d // 2)] * 2
        assert mem["factor"]["local"] == [(d, d // 2)]
        for name in ("gsm", "factor"):
            assert mem[name]["finite"] and mem[name]["calls"] > 0
            assert mem[name]["functional"] == [], mem[name]
            assert mem[name]["comm_debug_calls"] == mem[name]["calls"]
            assert mem[name]["max_sent"] < d * d // 2, mem[name]
        assert mem["gather_seen"], mem


# -- routes -------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_kernel_routes_under_a_mesh(ranks, world):
    """With the card's routes on: the update kernels under a mesh, none
    with a column-sharded factor; a batch that does not split evenly
    raises naming use_fused=False; the factor routes get the mesh; the
    one-device methods refuse it."""
    got = ranks[world][0]["routes"]
    assert got["factor_mode"] == got["bam_mode"] == "update"
    assert got["cov_mode"] is None
    assert got["gsm_hands_mesh"] and got["bam_hands_mesh"]
    want_raise = world > 1
    assert got["uneven_raises"] == {"factor": want_raise, "bam": want_raise}
    assert got["refused"] == [True] * 4


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_split_runs_the_plain_step_off_the_card(ranks, world):
    """B = 6 over 4 ranks (and 2, 1): the plain step on padded rows, the
    fit without a mesh to float32 rounding."""
    st, ref = ranks[world][0]["routes"]["uneven_plain"]
    assert st["step"] == ref["step"] == 21
    assert np.isfinite(st["mat"]).all()
    _states_close(st, ref, GSM_TOL)
