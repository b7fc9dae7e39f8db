"""The plain references against float64 NumPy, against the port's own plain
updates, and against the target they fit, at tiny sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import seeds
from portbench.reference import bam, common, dense_gaussian, gsm

F64 = common.Arith("float64")


def _target(seed=0, d=6):
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return {"mean": torch.as_tensor(rng.uniform(size=d)),
            "cov": torch.as_tensor(cov)}


def _state(rng, k, d):
    mu = rng.standard_normal((k, d))
    a = rng.standard_normal((k, d, d))
    cov = a @ a.transpose(0, 2, 1) / d + np.eye(d)
    return mu, cov


def _gsm_numpy(mu, cov, x, g):
    """The per-point GSM update of one fit in float64 NumPy, point by point."""
    b, _ = x.shape
    dmus, ds = [], np.zeros_like(cov)
    for xb, gb in zip(x, g):
        a = mu - xb
        sg = cov @ gb
        rho = 0.5 * (np.sqrt(1 + 4 * (gb @ sg + (a @ gb) ** 2)) - 1)
        eps0 = sg - a
        dmu = (eps0 - a * (gb @ eps0) / (1 + rho + a @ gb)) / (1 + rho)
        bm = a + dmu
        ds += np.outer(a, a) - np.outer(bm, bm)
        dmus.append(dmu)
    return mu + np.mean(dmus, axis=0), cov + ds / b


def _bam_numpy(mu, cov, x, g, reg):
    """BaM's update of one fit in float64 NumPy, in the paper's full-rank
    form S' = 2 V (I + (I + 4 U V)^(1/2))^-1 (by an eigendecomposition of the
    similar symmetric matrix), the mean as the paper's."""
    b, d = x.shape
    xbar, gbar = x.mean(0), g.mean(0)
    c = (x - xbar).T @ (x - xbar) / b
    gm = (g - gbar).T @ (g - gbar) / b
    r1 = reg / (1 + reg)
    u = reg * gm + r1 * np.outer(gbar, gbar)
    v = cov + reg * c + r1 * np.outer(mu - xbar, mu - xbar)
    lv = np.linalg.cholesky(v)
    lam, q = np.linalg.eigh(np.eye(d) + 4 * lv.T @ u @ lv)
    root = (q * np.sqrt(lam)) @ q.T
    s = 2 * lv @ np.linalg.inv(np.eye(d) + root) @ lv.T
    s = 0.5 * (s + s.T)
    return mu / (1 + reg) + r1 * (s @ gbar + xbar), s


@pytest.mark.parametrize("k,b,d", [(1, 3, 6), (3, 4, 5), (2, 8, 4)])
def test_gsm_update_matches_numpy(k, b, d):
    rng = np.random.default_rng(k * 100 + b)
    mu, cov = _state(rng, k, d)
    x = rng.standard_normal((k, b, d))
    g = rng.standard_normal((k, b, d))
    got = gsm.update(*(torch.as_tensor(t) for t in (mu, cov, x, g)), F64)
    for i in range(k):
        want = _gsm_numpy(mu[i], cov[i], x[i], g[i])
        np.testing.assert_allclose(got[0][i].numpy(), want[0], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got[1][i].numpy(), want[1], rtol=1e-11,
                                   atol=1e-11)


@pytest.mark.parametrize("k,b,d,reg", [(1, 3, 6, 100.0), (2, 4, 5, 0.3),
                                       (3, 8, 4, 2.0)])
def test_bam_update_matches_numpy(k, b, d, reg):
    rng = np.random.default_rng(k * 100 + b)
    mu, cov = _state(rng, k, d)
    x = rng.standard_normal((k, b, d))
    g = rng.standard_normal((k, b, d))
    got = bam.update(*(torch.as_tensor(t) for t in (mu, cov, x, g)), reg,
                     F64)
    for i in range(k):
        want = _bam_numpy(mu[i], cov[i], x[i], g[i], reg)
        np.testing.assert_allclose(got[0][i].numpy(), want[0], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got[1][i].numpy(), want[1], rtol=1e-9,
                                   atol=1e-9)


def test_updates_match_the_ports_plain_updates():
    """The same semantics as the program's own plain dense updates."""
    from gsmvi_tpu_torch.ops.bam import bam_update
    from gsmvi_tpu_torch.ops.gsm import gsm_update

    rng = np.random.default_rng(7)
    mu, cov = _state(rng, 1, 6)
    x, g = rng.standard_normal((1, 4, 6)), rng.standard_normal((1, 4, 6))
    t = [torch.as_tensor(a) for a in (mu, cov, x, g)]
    got = gsm.update(*t, F64)
    want = gsm_update(t[2][0], t[3][0], t[0][0], t[1][0])
    torch.testing.assert_close(got[0][0], want[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[1][0], want[1], rtol=1e-12, atol=1e-12)
    got = bam.update(*t, 5.0, F64)
    want = bam_update(t[2][0], t[3][0], t[0][0], t[1][0], 5.0)
    torch.testing.assert_close(got[0][0], want[0], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(got[1][0], want[1], rtol=1e-9, atol=1e-9)


def test_draws_are_the_programs_stream():
    from gsmvi_tpu_torch.driver import EpsStream

    gen = torch.Generator()
    got = common.draws(gen, [3, 2 ** 31 + 5], 17, 4, 6, torch.float64)
    stream = EpsStream("cpu")
    for i, s in enumerate([3, 2 ** 31 + 5]):
        want = stream(s, 17, 4, 6)
        assert torch.equal(got[i], want.to(torch.float64))


def test_step_seed_is_the_programs():
    from gsmvi_tpu_torch.driver import step_seed

    for s, i in [(0, 0), (1, 3000), (2 ** 31 + 77, 12), (2 ** 40, 5)]:
        assert seeds.step_seed(s, i) == step_seed(s, i)


@pytest.mark.parametrize("name,kw", [("gsm", {}),
                                     ("bam", {"regf": ["linear", 100.0]})])
def test_reference_fits_converge_to_the_target(name, kw):
    arrays = _target()
    fitter = {"gsm": gsm, "bam": bam}[name]
    means, covs = fitter.fit(dense_gaussian.score, arrays, [11, 12],
                             batch_size=4, niter=300, device="cpu", **kw)
    for m, c in zip(means, covs):
        torch.testing.assert_close(m, arrays["mean"], rtol=0, atol=1e-6)
        torch.testing.assert_close(c, arrays["cov"], rtol=1e-6, atol=1e-6)


def test_tf32_round():
    # A TF32 step at 1 is 2^-10: a quarter step rounds down, three
    # quarters and the half step round up.
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -11, 0.0,
                      float("inf"), float("nan")], dtype=torch.float32)
    got = common.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -10, 0.0, float("inf"),
                         float("nan")])
    assert torch.equal(got[:7], want[:7]) and torch.isnan(got[7])
    y = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    rel = ((common.tf32_round(y) - y) / y).abs().max()
    assert 0 < rel <= 2.0 ** -11
