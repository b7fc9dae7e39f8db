"""What the plain fitters share: the arithmetic at a stated precision, the
draws, the accept test and the loop of steps."""

from __future__ import annotations

import torch

from ..seeds import step_seed

# Precisions a reference runs at: the dtype of its arithmetic, and whether
# its matrix products round their operands to TF32 (10 explicit mantissa
# bits, as the tensor cores take float32 operands with TF32 on).  float64 is
# the reference; tf32 is its control.
PRECISIONS = {"float64": (torch.float64, False),
              "tf32": (torch.float32, True)}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties away from
    zero): the 13 low mantissa bits cleared after adding half their range."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    rounded = bits.view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


class Arith:
    """Matrix products and the dtype of one precision."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                             f"got {precision!r}")
        self.dtype, self.tf32 = PRECISIONS[precision]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


def draws(generator: torch.Generator, seeds, step: int, batch: int, d: int,
          dtype) -> torch.Tensor:
    """(K, B, D) standard normals of step ``step`` for the K fits seeded
    with ``seeds``: fit i's are those of a float32 ``randn`` from a generator
    seeded with ``step_seed(seeds[i], step)``, the program's stream."""
    out = torch.empty((len(seeds), batch, d), dtype=torch.float32,
                      device=generator.device)
    for i, seed in enumerate(seeds):
        generator.manual_seed(step_seed(seed, step))
        out[i].normal_(generator=generator)
    return out.to(dtype)


def accept(cov_new: torch.Tensor, mean_new: torch.Tensor):
    """(Cholesky factor, per-fit flag): the proposal is kept where its
    covariance factors and every number in it is finite."""
    chol, info = torch.linalg.cholesky_ex(cov_new)
    good = ((info == 0) & torch.isfinite(chol).flatten(1).all(1)
            & torch.isfinite(mean_new).all(1))
    return chol, good


def select(good: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` where ``good`` (per fit, the leading axis), else ``old``."""
    shape = (-1,) + (1,) * (new.dim() - 1)
    return torch.where(good.reshape(shape), new, old)


def run(update, lp_g, seeds, *, batch: int, niter: int, arith, device,
        d: int, start=None, first_step: int = 0):
    """``niter + 1`` steps of ``update(mu, cov, x, g, step)`` for the K fits
    seeded with ``seeds``, from absolute step ``first_step``: (means (K, D),
    covs (K, D, D)).  The fits start at (0, I), or at ``start`` = (means,
    factors), a state that the program reached (S = F F'): then the first
    step draws x = mu + eps F' from that factor, as the program does, and
    the later ones from the Cholesky factor of the reference's own state."""
    dt = arith.dtype
    k = len(seeds)
    if start is None:
        mu = torch.zeros((k, d), dtype=dt, device=device)
        fac = torch.eye(d, dtype=dt, device=device).expand(k, d, d)
    else:
        mu, fac = (t.to(device=device, dtype=dt) for t in start)
    fac = fac.contiguous()
    cov = fac @ fac.mT
    cov = 0.5 * (cov + cov.mT)
    gen = torch.Generator(device=device)
    for step in range(first_step, first_step + niter + 1):
        eps = draws(gen, seeds, step, batch, d, dt)
        x = mu[:, None, :] + arith.mm(eps, fac.mT)
        mu_new, cov_new = update(mu, cov, x, lp_g(x), step)
        chol_new, good = accept(cov_new, mu_new)
        mu = select(good, mu_new, mu)
        cov = select(good, cov_new, cov)
        fac = select(good, chol_new, fac)
    return mu, cov
