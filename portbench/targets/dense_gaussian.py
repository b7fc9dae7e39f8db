"""The upstream examples' dense Gaussian (``setup_model``): a uniform mean
and cov = s^2 L L' + 1e-3 I with L standard normal, made on the device in
float64 from the configuration's target seed and cast once to its dtype.

The target is the configuration's, like a published model's weights, and
the same in every run: its conditioning sets how many Newton-Schulz tiers a
BaM fit takes, which moved a run's rate by 8 % from one target to another.
"""

from __future__ import annotations

import torch


def arrays(cfg: dict, device) -> dict:
    """{"mean": (D,), "cov": (D, D)} in the configuration's dtype."""
    d = int(cfg["dim"])
    scale = float(cfg["target"].get("scale", 1.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["target"]["seed"]))
    mean = torch.rand(d, generator=gen, dtype=torch.float64, device=device)
    l = scale * torch.randn((d, d), generator=gen, dtype=torch.float64,
                            device=device)
    cov = l @ l.T + 1e-3 * torch.eye(d, dtype=torch.float64, device=device)
    dtype = getattr(torch, cfg["dtype"])
    return {"mean": mean.to(dtype), "cov": cov.to(dtype)}


def program(arr: dict, device):
    """The port's target on the same arrays (its public constructor)."""
    from gsmvi_tpu_torch.models import gaussian_target_from_arrays

    return gaussian_target_from_arrays(arr["mean"].cpu().numpy(),
                                       arr["cov"].cpu().numpy(),
                                       device=device)
