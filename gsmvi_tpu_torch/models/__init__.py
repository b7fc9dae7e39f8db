"""Target zoo of the port: the Gaussian family (the main path's targets)."""

from .base import Target, make_target
from .gaussian import (dense_gaussian, gaussian_target_from_arrays,
                       ill_conditioned_gaussian)

__all__ = ["Target", "dense_gaussian", "gaussian_target_from_arrays",
           "ill_conditioned_gaussian", "make_target"]
