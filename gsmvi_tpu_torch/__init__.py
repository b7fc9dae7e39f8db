"""gsmvi_tpu_torch — the PyTorch/CUDA port of gsmvi_tpu.

Three algorithms so far.  ``GSM(D, lp, lp_g, device=...)`` with
``fit(seed, ...) -> (mean, cov)`` hands the fit to ``FactorGSM`` (the
eps-coordinate route) on a CUDA device, where each step runs on
hand-written Hopper kernels (``ops/fused_step.py``, ``ops/cuda/csrc``);
``BaM(D, lp, lp_g, device=...)`` with ``fit(seed, regf, ...)`` likewise
hands the fit to ``FactorBaM`` (``ops/bam_fused.py``).  Elsewhere the dense
routes run in plain torch.  ``ADVI(D, lp, device=...)`` fits by autograd
and ``Adam`` (``fit``) or on the whole-step kernels (``fit_fused``,
``ops/advi_fused.py``).  The JAX
package ``gsmvi_tpu`` is the reference the port is tested against.  This
package imports torch and numpy only.
"""

from .advi import ADVI, Adam
from .bam import BaM
from .bam_factor import FactorBaM
from .distributions import mvn_logpdf, mvn_sample
from .gsm import GSM
from .gsm_factor import FactorGSM
from .models import dense_gaussian, ill_conditioned_gaussian
from .ops.bam import Regularizers
from .ops.gsm import gsm_update
from .state import VIState, init_state

__version__ = "0.1.0"

__all__ = [
    "ADVI", "Adam", "BaM", "FactorBaM", "FactorGSM", "GSM", "Regularizers",
    "VIState", "dense_gaussian", "gsm_update", "ill_conditioned_gaussian", "init_state",
    "mvn_logpdf", "mvn_sample",
]
