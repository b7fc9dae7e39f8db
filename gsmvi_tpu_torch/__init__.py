"""gsmvi_tpu_torch — the PyTorch/CUDA port of gsmvi_tpu.

Three algorithms so far, on the CUDA card unless the caller passes
``device="cpu"``.  ``GSM(D, lp, lp_g)`` with ``fit(seed, ...) -> (mean,
cov)`` hands the fit to ``FactorGSM`` (the eps-coordinate route) on a CUDA
device, where each step runs on hand-written Hopper kernels
(``ops/fused_step.py``, ``ops/cuda/csrc``); with ``use_factor=False`` or a
huge batch its dense route runs the K5 kernel (``ops/gsm_step.py``);
``fit_batch(seeds, ...)`` runs K replica fits together (batched K1/K5, or
K6 ``ops/batch_fused.py``); ``FactorGSM(..., steps_per_call=1)`` runs one
K4 whole step per iteration.  ``BaM(D, lp, lp_g)`` with ``fit(seed, regf,
...)`` likewise hands the fit to ``FactorBaM`` (``ops/bam_fused.py``); its
dense route is plain torch.  ``ADVI(D, lp)`` fits by autograd and ``Adam``
(``fit``) or on the whole-step kernels (``fit_fused``,
``ops/advi_fused.py``).  ``FactorGSM.fit``/``FactorBaM.fit`` take
``audit_every`` (``utils/audit.py``): periodic checks of the fused kernels
against the exact plain step on the live state.  The JAX package
``gsmvi_tpu`` is the reference the port is tested against.  This package
imports torch and numpy only.
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
from .state import FactorVIState, VIState, init_state

__version__ = "0.1.0"

__all__ = [
    "ADVI", "Adam", "BaM", "FactorBaM", "FactorGSM", "FactorVIState", "GSM",
    "Regularizers", "VIState", "dense_gaussian", "gsm_update", "ill_conditioned_gaussian", "init_state",
    "mvn_logpdf", "mvn_sample",
]
