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
``ops/advi_fused.py``).  ``BaM``, ``FactorBaM`` and ``ADVI`` also take
``fit_batch`` (FactorBaM's on K7 with a replica axis).
``FactorGSM.fit``/``FactorBaM.fit`` take ``audit_every``
(``utils/audit.py``): periodic checks of the fused kernels against the
exact plain step on the live state.  The surface around the fits:
``Gaussian``, ``mvn_kl``, ``Posterior``, ``KLMonitor``, ``lbfgs_init``,
``map_init`` and ``save_state``/``load_state`` (``utils/``).  ``GSM`` and
``BaM`` take numpy score callables (their dense eager loop, as
``BaM(jit_compile=False)``), ``compat`` holds the numpy GSM, and
``FactorGSM`` takes ``pallas_precision`` "bf16"/"high" (bf16 tensor-core
products) and ``method`` "twophase"/"qr".  The fitters take
``mesh=``/``data_axis=`` (``GSM`` and ``FactorGSM`` also ``cov_sharding=``,
``GSM`` ``chol_block=``): data-parallel fits over the ranks of a
``torch.distributed`` process group, one rank per device, and a
column-sharded covariance for large D; the ``parallel`` subpackage
(``gsmvi_tpu_torch.parallel``, not re-exported here) starts the group and
builds the meshes.  The JAX
package ``gsmvi_tpu`` is the reference the port is tested against.  This
package imports torch, numpy and (``lbfgs_init``) scipy only.
"""

from .advi import ADVI, Adam
from .bam import BaM
from .bam_factor import FactorBaM
from .distributions import Gaussian, mvn_kl, mvn_logpdf, mvn_sample
from .gsm import GSM
from .gsm_factor import FactorGSM
from .models import dense_gaussian, ill_conditioned_gaussian
from .ops.bam import Regularizers, bam_lowrank_update, bam_update
from .ops.gsm import gsm_update
from .posterior import Posterior
from .state import FactorVIState, VIState, init_state
from .utils.checkpoint import load_state, save_state
from .utils.initializers import lbfgs_init, map_init
from .utils.monitors import KLMonitor

__version__ = "0.1.0"

__all__ = [
    "ADVI", "Adam", "BaM", "FactorBaM", "FactorGSM", "FactorVIState", "GSM",
    "Gaussian", "KLMonitor", "Posterior", "Regularizers", "VIState",
    "bam_lowrank_update", "bam_update", "dense_gaussian", "gsm_update",
    "ill_conditioned_gaussian", "init_state", "lbfgs_init", "load_state",
    "map_init", "mvn_kl", "mvn_logpdf", "mvn_sample", "save_state",
]
