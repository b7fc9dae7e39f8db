"""Device and dtype policy of the PyTorch port.

Counterpart of ``gsmvi_tpu/config.py``.  Two rules:

- Every fitter takes an explicit ``device=`` (default ``"cpu"``, as torch's
  own default is).  Nothing here guesses "cuda if available": a fit asked
  for CUDA runs on CUDA or fails.
- Float32 matrix products run in true fp32.  The JAX package pins
  ``Precision.HIGHEST`` for the same reason (``ops/pallas/fused_step.py``,
  ``gsm.py``): reduced-precision passes (bf16 on the TPU, TF32 on Hopper)
  break the covariance recursions.  The fitters call ``pin_fp32`` at the
  start of ``fit``.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Turn TF32 off for matmuls and convolutions (full fp32 everywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def default_dtype(dtype=None) -> torch.dtype:
    """The fitter dtype: ``dtype`` when given, else torch's default."""
    return dtype if dtype is not None else torch.get_default_dtype()
