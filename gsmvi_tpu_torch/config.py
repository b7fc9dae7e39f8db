"""Device and dtype policy of the PyTorch port.

Counterpart of ``gsmvi_tpu/config.py``.  Two rules:

- Every fitter, target constructor and state helper runs on the card unless
  the caller asks for the CPU: ``device=None`` means ``"cuda"``
  (``resolve_device``).  Nothing here guesses "cuda if available": with no
  CUDA device the default raises at construction, and a fit asked for CUDA
  runs on CUDA or fails.  CPU runs pass ``device="cpu"``.
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


def resolve_device(device=None) -> torch.device:
    """The device of a fitter, target or state: ``device`` when given, else
    the card.  A CUDA device with no card available raises here, before
    anything is allocated; it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available (the port runs "
            "on the card by default); pass device=\"cpu\" to run on the CPU")
    return dev


def default_dtype(dtype=None) -> torch.dtype:
    """The fitter dtype: ``dtype`` when given, else torch's default."""
    return dtype if dtype is not None else torch.get_default_dtype()
