"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).

float32 outside the tensor cores, since the configurations run float32 with
TF32 off; HBM3 bandwidth.  A card set below 700 W reaches less: the run
prints the card's power limit beside the shares computed against these.
"""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    peak FLOP/s and bytes over peak bytes/s."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
