"""GSM's eps-coordinate step at batch B, dimension D (float32).

A step: the sampling product ef = eps F' (x = mu + ef), the score
(m - x) P, vf = v F and t = vf F' ((B, D) rows against a (D, D) matrix each:
the row products); the small space from the five (B, D) row arrays to the
new mean and the (2B, D) stacks su, sw; the fat apply F + su' sw.  The small
space is counted as the exact update's work: the two (2B)^2 Grams over D
(Z'Z and S2 Z'), the row dot products and forms, and its (2B)^3 factor
work as five (2B)^3 products, the least a pair of Cholesky factors with
their solves costs; the program's Newton-Schulz sweeps are not counted.
"""

F32 = 4


def rowprod(b: int, d: int) -> tuple:
    flops = 4 * 2 * b * d * d
    # F and P read once; four row arrays in, four out; the two means.
    nbytes = F32 * (2 * d * d + 8 * b * d + 2 * d)
    return flops, nbytes


def smallspace(b: int, d: int) -> tuple:
    n = 2 * b
    flops = 2 * (2 * n * n * d) + 5 * n ** 3 + 16 * b * d
    # e, v, vf, t, ef and the mean in; su, sw and the new mean out.
    nbytes = F32 * (5 * b * d + d + 2 * n * d + d)
    return flops, nbytes


def apply(b: int, d: int) -> tuple:
    n = 2 * b
    flops = 2 * n * d * d
    nbytes = F32 * (2 * d * d + 2 * n * d)
    return flops, nbytes


def step_flops(b: int, d: int) -> float:
    return rowprod(b, d)[0] + smallspace(b, d)[0] + apply(b, d)[0]
