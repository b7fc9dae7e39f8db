"""BaM's factor-coordinate step at batch B, dimension D (float32), with
k = B + 1 columns in the low-rank factors.

A step: the sampling product ef = eps F' (x = mu + ef), the score
(m - x) P, vf = v F and t = vf F' ((B, D) rows against a (D, D) matrix), and
the new mean's two vector products on the new factor, (gbar F'') F''' (the
row products); the small space from the five (B, D) row arrays to the
(2k, D) stacks su, sw; the fat apply F + su' sw.  The small space is counted
as eight (k, k) Grams or products over D (Om'Om, Om'Q, Y'Y and the stacks'
rows), its row forms, and its k^3 work as ten k^3 products (two roots and
three inverses); the program's Newton-Schulz sweeps are not counted.
"""

F32 = 4


def rowprod(b: int, d: int) -> tuple:
    flops = 4 * 2 * b * d * d + 2 * 2 * d * d
    # F, P and the new factor read once; four row arrays in, four out;
    # gbar, the mean, and the two vector products' results.
    nbytes = F32 * (3 * d * d + 8 * b * d + 4 * d)
    return flops, nbytes


def smallspace(b: int, d: int) -> tuple:
    k = b + 1
    flops = 8 * (2 * k * k * d) + 10 * k ** 3 + 8 * k * d
    # e, v, vf, t, ef and the mean in; su, sw and the mean's two rows out.
    nbytes = F32 * (5 * b * d + d + 4 * k * d + 2 * d)
    return flops, nbytes


def apply(b: int, d: int) -> tuple:
    n = 2 * (b + 1)
    flops = 2 * n * d * d
    nbytes = F32 * (2 * d * d + 2 * n * d)
    return flops, nbytes


def step_flops(b: int, d: int) -> float:
    return rowprod(b, d)[0] + smallspace(b, d)[0] + apply(b, d)[0]
