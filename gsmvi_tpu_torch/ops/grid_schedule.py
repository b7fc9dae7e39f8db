"""The schedule of the large-batch eps-NS small space (B 129-512): the
table of phases that ``eps_smallspace_grid.cu`` runs in one cooperative
launch, one grid barrier between two phases.

``grid_schedule(b, iters)`` lists the phases of one update at batch ``b``
and NS profile ``iters`` (sqrt1, inv1, inv2, sqrt2, inv3): each phase a
list of ``(label, op)``, every op a dict of the fields in ``FIELDS``.  The
ops of a phase are independent of each other; no phase reads a buffer it
writes.  ``encode`` packs it into the int32 table the kernel reads (the
phases' first ops, then ``len(FIELDS)`` ints per op); ``decode`` unpacks
it.  A function of (B, iters) alone, never of D or of the replica count:
D enters an op as ``DIM_D`` and each op's units are counted per replica
on the card.

What each op computes (``eps_smallspace_grid.cuh`` holds the same codes):

- ``K_GEMM``: out = epi(A' B') with A' (m, k) and B' (k, n) operands
  (``O_*``: a source as it is or transposed, the identity, the identity
  over the norm, (I +- G)/nrm); every output one fused multiply-add chain
  over k ascending; the epilogues scale, form T = c (aI - acc), Xi~^T,
  fw1xi^T, Q = acc - aux^T or -acc.  With ``pset``,
  the epilogue also writes per tile the row sums of |I + out| (``P_PLUS``)
  or |I - out| (``P_MINUS``), reduced to the norm bound of that set by the
  last tile of each row block; ``E_RES_*`` writes instead the tile's sums
  of (out - A)^2 and A^2 for the residual ``res``.
- ``K_PAIR``: the last sweep of a Newton-Schulz chain, S = sym(Y T
  sqrt(nrm)), each unit an upper tile pair, with I + S (``out2``) and
  (I + S) + aux (``out3``), the inverse chains' operands, and the row sums
  of |I + S| (``pset``) and |(I + S) + aux| (``pset2``).
- ``K_ROWSCAL``, ``K_CROWS``, ``K_MEANSUM``, ``K_SELECT``: the row scalars
  (1/(1 + rho), w/den, gamma), the downdate rows c and u1row = ef/sqrt(B),
  the mean's column sums (into c's first row, dead by then), and the gates,
  ``good``, ``nacc`` and the selected mean.

Phases at the long profile (8, 6, 9, 10, 6): 71, so 70 grid barriers (the
chains' products run two phases a sweep: T, then the two iterates; the
``cu`` and ``cui`` inverses of phase 1 run in lockstep, and the residual
products, ``e c^T``, Q's and the row work run beside them).
"""

from __future__ import annotations

# Op kinds, operand modes, epilogues, norm partial forms and sources.
K_GEMM, K_PAIR, K_ROWSCAL, K_CROWS, K_MEANSUM, K_SELECT = range(6)
O_PLAIN, O_TRANS, O_EYE, O_EYE_INV, O_NS_PLUS, O_NS_MINUS = range(6)
(E_NONE, E_STORE, E_SCALE_B, E_SCALE_ZC, E_NS_T, E_INV_T, E_XIM, E_SU2,
 E_RES_PLUS, E_RES_MINUS, E_SUB_AUXT, E_NEG) = range(12)
P_NONE, P_PLUS, P_MINUS = range(3)
(S_E, S_V, S_VF, S_T, S_EF, S_C, S_XIM, S_SU_LO, S_SU_HI, S_SW_LO,
 S_SW_HI) = range(11)
S_M0 = 16                  # the workspace's (B, B) matrices: S_M0 + i
N_MATRICES = 11
DIM_D = -1                 # a dimension of D
# Norm sets: I + Gu, I + S1, I + S1 + Gu, I - Gv, I + S2; residuals.
NS_A1, NS_S1, NS_S1G, NS_A2, NS_S2 = range(5)
N_NORM_SETS = 5
N_RESIDUALS = 2

FIELDS = ("kind", "epi", "out", "m", "n", "k", "a", "amode", "out2", "b",
          "bmode", "out3", "nrm", "pset", "pexpr", "pset2", "aux", "res")
_DEFAULT = dict(epi=E_NONE, out=-1, m=0, n=0, k=0, a=-1, amode=O_PLAIN,
                out2=-1, b=-1, bmode=O_PLAIN, out3=-1, nrm=-1, pset=-1,
                pexpr=P_NONE, pset2=-1, aux=-1, res=-1)


def grid_schedule(b: int, iters) -> list:
    """The phases of one update at batch ``b`` and NS profile ``iters``
    (every count >= 1): a list of phases, each a list of (label, op)."""
    it = tuple(int(x) for x in iters)
    if len(it) != 5 or min(it) < 1:
        raise ValueError(f"the grid small space takes five NS sweep counts "
                         f">= 1, got {tuple(iters)}")
    it0, it1, it2, it3, it4 = it
    phases = []

    def put(p, label, kind, **fields):
        while len(phases) <= p:
            phases.append([])
        op = dict(_DEFAULT, kind=kind)
        op.update(fields)
        phases[p].append((label, op))

    def gemm(p, label, out, a, bb, epi, m=b, n=b, k=b, nrm=-1, **kw):
        # The norm bound is read only by an operand formed from it.
        if not {a[0], bb[0]} & {O_NS_PLUS, O_NS_MINUS, O_EYE_INV}:
            nrm = -1
        put(p, label, K_GEMM, epi=epi, out=out, m=m, n=n, k=k, a=a[1],
            amode=a[0], b=bb[1], bmode=bb[0], nrm=nrm, **kw)

    mat = [S_M0 + i for i in range(N_MATRICES)]
    gu, ec, s, ips, ipsg = mat[:5]         # ips = I + S, ipsg = I + S1 + Gu
    gv, qm = mat[0], mat[1]                # after Gu and e c^T are dead
    w = mat[5:]

    def ns_chain(p0, n_it, start, src, nrm, pset, aux=-1, tag=""):
        """Coupled Newton-Schulz from Y0 = (I +- src)/nrm, Z0 = I; the last
        sweep's Y T as a symmetric pair into ``s`` and I + S into ``ips``
        (and (I + S) + aux into ``ipsg``, with its norm set pset + 1).
        Returns the next phase."""
        y, z = (start, src), (O_EYE, -1)
        for j in range(1, n_it + 1):
            pt, pyz = p0 + 2 * (j - 1), p0 + 2 * j - 1
            gemm(pt, f"{tag}.{j}.zy", w[4], z, y, E_NS_T, nrm=nrm)
            tn = (O_PLAIN, w[4])
            if j < n_it:
                yn, zn = (w[0], w[2]) if j % 2 else (w[1], w[3])
                gemm(pyz, f"{tag}.{j}.yt", yn, y, tn, E_STORE, nrm=nrm)
                gemm(pyz, f"{tag}.{j}.tz", zn, tn, z, E_STORE)
                y, z = (O_PLAIN, yn), (O_PLAIN, zn)
            else:
                two = aux >= 0
                put(pyz, f"{tag}.{j}.yt", K_PAIR, out=s, out2=ips,
                    out3=ipsg if two else -1, m=b, n=b, k=b, a=y[1],
                    amode=y[0], b=tn[1], bmode=tn[0], nrm=nrm, pset=pset,
                    pset2=pset + 1 if two else -1, aux=aux)
        return p0 + 2 * n_it

    def inv_chain(p0, n_it, a, nrm, bufs, tag):
        """Newton-Hotelling from X0 = I/nrm: T = 2I - A X, X' = X T.
        Returns the buffer of the last iterate."""
        x = (O_EYE_INV, -1)
        for j in range(1, n_it + 1):
            xn = bufs[0] if j % 2 else bufs[1]
            gemm(p0 + 2 * (j - 1), f"{tag}.{j}.ax", bufs[2], a, x, E_INV_T,
                 nrm=nrm)
            gemm(p0 + 2 * j - 1, f"{tag}.{j}.xt", xn, x, (O_PLAIN, bufs[2]),
                 E_STORE, nrm=nrm)
            x = (O_PLAIN, xn)
        return x[1]

    # Phase 0: the row scalars; Gu = e e^T / B (exactly symmetric: each
    # entry one chain), with the row sums of |I + Gu|.
    put(0, "rowscal", K_ROWSCAL)
    gemm(0, "gu", gu, (O_PLAIN, S_E), (O_TRANS, S_E), E_SCALE_B, k=DIM_D,
         pset=NS_A1, pexpr=P_PLUS)
    # Phase 1: the rows c and u1row; S1 = sqrt(I + Gu) from here; e c^T / B
    # beside its second phase.
    put(1, "crows", K_CROWS)
    q = ns_chain(1, it0, O_NS_PLUS, gu, NS_A1, NS_S1, gu, "s1")
    gemm(2, "ec", ec, (O_PLAIN, S_E), (O_TRANS, S_C), E_SCALE_B, k=DIM_D)
    # res1 and the two inverses of phase 1 in lockstep: cu = (I + S1)^-1,
    # cui = (I + S1 + Gu)^-1.
    gemm(q, "res1", -1, (O_PLAIN, s), (O_PLAIN, s), E_RES_PLUS, aux=gu,
         res=0)
    cu = inv_chain(q, it1, (O_PLAIN, ips), NS_S1, w[0:3], "cu")
    cui = inv_chain(q, it2, (O_PLAIN, ipsg), NS_S1G, w[3:6], "cui")
    end_cu, pc = q + 2 * it1, q + 2 * it2
    # w1row = cu e / sqrt(B) as soon as cu is done.
    gemm(end_cu, "w1row", S_SW_LO, (O_PLAIN, cu), (O_PLAIN, S_E), E_SCALE_ZC,
         n=DIM_D)
    # cuiec = cui (e c^T / B) into cui's T buffer (dead), then Xi~^T.
    cuiec = w[5]
    gemm(pc, "cuiec", cuiec, (O_PLAIN, cui), (O_PLAIN, ec), E_STORE)
    gemm(pc + 1, "xim", S_XIM, (O_TRANS, cuiec), (O_PLAIN, S_E), E_XIM,
         n=DIM_D)
    # Gv = Xi~^T Xi~ (exactly symmetric) with the row sums of |I - Gv|, and
    # Q = Xi~^T w1row^T - cuiec^T.
    gemm(pc + 2, "gv", gv, (O_PLAIN, S_XIM), (O_TRANS, S_XIM), E_STORE,
         k=DIM_D, pset=NS_A2, pexpr=P_MINUS)
    p_qa = max(pc + 2, end_cu + 1)
    gemm(p_qa, "qa", qm, (O_PLAIN, S_XIM), (O_TRANS, S_SW_LO), E_SUB_AUXT,
         k=DIM_D, aux=cuiec)
    # fw1xi^T = (-gamma ef + t/(1+rho) + Q ef) / sqrt(B), and the mean's
    # column sums (c is dead after Xi~^T).
    gemm(p_qa + 1, "su2", S_SU_HI, (O_PLAIN, qm), (O_PLAIN, S_EF), E_SU2,
         n=DIM_D)
    put(p_qa + 1, "meansum", K_MEANSUM)
    # Phase 2: S2 = sqrt(I - Gv), then res2 and cv = -(I + S2)^-1.
    p_s2 = max(pc + 3, end_cu + 1)
    q2 = ns_chain(p_s2, it3, O_NS_MINUS, gv, NS_A2, NS_S2, tag="s2")
    gemm(q2, "res2", -1, (O_PLAIN, s), (O_PLAIN, s), E_RES_MINUS, aux=gv,
         res=1)
    cv = inv_chain(q2, it4, (O_PLAIN, ips), NS_S2, w[0:3], "cv")
    last = q2 + 2 * it4
    # w2row = cv Xi~^T with cv = -X: the negated chain, bit for bit.
    gemm(last, "w2row", S_SW_HI, (O_PLAIN, cv), (O_PLAIN, S_XIM), E_NEG,
         n=DIM_D)
    put(last, "select", K_SELECT)
    return phases


def encode(phases) -> list:
    """The int32 table of ``phases``: the index of each phase's first op
    (and one past the last), then every op's ``FIELDS`` in order."""
    starts, ops = [0], []
    for phase in phases:
        ops.extend(op for _, op in phase)
        starts.append(len(ops))
    return starts + [int(op[f]) for op in ops for f in FIELDS]


def decode(table, nphases: int) -> list:
    """``encode``'s inverse, without the labels: a list of phases, each a
    list of op dicts."""
    starts = [int(x) for x in table[:nphases + 1]]
    body = [int(x) for x in table[nphases + 1:]]
    width = len(FIELDS)
    ops = [dict(zip(FIELDS, body[i * width:(i + 1) * width]))
           for i in range(starts[-1])]
    return [ops[starts[p]:starts[p + 1]] for p in range(nphases)]
