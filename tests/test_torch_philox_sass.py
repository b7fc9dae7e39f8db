"""``tools/philox_sass.py``, the SASS counter behind the Philox ops bound,
on small hand-written ``cuobjdump -sass`` listings (no toolkit needed).

The listing below is a kernel of the shape the counter expects: an early
exit, a skippable 16-byte store of the words, four MUFU.RSQ (one a normal),
a slow path reached by a branch that calls a subroutine, and the float4
store of the normals.  The fewest instructions through that store skip the
words' store and the slow path; counts are exact by hand.
"""

import pytest

from tools import philox_sass as ps

NAME = "_ZN12_GLOBAL__N_113philox_kernelILi1EEEvPjPfxxjj"


def listing(body, name=NAME):
    lines = [f"\t\tFunction : {name}",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    for addr, text in body:
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     "          /* 0x0000000000000000 */")
        lines.append("                                          "
                     "                /* 0x000fe20000000000 */")
    return "\n".join(lines) + "\n"


KERNEL = [
    (0x00, "S2R R0, SR_TID.X"),
    (0x10, "ISETP.GE.AND P0, PT, R0, 0x10, PT"),
    (0x20, "@P0 EXIT"),
    (0x30, "IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ"),
    (0x40, "@P1 BRA 0x60"),
    (0x50, "STG.E.128 desc[UR4][R4.64], R8"),
    (0x60, "MUFU.RSQ R9, R2"),
    (0x70, "MUFU.RSQ R10, R2"),
    (0x80, "MUFU.RSQ R11, R2"),
    (0x90, "MUFU.RSQ R12, R2"),
    (0xa0, "FSETP.GEU.AND P2, PT, R9, 1, PT"),
    (0xb0, "@!P2 BRA 0xe0"),
    (0xc0, "CALL.REL.NOINC 0x120"),
    (0xd0, "FFMA R9, R9, R9, R9"),
    (0xe0, "FFMA R10, R9, R9, R9"),
    (0xf0, "STG.E.128 desc[UR4][R6.64], R8"),
    (0x100, "EXIT"),
    (0x110, "BRA 0x110"),
    (0x120, "MUFU.LG2 R1, R1"),
    (0x130, "RET.REL.NODEC R20 0x0"),
]


def test_fewest_instructions_through_the_normals_store():
    """Entry, the exit test, the product, the skip of the words' store,
    four RSQ, the slow-path test and its skip, one FFMA, the store and the
    exit: 14 issue slots; FP32 lanes take the FFMA and the IMAD."""
    out = ps.pipe_counts(listing(KERNEL))
    assert out["paths"][1] == {"issue": 14, "fma": 2, "imad": 1, "alu": 2,
                               "xu": 4}
    assert out["per_normal"] == {"issue": 3.5, "fma": 0.5, "imad": 0.25,
                                 "alu": 0.5, "xu": 1.0}
    hist = out["kernels"][NAME]
    assert hist["MUFU.RSQ"] == 4 and hist["STG.E.128"] == 2
    assert hist["IMAD.WIDE.U32"] == 1 and "IMAD.HI.U32" not in hist


@pytest.mark.parametrize("skip, issue, xu", [
    (True, 14, 4),       # the branch around the slow path is taken
    (False, 17, 5),      # no branch: the call (its LG2 and RET) and FFMA
])
def test_a_forced_slow_path_counts_its_subroutine(skip, issue, xu):
    body = [row for row in KERNEL if skip or row[0] != 0xb0]
    code = ps.parse(listing(body))[NAME]
    stores = ps.normals_stores(code, 1)
    assert [code[i][0] for i in stores] == [0xf0]
    got = ps.path_counts(code, stores)
    assert got["issue"] == issue and got["xu"] == xu


def test_predicated_instructions_stay_off_their_pipes():
    assert ps.pipes_of("FFMA", predicated=True) == {"issue": 1}
    assert ps.pipes_of("IMAD.WIDE.U32", predicated=False) == {
        "issue": 1, "fma": 1, "imad": 1}
    assert ps.pipes_of("MOV", predicated=False) == {"issue": 1}
    assert ps.pipes_of("MUFU.RSQ", predicated=False) == {"issue": 1, "xu": 1}


def test_a_store_without_its_normals_is_refused():
    """Two RSQ before the only float4 store: no store of four normals."""
    body = [row for row in KERNEL if row[0] not in (0x80, 0x90)]
    with pytest.raises(ValueError, match="float4 stores"):
        ps.pipe_counts(listing(body))
