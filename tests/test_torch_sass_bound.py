"""The arithmetic count behind chip_smoke.py's operation bound.

``chip_smoke.tick_loop_ops`` reads a kernel's ``cuobjdump -sass`` listing
and counts, per tick, the arithmetic instructions on the shortest path
through the tick loop. A hand-made listing in the same format checks that
it finds the tick loop (not the staging or write-back loops), takes the
shorter arm of a branch, leaves out memory, control and move instructions,
and sorts the rest by pipe.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(body: list[str]) -> str:
    """A cuobjdump-style listing of one function from bare instructions."""
    lines = ["\t\tFunction : _ZN4demo18sync_window_kernelILi5EEEvv",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"      /* 0x000000000000 */")
        lines.append("                                     /* 0x000fe2 */")
    return "\n".join(lines) + "\n"


#: a staging loop (LDG + STS), then the tick loop: a load, a branch whose
#: taken arm skips three ops, two stores, a back edge; then a write-back
BODY = [
    "S2R R0, SR_TID.X",                   # 0x00
    "LDG.E.CONSTANT R1, desc[UR4][R2.64]",  # 0x10 staging loop head
    "STS [R3], R1",                       # 0x20
    "ISETP.NE.AND P0, PT, R0, RZ, PT",    # 0x30
    "@P0 BRA 0x10",                       # 0x40 staging back edge
    "BAR.SYNC.DEFER_BLOCKING 0x0",        # 0x50
    "LDG.E.CONSTANT R4, desc[UR4][R6.64]",  # 0x60 tick loop head
    "LDS R5, [R3]",                       # 0x70
    "ISETP.GE.AND P1, PT, R4, R5, PT",    # 0x80
    "@P1 BRA 0xd0",                       # 0x90 skip the long arm
    "IADD3 R7, R4, R5, RZ",               # 0xa0
    "LOP3.LUT R7, R7, 0xff, RZ, 0xc0, !PT",  # 0xb0
    "SEL R4, R7, R4, P1",                 # 0xc0
    "POPC R8, R4",                        # 0xd0 join
    "IMAD.MOV.U32 R9, RZ, RZ, R4",        # 0xe0 a move
    "IMAD R10, R4, 0x4, R6",              # 0xf0
    "STG.E desc[UR4][R10.64], R4",        # 0x100
    "STG.E desc[UR4][R10.64+0x4], R8",    # 0x110
    "@!P0 BRA 0x60",                      # 0x120 tick back edge
    "STG.E desc[UR4][R2.64], R9",         # 0x130 write-back
    "EXIT",                               # 0x140
]


def test_listing_parses_into_functions(smoke):
    fns = smoke.sass_functions(_listing(BODY))
    [(name, ins)] = fns.items()
    assert "sync_window_kernel" in name and len(ins) == len(BODY)
    assert ins[9] == (0x90, "@P1", "BRA", "0xd0")


def test_tick_loop_counts_the_shortest_path_by_pipe(smoke):
    [ins] = smoke.sass_functions(_listing(BODY)).values()
    # the short arm: ISETP, POPC, IMAD; the long arm's IADD3/LOP3/SEL and
    # the loads, stores, move and branches are left out
    assert smoke.tick_loop_ops(ins) == {"alu": 1, "popc": 1, "imad": 1}


def test_unrolled_loop_counts_per_tick(smoke):
    body = BODY[:6] + [
        "LDG.E.CONSTANT R4, desc[UR4][R6.64]",  # 0x60
        "IADD3 R7, R4, 0x1, RZ",
        "STG.E desc[UR4][R10.64], R7",
        "STG.E desc[UR4][R12.64], R7",
        "IADD3 R8, R4, 0x2, RZ",
        "STG.E desc[UR4][R10.64+0x4], R8",
        "STG.E desc[UR4][R12.64+0x4], R8",
        "@!P0 BRA 0x60",
        "EXIT",
    ]
    [ins] = smoke.sass_functions(_listing(body)).values()
    assert smoke.tick_loop_ops(ins) == {"alu": 1.0}


def test_bound_takes_the_busiest_pipe(smoke):
    lanes = smoke.PIPE_LANES
    rate = smoke.SM_CLOCKS_PER_S
    per_tick = {"alu": 640, "popc": 1}
    want = 1000 * 640 / (lanes["alu"] * rate) * 1e3
    assert smoke.ops_ms(1000, per_tick) == pytest.approx(want)
    assert smoke.sass_pipe("MUFU.RCP") == "xu"
    assert smoke.sass_pipe("UIADD3") is None and smoke.sass_pipe("LDS") is None
