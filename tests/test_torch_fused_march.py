"""K1's bf16 march (csrc/fused_pcg.cu ``k1_march_kernel``, the pieces in
csrc/pn_march.cuh) as far as the CPU can hold it: the launchers' C
prototypes, the partials count from the grid's shape, and the march's
geometry mirrored in Python.

The kernel itself runs only on the card (``tests/test_torch_gpu.py`` holds
it bitwise against ``k1_plain``). What is held here is what a wrong index
would break there: every node of the grid owned by exactly one lane in
exactly one unit, every word a lane loads or stores aligned to 4 bytes
and inside one row's columns or masked, and the neighbour pairs that move
a row of pn from one frame into the other naming the right columns.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp

# 1x1; widths odd and even, below a strip, a strip and a node past it, not
# a multiple of it; the two grids fused runs its bf16 path at, cut to a
# few row tiles where the rows add nothing new
SHAPES = [(1, 1), (17, 33), (2, 64), (16, 65), (33, 128), (45, 133),
          (130, 20), (40, 601), (35, 3201), (2401, 64)]


def _c_kinds(symbol: str) -> list:
    """The parameter kinds of ``symbol``'s C prototype in fused_pcg.cu."""
    source = _build.source_path(fp.LIBRARY).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in {fp.LIBRARY}.cu"
    return ["ptr" if "*" in p else " ".join(p.split()).rsplit(" ", 1)[0]
            .removeprefix("const ") for p in match.group(1).split(",")]


@pytest.mark.parametrize("symbol", sorted(
    s for s, (restype, _) in fp._SIGNATURES.items()
    if restype is ctypes.c_int))
def test_fused_launchers_match_their_c_prototypes(symbol):
    """Every entry of the fused library, the timing instantiation and the
    scratch lengths included: a ctypes list that drifts from its C
    prototype is no error to ctypes and misreads arguments on the card."""
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    _, argtypes = fp._SIGNATURES[symbol]
    assert [names[t] for t in argtypes] == _c_kinds(symbol)


def test_every_form_has_its_entries():
    for form in fp.DTYPES.values():
        for stem in ("k1", "k1_part", "k2", "scratch_len"):
            assert f"pe_fused_{stem}_{form}" in fp._SIGNATURES


@pytest.mark.parametrize("g,rows,bf16,f32", [
    ((2401, 3201), 16, 963, 7676), ((801, 1201), 8, 240, 988),
    ((401, 601), 4, 127, 247), ((1, 1), 4, 1, 1), ((17, 33), 4, 1, 2),
    ((45, 133), 4, 5, 10)])
def test_k1_blocks_by_hand(g, rows, bf16, f32):
    """2401x3201: 51 strips (1601 words) x 151 row tiles of 16 = 7701
    units, 963 blocks of 8, against 76 x 101 tiles; 801x1201: 19 strips
    x 51 tiles of 16 = 969 units would give 122 blocks, so 8 rows: 19 x
    101; 401x601: 10 strips, 33 and 64 blocks at 16 and 8 rows, so 4:
    10 x 101 = 1010 units."""
    assert fp.march_rows(*g) == rows
    assert fp.k1_blocks(*g, torch.bfloat16) == bf16
    assert fp.k1_blocks(*g, torch.float32) == f32


@pytest.mark.parametrize("g1,g2", SHAPES)
def test_partials_count_holds_k1_and_k2(g1, g2):
    k2 = min(-(-g1 * g2 // fp.K2_THREADS), fp.K2_MAX_BLOCKS)
    for dtype in fp.DTYPES:
        n = fp.partials_count(g1, g2, dtype)
        assert n >= fp.k1_blocks(g1, g2, dtype) and n >= 2 * k2
        assert n in (fp.k1_blocks(g1, g2, dtype), 2 * k2)
    # the bf16 scratch is never longer than the f32 one
    assert (fp.partials_count(g1, g2, torch.bfloat16)
            <= fp.partials_count(g1, g2, torch.float32))


def _frame(i: int, g2: int) -> int:
    return (i * g2) & 1


def _lane_columns(s: int, lane: int, o: int) -> tuple[int, int]:
    c = fp.MARCH_STRIP * s + 2 * lane - o
    return c, c + 1


@pytest.mark.parametrize("g1,g2", SHAPES)
def test_march_owns_every_node_once_in_aligned_words(g1, g2):
    """Units row tile by row tile, strips across a row; in row i a lane
    owns the word whose first element is column 2q - o(i): each node of
    the grid once, every word at an even element offset (4 bytes), its
    halves either a column of row i or masked. Rows start even at every
    row tile, so a unit's first row is in frame 0."""
    strips = fp.march_strips(g2)
    rows = fp.march_rows(g1, g2)
    assert rows % 4 == 0 and rows + 2 <= 32
    tiles = -(-g1 // rows)
    owned = np.zeros((g1, g2), dtype=np.int64)
    for unit in range(strips * tiles):
        tile, s = divmod(unit, strips)
        r0 = tile * rows
        assert r0 % 2 == 0 and _frame(r0, g2) == 0
        for i in range(r0, min(r0 + rows, g1)):
            o = _frame(i, g2)
            for lane in range(32):
                cx, cy = _lane_columns(s, lane, o)
                assert (i * g2 + cx) % 2 == 0
                for c in (cx, cy):
                    if 0 <= c < g2:
                        owned[i, c] += 1
    assert (owned == 1).all()
    # the blocks hold every unit, with fewer than a block's warps to spare
    blocks = fp.k1_blocks(g1, g2, torch.bfloat16)
    assert 0 <= blocks * fp.MARCH_WARPS - strips * tiles < fp.MARCH_WARPS


def _pairs(s: int, o: int) -> tuple[list, list]:
    """The west and east pairs of every lane (pn_march.cuh ``west`` and
    ``east``) of strip s in a row in frame o, as the columns they name:
    lane 0's west from the strip's west edge, lane 31's east from its east
    edge."""
    cols = [_lane_columns(s, lane, o) for lane in range(32)]
    e_w = fp.MARCH_STRIP * s - o - 1
    e_e = fp.MARCH_STRIP * (s + 1) - o
    west = [(cols[lane - 1][1] if lane else e_w, cols[lane][0])
            for lane in range(32)]
    east = [(cols[lane][1], cols[lane + 1][0] if lane < 31 else e_e)
            for lane in range(32)]
    return west, east


@pytest.mark.parametrize("g2", [33, 65, 133, 601, 3201])
def test_neighbour_pairs_move_a_row_into_the_other_frame(g2):
    """At an odd width consecutive rows alternate frames. A row in frame 1
    moved into frame 0 is its east pairs (own second column, the next
    lane's first, the east edge for lane 31); a row in frame 0 moved into
    frame 1 is its west pairs. Each names, lane by lane, the columns the
    other frame owns; and the west / east pairs in a row's own frame name
    each node's west and east neighbour columns."""
    for s in range(fp.march_strips(g2)):
        for o in (0, 1):
            west, east = _pairs(s, o)
            moved = east if o == 1 else west
            for lane in range(32):
                assert moved[lane] == _lane_columns(s, lane, 1 - o)
                cx, cy = _lane_columns(s, lane, o)
                assert west[lane] == (cx - 1, cy - 1)
                assert east[lane] == (cx + 1, cy + 1)


def test_k1_part_runs_only_on_the_card():
    z = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="only on the card"):
        fp.k1_part("whole", *([z] * 9), torch.zeros(5), torch.zeros(
            6, dtype=torch.int32), torch.zeros(0), max_iter=5, h1=0.1,
            h2=0.1)
