"""K-e and K-f bf16's vector-lane march (csrc/lane_march.cuh, launched by
``pe_batched_stencil_bf16`` in csrc/stencil.cu and
``pe_batched_stencil_dots_bf16`` in csrc/stencil_dots.cu) as far as the CPU
can hold it: the launch geometry mirrored in Python, the frames of every
array's rows, the partials count, and the C prototypes.

The kernels run only on the card (``tests/test_torch_gpu.py`` holds them
bitwise against their plain versions and, lane by lane, against K-a and
K-d bf16). What is held here is what a wrong index would break there: every
(lane, node) of the output owned by exactly one thread, every word a lane
loads or stores aligned to 4 bytes and inside its row or masked, each
row's frame as the kernel compiles it, and the wrapper sizing the partials
from the library's block count.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.ops import scratch

STRIP, WARPS = hk.LANE_STRIP, hk.LANE_WARPS

# (g1, g2, lanes): the paths' grids cut to a few row tiles (401x601 odd,
# 801x1201 odd), odd g1 g2 below, at and just past a strip, even widths of
# one strip and past it, an even g1 at an odd width, B = 1 and odd B
SHAPES = [(3, 3, 1), (11, 65, 2), (45, 133, 3), (13, 64, 3), (6, 66, 1),
          (8, 63, 3), (17, 128, 5), (40, 601, 4), (35, 1201, 2)]


def _frame(l: int, g1: int, g2: int, i: int) -> int:
    """The frame of lane l's row i of a (B, g1, g2) stack: its first
    element's parity."""
    return (l * g1 * g2 + i * g2) & 1


def _delta(l: int, g1: int, g2: int) -> int:
    """The kernel's compiled frame of lane l against a and b: kD1 (an odd
    g1 g2) for an odd lane, a and b's frame for an even one."""
    return int(bool(g2 & 1 and g1 & 1 and l & 1))


def _units(g1: int, g2: int, pad: int, lanes: int):
    """(rows, [(tile, strip)]) of one lane, in the kernel's order."""
    rows = hk.lane_rows(g1, g2, pad, lanes)
    strips = hk.lane_strips(g2)
    tiles = hk.lane_tiles(g1, pad, rows)
    return rows, [divmod(u, strips) for u in range(strips * tiles)]


def _march(g1: int, g2: int, pad: int, lanes: int):
    """Every store and load of the march, mirrored: yields ("load" | "store",
    array, lane, row, element, halves) with element the word's first
    element in that array (a lane's stack offset included) and halves the
    (column, wanted) of its two elements."""
    on = g2 - 2 + 2 * pad
    om = g1 - 2 + 2 * pad
    end_row = g1 - 1 + pad
    rows, units = _units(g1, g2, pad, lanes)
    lo, hi = 1 - pad, g2 - 2 + pad
    for l in range(lanes):
        d = _delta(l, g1, g2)
        for tile, s in units:
            r0 = tile * rows
            assert r0 % 2 == 0
            for r in range(r0, min(r0 + rows, end_row)):
                fr = (g2 & 1) and r & 1
                for lane in range(32):
                    c = STRIP * s + 2 * lane
                    # w and a of row r + 1 and b of row r, as a step loads
                    # them; out's row r as it stores it
                    if r + 1 <= g1 - 1:
                        fd = (g2 & 1) and (r + 1) & 1
                        yield from _word("w", l, g1, g2, r + 1, c, d ^ fd)
                        yield from _word("a", 0, g1, g2, r + 1, c, fd)
                    yield from _word("b", 0, g1, g2, r, c, fr)
                    if r >= 1 - pad:
                        fo = d ^ fr ^ int(pad == 0 and g2 % 2 == 0)
                        yield from _store(l, om, on, r - lo, c - lo, c, lo,
                                          hi, fo, lane)


def _word(name, l, g1, g2, i, c, f):
    """The frame-f word holding column c of row i (lane l's), loaded as
    lane_march.cuh ``word`` predicates it."""
    row = l * g1 * g2 + i * g2
    if f == 0:
        cols = (c, c + 1)
        load = c < g2 and not (c == g2 - 1 and i == g1 - 1)
    else:
        cols = (c - 1, c)
        load = c - 1 < g2
    if load:
        yield ("load", name, l, i, row + cols[0],
               tuple((col, 0 <= col < g2) for col in cols))


def _store(l, om, on, oi, oc, c, lo, hi, f, lane):
    """lane_march.cuh ``store``: the words and halves a lane writes of out
    row oi (columns c, c + 1 at out column oc, oc + 1), in frame f."""
    row = l * om * on + oi * on
    ok = [lo <= col <= hi for col in (c - 1, c, c + 1)]
    if f == 0:
        if ok[1] or ok[2]:
            yield ("store", "out", l, oi, row + oc,
                   ((c, ok[1]), (c + 1, ok[2])))
        return
    if lane > 0 and ok[0] or ok[1]:
        yield ("store", "out", l, oi, row + oc - 1,
               ((c - 1, lane > 0 and ok[0]), (c, ok[1])))
    if lane == 31 and ok[2]:
        yield ("store", "out", l, oi, row + oc + 1, ((c + 1, True),
                                                      (c + 2, False)))


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("g1,g2,lanes", SHAPES)
def test_march_owns_every_output_once_in_aligned_words(g1, g2, lanes, pad):
    """Every (lane, node) of out written by exactly one thread, once; each
    store a word at an even element (4 bytes) of its lane's out or a half
    of one, each half it writes a column of out's row. Every word load
    aligned, inside its array and holding at least one column of its row
    (the grid's corner word is never loaded)."""
    on, om = g2 - 2 + 2 * pad, g1 - 2 + 2 * pad
    lo = 1 - pad
    owned = np.zeros((lanes, om, on), dtype=np.int64)
    size = {"w": lanes * g1 * g2, "a": g1 * g2, "b": g1 * g2}
    for kind, name, l, i, at, halves in _march(g1, g2, pad, lanes):
        assert at % 2 == 0
        if kind == "store":
            wanted = [(col, k) for k, (col, ok) in enumerate(halves) if ok]
            for col, k in wanted:
                assert at + k == l * om * on + i * on + col - lo
                owned[l, i, col - lo] += 1
            continue
        assert 0 <= at and at + 1 < size[name]
        assert any(0 <= col < g2 for col, _ in halves)
    assert (owned == 1).all()


@pytest.mark.parametrize("g1,g2,lanes", SHAPES)
def test_frames_compiled_by_the_march_are_the_arrays(g1, g2, lanes):
    """A unit starts at an even row, so the kernel compiles each row's
    frames from (kOdd, kD1, kFlip): a and b in (i g2) & 1, lane l's w, out
    and pair operands in delta(l) ^ that, a pad-0 out in w's frame at an
    odd width and in frame 1 at an even one. Held against each array's
    first element of the row, at odd and even g2, odd g1 g2, odd lanes."""
    bm, bn = g1 - 2, g2 - 2
    for l in range(lanes):
        d = _delta(l, g1, g2)
        for i in range(g1):
            fs = (i * g2) & 1
            assert fs == ((g2 & 1) and i & 1)
            assert _frame(l, g1, g2, i) == d ^ fs
            if 1 <= i <= g1 - 2:
                # pad 0's out: element of (row i, column c), c even
                for c in (0, 2, 2 * (g2 // 2)):
                    at = l * bm * bn + (i - 1) * bn + c - 1
                    flip = int(g2 % 2 == 0)
                    assert at & 1 == d ^ fs ^ flip
    # a lane pair's second lane differs from the first exactly at odd g1 g2
    assert _delta(1, g1, g2) == (g1 * g2) & 1


def _fixed(word_cols, lane):
    """lane_march.cuh ``fixed`` at frame 1: the high half of a lane's word
    and the next lane's low half, lane 31 the strip's last-column edge."""
    nxt = word_cols[lane + 1][0] if lane < 31 else "edge"
    return word_cols[lane][1], nxt


@pytest.mark.parametrize("s", [0, 1, 4])
def test_frame_one_words_move_into_the_fixed_columns(s):
    """In frame 1 lane L loads (c - 1, c); its high half and the next
    lane's low half are (c, c + 1), lane 31's second the strip's last
    column, which the edge lanes hold (column 64 s + 63)."""
    words = [(STRIP * s + 2 * L - 1, STRIP * s + 2 * L) for L in range(32)]
    for lane in range(32):
        c = STRIP * s + 2 * lane
        got = _fixed(words, lane)
        want = (c, c + 1) if lane < 31 else (c, "edge")
        assert got == want
    assert STRIP * s + 2 * 31 + 1 == STRIP * s + 63


@pytest.mark.parametrize("g1,g2,pad,lanes,rows,blocks", [
    (401, 601, 1, 32, 16, 33), (801, 1201, 1, 8, 16, 122),
    (401, 601, 1, 16, 8, 64), (801, 1201, 1, 4, 8, 240),
    (3, 3, 1, 1, 4, 1), (3, 3, 0, 1, 4, 1)])
def test_lane_blocks_by_hand(g1, g2, pad, lanes, rows, blocks):
    """401x601: 10 strips x 26 tiles of 16 = 260 units, 33 blocks a lane,
    1056 for 32 lanes (at least two waves of three blocks an SM); for 16
    lanes 528 would be fewer, so 8 rows: 51 tiles, 64 blocks. 801x1201: 19
    strips x 51 tiles = 969 units, 122 blocks; 4 lanes take 8 rows, 101
    tiles, 240 blocks. K-f bf16's blocks a lane are these."""
    assert hk.lane_rows(g1, g2, pad, lanes) == rows
    assert hk.lane_blocks(g1, g2, pad, rows) == blocks
    assert hk.lane_dots_blocks(g1, g2, pad, lanes) == blocks


class _Fn:
    def __init__(self, impl):
        self.impl = impl

    def __call__(self, *args):
        return self.impl(*args)


class _FakeLib:
    """K-e's and K-f's libraries without a card: each launch's symbol and
    arguments recorded, K-f bf16's blocks a lane from the mirror."""

    def __init__(self, signatures):
        self.launches = []
        for symbol, (restype, _) in signatures.items():
            if restype is ctypes.c_int:
                setattr(self, symbol, _Fn(
                    lambda *a, s=symbol: self.launches.append((s, a)) or 0))
        self.pe_batched_stencil_dots_bf16_blocks = _Fn(
            lambda bm, bn, pad, lanes: hk.lane_dots_blocks(bm + 2, bn + 2,
                                                           pad, lanes))
        self.pe_stencil_dots_blocks = _Fn(lambda bm, bn, pad: 7)
        for name in ("pe_stencil_error_string",
                     "pe_stencil_dots_error_string"):
            setattr(self, name, _Fn(lambda code: f"error {code}".encode()))


@pytest.fixture
def fake(monkeypatch):
    libs = {hk.KERNEL: _FakeLib(hk._SIGNATURES),
            hk.DOTS_KERNEL: _FakeLib(hk._DOTS_SIGNATURES)}
    for name, lib in libs.items():
        monkeypatch.setitem(_build._LOADED, name, lib)
    monkeypatch.setattr(_build, "_DECLARED", {})
    monkeypatch.setattr(_build, "stream_handle", lambda device: 11)
    monkeypatch.setattr(scratch, "_SCRATCH", {})
    monkeypatch.setattr(scratch, "_RETIRED", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return libs


def _stack(lanes, g, dtype=torch.bfloat16):
    return torch.zeros((lanes,) + g, dtype=dtype)


@pytest.mark.parametrize("g1,g2,lanes", [(401, 601, 32), (45, 133, 3),
                                         (13, 64, 1)])
def test_partials_are_sized_from_the_library_block_count(fake, g1, g2,
                                                         lanes):
    """K-f bf16's partials: n_pairs x the library's blocks a lane
    (pe_batched_stencil_dots_bf16_blocks) x lanes doubles, a ticket a
    lane; K-d's bf16 form keeps its own count."""
    g = (g1, g2)
    w = _stack(lanes, g)
    a, b = (torch.ones(g, dtype=torch.bfloat16) for _ in range(2))
    ops = [_stack(lanes, g) for _ in range(5)]
    hk._launch_dots(w, a, b, 0.1, 0.2, pp._bundle(*ops), pad=1, lanes=True)
    partials, tickets = scratch._SCRATCH[(None, 11)]
    blocks = hk.lane_dots_blocks(g1, g2, 1, lanes)
    assert partials.numel() == 8 * blocks * lanes
    assert tickets.numel() == lanes
    (symbol, args), = fake[hk.DOTS_KERNEL].launches
    assert symbol == "pe_batched_stencil_dots_bf16"
    assert args[14] == lanes and args[11] == partials.data_ptr()


def test_lane_entries_refuse_arrays_off_a_word(fake):
    """The engines' K-e bf16 entry with the grid and pad; a bf16 array off
    a 4-byte boundary is refused before any launch, for K-e and K-f."""
    lanes, g = 3, (9, 13)
    w, a, b = _stack(lanes, g), torch.ones(g, dtype=torch.bfloat16), \
        torch.ones(g, dtype=torch.bfloat16)
    hk._launch_batched(w, a, b, 0.1, 0.2, 1)
    hk._launch_batched(w, a, b, 0.1, 0.2, 0)
    lib = fake[hk.KERNEL]
    (s0, a0), (s1, a1) = lib.launches
    assert s0 == s1 == "pe_batched_stencil_bf16"
    assert a0[4:8] == (lanes, 7, 11, 1) and a1[4:8] == (lanes, 7, 11, 0)
    def off(t):
        return torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)

    for args in ((off(w), a, b), (w, off(a), b), (w, a, off(b))):
        with pytest.raises(ValueError, match="4-byte"):
            hk._launch_batched(*args, 0.1, 0.2, 1)
    ops = [_stack(lanes, g) for _ in range(4)] + [off(w)]
    with pytest.raises(ValueError, match="4-byte"):
        hk._launch_dots(w, a, b, 0.1, 0.2, pp._bundle(*ops), pad=1,
                        lanes=True)
    assert len(lib.launches) == 2 and not fake[hk.DOTS_KERNEL].launches


def _c_kinds(library: str, symbol: str) -> list:
    source = _build.source_path(library).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in {library}.cu"
    return ["ptr" if "*" in p else " ".join(p.split()).rsplit(" ", 1)[0]
            .removeprefix("const ") for p in match.group(1).split(",")]


@pytest.mark.parametrize("library,symbol,table", [
    (hk.KERNEL, "pe_batched_stencil_bf16", hk._SIGNATURES),
    (hk.DOTS_KERNEL, "pe_batched_stencil_dots_bf16", hk._DOTS_SIGNATURES),
    (hk.DOTS_KERNEL, "pe_batched_stencil_dots_bf16_blocks",
     hk._DOTS_SIGNATURES)])
def test_lane_entries_match_their_c_prototypes(library, symbol, table):
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    assert [names[t] for t in table[symbol][1]] == _c_kinds(library, symbol)


def test_mirror_constants_are_the_header_s():
    """The Python mirror's strip, warps, rows and fill are lane_march.cuh's."""
    header = (_build.source_path("stencil").parent
              / "lane_march.cuh").read_text()
    for name, value in (("kWarps", WARPS), ("kMaxRows", hk.LANE_MAX_ROWS),
                        ("kMinRows", hk.LANE_MIN_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", header), name
    assert re.search(r"kFillBlocks = 2 \* 132 \* 3;", header)
    assert hk.LANE_FILL_BLOCKS == 2 * 132 * 3
    assert STRIP == 64
