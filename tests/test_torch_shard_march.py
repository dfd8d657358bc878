"""K1-shard bf16's vector-lane march (``k1_march_kernel`` in
csrc/fused_sharded.cu on csrc/lane_march.cuh, launched by
``pe_fused_sharded_k1_bf16``) as far as the CPU can hold it: the launch
geometry mirrored in Python, the frames of every array's rows, the
partials count, and the C prototypes.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
bitwise against ``k1_plain``). What is held here is what a wrong index
would break there: every node of the (bm, bn) block written by exactly one
thread in pn and in ap, every word loaded or stored aligned to 4 bytes and
inside its row or masked, never past an array's last element, each row's
frames of z, p, a, b, d, pn and ap as the kernel compiles them (the p window
at both parities of the halo exchange's stack, and z off a word too), and
the wrapper sizing and checking the partials by the library's bf16 block
count.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs

STRIP = hk.LANE_STRIP
BF16 = torch.bfloat16
# rows of loads in flight (kShardAhead): the launcher's 32-bit limit
# leaves room for them past the windows' last row
AHEAD = 2

# (bm, bn): chip_smoke.py's SHARD_BF16_BLOCKS cut to a few row tiles (a
# rank's 1201x1601, bn + 2 odd, and 1200x1600, even), the 1x1 block and
# the ragged ones, and the width of K1-shard bf16's path block (2401x3201)
BLOCKS = [(13, 1601), (12, 1600), (1, 1), (7, 5), (8, 9), (33, 62),
          (9, 3201)]
# (z's first element, p's first element) of the windows: the halo
# exchange's stack (z at 0, p at (bm+2)(bn+2): mid-word where that is odd),
# and z and p each at either frame in buffers of their own
LAYOUTS = ["stack", (0, 0), (0, 1), (1, 0), (1, 1)]


def _offsets(layout, n):
    """(z's first element, p's first element) in their buffers."""
    return (0, n) if layout == "stack" else layout


def _rows(g1, g2):
    """Rows a unit: K1-shard bf16 takes 16 whatever the block."""
    return hk.LANE_MAX_ROWS


def _word(name, base, i, c, f, g1, g2):
    """lane_march.cuh ``window_word`` (``word`` for a and b, which are in
    frame 1 only at an odd width): the frame-f word holding column c of
    row i of a (g1, g2) array at element ``base``, as ("load", name, row,
    first element, ((column, in the row), ...)); nothing where it is not
    loaded (the grid's corner in the last row)."""
    row = base + i * g2
    last = i == g1 - 1
    if f == 0:
        cols = (c, c + 1)
        load = c < g2 and not (c == g2 - 1 and last)
    else:
        cols = (c - 1, c)
        load = c - 1 < g2 and not (c == g2 and last)
    if load:
        yield ("load", name, i, row + cols[0],
               tuple((col, 0 <= col < g2) for col in cols))


def _store(name, bn, r, c, f, lane, g2):
    """lane_march.cuh ``store`` of a block array (pad 0): the words and
    halves lane ``lane`` writes of block row r - 1 in frame f."""
    row = (r - 1) * bn
    oc = c - 1
    ok = [1 <= col <= g2 - 2 for col in (c - 1, c, c + 1)]
    if f == 0:
        if ok[1] or ok[2]:
            yield ("store", name, r, row + oc, ((c, ok[1]), (c + 1, ok[2])))
        return
    if lane > 0 and ok[0] or ok[1]:
        yield ("store", name, r, row + oc - 1,
               ((c - 1, lane > 0 and ok[0]), (c, ok[1])))
    if lane == 31 and ok[2]:
        yield ("store", name, r, row + oc + 1, ((c + 1, True),
                                                 (c + 2, False)))


def _d_word(bn, r, c, f, node_row, g1, g2):
    """ShardDots ``issue``: d's word of row r holding column c in out's
    frame f; in the last row the word whose low half is the last column,
    one element."""
    nx, ny, nm = (1 <= col <= g2 - 2 for col in (c, c + 1, c - 1))
    if not node_row or not ((nm or nx) if f else (nx or ny)):
        return
    at = (r - 1) * bn + c - 1 - f
    cols = (c - 1, c) if f else (c, c + 1)
    halves = tuple((col, 1 <= col <= g2 - 2) for col in cols)
    if r == g1 - 2 and not (nx if f else ny):
        yield ("element", "d", r, at, halves[:1])
    else:
        yield ("load", "d", r, at, halves)


def _march(bm, bn, oz, op):
    """Every load and store of K1-shard bf16's launch, mirrored: yields
    (kind, array, row, element, halves) with element in its array (z and p
    in their buffers, from ``oz`` and ``op``), kind "load" (an aligned
    word), "element" (one element) or "store", halves the (column, wanted)
    of a word's two elements."""
    g1, g2 = bm + 2, bn + 2
    rows = _rows(g1, g2)
    strips, tiles = hk.lane_strips(g2), hk.lane_tiles(g1, 0, rows)
    dz, dp = oz & 1, op & 1
    flip = int(g2 % 2 == 0)
    end_row = g1 - 1
    for unit in range(strips * tiles):
        tile, s = divmod(unit, strips)
        r0, c0 = tile * rows, STRIP * s
        assert r0 % 2 == 0
        # the unit's edges, an element each: lane k holds row r0 - 1 + k
        for k in range(rows + 2):
            i = r0 - 1 + k
            if 0 <= i < g1:
                for col, names in ((c0 - 1, "zp"), (c0 + 63, "zpab"),
                                   (c0 + 64, "zpb")):
                    if 0 <= col < g2 and (col >= c0 or c0 >= 1):
                        for name in names:
                            base = {"z": oz, "p": op}.get(name, 0)
                            yield ("element", name, i, base + i * g2 + col,
                                   ((col, True),))
            if 1 <= i <= g1 - 2 and c0 + 63 <= bn:
                yield ("element", "d", i, (i - 1) * bn + c0 + 62,
                       ((c0 + 63, True),))
        end = min(r0 + rows, end_row)
        if r0 >= end:
            continue
        for lane in range(32):
            c = c0 + 2 * lane
            # rows r0 and r0 - 1 of z and p, and a of row r0, before the
            # march
            fa = (r0 * g2) & 1
            yield from _word("a", 0, r0, c, fa, g1, g2)
            for name, base, d in (("z", oz, dz), ("p", op, dp)):
                yield from _word(name, base, r0, c, fa ^ d, g1, g2)
                if r0 >= 1:
                    fm = ((r0 - 1) * g2) & 1
                    yield from _word(name, base, r0 - 1, c, fm ^ d, g1, g2)
            for r in range(r0, end):
                fr, fd = (r * g2) & 1, ((r + 1) * g2) & 1
                node_row = 1 <= r <= g1 - 2
                if r + 1 <= g1 - 1:
                    yield from _word("z", oz, r + 1, c, fd ^ dz, g1, g2)
                    yield from _word("p", op, r + 1, c, fd ^ dp, g1, g2)
                    yield from _word("a", 0, r + 1, c, fd, g1, g2)
                yield from _word("b", 0, r, c, fr, g1, g2)
                fo = fr ^ flip
                yield from _d_word(bn, r, c, fo, node_row, g1, g2)
                if r >= 1:
                    yield from _store("ap", bn, r, c, fo, lane, g2)
                if node_row:
                    yield from _store("pn", bn, r, c, fo, lane, g2)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bm,bn", BLOCKS)
def test_march_owns_every_node_once_in_aligned_words(bm, bn, layout):
    """pn and ap: every node of the block written by exactly one thread,
    once, each store a word at an even element of the block array or a
    half of one. Every load: a word at an even element of its buffer (z
    and p from their first elements), holding a column of its row, never
    past the array's last element (a window mid-word may start its first
    word one element before it, inside the same aligned word); every
    element load inside its array."""
    g1, g2 = bm + 2, bn + 2
    n, nb = g1 * g2, bm * bn
    oz, op = _offsets(layout, n)
    base = {"z": oz, "p": op, "a": 0, "b": 0, "d": 0}
    size = {"z": n, "p": n, "a": n, "b": n, "d": nb}
    owned = {name: np.zeros((bm, bn), dtype=np.int64) for name in ("pn",
                                                                   "ap")}
    for kind, name, i, at, halves in _march(bm, bn, oz, op):
        if kind == "store":
            assert at % 2 == 0
            for k, (col, ok) in enumerate(halves):
                if ok:
                    assert at + k == (i - 1) * bn + col - 1
                    owned[name][i - 1, col - 1] += 1
            continue
        lo, hi = base[name], base[name] + size[name]
        if kind == "element":
            assert lo <= at < hi, (name, i, at)
            continue
        assert at % 2 == 0, (name, i, at)
        assert at >= lo - (lo & 1) and at + 2 <= hi, (name, i, at)
        assert any(ok for _, ok in halves), (name, i, at)
    for name, count in owned.items():
        assert (count == 1).all(), name


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bm,bn", BLOCKS)
def test_frames_compiled_by_the_march_are_the_arrays(bm, bn, layout):
    """A unit starts at an even row, so the kernel compiles each row's
    frames: a and b in (i g2) & 1, z and p in their own frame (the
    parity of their first element, DZ, DP, chosen on the host) against
    that, d, pn and ap in a and b's frame at an odd width and in the other
    at an even one (kFlip = not kOdd, pad 0). Held against each array's
    element of an even column in every row. In the halo exchange's stack p
    is mid-word exactly where (bm+2)(bn+2) is odd."""
    g1, g2 = bm + 2, bn + 2
    oz, op = _offsets(layout, g1 * g2)
    if layout == "stack":
        assert op & 1 == (g1 * g2) & 1 and oz == 0
    flip = int(g2 % 2 == 0)
    for i in range(g1):
        fa = (i * g2) & 1
        assert fa == ((g2 & 1) and i & 1)
        for c in range(0, g2, 2):
            assert (oz + i * g2 + c) & 1 == fa ^ (oz & 1)
            assert (op + i * g2 + c) & 1 == fa ^ (op & 1)
            if 1 <= i <= g1 - 2:
                assert ((i - 1) * bn + c - 1) & 1 == fa ^ flip


@pytest.mark.parametrize("bm,bn,blocks", [
    (2401, 3201, 963), (1201, 1601, 247), (1200, 1600, 247), (1, 1, 1)])
def test_k1_bf16_blocks_by_hand(bm, bn, blocks):
    """16-row units: 2401x3201, 51 strips x 151 tiles = 7701 units, 963
    blocks of 8 (the f32 form's 32x8 grid has 30401); 1201x1601, 26
    strips x 76 tiles = 1976 units, 247 blocks, one wave (K-e's rule
    would take 4-row units there, 979 blocks)."""
    g1, g2 = bm + 2, bn + 2
    assert _rows(g1, g2) == 16
    assert hk.lane_blocks(g1, g2, 0, 16) == blocks
    assert hk.lane_rows(g1, g2, 0, 1) == (16 if bm > 2000 else 4)


class _Fn:
    def __init__(self, impl):
        self.impl = impl

    def __call__(self, *args):
        return self.impl(*args)


class _FakeLib:
    """The fused_sharded library without a card: each launch's symbol and
    arguments recorded, K1-shard bf16's blocks from the mirror, the f32
    form's a count of its own."""

    def __init__(self, rc=0):
        self.launches = []
        for symbol, (restype, _) in fs._SIGNATURES.items():
            if restype is ctypes.c_int:
                setattr(self, symbol, _Fn(
                    lambda *a, s=symbol: self.launches.append((s, a)) or rc))
        self.pe_fused_sharded_k1_bf16_blocks = _Fn(
            lambda bm, bn: hk.lane_blocks(bm + 2, bn + 2, 0,
                                          _rows(bm + 2, bn + 2)))
        self.pe_fused_sharded_k1_blocks = _Fn(lambda bm, bn: 30401)
        self.pe_fused_sharded_k2_blocks = _Fn(lambda bm, bn: 5)
        self.pe_fused_sharded_error_string = _Fn(
            lambda code: f"error {code}".encode())


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setitem(_build._LOADED, fs.LIBRARY, lib)
    monkeypatch.setattr(_build, "_DECLARED", {})
    monkeypatch.setattr(_build, "stream_handle", lambda device: 11)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    fs.partial_counts.cache_clear()
    yield lib
    fs.partial_counts.cache_clear()


def _k1_args(bm, bn, dtype=BF16, partials=None):
    ext, blk = (bm + 2, bn + 2), (bm, bn)
    zp = torch.zeros((2,) + ext, dtype=dtype)
    scal = torch.zeros(fp.N_SCAL, dtype=dtype)
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    if partials is None:
        partials = torch.zeros(fs.partial_counts(bm, bn, dtype)[0],
                               dtype=torch.float64)
    return dict(z_ext=zp[0], p_ext=zp[1], a_ext=torch.ones(ext, dtype=dtype),
                b_ext=torch.ones(ext, dtype=dtype),
                d=torch.ones(blk, dtype=dtype),
                pn=torch.zeros(blk, dtype=dtype),
                ap=torch.zeros(blk, dtype=dtype), scal=scal, flags=flags,
                partials=partials)


def _launch(args):
    fs._launch_k1(args["z_ext"], args["p_ext"], args["a_ext"],
                  args["b_ext"], args["d"], args["pn"], args["ap"],
                  args["scal"], args["flags"], args["partials"], 9, 0.1,
                  0.2)


@pytest.mark.parametrize("bm,bn", [(1201, 1601), (7, 5), (8, 9)])
def test_partials_are_sized_from_the_library_bf16_block_count(fake, bm,
                                                              bn):
    """K1-shard's partials by form: the bf16 form's count is the march's
    (pe_fused_sharded_k1_bf16_blocks), the f32 form keeps its grid's; a
    bf16 launch takes partials of that count, with p mid-word as the stack
    gives it, and refuses fewer before any launch."""
    n1 = fs.partial_counts(bm, bn, BF16)[0]
    assert n1 == hk.lane_blocks(bm + 2, bn + 2, 0, _rows(bm + 2, bn + 2))
    assert fs.partial_counts(bm, bn, torch.float32)[0] == 30401
    args = _k1_args(bm, bn)
    assert args["partials"].numel() == n1
    _launch(args)
    (symbol, got), = fake.launches
    assert symbol == "pe_fused_sharded_k1_bf16"
    assert got[7] == args["partials"].data_ptr() and got[10:12] == (bm, bn)
    assert dict(_build.LAUNCHES) == {"fused_sharded_k1_bf16": 1}
    short = _k1_args(bm, bn, partials=torch.zeros(n1 - 1,
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="partials"):
        _launch(short)
    assert len(fake.launches) == 1


def test_k1_bf16_refuses_block_arrays_off_a_word(fake):
    """a, b, d, pn and ap off a 4-byte boundary are refused by name before
    any launch; z and p may start on any element."""
    def off(t):
        return torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)

    args = _k1_args(7, 5)
    _launch(dict(args, z_ext=off(args["z_ext"]), p_ext=off(args["p_ext"])))
    for name in ("a_ext", "b_ext", "d", "pn", "ap"):
        with pytest.raises(ValueError, match=f"{name} starts off a 4-byte"):
            _launch(dict(args, **{name: off(args[name])}))
    assert len(fake.launches) == 1


def test_k1_bf16_refused_launch_raises(monkeypatch):
    """A launch the library refuses (a block past its 32-bit indexing, an
    array off a word) raises with the CUDA error, counts no launch and
    takes no other path."""
    lib = _FakeLib(rc=1)
    monkeypatch.setitem(_build._LOADED, fs.LIBRARY, lib)
    monkeypatch.setattr(_build, "_DECLARED", {})
    monkeypatch.setattr(_build, "stream_handle", lambda device: 11)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    fs.partial_counts.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fused_sharded_k1_bf16"):
            _launch(_k1_args(7, 5))
    finally:
        fs.partial_counts.cache_clear()
    assert len(lib.launches) == 1 and not _build.LAUNCHES


def _c_kinds(symbol: str) -> list:
    source = _build.source_path(fs.LIBRARY).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in {fs.LIBRARY}.cu"
    return ["ptr" if "*" in p else " ".join(p.split()).rsplit(" ", 1)[0]
            .removeprefix("const ") for p in match.group(1).split(",")]


@pytest.mark.parametrize("symbol", ["pe_fused_sharded_k1_bf16",
                                    "pe_fused_sharded_k1_bf16_blocks",
                                    "pe_fused_sharded_k1_blocks"])
def test_k1_entries_match_their_c_prototypes(symbol):
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    assert [names[t] for t in fs._SIGNATURES[symbol][1]] == _c_kinds(symbol)


def test_mirror_constants_are_the_sources():
    """The mirror's rows ahead, the 32-bit limit with room for them, the
    frames it compiles and the march's rule for rows are the sources'."""
    source = _build.source_path(fs.LIBRARY).read_text()
    assert re.search(rf"constexpr int kShardAhead = {AHEAD};", source)
    assert "(int64_t)(bm + 4 + kShardAhead) * (bn + 2) >= (int64_t{1} << 31)" \
        in source
    assert "lm::march_rows<kOdd, !kOdd, false, kShardAhead>" in source
    assert "int k1_march_rows(int, int) { return lm::kMaxRows; }" in source
    assert re.search(r"frame_of\(const BF\* x\)[^}]*>> 1\) & 1", source)
