"""K-d's host path on the CPU: the pair table a launch passes, the C
prototypes of ``csrc/stencil_dots.cu``, and the sums' scratch that the
K-d family shares with the stage-4 kernels.

K-d (``csrc/stencil_dots.cu``) has the pipelined bundle's pair table
compiled in and runs it for a table that is that one index for index;
any other table runs the generic instantiation. The wrapper passes the
table as ``distinct_operands`` numbers it: by the pattern of the pairs'
operands, whichever tensors fill them, so an aliased or reordered bundle
is another table. A fake library placed in ``_build._LOADED`` records
each launch's arguments, so the table, the scratch and the launch shape
are read here without a card (the kernels themselves, and which
instantiation runs, in ``tests/test_torch_gpu.py``). ``ops.scratch``
keeps one (partials, tickets) pair per device and stream, grown to the
largest launch and never freed while a graph may point at it.
"""

import ctypes
import re

import pytest
import torch

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.ops import scratch
from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4

BLOCKS = 7  # the fake library's blocks a lane


class _Fn:
    """A ctypes function stand-in: callable, with settable attributes."""

    def __init__(self, impl):
        self.impl = impl

    def __call__(self, *args):
        return self.impl(*args)


class _FakeDots:
    """K-d's library without a card: records every launch's arguments."""

    def __init__(self):
        self.launches = []
        for symbol, (restype, _) in hk._DOTS_SIGNATURES.items():
            if restype is ctypes.c_int and symbol != "pe_stencil_dots_blocks":
                setattr(self, symbol, _Fn(
                    lambda *a, s=symbol: self.launches.append((s, a)) or 0))
        self.pe_stencil_dots_blocks = _Fn(lambda bm, bn, pad: BLOCKS)
        self.pe_stencil_dots_error_string = _Fn(
            lambda code: f"error {code}".encode())
        self.pe_stage4_scratch_len = _Fn(lambda device: 16)
        self.pe_stage4_error_string = _Fn(lambda code: b"error")


@pytest.fixture
def fake(monkeypatch):
    """The fake library as K-d's, an empty scratch cache, no capture."""
    lib = _FakeDots()
    monkeypatch.setitem(_build._LOADED, hk.DOTS_KERNEL, lib)
    monkeypatch.setattr(_build, "_DECLARED", {})
    monkeypatch.setattr(_build, "stream_handle", lambda device: 11)
    monkeypatch.setattr(scratch, "_SCRATCH", {})
    monkeypatch.setattr(scratch, "_RETIRED", [])
    monkeypatch.setattr(s4, "_LENGTHS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return lib


def _vecs(n, shape=(6, 9)):
    return [torch.zeros(shape) for _ in range(n)]


def _pairs(case):
    """The pair tables of the classification cases, over fresh tensors."""
    r, u, w, s, p = _vecs(5)
    bundle = pp._bundle(r, u, w, s, p)
    return {
        "bundle": bundle,
        # the same table over the operands passed in another order
        "bundle, operands permuted": pp._bundle(p, s, w, u, r),
        "bundle, operands swapped": pp._bundle(r, u, s, w, p),
        # aliases change the table: fewer distinct operands
        "w aliased to s": pp._bundle(r, u, w, w, p),
        "r aliased to u": pp._bundle(u, u, w, s, p),
        "all one tensor": pp._bundle(r, r, r, r, r),
        # the same pairs in another order
        "pairs reversed": tuple(reversed(bundle)),
        "first two pairs swapped": (bundle[1], bundle[0]) + bundle[2:],
        # the same products under another table: the GPU tests' and
        # chip_smoke's generic run of the bundle
        "each pair's operands swapped": tuple((y, x) for x, y in bundle),
        "seven pairs": bundle[:7],
        "one pair": bundle[:1],
        # the GPU tests' table: eight pairs over the same five operands
        "the tests' eight pairs": ((u, u), (r, u), (p, p), (w, u), (w, p),
                                   (s, u), (s, p), (u, p)),
        # one operand more in the last pair
        "six operands": bundle[:7] + ((p, torch.zeros(6, 9)),),
    }[case]


CASES = {
    "bundle": True, "bundle, operands permuted": True,
    "bundle, operands swapped": True, "w aliased to s": False,
    "r aliased to u": False, "all one tensor": False,
    "pairs reversed": False, "first two pairs swapped": False,
    "each pair's operands swapped": False,
    "seven pairs": False, "one pair": False,
    "the tests' eight pairs": False, "six operands": False,
}


def _table(pairs):
    """The table ``distinct_operands`` makes of ``pairs``: (distinct
    operands, each pair's x index, each pair's y index)."""
    ops, xs, ys = hk.distinct_operands(pairs)
    return len(ops), tuple(xs), tuple(ys)


# the pipelined engine's table, as the library receives it
BUNDLE = _table(pp._bundle(*_vecs(5)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_classification(case):
    """A table is the pipelined bundle's exactly when its pairs repeat the
    bundle's pattern of operands: whichever tensors fill it, and no
    aliased or reordered form of it."""
    assert (_table(_pairs(case)) == BUNDLE) is CASES[case]
    # each operand once, in the order of first use
    ops = hk.distinct_operands(_pairs(case))[0]
    assert len({id(t) for t in ops}) == len(ops)


def _c_source() -> str:
    return _build.source_path(hk.DOTS_KERNEL).read_text()


def _c_kinds(params: str) -> list:
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        kinds.append("ptr" if "*" in param
                     else param.rsplit(" ", 1)[0].removeprefix("const "))
    return kinds


def test_c_prototypes_match_the_dots_signatures():
    """Every extern "C" function of csrc/stencil_dots.cu has an entry in
    ``_DOTS_SIGNATURES`` with its arity and argument kinds in order, and
    the table has no entry the source lacks: a ctypes list that drifts
    from its prototype is no ctypes error, it misreads the arguments on
    the card."""
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr", ctypes.c_char_p: "const char*"}
    src = _c_source()
    extern = src[src.index('extern "C" {'):]
    protos = dict(re.findall(r"\n(?:int|const char\*) (pe_\w+)\(([^)]*)\)",
                             extern))
    assert set(protos) == set(hk._DOTS_SIGNATURES)
    for symbol, params in protos.items():
        restype, argtypes = hk._DOTS_SIGNATURES[symbol]
        assert [names[t] for t in argtypes] == _c_kinds(params), symbol
        want = "const char*" if symbol.endswith("error_string") else "int"
        assert names[restype] == want, symbol


def _launch_args(lib, symbol):
    """The named arguments of each recorded launch of ``symbol``."""
    src = _c_source()
    params = re.search(rf"\bint {symbol}\(([^)]*)\)", src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    return [dict(zip(names, a)) for s, a in lib.launches if s == symbol]


def _kd_inputs(shape=(6, 9)):
    w = torch.zeros(shape)
    a, b = torch.ones(shape), torch.ones(shape)
    return w, a, b


def _passed(args) -> tuple:
    """The table a recorded launch passed: (n_operands, pair_x, pair_y)."""
    n = args["n_pairs"]
    return (args["n_operands"], tuple(args["pair_x"][:n]),
            tuple(args["pair_y"][:n]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_runs_the_bundle_instantiation_exactly_for_the_bundle(fake,
                                                                      case):
    """The library, which picks the instantiation from the table, receives
    the table ``distinct_operands`` makes: the bundle's index for index
    exactly for the bundle, with each distinct tensor's pointer once."""
    w, a, b = _kd_inputs()
    pairs = _pairs(case)
    _build.reset_launches()
    hk._launch_dots(w, a, b, 0.1, 0.2, pairs, pad=1)
    (args,) = _launch_args(fake, "pe_stencil_dots_f32")
    assert _passed(args) == _table(pairs)
    assert (_passed(args) == BUNDLE) is CASES[case]
    ops = hk.distinct_operands(pairs)[0]
    assert list(args["operands"][:len(ops)]) == [t.data_ptr() for t in ops]
    assert _build.LAUNCHES == {"stencil_dots": 1}


def test_mixed_and_lane_launches_carry_the_flag(fake):
    """K-h and K-f pass their table the same way: the bundle's for the
    bundle, another for any other."""
    r, u, w_, s, p = (torch.zeros(6, 9, dtype=torch.bfloat16)
                      for _ in range(5))
    m = torch.zeros(6, 9)
    a, b = (torch.ones(6, 9, dtype=torch.bfloat16) for _ in range(2))
    hk._launch_dots_mixed(m, a, b, 0.1, 0.2, pp._bundle(r, u, w_, s, p), 1,
                          torch.float32)
    (kh,) = _launch_args(fake, "pe_stencil_dots_mixed_bf16")
    assert _passed(kh) == BUNDLE
    lanes = [torch.zeros(3, 6, 9) for _ in range(5)]
    w3 = torch.zeros(3, 6, 9)
    hk._launch_dots(w3, torch.ones(6, 9), torch.ones(6, 9), 0.1, 0.2,
                    pp._bundle(*lanes), pad=1, lanes=True)
    hk._launch_dots(w3, torch.ones(6, 9), torch.ones(6, 9), 0.1, 0.2,
                    pp._bundle(*lanes)[:3], pad=1, lanes=True)
    kf, kf3 = _launch_args(fake, "pe_batched_stencil_dots_f32")
    assert _passed(kf) == BUNDLE and kf["lanes"] == 3
    assert _passed(kf3) != BUNDLE and kf3["n_pairs"] == 3


def test_launches_reuse_one_scratch_pair(fake):
    """A call allocates no scratch after the first on its stream: the
    partials and tickets pointers repeat, the pair is large enough for
    n_pairs x blocks x lanes doubles and a ticket a lane, and K-d, K-f
    and the stage-4 kernels on one stream share it (grown as needed)."""
    w, a, b = _kd_inputs()
    pairs = pp._bundle(*_vecs(5))
    for _ in range(3):
        hk._launch_dots(w, a, b, 0.1, 0.2, pairs, pad=1)
    args = _launch_args(fake, "pe_stencil_dots_f32")
    assert len({(x["partials"], x["ticket"]) for x in args}) == 1
    partials, tickets = scratch._SCRATCH[(None, 11)]
    assert partials.numel() == 8 * BLOCKS and tickets.tolist() == [0]
    assert args[0]["partials"] == partials.data_ptr()
    # eight lanes: grown to 8 x 8 x blocks partials and 8 tickets
    w8 = torch.zeros(8, 6, 9)
    hk._launch_dots(w8, a, b, 0.1, 0.2,
                    pp._bundle(*(torch.zeros(8, 6, 9) for _ in range(5))),
                    pad=1, lanes=True)
    grown = scratch._SCRATCH[(None, 11)]
    assert grown[0].numel() == 8 * 8 * BLOCKS
    assert grown[1].tolist() == [0] * 8
    assert scratch._RETIRED == [(partials, tickets)]
    # the stage-4 kernels on the same stream take the same pair
    assert s4._scratch(fake, torch.device("cpu"), 11) is grown
    hk._launch_dots(w, a, b, 0.1, 0.2, pairs, pad=1)
    assert _launch_args(fake, "pe_stencil_dots_f32")[-1]["partials"] == \
        grown[0].data_ptr()


def test_scratch_grows_only_and_keeps_what_it_outgrew(fake):
    cpu = torch.device("cpu", 0)
    small = scratch.sums_scratch(cpu, 5, 10)
    assert small[0].numel() == 10 and small[1].tolist() == [0]
    assert scratch.sums_scratch(cpu, 5, 4) is small
    big = scratch.sums_scratch(cpu, 5, 40, 3)
    assert big[0].numel() == 40 and big[1].tolist() == [0, 0, 0]
    # tickets grown alone keep the partials' length
    more = scratch.sums_scratch(cpu, 5, 1, 5)
    assert more[0].numel() == 40 and more[1].numel() == 5
    assert scratch._RETIRED == [small, big]
    assert scratch.sums_scratch(cpu, 5, 40, 5) is more


def test_scratch_outgrown_inside_a_capture_is_not_kept(fake, monkeypatch):
    cpu = torch.device("cpu", 0)
    kept = scratch.sums_scratch(cpu, 5, 10)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    # a pair large enough is the capture's too
    assert scratch.sums_scratch(cpu, 5, 8) is kept
    bigger = scratch.sums_scratch(cpu, 5, 20)
    assert bigger is not kept and bigger[0].numel() == 20
    assert scratch._SCRATCH == {(0, 5): kept} and scratch._RETIRED == []


def test_stage4_asks_its_length_once_a_device(fake):
    asked = []
    fake.pe_stage4_scratch_len = _Fn(lambda device: asked.append(device)
                                     or 16)
    for stream in (11, 12, 11):
        s4._scratch(fake, torch.device("cpu", 0), stream)
    s4._scratch(fake, torch.device("cpu"), 11)
    assert asked == [0, None]
    assert s4._LENGTHS == {0: 16, None: 16}
