"""Hand-written Hopper kernels for the per-op PCG path, with plain twins.

The counterpart of ``poisson_ellipse_tpu.ops.pallas_kernels``. Four of its
kernels are ported:

- ``_stencil_kernel`` as K-a (``csrc/stencil.cu``): the ``pallas``
  engine's loop runs it once per iteration, the ``pipelined-pallas``
  engine for w₀ and its residual replacements, ``sstep-pallas`` in its
  basis chain;
- ``_stencil_dots_kernel`` as K-d (``csrc/stencil_dots.cu``): the stencil
  fused with up to eight dot products, the ``pipelined-pallas`` engine's
  one pass per iteration;
- ``_batched_stencil_kernel`` as K-e (``csrc/stencil.cu``, K-a's march
  with the lane on the grid): the stencil for B lanes with lane-shared
  coefficients,
  once a body of ``batched-pallas``, for w₀ and the rebuilds of
  ``batched-pipelined-pallas``;
- ``_batched_stencil_dots_kernel`` as K-f (``csrc/stencil_dots.cu``, K-d
  with the lane on the grid): once a body of ``batched-pipelined-pallas``;
- ``_stencil_kernel_mixed`` as K-g (``csrc/stencil.cu``, K-a's march
  with typed loads): the storage axis's stencil, w in
  the storage dtype or f32, a and b in the storage dtype, out f32; once a
  body of ``pallas`` with ``storage_dtype``, in the rebuilds of
  ``pipelined-pallas`` and in the basis chain of ``sstep-pallas``;
- ``_stencil_dots_kernel_mixed`` as K-h (``csrc/stencil_dots.cu``, K-d
  with typed loads): f32 m, a, b and the pair operands in the storage
  dtype; once a body of ``pipelined-pallas`` with ``storage_dtype``.

K-a, K-d, K-e and K-f also have a bf16 form (``csrc/stencil.cu``
``pe_stencil_bf16``, ``pe_batched_stencil_bf16``, ``csrc/stencil_dots.cu``
``pe_stencil_dots_bf16``, ``pe_batched_stencil_dots_bf16``), the JAX
kernels at bf16: every input bf16, the arithmetic in float on the exactly
widened loads, each result rounded once to bf16 where it is stored (the
rule of the bf16 whole-solve forms, ``ops.whole_solve.rounder``), and the
sums of K-d and K-f taken in double and rounded once to bf16. Their plain
versions compute the same way. The bf16 ``pallas``, ``sstep-pallas`` and
the w₀ and rebuilds of ``pipelined-pallas`` run K-a's, the bf16
``pipelined-pallas`` body K-d's, the bf16 ``batched-pallas`` body and the
w₀ and rebuilds of ``batched-pipelined-pallas`` K-e's, and the bf16
``batched-pipelined-pallas`` body K-f's. They count under
``stencil_bf16``, ``stencil_dots_bf16``, ``batched_stencil_bf16`` and
``batched_stencil_dots_bf16``.

The stage-4 vector kernels of that module are ``ops.stage4_kernels``.

K-a, its bf16 form, K-e and K-g are four forms of one kernel, the march
of ``csrc/stencil.cu`` (a lane a column, each face flux once, every
division through ``stencil_tree.cuh``'s ``div_pos``, so a zero dividend
skips IEEE division's slow path and gives the division's own signed
zero): each is bitwise its plain version, and lane l of K-e bitwise K-a
on lane l. K-e's and K-f's bf16 forms are the vector-lane march of
``csrc/lane_march.cuh`` (a lane two columns, one aligned 4-byte word of
each array, a warp a 64-column strip): lane l of each is bitwise K-a bf16
or K-d bf16 on lane l, its sums those of the same products in another
fixed order; they take 4-byte aligned arrays, and K-f bf16's partials
follow ``pe_batched_stencil_dots_bf16_blocks``.

The plain versions index the last two axes only (``ops.stencil``), so the
same plain function serves one grid and a (B, ·, ·) stack of lanes. The
mixed ones are K-a's and K-d's on the exactly upcast inputs.

Each wrapper takes the plain PyTorch version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from poisson_ellipse_tpu_torch.ops import _build, scratch
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.stencil import (
    apply_a_block,
    rounded,
    spacing,
)

# launch-counter names; K-e and K-f live in the libraries of K-a and K-d
KERNEL = "stencil"
DOTS_KERNEL = "stencil_dots"
BATCHED_KERNEL = "batched_stencil"
BATCHED_DOTS_KERNEL = "batched_stencil_dots"
# K-g and K-h live in the libraries of K-a and K-d
MIXED_KERNEL = "stencil_mixed"
MIXED_DOTS_KERNEL = "stencil_dots_mixed"

# the storage dtypes K-g and K-h load, by their names in the C entry points
_STORAGE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16"}

# the compute dtypes of K-a and K-d (one-lane launches); a form's C entry
# point and launch counter are named as ``ops.whole_solve`` names them
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# K-d takes at most this many distinct pair operands and pairs
MAX_OPERANDS = 8
MAX_PAIRS = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pe_stencil_error_string": (ctypes.c_char_p, [_I]),
    "pe_stencil_f32": (_I, [_P] * 4 + [_I] * 3 + [_F, _F, _P]),
    "pe_stencil_bf16": (_I, [_P] * 4 + [_I] * 3 + [_F, _F, _P]),
    # w, a, b, out, lanes, bm, bn, pad, h1, h2, stream
    **{f"pe_batched_stencil_{form}": (_I, [_P] * 4 + [_I] * 4 + [_F, _F, _P])
       for form in ("f32", "bf16")},
    # K-g: pe_stencil_f32's arguments, w and a, b of the named types
    **{f"pe_stencil_mixed_{w}_{ab}": (_I, [_P] * 4 + [_I] * 3 + [_F, _F, _P])
       for ab in ("bf16", "f16") for w in (ab, "f32")},
}
# w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
# x_off, partials, ticket, sums, bm, bn, pad, h1, h2, stream
_DOTS_ARGS = ([_P] * 5 + [_I] + [_P] * 2 + [_I] * 3 + [_P] * 3 + [_I] * 3
              + [_F, _F, _P])
_DOTS_SIGNATURES = {
    "pe_stencil_dots_error_string": (ctypes.c_char_p, [_I]),
    "pe_stencil_dots_blocks": (_I, [_I] * 3),
    # K-d and its bf16 form; K-h (a, b and the operands narrow)
    **{f"pe_stencil_dots_{form}": (_I, _DOTS_ARGS)
       for form in ("f32", "bf16", "mixed_bf16", "mixed_f16")},
    # K-f and its bf16 form: the same with lanes before bm
    **{f"pe_batched_stencil_dots_{form}": (_I, _DOTS_ARGS[:14] + [_I]
                                           + _DOTS_ARGS[14:])
       for form in ("f32", "bf16")},
    # K-f bf16's blocks a lane: bm, bn, pad, lanes
    "pe_batched_stencil_dots_bf16_blocks": (_I, [_I] * 4),
}

# K-e and K-f bf16's march (csrc/lane_march.cuh), mirrored for the tests:
# a lane two columns, a warp a strip of LANE_STRIP columns over lane_rows
# rows (a unit), a block LANE_WARPS units of one lane
LANE_STRIP, LANE_WARPS = 64, 8
LANE_MAX_ROWS, LANE_MIN_ROWS = 16, 4
LANE_FILL_BLOCKS = 2 * 132 * 3


def lane_strips(g2: int) -> int:
    return -(-g2 // LANE_STRIP)


def lane_tiles(g1: int, pad: int, rows: int) -> int:
    """Row tiles over the extended rows 0 .. g1 - 2 + pad."""
    return -(-(g1 - 1 + pad) // rows)


def lane_blocks(g1: int, g2: int, pad: int, rows: int) -> int:
    """Blocks of one lane."""
    return -(-(lane_strips(g2) * lane_tiles(g1, pad, rows)) // LANE_WARPS)


def lane_rows(g1: int, g2: int, pad: int, lanes: int) -> int:
    """Rows a unit at the extended grid (g1, g2) with ``lanes`` lanes:
    LANE_MAX_ROWS, halved while the launch would give fewer than
    LANE_FILL_BLOCKS blocks."""
    rows = LANE_MAX_ROWS
    while (rows > LANE_MIN_ROWS
           and lane_blocks(g1, g2, pad, rows) * lanes < LANE_FILL_BLOCKS):
        rows //= 2
    return rows


def lane_dots_blocks(g1: int, g2: int, pad: int, lanes: int) -> int:
    """K-f bf16's blocks a lane (``pe_batched_stencil_dots_bf16_blocks``)."""
    return lane_blocks(g1, g2, pad, lane_rows(g1, g2, pad, lanes))


def _check_words(kernel: str, tensors) -> None:
    """Raise unless every tensor starts on a 4-byte boundary: the bf16
    lane marches load and store aligned words."""
    for t in tensors:
        if t.data_ptr() % 4:
            raise ValueError(f"{kernel}: a bf16 array starts off a 4-byte "
                             f"boundary ({t.data_ptr():#x}); the lane march "
                             "takes aligned words")


def apply_a_block_plain(w_ext, a_ext, b_ext, h1: float, h2: float):
    """The plain version of K-a in block layout: (bm+2, bn+2) → (bm, bn).
    At bf16 (K-a's bf16 form): the tree in float on the widened inputs,
    with the bf16-rounded spacings widened, rounded once to bf16."""
    hs = (spacing(h1, w_ext), spacing(h2, w_ext))
    if w_ext.dtype == torch.bfloat16:
        wide = (x.float() for x in (w_ext, a_ext, b_ext, *hs))
        return apply_a_block(*wide).to(torch.bfloat16)
    return apply_a_block(w_ext, a_ext, b_ext, *hs)


def apply_a_plain(w, a, b, h1: float, h2: float):
    """The plain version of K-a on the full grid (zero boundary ring)."""
    return F.pad(apply_a_block_plain(w, a, b, h1, h2), (1, 1, 1, 1))


def apply_a_block_kernel(w_ext, a_ext, b_ext, h1: float, h2: float):
    """A·w over a halo-extended block, (bm+2, bn+2) → (bm, bn): the port
    of ``apply_a_block_pallas``."""
    if w_ext.device.type == "cpu":
        return apply_a_block_plain(w_ext, a_ext, b_ext, h1, h2)
    return _launch(w_ext, a_ext, b_ext, h1, h2, pad=0)


def apply_a_kernel(w, a, b, h1: float, h2: float):
    """A·w on the full node grid with a zero boundary ring: the port of
    ``apply_a_pallas``. The kernel writes the ring itself."""
    if w.device.type == "cpu":
        return apply_a_plain(w, a, b, h1, h2)
    return _launch(w, a, b, h1, h2, pad=1)


def _check_stencil_inputs(kernel: str, w, a, b, lanes: bool = False) -> None:
    """Raise unless w is a float32 or bfloat16 block of at least 3x3 (a
    (B, ·, ·) stack of them with ``lanes``) and a, b are one block of its
    shape and dtype, all contiguous on one device."""
    grid = tuple(w.shape[1:]) if lanes else tuple(w.shape)
    for name, t in (("a", a), ("b", b)):
        if (t.device != w.device or t.dtype != w.dtype
                or tuple(t.shape) != grid):
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; w is {w.dtype} {tuple(w.shape)} on {w.device}"
            )
    if w.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{kernel}: the kernel runs float32 or bfloat16, "
                         f"got {w.dtype}")
    dims = 3 if lanes else 2
    if (w.dim() != dims or len(grid) != 2 or grid[0] < 3 or grid[1] < 3
            or (lanes and w.shape[0] < 1)):
        raise ValueError(f"{kernel}: need a {dims}-D "
                         f"{'stack of blocks' if lanes else 'block'} of at "
                         f"least 3x3, got {tuple(w.shape)}")
    if not (w.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: inputs must be contiguous")


def _launch(w, a, b, h1, h2, pad: int):
    _check_stencil_inputs(KERNEL, w, a, b)
    form = ws.form_of(w.dtype)
    bm, bn = w.shape[0] - 2, w.shape[1] - 2
    out = torch.empty((bm + 2 * pad, bn + 2 * pad), dtype=w.dtype,
                      device=w.device)
    lib = _build.load(KERNEL, _SIGNATURES)
    rc = getattr(lib, f"pe_stencil_{form}")(
        w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bm, bn,
        pad, rounded(h1, w.dtype), rounded(h2, w.dtype),
        _build.stream_handle(w.device),
    )
    counter = ws.counter(KERNEL, form)
    _build.check(lib.pe_stencil_error_string, counter, rc)
    _build.count_launch(counter)
    return out


def apply_a_batched_plain(w, a, b, h1: float, h2: float):
    """The plain version of K-e on full (B, M+1, N+1) grids (zero ring):
    ``batch.batched_pcg.apply_a_batched`` with the port's ``spacing``."""
    return apply_a_plain(w, a, b, h1, h2)


def apply_a_batched_block_kernel(w_ext, a_ext, b_ext, h1: float, h2: float):
    """A·w per lane over halo-extended blocks, (B, bm+2, bn+2) with
    lane-shared (bm+2, bn+2) coefficients → (B, bm, bn): the port of
    ``apply_a_batched_block_pallas``."""
    if w_ext.device.type == "cpu":
        return apply_a_block_plain(w_ext, a_ext, b_ext, h1, h2)
    return _launch_batched(w_ext, a_ext, b_ext, h1, h2, pad=0)


def apply_a_batched_kernel(w, a, b, h1: float, h2: float):
    """A·w per lane on full (B, M+1, N+1) grids with a zero ring and
    lane-shared (M+1, N+1) coefficients: the port of
    ``apply_a_batched_pallas``."""
    if w.device.type == "cpu":
        return apply_a_batched_plain(w, a, b, h1, h2)
    return _launch_batched(w, a, b, h1, h2, pad=1)


def _launch_batched(w, a, b, h1, h2, pad: int):
    """K-e; at bf16 the lane march, which takes 4-byte aligned arrays."""
    _check_stencil_inputs(BATCHED_KERNEL, w, a, b, lanes=True)
    form = ws.form_of(w.dtype)
    counter = ws.counter(BATCHED_KERNEL, form)
    if form == "bf16":
        _check_words(counter, (w, a, b))
    lanes, bm, bn = w.shape[0], w.shape[1] - 2, w.shape[2] - 2
    out = torch.empty((lanes, bm + 2 * pad, bn + 2 * pad), dtype=w.dtype,
                      device=w.device)
    lib = _build.load(KERNEL, _SIGNATURES)
    rc = getattr(lib, f"pe_batched_stencil_{form}")(
        w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes, bm,
        bn, pad, rounded(h1, w.dtype), rounded(h2, w.dtype),
        _build.stream_handle(w.device),
    )
    _build.check(lib.pe_stencil_error_string, counter, rc)
    _build.count_launch(counter)
    return out


def _pair_tuple(pairs) -> tuple:
    pairs = tuple(tuple(p) for p in pairs)
    if not pairs:
        raise ValueError("need at least one (x, y) dot pair")
    return pairs


def dot_sums_plain(pairs):
    """Σ x·y over the last two axes of each pair: each product rounded in
    the operands' dtype (in float for bf16 operands, where it is exact),
    summed in double, rounded once back through float (K-d's
    accumulation). (n_pairs,) for grids, (n_pairs, B) for lane stacks."""
    dtype = pairs[0][0].dtype
    sums = torch.stack([(ws.held(x) * ws.held(y)).double().sum(dim=(-2, -1))
                        for x, y in pairs])
    return sums.to(dtype) if dtype.itemsize >= 4 else sums.float().to(dtype)


def apply_a_block_dots_plain(w_ext, a_ext, b_ext, h1: float, h2: float,
                             pairs):
    """The plain version of K-d in block layout: (A·w over the (bm, bn)
    block, sums) with ``sums[j] = Σ xⱼ·yⱼ`` over (bm, bn) pair operands."""
    pairs = _pair_tuple(pairs)
    return (apply_a_block_plain(w_ext, a_ext, b_ext, h1, h2),
            dot_sums_plain(pairs))


def apply_a_dots_plain(w, a, b, h1: float, h2: float, pairs):
    """The plain version of K-d on the full grid: A·w with a zero ring, and
    the pair sums over the interior of full-grid operands."""
    pairs = _pair_tuple(pairs)
    cropped = tuple((x[..., 1:-1, 1:-1], y[..., 1:-1, 1:-1])
                    for x, y in pairs)
    return apply_a_plain(w, a, b, h1, h2), dot_sums_plain(cropped)


def apply_a_dots_batched_plain(w, a, b, h1: float, h2: float, pairs):
    """The plain version of K-f: per-lane A·w on (B, M+1, N+1) grids with
    a zero ring, and the (n_pairs, B) per-lane sums over the interior of
    (B, M+1, N+1) pair operands (``dot_sums_plain``)."""
    return apply_a_dots_plain(w, a, b, h1, h2, pairs)


def apply_a_block_dots_kernel(w_ext, a_ext, b_ext, h1: float, h2: float,
                              pairs):
    """A·w over a halo-extended block and the raw sums Σ xⱼ·yⱼ of
    ``pairs`` of (bm, bn) arrays in one pass: the port of
    ``apply_a_block_dots_pallas``. Returns ``(n, sums)``."""
    pairs = _pair_tuple(pairs)
    if w_ext.device.type == "cpu":
        return apply_a_block_dots_plain(w_ext, a_ext, b_ext, h1, h2, pairs)
    return _launch_dots(w_ext, a_ext, b_ext, h1, h2, pairs, pad=0)


def apply_a_dots_kernel(w, a, b, h1: float, h2: float, pairs):
    """The full-grid form of K-d: A·w with a zero ring and the raw sums
    over the interior of full-grid pair operands (which are zero on the
    ring in the solvers): the port of ``apply_a_dots_pallas``."""
    pairs = _pair_tuple(pairs)
    if w.device.type == "cpu":
        return apply_a_dots_plain(w, a, b, h1, h2, pairs)
    return _launch_dots(w, a, b, h1, h2, pairs, pad=1)


def apply_a_dots_batched_kernel(w, a, b, h1: float, h2: float, pairs):
    """Per-lane A·w and per-lane raw sums Σ xⱼ·yⱼ in one pass: the port of
    ``apply_a_dots_batched_pallas``. ``w`` is (B, M+1, N+1), ``a``/``b``
    lane-shared (M+1, N+1), each pair operand (B, M+1, N+1) and summed over
    its interior. Returns ``(Aw, sums)`` with ``sums`` of shape
    (n_pairs, B)."""
    pairs = _pair_tuple(pairs)
    if w.device.type == "cpu":
        return apply_a_dots_batched_plain(w, a, b, h1, h2, pairs)
    return _launch_dots(w, a, b, h1, h2, pairs, pad=1, lanes=True)


def distinct_operands(pairs) -> tuple[list, list, list]:
    """(operands, x index, y index): each distinct tensor of ``pairs`` once,
    by identity, in order of first use, and each pair's two indices."""
    operands, xs, ys = [], [], []
    index: dict[int, int] = {}
    for pair in pairs:
        for t, slot in zip(pair, (xs, ys)):
            if id(t) not in index:
                index[id(t)] = len(operands)
                operands.append(t)
            slot.append(index[id(t)])
    return operands, xs, ys


def _launch_dots(w, a, b, h1, h2, pairs, pad: int, lanes: bool = False,
                 symbol: str | None = None, kernel: str | None = None):
    """K-d, or with ``lanes`` K-f over the (B, ·, ·) stacks w and operands;
    or K-h, the entry ``symbol`` counted as ``kernel``, whose inputs the
    caller has checked, with every operand in a's dtype. The library runs
    the pipelined bundle's table compiled in and any other table generic;
    the sums' scratch is ``ops.scratch``'s pair for the stream, so a call
    is one kernel."""
    if kernel is None:
        kernel = ws.counter(BATCHED_DOTS_KERNEL if lanes else DOTS_KERNEL,
                            ws.form_of(w.dtype))
    if len(pairs) > MAX_PAIRS:
        raise ValueError(f"{kernel}: at most {MAX_PAIRS} pairs, got "
                         f"{len(pairs)}")
    operands, xs, ys = distinct_operands(pairs)
    if len(operands) > MAX_OPERANDS:
        raise ValueError(f"{kernel}: at most {MAX_OPERANDS} distinct "
                         f"operands, got {len(operands)}")
    if symbol is None:
        _check_stencil_inputs(kernel, w, a, b, lanes)
    bm, bn = w.shape[-2] - 2, w.shape[-1] - 2
    lead = tuple(w.shape[:1]) if lanes else ()
    x_shape = lead + (bm + 2 * pad, bn + 2 * pad)
    for t in operands:
        if (t.device != w.device or t.dtype != a.dtype
                or tuple(t.shape) != x_shape or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: a pair operand is {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous="
                f"{t.is_contiguous()}); expected contiguous {a.dtype} "
                f"{x_shape} on {w.device}")
    n_lanes = w.shape[0] if lanes else 1
    x_ld = bn + 2 * pad
    x_off = pad * (x_ld + 1)
    lib = _build.load(DOTS_KERNEL, _DOTS_SIGNATURES)
    if lanes and w.dtype == torch.bfloat16:
        # K-f bf16's lane march: its own grid, aligned words
        _check_words(kernel, (w, a, b, *operands))
        nblocks = lib.pe_batched_stencil_dots_bf16_blocks(bm, bn, pad,
                                                          n_lanes)
    else:
        nblocks = lib.pe_stencil_dots_blocks(bm, bn, pad)
    # the form's dtype: w's (f32, or bf16 for K-d's bf16 form)
    out = torch.empty(x_shape, dtype=w.dtype, device=w.device)
    sums = torch.empty((len(pairs),) + lead, dtype=w.dtype, device=w.device)
    stream = _build.stream_handle(w.device)
    # the block partials, and the last-block tickets, one a lane
    partials, ticket = scratch.sums_scratch(
        w.device, stream, len(pairs) * nblocks * n_lanes, n_lanes)
    ptrs = (ctypes.c_void_p * len(operands))(
        *(t.data_ptr() for t in operands))
    pair_x = (ctypes.c_int * len(pairs))(*xs)
    pair_y = (ctypes.c_int * len(pairs))(*ys)
    head = (w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), ptrs,
            len(operands), pair_x, pair_y, len(pairs), x_ld, x_off,
            partials.data_ptr(), ticket.data_ptr(), sums.data_ptr())
    tail = (bm, bn, pad, rounded(h1, w.dtype), rounded(h2, w.dtype), stream)
    if lanes:
        rc = getattr(lib, f"pe_batched_stencil_dots_{ws.form_of(w.dtype)}")(
            *head, n_lanes, *tail)
    else:
        symbol = symbol or f"pe_stencil_dots_{ws.form_of(w.dtype)}"
        rc = getattr(lib, symbol)(*head, *tail)
    _build.check(lib.pe_stencil_dots_error_string, kernel, rc)
    _build.count_launch(kernel)
    return out, sums


# -- the storage axis: K-g and K-h -----------------------------------------
#
# Like the JAX mixed kernels, each takes the compute dtype: its plain version
# computes in it, on the exactly upcast inputs. The CUDA kernels compute in
# f32, the width of every engine that launches them.


def _check_compute(kernel: str, compute_dtype) -> None:
    if compute_dtype != torch.float32:
        raise ValueError(f"{kernel}: the kernel computes in float32, got "
                         f"compute_dtype {compute_dtype}")


def apply_a_mixed_block_plain(w_ext, a_s, b_s, h1: float, h2: float,
                              compute_dtype=torch.float32):
    """The plain version of K-g in block layout: K-a's on the inputs upcast
    to ``compute_dtype``, (bm+2, bn+2) → (bm, bn)."""
    return apply_a_block_plain(*(x.to(compute_dtype) for x in
                                 (w_ext, a_s, b_s)), h1, h2)


def apply_a_mixed_plain(w, a_s, b_s, h1: float, h2: float,
                        compute_dtype=torch.float32):
    """The plain version of K-g on the full grid (zero ring)."""
    return apply_a_plain(*(x.to(compute_dtype) for x in (w, a_s, b_s)), h1,
                         h2)


def apply_a_mixed_block_kernel(w_ext, a_s, b_s, h1: float, h2: float,
                               compute_dtype=torch.float32):
    """Mixed A·w over a halo-extended block: w in the storage dtype or
    f32, a and b in the storage dtype (bf16 or f16), (bm+2, bn+2) →
    (bm, bn) at compute width. The port of ``apply_a_block_mixed_pallas``."""
    if w_ext.device.type == "cpu":
        return apply_a_mixed_block_plain(w_ext, a_s, b_s, h1, h2,
                                         compute_dtype)
    _check_compute(MIXED_KERNEL, compute_dtype)
    return _launch_mixed(w_ext, a_s, b_s, h1, h2, pad=0)


def apply_a_mixed_kernel(w, a_s, b_s, h1: float, h2: float,
                         compute_dtype=torch.float32):
    """The full-grid form of K-g: A·w at compute width with a zero ring,
    from narrow inputs. The port of ``apply_a_mixed_pallas``."""
    if w.device.type == "cpu":
        return apply_a_mixed_plain(w, a_s, b_s, h1, h2, compute_dtype)
    _check_compute(MIXED_KERNEL, compute_dtype)
    return _launch_mixed(w, a_s, b_s, h1, h2, pad=1)


def _check_mixed_inputs(kernel: str, w, a, b) -> str:
    """Raise unless a and b are one contiguous block of w's shape in a
    storage dtype K-g and K-h load, and w is a contiguous block of at least
    3x3 on their device in that dtype or f32. Returns the storage name."""
    st = _STORAGE_NAMES.get(a.dtype)
    if st is None or b.dtype != a.dtype:
        raise ValueError(f"{kernel}: a and b must be one of "
                         f"{sorted(map(str, _STORAGE_NAMES))}, got "
                         f"{a.dtype} and {b.dtype}")
    if w.dtype not in (a.dtype, torch.float32):
        raise ValueError(f"{kernel}: w must be {a.dtype} or float32, got "
                         f"{w.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.device != w.device or t.shape != w.shape:
            raise ValueError(
                f"{kernel}: {name} is {tuple(t.shape)} on {t.device}; w is "
                f"{tuple(w.shape)} on {w.device}")
    if w.dim() != 2 or w.shape[0] < 3 or w.shape[1] < 3:
        raise ValueError(f"{kernel}: need a 2-D block of at least 3x3, got "
                         f"{tuple(w.shape)}")
    if not (w.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: inputs must be contiguous")
    return st


def _launch_mixed(w, a, b, h1, h2, pad: int):
    st = _check_mixed_inputs(MIXED_KERNEL, w, a, b)
    w_name = "f32" if w.dtype == torch.float32 else st
    bm, bn = w.shape[0] - 2, w.shape[1] - 2
    out = torch.empty((bm + 2 * pad, bn + 2 * pad), dtype=torch.float32,
                      device=w.device)
    lib = _build.load(KERNEL, _SIGNATURES)
    rc = getattr(lib, f"pe_stencil_mixed_{w_name}_{st}")(
        w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bm, bn,
        pad, h1, h2, _build.stream_handle(w.device),
    )
    _build.check(lib.pe_stencil_error_string, MIXED_KERNEL, rc)
    _build.count_launch(MIXED_KERNEL)
    return out


def _upcast_pairs(pairs, compute_dtype) -> tuple:
    """Each pair with both operands upcast to ``compute_dtype``."""
    return tuple((x.to(compute_dtype), y.to(compute_dtype))
                 for x, y in _pair_tuple(pairs))


def apply_a_dots_mixed_block_plain(m_ext, a_s, b_s, h1: float, h2: float,
                                   pairs, compute_dtype=torch.float32):
    """The plain version of K-h in block layout: K-d's on the inputs
    upcast to ``compute_dtype``, each product rounded there, summed in
    double, rounded once."""
    return apply_a_block_dots_plain(
        *(x.to(compute_dtype) for x in (m_ext, a_s, b_s)), h1, h2,
        _upcast_pairs(pairs, compute_dtype))


def apply_a_dots_mixed_plain(m, a_s, b_s, h1: float, h2: float, pairs,
                             compute_dtype=torch.float32):
    """The plain version of K-h on the full grid."""
    return apply_a_dots_plain(*(x.to(compute_dtype) for x in (m, a_s, b_s)),
                              h1, h2, _upcast_pairs(pairs, compute_dtype))


def apply_a_block_dots_mixed_kernel(m_ext, a_s, b_s, h1: float, h2: float,
                                    pairs, compute_dtype=torch.float32):
    """Mixed A·m over a halo-extended block and the raw sums Σ xⱼ·yⱼ of
    ``pairs`` of (bm, bn) storage-dtype arrays in one pass, at compute
    width: the port of ``apply_a_block_dots_mixed_pallas``. Returns
    ``(n, sums)``."""
    pairs = _pair_tuple(pairs)
    if m_ext.device.type == "cpu":
        return apply_a_dots_mixed_block_plain(m_ext, a_s, b_s, h1, h2, pairs,
                                              compute_dtype)
    return _launch_dots_mixed(m_ext, a_s, b_s, h1, h2, pairs, 0,
                              compute_dtype)


def apply_a_dots_mixed_kernel(m, a_s, b_s, h1: float, h2: float, pairs,
                              compute_dtype=torch.float32):
    """The full-grid form of K-h: A·m with a zero ring and the raw sums
    over the interior of full-grid storage-dtype pair operands, at
    compute width: the port of ``apply_a_dots_mixed_pallas``."""
    pairs = _pair_tuple(pairs)
    if m.device.type == "cpu":
        return apply_a_dots_mixed_plain(m, a_s, b_s, h1, h2, pairs,
                                        compute_dtype)
    return _launch_dots_mixed(m, a_s, b_s, h1, h2, pairs, 1, compute_dtype)


def _launch_dots_mixed(m, a, b, h1, h2, pairs, pad: int, compute_dtype):
    _check_compute(MIXED_DOTS_KERNEL, compute_dtype)
    if m.dtype != torch.float32:
        raise ValueError(f"{MIXED_DOTS_KERNEL}: the stencil input must be "
                         f"float32, got {m.dtype}")
    st = _check_mixed_inputs(MIXED_DOTS_KERNEL, m, a, b)
    return _launch_dots(m, a, b, h1, h2, pairs, pad,
                        symbol=f"pe_stencil_dots_mixed_{st}",
                        kernel=MIXED_DOTS_KERNEL)
