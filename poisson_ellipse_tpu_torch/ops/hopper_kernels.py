"""Hand-written Hopper kernels for the per-op PCG path, with plain twins.

The counterpart of ``poisson_ellipse_tpu.ops.pallas_kernels``. Two of its
kernels are ported:

- ``_stencil_kernel`` as K-a (``csrc/stencil.cu``): the ``pallas``
  engine's loop runs it once per iteration, the ``pipelined-pallas``
  engine for w₀ and its residual replacements, ``sstep-pallas`` in its
  basis chain;
- ``_stencil_dots_kernel`` as K-d (``csrc/stencil_dots.cu``): the stencil
  fused with up to eight dot products, the ``pipelined-pallas`` engine's
  one pass per iteration.

The other kernels of that module are still queued (ROADMAP Queue B).

Each wrapper takes the plain PyTorch version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops.stencil import apply_a_block, spacing

KERNEL = "stencil"
DOTS_KERNEL = "stencil_dots"

# K-d takes at most this many distinct pair operands and pairs
MAX_OPERANDS = 8
MAX_PAIRS = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pe_stencil_error_string": (ctypes.c_char_p, [_I]),
    "pe_stencil_f32": (_I, [_P] * 4 + [_I] * 3 + [_F, _F, _P]),
}
_DOTS_SIGNATURES = {
    "pe_stencil_dots_error_string": (ctypes.c_char_p, [_I]),
    "pe_stencil_dots_blocks": (_I, [_I] * 3),
    # w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
    # x_off, partials, ticket, sums, bm, bn, pad, h1, h2, stream
    "pe_stencil_dots_f32": (_I, [_P] * 5 + [_I] + [_P] * 2 + [_I] * 3
                            + [_P] * 3 + [_I] * 3 + [_F, _F, _P]),
}


def apply_a_block_plain(w_ext, a_ext, b_ext, h1: float, h2: float):
    """The plain version of K-a in block layout: (bm+2, bn+2) → (bm, bn)."""
    return apply_a_block(
        w_ext, a_ext, b_ext, spacing(h1, w_ext), spacing(h2, w_ext)
    )


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


def _check_stencil_inputs(kernel: str, w, a, b) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device != w.device or t.dtype != w.dtype or t.shape != w.shape:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; w is {w.dtype} {tuple(w.shape)} on {w.device}"
            )
    if w.dtype != torch.float32:
        raise ValueError(f"{kernel}: the kernel runs float32, got {w.dtype}")
    if w.dim() != 2 or w.shape[0] < 3 or w.shape[1] < 3:
        raise ValueError(f"{kernel}: need a 2-D block of at least 3x3, got "
                         f"{tuple(w.shape)}")
    if not (w.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: inputs must be contiguous")


def _launch(w, a, b, h1, h2, pad: int):
    _check_stencil_inputs(KERNEL, w, a, b)
    bm, bn = w.shape[0] - 2, w.shape[1] - 2
    out = torch.empty((bm + 2 * pad, bn + 2 * pad), dtype=w.dtype,
                      device=w.device)
    lib = _build.load(KERNEL, _SIGNATURES)
    rc = lib.pe_stencil_f32(
        w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bm, bn,
        pad, h1, h2, _build.stream_handle(w.device),
    )
    _build.check(lib.pe_stencil_error_string, KERNEL, rc)
    _build.count_launch(KERNEL)
    return out


def _pair_tuple(pairs) -> tuple:
    pairs = tuple(tuple(p) for p in pairs)
    if not pairs:
        raise ValueError("need at least one (x, y) dot pair")
    return pairs


def dot_sums_plain(pairs):
    """Σ x·y of each pair: each product rounded in the operands' dtype,
    summed in double, rounded once back (K-d's accumulation)."""
    return torch.stack([(x * y).double().sum() for x, y in pairs]).to(
        pairs[0][0].dtype)


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
    cropped = tuple((x[1:-1, 1:-1], y[1:-1, 1:-1]) for x, y in pairs)
    return apply_a_plain(w, a, b, h1, h2), dot_sums_plain(cropped)


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


def _launch_dots(w, a, b, h1, h2, pairs, pad: int):
    if len(pairs) > MAX_PAIRS:
        raise ValueError(f"{DOTS_KERNEL}: at most {MAX_PAIRS} pairs, got "
                         f"{len(pairs)}")
    operands, xs, ys = distinct_operands(pairs)
    if len(operands) > MAX_OPERANDS:
        raise ValueError(f"{DOTS_KERNEL}: at most {MAX_OPERANDS} distinct "
                         f"operands, got {len(operands)}")
    _check_stencil_inputs(DOTS_KERNEL, w, a, b)
    bm, bn = w.shape[0] - 2, w.shape[1] - 2
    x_shape = (bm + 2 * pad, bn + 2 * pad)
    for t in operands:
        if (t.device != w.device or t.dtype != w.dtype
                or tuple(t.shape) != x_shape or not t.is_contiguous()):
            raise ValueError(
                f"{DOTS_KERNEL}: a pair operand is {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous="
                f"{t.is_contiguous()}); expected contiguous {w.dtype} "
                f"{x_shape} on {w.device}")
    x_ld = bn + 2 * pad
    x_off = pad * (x_ld + 1)
    lib = _build.load(DOTS_KERNEL, _DOTS_SIGNATURES)
    nblocks = lib.pe_stencil_dots_blocks(bm, bn, pad)
    out = torch.empty(x_shape, dtype=w.dtype, device=w.device)
    sums = torch.empty(len(pairs), dtype=w.dtype, device=w.device)
    partials = torch.empty(len(pairs) * nblocks, dtype=torch.float64,
                           device=w.device)
    # the last-block ticket: 0 before the launch
    ticket = torch.zeros(1, dtype=torch.int32, device=w.device)
    ptrs = (ctypes.c_void_p * len(operands))(
        *(t.data_ptr() for t in operands))
    pair_x = (ctypes.c_int * len(pairs))(*xs)
    pair_y = (ctypes.c_int * len(pairs))(*ys)
    rc = lib.pe_stencil_dots_f32(
        w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), ptrs,
        len(operands), pair_x, pair_y, len(pairs), x_ld, x_off,
        partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(), bm, bn,
        pad, h1, h2, _build.stream_handle(w.device),
    )
    _build.check(lib.pe_stencil_dots_error_string, DOTS_KERNEL, rc)
    _build.count_launch(DOTS_KERNEL)
    return out, sums
