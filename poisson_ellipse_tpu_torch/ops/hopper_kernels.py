"""Hand-written Hopper kernels for the per-op PCG path, with plain twins.

The counterpart of ``poisson_ellipse_tpu.ops.pallas_kernels``. This slice
ports its stencil, ``_stencil_kernel``, as the CUDA kernel K-a
(``csrc/stencil.cu``); the ``pallas`` engine's loop runs it once per
iteration. The other kernels of that module are still queued (ROADMAP
Queue B).

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

_SIGNATURES = {
    "pe_stencil_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    "pe_stencil_f32": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]),
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


def _launch(w, a, b, h1, h2, pad: int):
    for name, t in (("a", a), ("b", b)):
        if t.device != w.device or t.dtype != w.dtype or t.shape != w.shape:
            raise ValueError(
                f"stencil: {name} is {t.dtype} {tuple(t.shape)} on {t.device}"
                f"; w is {w.dtype} {tuple(w.shape)} on {w.device}"
            )
    if w.dtype != torch.float32:
        raise ValueError(f"stencil: the kernel runs float32, got {w.dtype}")
    if w.dim() != 2 or w.shape[0] < 3 or w.shape[1] < 3:
        raise ValueError(f"stencil: need a 2-D block of at least 3x3, got "
                         f"{tuple(w.shape)}")
    if not (w.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("stencil: inputs must be contiguous")
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
