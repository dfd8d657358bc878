"""5-point variable-coefficient stencil and diagonal preconditioner (L3).

The plain PyTorch forms of ``poisson_ellipse_tpu.ops.stencil``, in the
same two layouts:

- **global**: the full (M+1, N+1) node grid; the stencil writes the
  interior and leaves the boundary ring at zero;
- **block**: one halo-extended (bm+2, bn+2) block → (bm, bn) output.

Every function indexes the last two axes only, so a leading lane axis
(B, ·, ·) rides through unchanged: the lane-batched engines (``batch``)
call the same expressions with (B, g1, g2) iterates, (g1, g2) or
(B, g1, g2) coefficients and scalar or (B, 1, 1) spacings.

The floating-point tree is the reference's, term for term: each
difference is divided by h before the terms are combined
(``stage0/Withoutopenmp1.cpp:83-85``). ``h1``/``h2`` are 0-dim tensors on
the operands' device (``spacing``): a Python float divisor would let
PyTorch's CUDA division multiply by a rounded reciprocal instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def spacing(h: float, like: torch.Tensor) -> torch.Tensor:
    """``h`` rounded to ``like``'s dtype, as a 0-dim tensor on its device."""
    return torch.tensor(h, dtype=like.dtype, device=like.device)


# the dtypes numpy rounds to on the host as torch does (a C cast)
_HOST_ROUND = {torch.float32: np.float32, torch.float64: float}


def rounded(h: float, dtype: torch.dtype) -> float:
    """``h`` rounded to ``dtype``, as ``spacing`` rounds it, as a Python
    float: the spacing a kernel launch takes, read from no device. Kernel
    wrappers call this on every launch, so f32 and f64 round without
    building a tensor."""
    cast = _HOST_ROUND.get(dtype)
    if cast is not None:
        return float(cast(h))
    return float(torch.tensor(h, dtype=dtype))


def apply_a(w, a, b, h1, h2):
    """A·w on the full node grid; boundary ring stays zero."""
    return F.pad(apply_a_block(w, a, b, h1, h2), (1, 1, 1, 1))


def apply_a_block(w_ext, a_ext, b_ext, h1, h2):
    """A·w over one halo-extended block: (bm+2, bn+2) inputs → (bm, bn).

    (Aw)_ij = −(a_{i+1,j}(w_{i+1,j}−w_ij)/h1 − a_ij(w_ij−w_{i−1,j})/h1)/h1
              −(b_{i,j+1}(w_{i,j+1}−w_ij)/h2 − b_ij(w_ij−w_{i,j−1})/h2)/h2
    """
    wc = w_ext[..., 1:-1, 1:-1]
    ax = -(
        a_ext[..., 2:, 1:-1] * (w_ext[..., 2:, 1:-1] - wc) / h1
        - a_ext[..., 1:-1, 1:-1] * (wc - w_ext[..., :-2, 1:-1]) / h1
    ) / h1
    ay = -(
        b_ext[..., 1:-1, 2:] * (w_ext[..., 1:-1, 2:] - wc) / h2
        - b_ext[..., 1:-1, 1:-1] * (wc - w_ext[..., 1:-1, :-2]) / h2
    ) / h2
    return ax + ay


def diag_d(a, b, h1, h2):
    """Diagonal of A on the full node grid, zero on the boundary ring:
    D_ij = (a_{i+1,j} + a_ij)/h1² + (b_{i,j+1} + b_ij)/h2²."""
    return F.pad(diag_d_block(a, b, h1, h2), (1, 1, 1, 1))


def diag_d_block(a_ext, b_ext, h1, h2):
    """Diagonal of A over one halo-extended block → (bm, bn)."""
    return (a_ext[..., 2:, 1:-1] + a_ext[..., 1:-1, 1:-1]) / (h1 * h1) + (
        b_ext[..., 1:-1, 2:] + b_ext[..., 1:-1, 1:-1]
    ) / (h2 * h2)


def apply_dinv(r, d):
    """z = r / D, with z = 0 where D == 0 (``stage0/Withoutopenmp1.cpp:100``).
    The explicit division keeps bitwise agreement with ``r[i][j] / D_ij``."""
    nonzero = d != 0.0
    safe = torch.where(nonzero, d, torch.ones_like(d))
    return torch.where(nonzero, r / safe, torch.zeros_like(r))
