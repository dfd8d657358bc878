"""Fictitious-domain coefficient assembly (reference layer L1).

The port keeps the reference's contract: per-edge diffusion coefficients
a_ij (vertical faces), b_ij (horizontal faces) and the indicator RHS B_ij
are evaluated on the host in float64 and cast once to the solve dtype
(``stage0/Withoutopenmp1.cpp:42-61``; ``poisson_mpi_cuda2.cu:146-192``).

Coefficient law (``stage0/Withoutopenmp1.cpp:53-54``):
    a_ij = 1                         face fully inside D  (|l − h2| < 1e-9)
         = 1/eps                     face fully outside   (l < 1e-9)
         = l/h2 + (1 − l/h2)/eps     cut face (length-weighted blend)
with eps = max(h1,h2)² by default, and symmetrically for b with h1.

Only the closed-form ellipse is ported in this slice; the SDF geometry
path (``geometry=``) is ROADMAP Queue A item 11.
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models import ellipse
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# Tolerances from the reference's blend law (stage0/Withoutopenmp1.cpp:53-54).
_FULL_TOL = 1e-9
_EMPTY_TOL = 1e-9


def _blend(length, h, eps, xp=np):
    """Piecewise coefficient law for one face of length-in-D ``length``."""
    frac = length / h
    cut = frac + (1.0 - frac) / eps
    return xp.where(
        xp.abs(length - h) < _FULL_TOL,
        1.0,
        xp.where(length < _EMPTY_TOL, 1.0 / eps, cut),
    )


def _coefficients_xp(problem: Problem, x, y, xp=np):
    """The blend law applied to the segment closed forms at node
    coordinates x × y (1-D arrays of the module ``xp``)."""
    h1, h2 = problem.h1, problem.h2
    eps = problem.eps_value
    xc = x[:, None]
    yc = y[None, :]
    la = ellipse.segment_length_vertical(
        xc - 0.5 * h1, yc - 0.5 * h2, yc + 0.5 * h2, xp
    )
    lb = ellipse.segment_length_horizontal(
        yc - 0.5 * h2, xc - 0.5 * h1, xc + 0.5 * h1, xp
    )
    return _blend(la, h2, eps, xp), _blend(lb, h1, eps, xp)


def assemble_numpy(problem: Problem):
    """(a, b, rhs) as float64 numpy arrays of shape (M+1, N+1).

    The geometry is evaluated in f64 whatever the solve dtype: the
    cut-face blend amplifies noise in l/h by 1/eps, which in f32 gives
    O(10) errors on fine grids. Row/col 0 of a, b are zero, as in the
    reference's zero-initialised arrays.
    """
    M, N = problem.M, problem.N
    gi = np.arange(M + 1, dtype=np.float64)
    gj = np.arange(N + 1, dtype=np.float64)
    x = problem.a1 + gi * problem.h1
    y = problem.a2 + gj * problem.h2
    a, b = _coefficients_xp(problem, x, y, np)
    inside = ellipse.is_in_d(x[:, None], y[None, :])

    valid = ((gi >= 1) & (gi <= M))[:, None] & ((gj >= 1) & (gj <= N))[None, :]
    a = np.where(valid, a, 0.0)
    b = np.where(valid, b, 0.0)

    interior = ((gi >= 1) & (gi <= M - 1))[:, None] & (
        (gj >= 1) & (gj <= N - 1)
    )[None, :]
    rhs = np.where(inside & interior, problem.f_val, 0.0)
    return a, b, rhs


def to_device(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """One host array rounded to ``dtype`` as the JAX package's numpy
    ``astype`` rounds it, and copied to ``device``.

    numpy has no bfloat16; the JAX package's ``astype`` goes through
    ml_dtypes, which rounds f64 to bf16 through f32 (1 + 2⁻⁸ + 2⁻³⁰ gives
    1.0, where one rounding from f64 gives 1 + 2⁻⁷). PyTorch's cast from an
    f64 tensor rounds the same way, so bf16 takes it; every other dtype
    is numpy's own ``astype``, one rounding from f64."""
    x = np.ascontiguousarray(x)
    if dtype == torch.bfloat16:
        return torch.from_numpy(x).to(dtype).to(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(np.ascontiguousarray(x.astype(np_dtype))).to(device)


def assemble(problem: Problem, dtype: torch.dtype = torch.float32,
             device=None):
    """(a, b, rhs) on ``device`` (cuda unless ``device='cpu'``) in
    ``dtype``: the f64 host assembly cast once, exactly as the reference
    assembles on the CPU before uploading (``poisson_mpi_cuda2.cu:716-759``)."""
    dev = resolve_device(device)
    return tuple(to_device(x, dtype, dev) for x in assemble_numpy(problem))
