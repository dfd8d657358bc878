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

The global-index forms (``coefficients_at``, ``rhs_at``, ``interior_mask``)
evaluate the same law at any outer product of global node indices in the
tensors' own dtype, on their device: a rank of the mesh assembles its
halo-extended block with them and no communication
(``fictitious_regions_setup_local``, ``poisson_mpi_cuda2.cu:146-192``).
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


def to_host(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """One host array rounded to ``dtype`` as the JAX package's numpy
    ``astype`` rounds it, as a host tensor.

    numpy has no bfloat16; the JAX package's ``astype`` goes through
    ml_dtypes, which rounds f64 to bf16 through f32 (1 + 2⁻⁸ + 2⁻³⁰ gives
    1.0, where one rounding from f64 gives 1 + 2⁻⁷). PyTorch's cast from an
    f64 tensor rounds the same way, so bf16 takes it; every other dtype
    is numpy's own ``astype``, one rounding from f64."""
    x = np.ascontiguousarray(x)
    if dtype == torch.bfloat16:
        return torch.from_numpy(x).to(dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(np.ascontiguousarray(x.astype(np_dtype)))


def to_device(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """One host array rounded to ``dtype`` (``to_host``) and copied to
    ``device``."""
    return to_host(x, dtype).to(device)


def assemble(problem: Problem, dtype: torch.dtype = torch.float32,
             device=None):
    """(a, b, rhs) on ``device`` (cuda unless ``device='cpu'``) in
    ``dtype``: the f64 host assembly cast once, exactly as the reference
    assembles on the CPU before uploading (``poisson_mpi_cuda2.cu:716-759``)."""
    dev = resolve_device(device)
    return tuple(to_device(x, dtype, dev) for x in assemble_numpy(problem))


def _node_coordinates(problem: Problem, gi, gj, dtype):
    """x_i, y_j at the global indices, formed in ``dtype`` as the JAX
    package forms them: a + index·h with h rounded to ``dtype``."""
    h1 = torch.tensor(problem.h1, dtype=dtype, device=gi.device)
    h2 = torch.tensor(problem.h2, dtype=dtype, device=gj.device)
    return problem.a1 + gi.to(dtype) * h1, problem.a2 + gj.to(dtype) * h2


def coefficients_at(problem: Problem, gi, gj, dtype=torch.float64):
    """(a, b) at the outer product of global node indices gi × gj (1-D
    integer tensors), in ``dtype`` on their device.

    a[i,j] lives on the vertical face x = x_i − h1/2, y ∈ [y_j − h2/2,
    y_j + h2/2]; b[i,j] on the horizontal face y = y_j − h2/2
    (``stage0/Withoutopenmp1.cpp:49-54``). Valid for 1 ≤ gi ≤ M,
    1 ≤ gj ≤ N; indices outside (the boundary ring, the mesh padding) give
    0, as the reference's zero-initialised arrays hold."""
    x, y = _node_coordinates(problem, gi, gj, dtype)
    a, b = _coefficients_xp(problem, x, y, torch)
    valid = (((gi >= 1) & (gi <= problem.M))[:, None]
             & ((gj >= 1) & (gj <= problem.N))[None, :])
    zero = torch.zeros((), dtype=dtype, device=gi.device)
    return torch.where(valid, a, zero), torch.where(valid, b, zero)


def rhs_at(problem: Problem, gi, gj, dtype=torch.float64):
    """The indicator right-hand side at gi × gj: f_val at interior nodes
    strictly inside the ellipse, else 0 (``stage0/Withoutopenmp1.cpp:57-60``)."""
    x, y = _node_coordinates(problem, gi, gj, dtype)
    inside = ellipse.is_in_d(x[:, None], y[None, :])
    interior = interior_mask(problem, gi, gj)
    return torch.where(
        inside & interior,
        torch.tensor(problem.f_val, dtype=dtype, device=gi.device),
        torch.zeros((), dtype=dtype, device=gi.device))


def interior_mask(problem: Problem, gi, gj):
    """The mask of interior nodes 1 ≤ gi ≤ M−1, 1 ≤ gj ≤ N−1 at gi × gj."""
    return (((gi >= 1) & (gi <= problem.M - 1))[:, None]
            & ((gj >= 1) & (gj <= problem.N - 1))[None, :])
