"""Accuracy against the analytic control solution u = (1 − x² − 4y²)/10.

The discrete L2 norm, h1·h2-weighted over nodes strictly inside D (the
fictitious exterior carries O(eps) values by design), and the weighted
residual norm as a solver-independent check.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models import ellipse
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.reduction import grid_dot
from poisson_ellipse_tpu_torch.ops.stencil import apply_a, spacing


def _node_coords(problem: Problem, like: torch.Tensor):
    gi = torch.arange(problem.M + 1, dtype=like.dtype, device=like.device)
    gj = torch.arange(problem.N + 1, dtype=like.dtype, device=like.device)
    x = problem.a1 + gi * spacing(problem.h1, like)
    y = problem.a2 + gj * spacing(problem.h2, like)
    return x[:, None], y[None, :]


def l2_error_vs_analytic(problem: Problem, w: torch.Tensor) -> torch.Tensor:
    """sqrt( h1·h2 · Σ_{nodes in D} (w_ij − u(x_i, y_j))² )."""
    x, y = _node_coords(problem, w)
    u = ellipse.analytic_solution(x, y)
    in_d = ellipse.is_in_d(x, y)
    err2 = torch.where(in_d, (w - u) ** 2, torch.zeros_like(w))
    return torch.sqrt(torch.sum(err2) * problem.h1 * problem.h2)


def residual_norm(problem: Problem, w, a, b, rhs) -> torch.Tensor:
    """‖B − A·w‖ in the grid-weighted norm."""
    h1, h2 = spacing(problem.h1, w), spacing(problem.h2, w)
    r = rhs - apply_a(w, a, b, h1, h2)
    return torch.sqrt(grid_dot(r, r, h1, h2))
