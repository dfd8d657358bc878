"""Grid-weighted reductions (reference layer L3, reduction side).

The reference's ``dot`` is the h1·h2-weighted inner product over interior
nodes (``stage0/Withoutopenmp1.cpp:64-72``). Every iterate is kept exactly
zero outside the interior, so the sum over the whole array equals the
interior sum. Results stay on the device as 0-dim tensors: no host sync.
"""

from __future__ import annotations

import torch


def grid_dot(u, v, h1, h2):
    """(u, v) = h1·h2 · Σ u_ij v_ij (interior; arrays are zero elsewhere)."""
    return torch.sum(u * v) * h1 * h2


def grid_sumsq(u):
    """Unweighted Σ u², the stage0 convergence-norm convention."""
    return torch.sum(u * u)


def grid_dots(*pairs):
    """All Σ uᵢ·vᵢ of ``pairs`` as one stacked (k,) tensor (raw sums;
    callers apply their h1·h2 weights)."""
    return torch.stack([torch.sum(u * v) for u, v in pairs])
