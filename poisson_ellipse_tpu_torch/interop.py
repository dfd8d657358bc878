"""Carry the JAX package's state into the port, so both compute on the
same inputs.

The arguments are numpy arrays (or anything ``numpy.asarray`` accepts,
such as a JAX array): this module imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.utils.device import resolve_device


def strip_padding(problem: Problem, x) -> np.ndarray:
    """The (M+1, N+1) node grid of an array the TPU padded to (g1p, g2p)."""
    x = np.asarray(x)
    g1, g2 = problem.node_shape
    if x.shape[0] < g1 or x.shape[1] < g2:
        raise ValueError(
            f"array {x.shape} is smaller than the node grid {(g1, g2)}"
        )
    if np.any(x[g1:]) or np.any(x[:, g2:]):
        raise ValueError("the padding outside the node grid is not zero")
    return x[:g1, :g2]


def operands_from_reference(problem: Problem, a, b, rhs, *, device=None,
                            dtype=torch.float64):
    """(a, b, rhs) on ``device`` from the JAX package's assembled arrays
    (``assembly.assemble_numpy`` there), cast once to ``dtype``."""
    dev = resolve_device(device)
    out = []
    for name, x in (("a", a), ("b", b), ("rhs", rhs)):
        x = np.asarray(x)
        if x.shape != problem.node_shape:
            raise ValueError(f"{name} is {x.shape}, expected "
                             f"{problem.node_shape}")
        out.append(assembly.to_device(x, dtype, dev))
    return tuple(out)


def fused_operands_from_reference(problem: Problem, coeffs, *, device=None,
                                  dtype=None):
    """The fused engine's (an, as_, bw, be, d, dinv) from JAX's operand set,
    padded to (g1p, g2p) there: the TPU padding is stripped (it holds only
    zeros, ``poisson_ellipse_tpu/ops/fused_pcg.py:209-214``), and the values
    are kept in their dtype unless ``dtype`` is given."""
    if len(coeffs) != 6:
        raise ValueError("expected (an, as_, bw, be, d, dinv)")
    dev = resolve_device(device)
    out = []
    for x in coeffs:
        x = strip_padding(problem, x)
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out.append(t if dtype is None else t.to(dtype))
    return tuple(out)
