"""Carry the JAX package's state into the port, so both compute on the
same inputs: operands, and the classical, pipelined and batched carries.

The arguments are numpy arrays (or anything ``numpy.asarray`` accepts,
such as a JAX array): this module imports neither JAX nor the JAX
package. A narrow carry (the storage axis) keeps its dtype: JAX's bf16
arrays reach numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
does not take, so they cross bit for bit as 16-bit words
(``tensor_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.utils.device import resolve_device


# numpy's names of the 2-byte floats, and their torch dtypes
_NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def tensor_from_numpy(x) -> torch.Tensor:
    """A writable CPU tensor holding ``x``'s values in its own dtype. A
    bf16 or f16 array is carried across bit for bit through its 16-bit
    words, since numpy's bfloat16 (``ml_dtypes``) has no torch
    counterpart that ``torch.from_numpy`` accepts."""
    x = np.array(x)  # a writable copy, 0-dim kept
    narrow = _NARROW.get(x.dtype.name)
    if narrow is not None:
        return torch.from_numpy(x.view(np.uint16)).view(narrow)
    return torch.from_numpy(x)


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
    return _stripped(problem, coeffs, device, dtype)


def _stripped(problem: Problem, arrays, device, dtype) -> tuple:
    """Each of ``arrays`` without its zero padding, on ``device``, in its
    own dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    out = []
    for x in arrays:
        t = torch.from_numpy(np.ascontiguousarray(strip_padding(problem, x)))
        t = t.to(dev)
        out.append(t if dtype is None else t.to(dtype))
    return tuple(out)


def streamed_operands_from_reference(problem: Problem, operands, *,
                                     device=None, dtype=None):
    """The streamed and xl engines' (dinv, an, bw, r0) from JAX's
    ``streamed_operand_set``: there each array is zero-padded to (g1p, g2p)
    and an carries 8 more padded rows
    (``poisson_ellipse_tpu/ops/streamed_pcg.py:538-571``). The padding is
    stripped after checking it holds only zeros; the values are kept in
    their dtype unless ``dtype`` is given."""
    if len(operands) != 4:
        raise ValueError("expected (dinv, an, bw, r0)")
    return _stripped(problem, operands, device, dtype)


_FLAGS = ("converged", "breakdown", "quarantined")


def _carry(state, names, problem: Problem, device, dtype) -> dict:
    """The fields of a JAX carry tuple as tensors on ``device``: the
    iteration counter k and the per-lane counts ``iters`` as int32, the
    flags as bool (0-dim, or (B,) in a batched carry), the (M+1, N+1) or
    (B, M+1, N+1) arrays and the scalars in their own dtype unless
    ``dtype`` is given; a narrow (bf16 or f16) array keeps its dtype
    whatever ``dtype`` says, so a stored carry resumes with its bits."""
    state = tuple(state)
    if len(state) != len(names):
        raise ValueError(f"expected a {len(names)}-field carry "
                         f"{names}, got {len(state)} fields")
    dev = resolve_device(device)
    out = {}
    for name, x in zip(names, state):
        x = np.asarray(x)
        if name == "k":
            t = torch.tensor(int(x), dtype=torch.int32)
        elif name == "iters":
            t = torch.from_numpy(np.array(x, dtype=np.int32))
        elif name in _FLAGS:
            t = torch.from_numpy(np.array(x, dtype=bool))
        else:
            if x.ndim >= 2 and x.shape[-2:] != problem.node_shape:
                raise ValueError(f"{name} is {x.shape}, expected "
                                 f"{problem.node_shape}")
            t = tensor_from_numpy(x)
            if dtype is not None and t.dtype not in _NARROW.values():
                t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def pipelined_state_from_reference(problem: Problem, state, *, device=None,
                                   dtype=None):
    """The port's ``PipelinedState`` from the JAX pipelined carry
    (k, x, r, u, w, z, s, p, γ₋₁, diff, converged, breakdown), so the port
    can advance a carry the JAX package began (a narrow one too: advance
    it with the same ``storage_dtype``)."""
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import PipelinedState

    return PipelinedState(**_carry(state, PipelinedState._fields, problem,
                                   device, dtype))


def pcg_state_from_reference(problem: Problem, state, *, device=None,
                             dtype=None):
    """The port's ``PCGState`` from the JAX classical carry
    (k, x, r, p, zr, diff, converged, breakdown), which the s-step engine
    shares; a narrow carry keeps its storage dtype."""
    from poisson_ellipse_tpu_torch.solver.pcg import PCGState

    return PCGState(**_carry(state, PCGState._fields, problem, device,
                             dtype))


def batched_state_from_reference(problem: Problem, state, engine: str, *,
                                 device=None, dtype=None):
    """The port's batched carry from the JAX one, so the port can advance
    a batched carry the JAX package began: for ``engine`` "batched" (or
    "batched-pallas") a ``BatchedPCGState`` from (k, w, r, p, zr, diff,
    converged, breakdown, quarantined, iters); for "batched-pipelined" (or
    its "-pallas" form) a ``BatchedPipelinedState`` from the 14-field
    carry. Flags become (B,) bool, iters (B,) int32; narrow lane fields
    keep their storage dtype."""
    from poisson_ellipse_tpu_torch.batch.batched_pcg import BatchedPCGState
    from poisson_ellipse_tpu_torch.batch.batched_pipelined import (
        BatchedPipelinedState,
    )

    states = {"batched": BatchedPCGState,
              "batched-pipelined": BatchedPipelinedState}
    cls = states.get(engine.removesuffix("-pallas"))
    if cls is None:
        raise ValueError(f"unknown batched engine {engine!r} (one of "
                         f"{sorted(states)} or their -pallas forms)")
    return cls(**_carry(state, cls._fields, problem, device, dtype))
