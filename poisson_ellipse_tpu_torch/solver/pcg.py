"""Single-device preconditioned conjugate gradients with the scalar
recurrence on the device.

The counterpart of ``poisson_ellipse_tpu.solver.pcg``. JAX keeps α, β and
the stopping rule inside one ``lax.while_loop``; an eager PyTorch loop that
tested ``diff < delta`` in Python would wait for the device on every
iteration (the stage-4 flaw). Here instead:

- the carry (k, w, r, p, zr, diff, converged, breakdown) is device
  tensors, and the loop condition is a device boolean ``active``;
- the host issues a chunk of iterations and reads the three flags once per
  chunk (``run_chunked``);
- a body entered after the loop has exited is a no-op: α is forced to 0,
  which leaves w and r bitwise unchanged, p and zr are held, and k only
  advances while the loop is active. So the iteration count is exact and
  a chunked run equals a straight run.

Semantics, in order (``stage0/Withoutopenmp1.cpp:124-169``):
  1. Ap = A·p;  denom = (Ap, p);  breakdown-exit if denom < 1e-15
  2. α = zr/denom;  w += αp;  r −= αAp
  3. z = D⁻¹r;  zr_new = (z, r)
  4. diff = ‖w^{k+1} − w^k‖ from the realised update; converged if < δ
  5. β = zr_new/zr;  p = z + βp
A breakdown iteration keeps its pre-update iterates.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.reduction import grid_dot, grid_dots
from poisson_ellipse_tpu_torch.ops.stencil import (
    apply_a,
    apply_dinv,
    diag_d,
    spacing,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# PCG breakdown guard on the (Ap, p) denominator (stage0/Withoutopenmp1.cpp:128).
DENOM_GUARD = 1e-15

# iterations issued between two host reads of the loop's flags
DEFAULT_CHUNK = 64

STENCILS = ("xla", "pallas")


class PCGResult(NamedTuple):
    """Solver output: solution grid, iterations, final step-norm, exit flags
    (0-dim device tensors, as the JAX package returns device arrays)."""

    w: torch.Tensor
    iters: torch.Tensor
    diff: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor


class PCGState(NamedTuple):
    """The resumable carry: everything the loop needs to continue."""

    k: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    zr: torch.Tensor
    diff: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor


class Solver:
    """A built solve: ``solver(*args)`` returns a ``PCGResult``;
    ``host_syncs`` is the number of host reads the last call made."""

    def __init__(self, run: Callable):
        self._run = run
        self.host_syncs = 0

    def __call__(self, *args) -> PCGResult:
        result, self.host_syncs = self._run(*args)
        return result


def unported(option: str, item: str):
    """The error for an option this slice of the port does not cover;
    ``item`` names the ROADMAP.md entry that will port it."""
    return NotImplementedError(
        f"{option} is not ported to PyTorch yet (ROADMAP.md {item})"
    )


def reject_unported(history=False, precond=None, storage_dtype=None,
                    x0=None, recycle=None, geometry=None,
                    lanes: int = 1) -> None:
    """Raise for any option this slice does not port, naming the
    ROADMAP.md item that will."""
    if geometry is not None:
        raise unported("geometry=", "Queue A item 11")
    if lanes != 1:
        raise unported("lanes>1", "Queue A item 10")
    if history:
        raise unported("history=", "Queue A item 8")
    if precond is not None:
        raise unported("precond=", "Queue A item 11")
    if storage_dtype is not None:
        raise unported("storage_dtype=", "Queue A item 17")
    if x0 is not None or recycle:
        raise unported("x0=/recycle=", "Queue A item 13")


def run_chunked(step: Callable[[int], None],
                flags: Callable[[], torch.Tensor], limit: int,
                chunk: int = DEFAULT_CHUNK, per_body: int = 1) -> int:
    """Issue ``step`` in chunks until the loop's flags say it has exited.

    ``flags()`` returns the device tensor (k, converged, breakdown); it is
    read on the host once per chunk. A chunk covers the next ``chunk``
    iterations, or what the iteration ``limit`` leaves, in bodies of up to
    ``per_body`` iterations each (the body masks itself at ``limit``, so a
    limit inside a body still stops exactly there). Body j of a chunk that
    starts at iteration k₀ is called as ``step(k₀ + j·per_body)``: the
    iteration it starts at while the loop is active, which lets the host
    issue work keyed on the iteration counter (the residual replacement of
    the recurrence engines) only in the bodies where it fires. Returns the
    number of host reads.
    """
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if per_body < 1:
        raise ValueError("per_body must be >= 1")
    syncs = 0
    while True:
        k, converged, breakdown = (int(v) for v in flags().tolist())
        syncs += 1
        if converged or breakdown or k >= limit:
            return syncs
        iters = min(chunk, limit - k)
        for j in range(-(-iters // per_body)):
            step(k + j * per_body)


def init_state(problem: Problem, a, b, rhs, history: bool = False,
               precond=None, storage_dtype=None, x0=None, recycle=None):
    """The PCG carry at iteration 0 (w = 0, r = rhs, p = z = D⁻¹r)."""
    reject_unported(history, precond, storage_dtype, x0, recycle)
    dev = rhs.device
    h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
    d = diag_d(a, b, h1, h2)
    z0 = apply_dinv(rhs, d)
    return PCGState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        w=torch.zeros_like(rhs),
        r=rhs,
        p=z0,
        zr=grid_dot(z0, rhs, h1, h2),
        diff=torch.full((), float("inf"), dtype=rhs.dtype, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )


def stencil_fn(problem: Problem, a, b, h1, h2, stencil: str):
    """The A·(·) closure of a loop engine: the plain stencil for "xla",
    K-a (``ops.hopper_kernels.apply_a_kernel``) for "pallas"."""
    if stencil == "xla":
        return lambda p: apply_a(p, a, b, h1, h2)
    if stencil == "pallas":
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import apply_a_kernel

        return lambda p: apply_a_kernel(p, a, b, problem.h1, problem.h2)
    raise ValueError(f"unknown stencil: {stencil!r} (choose from {STENCILS})")


def make_body(problem: Problem, a, b, rhs, limit: int, stencil: str = "xla"):
    """One PCG iteration as a function of the carry, with no host sync."""
    dtype, dev = rhs.dtype, rhs.device
    h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
    delta = spacing(problem.delta, rhs)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    weighted = problem.norm == "weighted"
    d = diag_d(a, b, h1, h2)
    apply_stencil = stencil_fn(problem, a, b, h1, h2, stencil)

    def body(s: PCGState) -> PCGState:
        active = (s.k < limit) & ~s.converged & ~s.breakdown
        ap = apply_stencil(s.p)
        denom = grid_dot(ap, s.p, h1, h2)
        breakdown = denom < DENOM_GUARD
        step = active & ~breakdown
        # α = 0 once the loop has exited or on breakdown: w, r unchanged
        alpha = torch.where(step, s.zr / torch.where(breakdown, one, denom),
                            zero)
        w_new = s.w + alpha * s.p
        r_new = s.r - alpha * ap
        z = apply_dinv(r_new, d)
        dw = w_new - s.w
        sums = grid_dots((z, r_new), (dw, dw))
        zr_new = sums[0] * h1 * h2
        dw2 = sums[1]
        diff = torch.sqrt(dw2 * h1 * h2) if weighted else torch.sqrt(dw2)
        converged = step & (diff < delta)
        beta = zr_new / s.zr
        advance = step & ~converged
        return PCGState(
            k=s.k + active.to(s.k.dtype),
            w=w_new,
            r=r_new,
            p=torch.where(advance, z + beta * s.p, s.p),
            zr=torch.where(advance, zr_new, s.zr),
            diff=torch.where(step, diff, s.diff),
            converged=s.converged | converged,
            breakdown=s.breakdown | (active & breakdown),
        )

    return body


def advance(problem: Problem, a, b, rhs, state: PCGState, limit=None,
            stencil: str = "xla", chunk: int = DEFAULT_CHUNK,
            history: bool = False, precond=None, storage_dtype=None):
    """Advance the carry until convergence/breakdown or iteration ``limit``
    (default ``max_iterations``). Returns (new carry, host reads).

    Chunking moves only where the host looks, not the arithmetic, so any
    ``chunk`` and any sequence of ``limit``s give the same bits.
    """
    reject_unported(history, precond, storage_dtype)
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = make_body(problem, a, b, rhs, limit, stencil)
    carry = [state]

    def step(_k):
        carry[0] = body(carry[0])

    def flags():
        s = carry[0]
        return torch.stack([s.k, s.converged.to(s.k.dtype),
                            s.breakdown.to(s.k.dtype)])

    syncs = run_chunked(step, flags, limit, chunk)
    return carry[0], syncs


def result_of(state: PCGState) -> PCGResult:
    """View a PCG carry as a PCGResult."""
    return PCGResult(w=state.w, iters=state.k, diff=state.diff,
                     converged=state.converged, breakdown=state.breakdown)


def pcg(problem: Problem, a, b, rhs, stencil: str = "xla",
        chunk: int = DEFAULT_CHUNK, history: bool = False, precond=None,
        storage_dtype=None, x0=None, recycle=None) -> PCGResult:
    """Run PCG on pre-assembled (M+1, N+1) coefficients on their device.

    stencil: "xla" (plain PyTorch slices) or "pallas" (the CUDA stencil
    K-a, ``ops.hopper_kernels.apply_a_kernel``).
    """
    reject_unported(history, precond, storage_dtype, x0, recycle)
    state = init_state(problem, a, b, rhs)
    state, _ = advance(problem, a, b, rhs, state, stencil=stencil,
                       chunk=chunk)
    return result_of(state)


def solve(problem: Problem, dtype: torch.dtype = torch.float32,
          stencil: str = "xla", device=None, chunk: int = DEFAULT_CHUNK,
          history: bool = False, storage_dtype=None) -> PCGResult:
    """Assemble and solve on one device (cuda unless ``device='cpu'``)."""
    reject_unported(history, storage_dtype=storage_dtype)
    dev = resolve_device(device)
    a, b, rhs = assembly.assemble(problem, dtype, dev)
    return pcg(problem, a, b, rhs, stencil=stencil, chunk=chunk)
