"""XL whole-solve PCG: state and operands in device memory, one launch.

The counterpart of ``poisson_ellipse_tpu.ops.xl_pcg``, the engine for
grids whose state does not fit on chip. The kernel (``csrc/xl_pcg.cu``) is
persistent: a cooperative grid of as many blocks as the card holds at once
(``cap.max_co_resident``), each walking 32×32 tiles, with the two scalar
sync points of an iteration as grid barriers.

The iteration is the JAX kernel's (``xl_pcg.py:237-400`` there):

- z-state: the state is (w, z, p) with z = dinv·r;
- the w-update is deferred one body and rides the next stencil phase,
  which reads p anyway; its realised ‖Δw‖² is that body's step norm;
- so convergence is seen one body late: the loop runs while
  i < max_iter + 1, a guard trip is a breakdown only while i < max_iter,
  and the count reported is bodies − 1 when converged, else the body
  count capped at max_iter.

``XLPlan`` is the tiling: the TPU's (tm, 128)-row tiles become 32×32
tiles of a Hopper block, and its ``passes_per_iter`` model (``12 + 8/tm``
there, the a-operand's 8-row halo window) becomes 12 passes plus the GPU
tile's halo rereads.

The forms (``ws.FORMS``): f32 or bf16 compute, and f32 compute with dinv,
an and bw streamed at a narrow storage dtype
(``build_xl_solver(storage_dtype=)``, the JAX ``tile_of`` upcast,
``:162-169``), rounded once from their f32 form at build time
(``:436-440``); the state scratch stays at the compute width. Of the pass
model's 12.32 passes ``OPERAND_PASSES`` are operand reads: the share a
narrow stream halves.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.precision import resolve_storage_dtype
from poisson_ellipse_tpu_torch.ops.streamed_pcg import streamed_operands
from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD, PCGResult, Solver
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    resolve_device,
)

LIBRARY = "xl_pcg"
KERNEL = "xl"

# csrc/xl_pcg.cu: the square tile a block computes per step
TILE = 32

# Modelled device-memory array passes per iteration. Stencil phase: z, p,
# w, an, bw read and w, p, ap written (8); update phase: z, dinv, ap read
# and z written (4). Plus the tile halo: z and p over a (T+2)² window for a
# T² tile, an one row on, bw one column on.
PASSES_PER_ITER = 12.0 + 2.0 * ((TILE + 2) ** 2 - TILE**2) / TILE**2 + 2.0 / TILE
# of which operand reads: an and bw in the stencil phase (each with its
# one-row / one-column halo), dinv in the update phase
OPERAND_PASSES = 3.0 + 2.0 / TILE


class XLPlan:
    """The tiling of the xl solve (no residency choices: all streams)."""

    def __init__(self, problem: Problem):
        g1, g2 = problem.node_shape
        self.tiles = -(-g1 // TILE) * -(-g2 // TILE)

    def nblocks(self, cap: DeviceCapacity, form: str = "f32") -> int:
        """The cooperative grid: every block of ``form``'s kernel the card
        holds at once, and no more blocks than tiles."""
        return max(1, min(self.tiles,
                          cap.max_co_resident(LIBRARY, 0, form)))


def xl_plain(problem: Problem, dinv, an, bw, r0) -> tuple[PCGResult, int]:
    """The plain version of the xl kernel: the same per-element expressions
    in the same order, one Python loop step per body, with the JAX
    kernel's one-body-late convergence, on the operands upcast to f32,
    each stored value rounded to r0's dtype (``ws.rounder``). Returns
    (result, host reads)."""
    ct = r0.dtype
    q = ws.rounder(ct)
    hh = ws.held(ws.h1h2(problem, r0))
    delta = ws.held(ws.scalar(problem.delta, r0))
    dinv, an, bw, r0 = (ws.held(x.to(ct)) for x in (dinv, an, bw, r0))
    weighted = problem.norm == "weighted"
    inside = ws.interior(problem, r0)
    max_iter = problem.max_iterations
    d = ws.guarded_reciprocal(dinv)

    z = q(r0 * dinv)
    carry = ws.Carry(q(q(ws.total(z * r0)) * hh), q)
    alpha = torch.zeros_like(carry.zr)
    w = p = torch.zeros_like(r0)
    i, reads = 0, 0
    while True:
        reads += 1
        if not (i < max_iter + 1 and carry.active()):
            break
        # the stencil phase: the previous body's deferred w-update, pn, ap
        w_new = q(w + alpha * p)
        dw = w_new - w
        w = w_new
        p = q(z + carry.beta * p)
        ap = q(ws.stencil_unmasked(p, an, bw, inside))
        dw2 = q(ws.total(dw * dw))
        denom = q(q(ws.total(ap * p)) * hh)
        ndiff = q(torch.sqrt(dw2 * hh) if weighted else torch.sqrt(dw2))
        # convergence of the previous reference iteration (none in body 0)
        converged = (ndiff < delta) & (i >= 1)
        if i < 1:
            ndiff = carry.diff
        # this body's denominator belongs to reference iteration i+1
        breakdown = (~converged & ws.below_guard(denom, ct)
                     & (i < max_iter))
        alpha = ws.guarded_alpha(carry.zr, denom, q, ct)
        # the update phase
        z = q(z - alpha * (dinv * ap))
        zr_new = q(q(ws.total((z * z) * d)) * hh)
        carry.beta = torch.where(breakdown, carry.beta, q(zr_new / carry.zr))
        carry.zr = torch.where(breakdown, carry.zr, zr_new)
        carry.diff = ndiff
        carry.converged = converged
        carry.breakdown = breakdown
        i += 1
    iters = i - 1 if bool(carry.converged) else min(i, max_iter)
    return ws.plain_result(w, iters, carry, ct), reads


_SIGNATURE = [ws.PTR] * 12 + [ws.INT] * 4 + [ws.FLOAT, ws.FLOAT, ws.INT,
                                             ws.PTR]


def xl(problem: Problem, dinv, an, bw, r0,
       cap: DeviceCapacity | None = None) -> tuple[PCGResult, int]:
    """The whole solve: the kernel for CUDA tensors (its form at r0's dtype
    with the operands at dinv's), its plain version for CPU tensors.
    Returns (result, host reads). ``cap`` is the card's capacity (read
    from the device when None); the grid is every block of the form's
    kernel it holds at once."""
    if r0.device.type == "cpu":
        return xl_plain(problem, dinv, an, bw, r0)
    form = ws.form_of(r0.dtype, dinv.dtype)
    arrays = dict(dinv=dinv, an=an, bw=bw, r0=r0)
    ws.check_operands(KERNEL, problem, arrays,
                      dict(dinv=dinv.dtype, an=dinv.dtype, bw=dinv.dtype,
                           r0=r0.dtype))
    cap = cap if cap is not None else device_capacity(r0.device)
    nblocks = XLPlan(problem).nblocks(cap, form)
    g1, g2 = problem.node_shape
    w, z = torch.empty_like(r0), torch.empty_like(r0)
    p0, p1, ap = (torch.empty_like(r0) for _ in range(3))
    status, diff, partials = ws.scratch(r0, nblocks)
    ws.launch(
        LIBRARY, ws.counter(KERNEL, form), f"pe_xl_pcg_{form}", _SIGNATURE,
        *(t.data_ptr() for t in (dinv, an, bw, r0, w, z, p0, p1, ap,
                                 partials, status, diff)),
        g1, g2, nblocks, problem.max_iterations,
        ws.h1h2_rounded(problem, r0.dtype),
        ws.rounded(problem.delta, r0.dtype),
        int(problem.norm == "weighted"),
        torch.cuda.current_stream(r0.device).cuda_stream,
    )
    return ws.launch_result(KERNEL, w, status, diff)


def build_xl_solver(problem: Problem, dtype=torch.float32, device=None,
                    cap: DeviceCapacity | None = None, storage_dtype=None):
    """(solver, args) with args = ``streamed_operands``; ``solver(*args)``
    may be called many times. On the card the capacity is read once here
    (default: the card's own). ``storage_dtype`` streams dinv, an and bw
    at that width (f32 compute only)."""
    st = resolve_storage_dtype(storage_dtype, dtype)
    ws.form_of(dtype, st)  # raises for a form no kernel has
    dev = resolve_device(device)
    if dev.type == "cuda" and cap is None:
        cap = device_capacity(dev)
    args = streamed_operands(problem, dtype, dev, st)
    solver = Solver(lambda *ops: xl(problem, *ops, cap=cap))
    return solver, args

