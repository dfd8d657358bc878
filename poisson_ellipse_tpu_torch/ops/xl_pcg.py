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
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
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


class XLPlan:
    """The tiling of the xl solve (no residency choices: all streams)."""

    def __init__(self, problem: Problem):
        g1, g2 = problem.node_shape
        self.tiles = -(-g1 // TILE) * -(-g2 // TILE)

    def nblocks(self, cap: DeviceCapacity) -> int:
        """The cooperative grid: every block the card holds at once, and no
        more blocks than tiles."""
        return max(1, min(self.tiles, cap.max_co_resident(LIBRARY, 0)))


def xl_plain(problem: Problem, dinv, an, bw, r0) -> tuple[PCGResult, int]:
    """The plain version of the xl kernel: the same per-element expressions
    in the same order, one Python loop step per body, with the JAX
    kernel's one-body-late convergence. Returns (result, host reads)."""
    inside = ws.interior(problem, r0)
    hh = ws.h1h2(problem, r0)
    delta = ws.scalar(problem.delta, r0)
    weighted = problem.norm == "weighted"
    max_iter = problem.max_iterations
    d = ws.guarded_reciprocal(dinv)

    z = r0 * dinv
    carry = ws.Carry(ws.total(z * r0) * hh)
    alpha = torch.zeros_like(carry.zr)
    w = p = torch.zeros_like(r0)
    i, reads = 0, 0
    while True:
        reads += 1
        if not (i < max_iter + 1 and carry.active()):
            break
        # the stencil phase: the previous body's deferred w-update, pn, ap
        w_new = w + alpha * p
        dw = w_new - w
        w = w_new
        p = z + carry.beta * p
        ap = ws.stencil_unmasked(p, an, bw, inside)
        dw2 = ws.total(dw * dw)
        denom = ws.total(ap * p) * hh
        ndiff = torch.sqrt(dw2 * hh) if weighted else torch.sqrt(dw2)
        # convergence of the previous reference iteration (none in body 0)
        converged = (ndiff < delta) & (i >= 1)
        if i < 1:
            ndiff = carry.diff
        # this body's denominator belongs to reference iteration i+1
        breakdown = ~converged & (denom < DENOM_GUARD) & (i < max_iter)
        alpha = ws.guarded_alpha(carry.zr, denom)
        # the update phase
        z = z - alpha * (dinv * ap)
        zr_new = ws.total((z * z) * d) * hh
        carry.beta = torch.where(breakdown, carry.beta, zr_new / carry.zr)
        carry.zr = torch.where(breakdown, carry.zr, zr_new)
        carry.diff = ndiff
        carry.converged = converged
        carry.breakdown = breakdown
        i += 1
    iters = i - 1 if bool(carry.converged) else min(i, max_iter)
    return ws.plain_result(w, iters, carry), reads


_SIGNATURE = [ws.PTR] * 12 + [ws.INT] * 4 + [ws.FLOAT, ws.FLOAT, ws.INT,
                                             ws.PTR]


def xl(problem: Problem, dinv, an, bw, r0,
       cap: DeviceCapacity | None = None) -> tuple[PCGResult, int]:
    """The whole solve: the kernel for CUDA tensors, its plain version for
    CPU tensors. Returns (result, host reads). ``cap`` is the card's
    capacity (read from the device when None); the grid is every block it
    holds at once."""
    if r0.device.type == "cpu":
        return xl_plain(problem, dinv, an, bw, r0)
    arrays = dict(dinv=dinv, an=an, bw=bw, r0=r0)
    ws.check_operands(KERNEL, problem, arrays)
    cap = cap if cap is not None else device_capacity(r0.device)
    nblocks = XLPlan(problem).nblocks(cap)
    g1, g2 = problem.node_shape
    w, z = torch.empty_like(r0), torch.empty_like(r0)
    p0, p1, ap = (torch.empty_like(r0) for _ in range(3))
    status, diff, partials = ws.scratch(r0, nblocks)
    ws.launch(
        LIBRARY, KERNEL, "pe_xl_pcg_f32", _SIGNATURE,
        *(t.data_ptr() for t in (dinv, an, bw, r0, w, z, p0, p1, ap,
                                 partials, status, diff)),
        g1, g2, nblocks, problem.max_iterations,
        float(problem.h1) * float(problem.h2), problem.delta,
        int(problem.norm == "weighted"),
        torch.cuda.current_stream(r0.device).cuda_stream,
    )
    return ws.launch_result(KERNEL, w, status, diff)


def build_xl_solver(problem: Problem, dtype=torch.float32, device=None,
                    cap: DeviceCapacity | None = None):
    """(solver, args) with args = ``streamed_operands``; ``solver(*args)``
    may be called many times. On the card the capacity is read once here
    (default: the card's own)."""
    if dtype != torch.float32:
        raise ValueError(f"the xl engine runs float32, not {dtype}")
    dev = resolve_device(device)
    if dev.type == "cuda" and cap is None:
        cap = device_capacity(dev)
    args = streamed_operands(problem, dtype, dev)
    solver = Solver(lambda *ops: xl(problem, *ops, cap=cap))
    return solver, args

