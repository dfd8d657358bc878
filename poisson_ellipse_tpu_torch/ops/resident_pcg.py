"""Resident whole-solve PCG: the solve in one launch, every array on chip.

The counterpart of ``poisson_ellipse_tpu.ops.resident_pcg``. The kernel
(``csrc/resident_pcg.cu``) keeps the operands and the state in the shared
memory of all SMs for the whole solve, one block per SM with a contiguous
span of ``span`` nodes each, and ap in registers; device memory is touched
to load the operands, to store w, and for the halo rows each block
publishes to its neighbours.

The iteration is the JAX kernel's (``resident_pcg.py:150-184`` there): z
is eliminated (pn = r·dinv + β·p), the stencil is
ap = d·pn − (an·p↑ + as·p↓ + bw·p← + be·p→) with masked coefficients, the
step norm is the realised Δw, and a breakdown forces α = 0. The operands
are the unmasked an = a/h1² and bw = b/h2², with d and dinv, rounded once
from the f64 assembly (``resident_operands``): as_/be and the interior
mask are formed from them, which gives the masked set's element values.

The gate (``fits_resident``) and the launch's dynamic shared memory come
from one function, ``layout``, so the two cannot disagree.
"""

from __future__ import annotations

import dataclasses

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.fused_pcg import (
    interior_normalized,
    normalized_unmasked,
)
from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD, PCGResult, Solver
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    resolve_device,
)

LIBRARY = "resident_pcg"
KERNEL = "resident"

# csrc/resident_pcg.cu: threads a block, ap values a thread keeps in
# registers, and the arrays a block holds in shared memory
THREADS = 512
PER_THREAD = 16
ARRAYS = 7  # an, bw, d, dinv, w, r, p


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """One block per SM, each holding ``span`` nodes of all seven arrays."""

    nblocks: int
    span: int
    smem_bytes: int   # dynamic shared memory of one block
    fits: bool


def layout(problem: Problem, cap: DeviceCapacity,
           dtype=torch.float32) -> ResidentLayout:
    """The launch shape on ``cap``: the same arithmetic as the size check
    of ``pe_resident_pcg_f32`` in the kernel's source."""
    item = torch.empty((), dtype=dtype).element_size()
    g1, g2 = problem.node_shape
    nblocks = cap.sm_count
    span = -(-g1 * g2 // nblocks)
    smem = ARRAYS * span * item + ws.REDUCE_BYTES
    fits = span <= THREADS * PER_THREAD and smem <= cap.smem_per_block
    return ResidentLayout(nblocks, span, smem, fits)


def fits_resident(problem: Problem, dtype, cap: DeviceCapacity) -> bool:
    """True if the whole solve's arrays fit the shared memory of
    ``cap``'s SMs."""
    return layout(problem, cap, dtype).fits


def resident_operands(problem: Problem, dtype=torch.float32, device=None):
    """(an, bw, d, dinv, r0): the unmasked an = a/h1², bw = b/h2², the
    masked diagonal d and its guarded inverse, and the RHS, computed in
    f64 on the host and rounded once to ``dtype`` on ``device``."""
    dev = resolve_device(device)
    a64, b64, rhs64 = assembly.assemble_numpy(problem)
    an, bw = normalized_unmasked(problem, a64, b64)
    d, dinv = interior_normalized(problem, a64, b64)[4:]
    return tuple(assembly.to_device(x, dtype, dev)
                 for x in (an, bw, d, dinv, rhs64))


def resident_plain(problem: Problem, an, bw, d, dinv, r0
                   ) -> tuple[PCGResult, int]:
    """The plain version of the resident kernel: the same per-element
    expressions in the same order, one Python loop step per iteration.
    Returns (result, host reads: one per loop test)."""
    inside = ws.interior(problem, r0)
    zero = torch.zeros_like(r0)
    an_m = torch.where(inside, an, zero)
    as_m = torch.where(inside, ws.next_row(an), zero)
    bw_m = torch.where(inside, bw, zero)
    be_m = torch.where(inside, ws.next_col(bw), zero)
    hh = ws.h1h2(problem, r0)
    delta = ws.scalar(problem.delta, r0)
    weighted = problem.norm == "weighted"

    z0 = r0 * dinv
    carry = ws.Carry(ws.total(z0 * r0) * hh)
    w, r, p = zero, r0, zero
    k, reads = 0, 0
    while True:
        reads += 1
        if not (k < problem.max_iterations and carry.active()):
            break
        pn = r * dinv + carry.beta * p
        p = pn
        pu, pd, pl, pr = ws.neighbours(pn)
        ap = d * pn - (an_m * pu + as_m * pd + bw_m * pl + be_m * pr)
        denom = ws.total(ap * pn) * hh
        breakdown = denom < DENOM_GUARD
        alpha = ws.guarded_alpha(carry.zr, denom)
        w_new = w + alpha * pn
        r_new = r - alpha * ap
        dw = w_new - w  # the realised step, not alpha*pn
        dw2 = ws.total(dw * dw)
        zr_raw = ws.total((r_new * dinv) * r_new)
        w, r = w_new, r_new
        carry.advance(breakdown, dw2, zr_raw, hh, delta, weighted)
        k += 1
    return ws.plain_result(w, k, carry), reads


_SIGNATURE = [ws.PTR] * 11 + [ws.INT] * 6 + [ws.FLOAT, ws.FLOAT, ws.INT,
                                              ws.PTR]


def resident(problem: Problem, an, bw, d, dinv, r0,
             cap: DeviceCapacity | None = None) -> tuple[PCGResult, int]:
    """The whole solve: the kernel for CUDA tensors, its plain version for
    CPU tensors. Returns (result, host reads). ``cap`` is the card's
    capacity (read from the device when None)."""
    if r0.device.type == "cpu":
        return resident_plain(problem, an, bw, d, dinv, r0)
    arrays = dict(an=an, bw=bw, d=d, dinv=dinv, r0=r0)
    ws.check_operands(KERNEL, problem, arrays)
    cap = cap if cap is not None else device_capacity(r0.device)
    lay = layout(problem, cap)
    if not lay.fits:
        raise ValueError(
            f"grid {problem.M}x{problem.N} does not fit the resident "
            f"kernel on {cap.name} (span {lay.span}, {lay.smem_bytes} B of "
            f"{cap.smem_per_block} B shared memory a block); use the "
            "streamed or xl engine, or engine='auto'"
        )
    g1, g2 = problem.node_shape
    w = torch.empty_like(r0)
    zpub, ppub = torch.empty_like(r0), torch.empty_like(r0)
    status, diff, partials = ws.scratch(r0, lay.nblocks)
    ws.launch(
        LIBRARY, KERNEL, "pe_resident_pcg_f32", _SIGNATURE,
        *(t.data_ptr() for t in (an, bw, d, dinv, r0, w, zpub, ppub,
                                 partials, status, diff)),
        g1, g2, lay.span, lay.nblocks, lay.smem_bytes,
        problem.max_iterations, float(problem.h1) * float(problem.h2),
        problem.delta,
        int(problem.norm == "weighted"),
        torch.cuda.current_stream(r0.device).cuda_stream,
    )
    return ws.launch_result(KERNEL, w, status, diff)


def build_resident_solver(problem: Problem, dtype=torch.float32, device=None,
                          cap: DeviceCapacity | None = None):
    """(solver, args) with args = ``resident_operands``; ``solver(*args)``
    may be called many times. The gate is checked here against ``cap``
    (on the card, default: its own capacity; on the CPU, only when
    given)."""
    if dtype != torch.float32:
        raise ValueError(f"the resident engine runs float32, not {dtype}")
    dev = resolve_device(device)
    if dev.type == "cuda" and cap is None:
        cap = device_capacity(dev)
    if cap is not None:
        if not fits_resident(problem, dtype, cap):
            raise ValueError(
                f"grid {problem.M}x{problem.N} exceeds the resident gate on "
                f"{cap.name}; use the streamed or xl engine, or "
                "engine='auto'"
            )
    args = resident_operands(problem, dtype, dev)
    solver = Solver(lambda *ops: resident(problem, *ops, cap=cap))
    return solver, args

