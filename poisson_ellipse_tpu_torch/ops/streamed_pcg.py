"""Streamed whole-solve PCG: state on chip, operands streamed or resident.

The counterpart of ``poisson_ellipse_tpu.ops.streamed_pcg``. The kernel
(``csrc/streamed_pcg.cu``) runs the whole solve in one launch, one block
per SM with a contiguous span of nodes each. The state (w, r or z, p)
stays in shared memory for the whole solve; each operand of
{ap, dinv, a, b} is either held there too or read from device memory each
iteration, as ``StreamPlan`` decides from the card's shared memory.

The kernel marches as the resident one does (``ws.march_split``: a warp
a strip of 32 columns of a block's span, down its rows; the block's
threads from ``StreamPlan.launch_shape``). ``StreamPlan`` is the JAX
plan's greedy residency (``streamed_pcg.py:133-183`` there) with the
H100's budget: after the state, the operands are
made resident in the order of the device-memory passes each saves (ap 2,
dinv 1, a 1, b 1) while they fit. There are no double-buffered tiles: a
streamed operand is read in place, so resident or not, an operand costs
``span`` elements of a block's shared memory or none.

The regime follows from the plan, as in the JAX kernel:

- dinv resident: r-state. The state holds r; pn = r·dinv + β·p and the
  update r −= α·ap, zr' = Σ(r·dinv)·r (``:456-468`` there);
- dinv streamed: z-state. The state holds z = dinv·r from the start
  (``:316-323``), pn = z + β·p reads no operand, and the update
  z −= α·(dinv·ap), zr' = Σ z²·(1/dinv) reads dinv once (``:489-510``).

The stencil is the unmasked, output-masked form (``:330-369``) on the
operand set of ``streamed_operand_set`` (``:538-571``): (dinv, an, bw, r0)
with an = a/h1² and bw = b/h2² unmasked, here unpadded.

The forms (``ws.FORMS``): f32 or bf16 compute, and f32 compute with the
operands dinv, an and bw streamed at a narrow storage dtype
(``build_streamed_solver(storage_dtype=)``, the JAX ``_read`` upcast,
``:258``): they are rounded once from their f32 form, and r0 and the state
stay at f32 (``:583-588``). The plan budgets every operand at the compute
width, as JAX's does (``:598-600``), so a storage dtype never changes the
plan a grid gets, nor the rung ``auto`` takes.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.fused_pcg import (
    interior_normalized,
    normalized_unmasked,
)
from poisson_ellipse_tpu_torch.ops.precision import (
    resolve_storage_dtype,
    store,
)
from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD, PCGResult, Solver
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    gate_capacity,
    resolve_device,
)

LIBRARY = "streamed_pcg"
KERNEL = "streamed"

# the operands in the greedy order, and their bits in the kernel's
# ``resident`` argument (csrc/streamed_pcg.cu kResAp..kResBw)
OPERANDS = ("ap", "dinv", "a", "b")
RESIDENT_BITS = {"ap": 1, "dinv": 2, "a": 4, "b": 8}
STATE_ARRAYS = 3  # w, r (or z), p
# csrc/streamed_pcg.cu kSteps, kMaxWarps: the march's steps a unit, and
# warps a block, at most
MARCH_STEPS = 10
MAX_WARPS = 26


class StreamPlan:
    """Which operands stay in shared memory, and the launch shape.

    ``cap`` is the card's capacity: one block per SM, each holding a span
    of ``ceil(n / sm_count)`` nodes of the state and of every resident
    operand. ``cap=None`` is the plain version's plan on the CPU, where
    there is no on-chip memory to run out of: every operand resident, the
    r-state regime. ``resident`` forces the set of resident operands
    (a test's way to run a given regime); it must fit.
    """

    def __init__(self, problem: Problem, cap: DeviceCapacity | None = None,
                 dtype=torch.float32, resident=None):
        g1, g2 = problem.node_shape
        item = torch.empty((), dtype=dtype).element_size()
        self.g2 = g2
        self.cap = cap
        self.nblocks = cap.sm_count if cap is not None else 1
        self.span = -(-g1 * g2 // self.nblocks)
        self.operand_bytes = self.span * item
        self.state_bytes = (STATE_ARRAYS * self.operand_bytes
                            + ws.REDUCE_BYTES)
        budget = (cap.smem_per_block - self.state_bytes
                  if cap is not None else float("inf"))
        self.fits = budget >= 0
        if resident is None:
            self.resident = {}
            for name in OPERANDS:
                take = self.fits and self.operand_bytes <= budget
                self.resident[name] = take
                if take:
                    budget -= self.operand_bytes
        else:
            unknown = set(resident) - set(OPERANDS)
            if unknown:
                raise ValueError(f"unknown operands {sorted(unknown)}")
            if not self.fits or len(resident) * self.operand_bytes > budget:
                raise ValueError(f"operands {sorted(resident)} do not fit "
                                 "in shared memory beside the state")
            self.resident = {name: name in resident for name in OPERANDS}
        self.smem_bytes = self.state_bytes + self.operand_bytes * sum(
            self.resident.values())

    def launch_shape(self) -> ws.MarchSplit:
        """The kernel's march over a span (``ws.march_split``): its warps
        are the block's threads."""
        return ws.march_split(self.span, self.g2, MARCH_STEPS, MAX_WARPS)

    @property
    def zstate(self) -> bool:
        """The regime: z-state when dinv is streamed, else r-state."""
        return not self.resident["dinv"]

    @property
    def resident_bits(self) -> int:
        return sum(RESIDENT_BITS[k] for k, v in self.resident.items() if v)

    def streamed_passes_per_iter(self) -> float:
        """Device-memory array passes per iteration (the roofline model):
        dinv 1 (the z-state reads it once, in the update phase), ap 2
        (written, then read), a 1 and b 1 (the row below is the same
        stream again, from L2)."""
        cost = {"dinv": 1.0, "ap": 2.0, "a": 1.0, "b": 1.0}
        return sum(cost[k] for k, v in self.resident.items() if not v)


def fits_streamed(problem: Problem, dtype, cap: DeviceCapacity) -> bool:
    """True if the always-resident state (w, r, p) fits the shared memory
    of ``cap``'s SMs. Past this gate the state itself does not fit: the xl
    engine streams it too. The shared memory is the gates' view of it
    (``utils.device.gate_capacity``)."""
    return StreamPlan(problem, gate_capacity(cap), dtype).fits


def streamed_operands(problem: Problem, dtype=torch.float32, device=None,
                      storage_dtype=None):
    """(dinv, an, bw, r0): the guarded 1/D, the unmasked an = a/h1² and
    bw = b/h2², and the RHS, computed in f64 on the host and rounded once
    to ``dtype`` on ``device``. The operand set of the streamed and xl
    engines (the JAX ``streamed_operand_set`` without its padding). With
    ``storage_dtype`` (an ``ops.precision`` name or dtype), dinv, an and bw
    are then rounded from their ``dtype`` form to it, as the JAX
    ``build_streamed_solver``/``build_xl_solver`` round them; r0 stays at
    ``dtype``."""
    dev = resolve_device(device)
    st = resolve_storage_dtype(storage_dtype, dtype)
    a64, b64, rhs64 = assembly.assemble_numpy(problem)
    dinv = interior_normalized(problem, a64, b64)[5]
    an, bw = normalized_unmasked(problem, a64, b64)
    dinv, an, bw, r0 = (assembly.to_device(x, dtype, dev)
                        for x in (dinv, an, bw, rhs64))
    return (*(store(x, st) for x in (dinv, an, bw)), r0)


def streamed_plain(problem: Problem, dinv, an, bw, r0, zstate: bool = False
                   ) -> tuple[PCGResult, int]:
    """The plain version of the streamed kernel in the regime ``zstate``
    selects: the same per-element expressions in the same order, one
    Python loop step per iteration, on the operands upcast to f32, each
    stored value rounded to r0's dtype (``ws.rounder``). Returns (result,
    host reads)."""
    ct = r0.dtype
    q = ws.rounder(ct)
    hh = ws.held(ws.h1h2(problem, r0))
    delta = ws.held(ws.scalar(problem.delta, r0))
    dinv, an, bw, r0 = (ws.held(x.to(ct)) for x in (dinv, an, bw, r0))
    weighted = problem.norm == "weighted"
    inside = ws.interior(problem, r0)
    d = ws.guarded_reciprocal(dinv) if zstate else None

    # z0 is stored (the state) in the z-state regime only
    z0 = q(r0 * dinv) if zstate else r0 * dinv
    carry = ws.Carry(q(q(ws.total(z0 * r0)) * hh), q)
    state = z0 if zstate else r0
    w = p = torch.zeros_like(r0)
    k, reads = 0, 0
    while True:
        reads += 1
        if not (k < problem.max_iterations and carry.active()):
            break
        z = state if zstate else state * dinv
        p = q(z + carry.beta * p)
        ap = q(ws.stencil_unmasked(p, an, bw, inside))
        denom = q(q(ws.total(ap * p)) * hh)
        breakdown = ws.below_guard(denom, ct)
        alpha = ws.guarded_alpha(carry.zr, denom, q, ct)
        w_new = q(w + alpha * p)
        dw = w_new - w  # the realised step, not alpha*p
        w = w_new
        if zstate:
            state = q(state - alpha * (dinv * ap))
            zr_raw = q(ws.total((state * state) * d))
        else:
            state = q(state - alpha * ap)
            zr_raw = q(ws.total((state * dinv) * state))
        carry.advance(breakdown, q(ws.total(dw * dw)), zr_raw, hh, delta,
                      weighted)
        k += 1
    return ws.plain_result(w, k, carry, ct), reads


_SIGNATURE = [ws.PTR] * 11 + [ws.INT] * 7 + [ws.FLOAT, ws.FLOAT, ws.INT,
                                             ws.PTR]


def streamed(problem: Problem, dinv, an, bw, r0, plan: StreamPlan,
             stamps: torch.Tensor | None = None) -> tuple[PCGResult, int]:
    """The whole solve under ``plan``: the kernel for CUDA tensors (its
    form at r0's dtype with the operands at dinv's), its plain version (in
    the plan's regime) for CPU tensors. Returns (result, host reads).
    ``stamps`` (``ws.stamps_buffer``) runs the timing instantiation
    instead: each body's phase boundaries on the device clock, in ns."""
    if r0.device.type == "cpu":
        return streamed_plain(problem, dinv, an, bw, r0, plan.zstate)
    form = ws.form_of(r0.dtype, dinv.dtype)
    arrays = dict(dinv=dinv, an=an, bw=bw, r0=r0)
    ws.check_operands(KERNEL, problem, arrays,
                      dict(dinv=dinv.dtype, an=dinv.dtype, bw=dinv.dtype,
                           r0=r0.dtype))
    if plan.cap is None or not plan.fits:
        raise ValueError(f"grid {problem.M}x{problem.N}: the kernel needs a "
                         "plan that fits a card's capacity")
    g1, g2 = problem.node_shape
    w = torch.empty_like(r0)
    ap = torch.empty_like(r0) if not plan.resident["ap"] else w.new_empty(0)
    # the span halo is float in every form (csrc/grid_sync.cuh)
    zpub = torch.empty_like(r0, dtype=torch.float32)
    ppub = torch.empty_like(zpub)
    status, diff, partials = ws.scratch(r0, plan.nblocks)
    args = (
        *(t.data_ptr() for t in (dinv, an, bw, r0, w, ap, zpub, ppub,
                                 partials, status, diff)),
        g1, g2, plan.span, plan.resident_bits, plan.nblocks, plan.smem_bytes,
        problem.max_iterations, ws.h1h2_rounded(problem, r0.dtype),
        ws.rounded(problem.delta, r0.dtype),
        int(problem.norm == "weighted"),
        torch.cuda.current_stream(r0.device).cuda_stream,
    )
    ws.launch_form(LIBRARY, KERNEL, form, _SIGNATURE, args, stamps,
                   (problem.max_iterations,
                    ws.WHOLE_STAMPS + 2 * plan.nblocks))
    return ws.launch_result(KERNEL, w, status, diff)


def build_streamed_solver(problem: Problem, dtype=torch.float32, device=None,
                          cap: DeviceCapacity | None = None,
                          storage_dtype=None):
    """(solver, args) with args = ``streamed_operands``; ``solver(*args)``
    may be called many times. On the card the plan reads ``cap`` (default:
    the card's own capacity); on the CPU ``cap=None`` plans every operand
    resident, and a given ``cap`` plans as it would on that card.
    ``storage_dtype`` streams dinv, an and bw at that width (f32 compute
    only); the plan stays the compute width's."""
    st = resolve_storage_dtype(storage_dtype, dtype)
    ws.form_of(dtype, st)  # raises for a form no kernel has
    dev = resolve_device(device)
    if dev.type == "cuda" and cap is None:
        cap = device_capacity(dev)
    plan = StreamPlan(problem, cap, dtype)
    if not plan.fits:
        raise ValueError(
            f"grid {problem.M}x{problem.N}: the PCG state (w, r, p) alone "
            f"exceeds the shared memory of {cap.name}; use the xl engine "
            "(auto's pick there)"
        )
    args = streamed_operands(problem, dtype, dev, st)
    solver = Solver(lambda *ops: streamed(problem, *ops, plan=plan))
    return solver, args

