"""Resident whole-solve PCG: the solve in one launch, every array on chip.

The counterpart of ``poisson_ellipse_tpu.ops.resident_pcg``. The kernel
(``csrc/resident_pcg.cu``) keeps the operands and the state in the shared
memory of all SMs for the whole solve, one block per SM with a contiguous
span of ``span`` nodes each; device memory is touched to load the
operands, to store w, and for the halo rows each block publishes to its
neighbours.

The iteration is the JAX kernel's (``resident_pcg.py:150-184`` there): z
is eliminated (pn = r·dinv + β·p), the stencil is
ap = d·pn − (an·p↑ + as·p↓ + bw·p← + be·p→) with masked coefficients, the
step norm is the realised Δw, and a breakdown forces α = 0. The operands
are the unmasked an = a/h1² and bw = b/h2², with d and dinv, rounded once
from the f64 assembly (``resident_operands``): as_/be and the interior
mask are formed from them, which gives the masked set's element values.

The gate (``fits_resident``) and the launch's dynamic shared memory come
from one function, ``layout``, so the two cannot disagree.

The kernel runs at f32 or bf16 compute (``ws.COMPUTE_FORMS``), as the JAX
engine runs at its solve dtype; a bf16 block holds twice the span
(``SPAN_LIMIT``), so the bf16 gate admits grids of up to twice as many
nodes (H100: 1100×1650, which f32 sends to ``streamed``).

The kernel marches (``ws.march_split``): a warp a strip of 32 columns of
the span down its rows, ap carried across the first barrier in registers
where each warp has at most ``AP_UNITS`` units of ``MARCH_STEPS`` steps
(every published grid), else in a device-memory scratch the wrapper
allocates (``ResidentLayout.ap_in_registers``).
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

# csrc/resident_pcg.cu Form: the largest span a block takes (by the
# compute type's bytes; the kernel before the march kept 16 / 32 nodes a
# thread over 512 threads), the march's steps a unit and the units a lane
# keeps ap for in registers, and the arrays a block holds in shared memory
SPAN_LIMIT = {4: 8192, 2: 16384}
MARCH_STEPS = {4: 8, 2: 10}
AP_UNITS = 2
MAX_WARPS = {4: 19, 2: 26}  # Form::kMaxWarps, by the compute type's bytes
ARRAYS = 7  # an, bw, d, dinv, w, r, p


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """One block per SM, each holding ``span`` nodes of all seven arrays,
    and the march's split of a span (``ws.march_split``): ap in registers
    where each warp has at most AP_UNITS units, else in a device-memory
    scratch."""

    nblocks: int
    span: int
    smem_bytes: int   # dynamic shared memory of one block
    fits: bool
    split: ws.MarchSplit | None = None

    @property
    def threads(self) -> int:
        return self.split.threads

    @property
    def ap_in_registers(self) -> bool:
        return self.split.per_warp <= AP_UNITS


def layout(problem: Problem, cap: DeviceCapacity,
           dtype=torch.float32) -> ResidentLayout:
    """The launch shape on ``cap`` at ``dtype``: the same arithmetic as the
    size check and the split of ``pe_resident_pcg_<form>`` in the kernel's
    source (no kernel form for other dtypes: nothing fits)."""
    item = torch.empty((), dtype=dtype).element_size()
    g1, g2 = problem.node_shape
    nblocks = cap.sm_count
    span = -(-g1 * g2 // nblocks)
    smem = ARRAYS * span * item + ws.REDUCE_BYTES
    fits = span <= SPAN_LIMIT.get(item, 0) and smem <= cap.smem_per_block
    split = (ws.march_split(span, g2, MARCH_STEPS[item], MAX_WARPS[item])
             if item in MARCH_STEPS else None)
    return ResidentLayout(nblocks, span, smem, fits, split)


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
    expressions in the same order, one Python loop step per iteration,
    in f32 with each stored value rounded to r0's dtype
    (``ws.rounder``). Returns (result, host reads: one per loop test)."""
    ct = r0.dtype
    q = ws.rounder(ct)
    hh = ws.held(ws.h1h2(problem, r0))
    delta = ws.held(ws.scalar(problem.delta, r0))
    an, bw, d, dinv, r0 = (ws.held(x) for x in (an, bw, d, dinv, r0))
    weighted = problem.norm == "weighted"
    inside = ws.interior(problem, r0)
    zero = torch.zeros_like(r0)
    an_m = torch.where(inside, an, zero)
    as_m = torch.where(inside, ws.next_row(an), zero)
    bw_m = torch.where(inside, bw, zero)
    be_m = torch.where(inside, ws.next_col(bw), zero)

    z0 = r0 * dinv
    carry = ws.Carry(q(q(ws.total(z0 * r0)) * hh), q)
    w, r, p = zero, r0, zero
    k, reads = 0, 0
    while True:
        reads += 1
        if not (k < problem.max_iterations and carry.active()):
            break
        pn = q(r * dinv + carry.beta * p)
        p = pn
        pu, pd, pl, pr = ws.neighbours(pn)
        ap = q(d * pn - (an_m * pu + as_m * pd + bw_m * pl + be_m * pr))
        denom = q(q(ws.total(ap * pn)) * hh)
        breakdown = ws.below_guard(denom, ct)
        alpha = ws.guarded_alpha(carry.zr, denom, q, ct)
        w_new = q(w + alpha * pn)
        r_new = q(r - alpha * ap)
        dw = w_new - w  # the realised step, not alpha*pn
        dw2 = q(ws.total(dw * dw))
        zr_raw = q(ws.total((r_new * dinv) * r_new))
        w, r = w_new, r_new
        carry.advance(breakdown, dw2, zr_raw, hh, delta, weighted)
        k += 1
    return ws.plain_result(w, k, carry, ct), reads


_SIGNATURE = [ws.PTR] * 12 + [ws.INT] * 6 + [ws.FLOAT, ws.FLOAT, ws.INT,
                                              ws.PTR]


def resident(problem: Problem, an, bw, d, dinv, r0,
             cap: DeviceCapacity | None = None,
             stamps: torch.Tensor | None = None) -> tuple[PCGResult, int]:
    """The whole solve: the kernel for CUDA tensors (its form at r0's
    dtype, f32 or bf16), its plain version for CPU tensors. Returns
    (result, host reads). ``cap`` is the card's capacity (read from the
    device when None). ``stamps`` (``ws.stamps_buffer``) runs the timing
    instantiation instead: each body's phase boundaries on the device
    clock, in ns."""
    if r0.device.type == "cpu":
        return resident_plain(problem, an, bw, d, dinv, r0)
    form = ws.form_of(r0.dtype)
    if form not in ws.COMPUTE_FORMS:
        raise ValueError(f"{KERNEL}: no kernel form {form}")
    arrays = dict(an=an, bw=bw, d=d, dinv=dinv, r0=r0)
    ws.check_operands(KERNEL, problem, arrays,
                      dict.fromkeys(arrays, r0.dtype))
    cap = cap if cap is not None else device_capacity(r0.device)
    lay = layout(problem, cap, r0.dtype)
    if not lay.fits:
        raise ValueError(
            f"grid {problem.M}x{problem.N} does not fit the resident "
            f"kernel on {cap.name} (span {lay.span}, {lay.smem_bytes} B of "
            f"{cap.smem_per_block} B shared memory a block); use the "
            "streamed or xl engine, or engine='auto'"
        )
    g1, g2 = problem.node_shape
    w = torch.empty_like(r0)
    # ap's scratch, where the march's split does not fit the registers
    ap = w.new_empty(0) if lay.ap_in_registers else torch.empty_like(r0)
    # the span halo is float in every form (csrc/grid_sync.cuh)
    zpub = torch.empty_like(r0, dtype=torch.float32)
    ppub = torch.empty_like(zpub)
    status, diff, partials = ws.scratch(r0, lay.nblocks)
    args = (
        *(t.data_ptr() for t in (an, bw, d, dinv, r0, w, ap, zpub, ppub,
                                 partials, status, diff)),
        g1, g2, lay.span, lay.nblocks, lay.smem_bytes,
        problem.max_iterations, ws.h1h2_rounded(problem, r0.dtype),
        ws.rounded(problem.delta, r0.dtype),
        int(problem.norm == "weighted"),
        torch.cuda.current_stream(r0.device).cuda_stream,
    )
    ws.launch_form(LIBRARY, KERNEL, form, _SIGNATURE, args, stamps,
                   (problem.max_iterations,
                    ws.WHOLE_STAMPS + 2 * lay.nblocks))
    return ws.launch_result(KERNEL, w, status, diff)


def build_resident_solver(problem: Problem, dtype=torch.float32, device=None,
                          cap: DeviceCapacity | None = None):
    """(solver, args) with args = ``resident_operands``; ``solver(*args)``
    may be called many times. The gate is checked here against ``cap``
    (on the card, default: its own capacity; on the CPU, only when
    given)."""
    if ws.DTYPE_NAMES.get(dtype) not in ws.COMPUTE_FORMS:
        raise ValueError(f"the resident engine runs float32 or bfloat16, "
                         f"not {dtype}")
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

