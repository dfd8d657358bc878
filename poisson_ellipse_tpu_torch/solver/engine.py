"""Engine selection: one entry point over the port's single-device engines.

The counterpart of ``poisson_ellipse_tpu.solver.engine``, holding the rows
the port has ported so far:

  engine    iteration                                   kernels
  --------  ------------------------------------------  ------------------
  xla       the classical loop in plain PyTorch         none
  pallas    the classical loop, stencil by kernel K-a   stencil
  fused     the rotated two-kernel iteration            fused_k1, fused_k2
  resident  the whole solve, every array on chip        resident
  streamed  the whole solve, state on chip              streamed
  xl        the whole solve, all in device memory       xl

Policy (``select_engine``), as in the JAX package: f64 takes ``xla``; f32
walks the capacity ladder resident → streamed → xl and takes the first
whose gate admits the grid. The gates are computed from the card's own
shared memory (``utils.device.capacity``), from the same functions that
size each kernel's launch, so a gate that admits a grid is a launch that
fits. On the CPU there is no on-chip memory for a block to keep state
in: there ``auto`` takes ``xl`` (its plain version) unless the caller
passes ``capacity=``.

There is no degrade chain (the JAX ``build_solver`` walks down the ladder
when a Mosaic compile fails): the gate is exact, and a kernel that fails
to build or a cooperative launch the card refuses raises.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    PCGResult,
    Solver,
    advance,
    init_state,
    reject_unported,
    result_of,
)
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    resolve_device,
)

# One row per ported engine.
#   family   — "loop": the classical recurrence with the carry on the
#              device; "fused": the rotated two-kernel iteration;
#              "megakernel": the whole solve in one launch
#   kernels  — the hand-written kernels (ops._build launch-counter names)
#              the engine launches
#   capacity — the engine's rung on the capacity ladder "auto" walks
#              (None: not on it)
#   dtypes   — the dtypes the engine accepts
ENGINE_CAPS = {
    "resident": dict(family="megakernel", kernels=("resident",), capacity=0,
                     dtypes=(torch.float32,)),
    "streamed": dict(family="megakernel", kernels=("streamed",), capacity=1,
                     dtypes=(torch.float32,)),
    "xl": dict(family="megakernel", kernels=("xl",), capacity=2,
               dtypes=(torch.float32,)),
    "xla": dict(family="loop", kernels=(), capacity=None,
                dtypes=(torch.float32, torch.float64)),
    "pallas": dict(family="loop", kernels=("stencil",), capacity=None,
                   dtypes=(torch.float32,)),
    "fused": dict(family="fused", kernels=("fused_k1", "fused_k2"),
                  capacity=None, dtypes=(torch.float32,)),
}

ENGINES = ("auto",) + tuple(ENGINE_CAPS)

# the capacity ladder "auto" walks: the rungs in order
CAPACITY_LADDER = tuple(sorted(
    (e for e, c in ENGINE_CAPS.items() if c["capacity"] is not None),
    key=lambda e: ENGINE_CAPS[e]["capacity"],
))


def select_engine(problem: Problem, dtype=torch.float32,
                  capacity: DeviceCapacity | None = None) -> str:
    """The engine "auto" resolves to: ``xla`` for f64; else the first rung
    of resident → streamed → xl whose gate admits the grid on
    ``capacity``. Without a capacity (the CPU) that is ``xl``."""
    from poisson_ellipse_tpu_torch.ops.resident_pcg import fits_resident
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import fits_streamed

    if dtype == torch.float64:
        return "xla"
    if capacity is None:
        return CAPACITY_LADDER[-1]
    # the last rung keeps everything in device memory and admits any grid
    gates = {"resident": fits_resident, "streamed": fits_streamed}
    for engine in CAPACITY_LADDER[:-1]:
        if gates[engine](problem, dtype, capacity):
            return engine
    return CAPACITY_LADDER[-1]


def build_solver(problem: Problem, engine: str = "auto",
                 dtype=torch.float32, device=None,
                 chunk: int = DEFAULT_CHUNK, history: bool = False,
                 lanes: int = 1, geometry=None, storage_dtype=None,
                 precond=None, recycle=None,
                 capacity: DeviceCapacity | None = None):
    """(solver, args, resolved_engine) for a single-device solve.

    Operands are assembled in f64 on the host and rounded once to
    ``dtype`` on ``device`` (cuda unless ``device='cpu'``). ``solver(*args)``
    returns a ``PCGResult`` and may be called many times;
    ``solver.host_syncs`` counts the host reads of its last call (one per
    ``chunk`` iterations for the loop engines, one per solve for the
    whole-solve engines).

    ``capacity`` is the card the gates and launch shapes read: on a CUDA
    device it defaults to that card's; on the CPU it defaults to none, so
    ``auto`` takes ``xl``, and a given capacity plans as on that card.
    """
    reject_unported(history, precond, storage_dtype, recycle=recycle,
                    geometry=geometry, lanes=lanes)
    dev = resolve_device(device)
    if capacity is None and dev.type == "cuda":
        capacity = device_capacity(dev)
    if engine == "auto":
        engine = select_engine(problem, dtype, capacity)
    if engine not in ENGINE_CAPS:
        raise ValueError(f"unknown engine: {engine!r} (choose from {ENGINES})")
    if dtype not in ENGINE_CAPS[engine]["dtypes"]:
        raise ValueError(f"engine {engine!r} does not run {dtype}")
    if engine == "fused":
        from poisson_ellipse_tpu_torch.ops.fused_pcg import build_fused_solver

        solver, args = build_fused_solver(problem, dtype, dev, chunk)
        return solver, args, engine
    if engine == "resident":
        from poisson_ellipse_tpu_torch.ops.resident_pcg import (
            build_resident_solver,
        )

        solver, args = build_resident_solver(problem, dtype, dev, capacity)
        return solver, args, engine
    if engine == "streamed":
        from poisson_ellipse_tpu_torch.ops.streamed_pcg import (
            build_streamed_solver,
        )

        solver, args = build_streamed_solver(problem, dtype, dev, capacity)
        return solver, args, engine
    if engine == "xl":
        from poisson_ellipse_tpu_torch.ops.xl_pcg import build_xl_solver

        solver, args = build_xl_solver(problem, dtype, dev, capacity)
        return solver, args, engine

    def run(a, b, rhs):
        state, syncs = advance(problem, a, b, rhs,
                               init_state(problem, a, b, rhs),
                               stencil=engine, chunk=chunk)
        return result_of(state), syncs

    return Solver(run), assembly.assemble(problem, dtype, dev), engine


def solve(problem: Problem, engine: str = "auto", dtype=torch.float32,
          device=None, chunk: int = DEFAULT_CHUNK, **options) -> PCGResult:
    """Assemble and solve on one device with the selected engine."""
    solver, args, _ = build_solver(problem, engine, dtype, device, chunk,
                                   **options)
    return solver(*args)
