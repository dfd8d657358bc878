"""Engine selection: one entry point over the port's single-device engines.

The counterpart of ``poisson_ellipse_tpu.solver.engine``, holding the rows
the port has ported so far:

  engine            iteration                               kernels
  ----------------  --------------------------------------  --------------
  xla               the classical loop in plain PyTorch     none
  pallas            the classical loop, stencil by K-a      stencil
  fused             the rotated two-kernel iteration        fused_k1,
                                                            fused_k2
  resident          the whole solve, every array on chip    resident
  streamed          the whole solve, state on chip          streamed
  xl                the whole solve, all in device memory   xl
  pipelined         the Ghysels–Vanroose recurrence, one    none
                    dot bundle per iteration
  pipelined-pallas  the same, stencil and bundle by K-d,    stencil,
                    w₀ and the rebuilds by K-a              stencil_dots
  sstep             s iterations per basis and Gram         none
                    (s = ``sstep_s`` ∈ {2, 4})
  sstep-pallas      the same, the basis chain by K-a        stencil
  batched           B independent lanes in one loop         none
                    (``lanes=`` selects B), per-lane masks
                    and quarantine
  batched-pipelined the same lanes through the pipelined    none
                    recurrence, one (8, B) bundle a body
  batched-pallas    ``batched``, stencil by K-e             batched_stencil
  batched-pipelined-pallas                                  batched_stencil,
                    ``batched-pipelined``, stencil and      batched_stencil_dots
                    bundle by K-f, w₀ and the rebuilds by
                    K-e

The ``-pallas`` batched rows are the port's names for the JAX
``stencil="pallas"`` option of ``pcg_batched`` and
``pcg_batched_pipelined``, as ``pallas`` and ``pipelined-pallas`` name it
for the single-lane loops.

Policy (``select_engine``), as in the JAX package: f64 takes ``xla``; f32
walks the capacity ladder resident → streamed → xl and takes the first
whose gate admits the grid. The pipelined and s-step engines are on no
rung: ``auto`` never picks them, as in the JAX package. The gates are
computed from the card's own shared memory (``utils.device.capacity``),
from the same functions that size each kernel's launch, so a gate that
admits a grid is a launch that fits. On the CPU there is no on-chip memory for a block to keep state
in: there ``auto`` takes ``xl`` (its plain version) unless the caller
passes ``capacity=``. The batched engines are on no rung either; the
harness resolves ``auto`` with ``lanes > 1`` to ``batched``, as the JAX
harness does.

There is no degrade chain (the JAX ``build_solver`` walks down the ladder
when a Mosaic compile fails): the gate is exact, and a kernel that fails
to build or a cooperative launch the card refuses raises.

``storage_dtype`` (``ops.precision``) runs the storage-vs-compute split on
the engines whose row says ``storage``, as in the JAX table: ``xla``,
``pallas`` (K-g in place of K-a), ``pipelined``, ``pipelined-pallas`` (K-h
in place of K-d, K-g for the rebuilds), ``sstep``, ``sstep-pallas`` (K-g
in the basis chain) and ``batched``. ``streamed`` and ``xl`` have a
storage form in JAX (bf16 operand streams) that is not ported yet (ROADMAP
Queue A item 18); every other engine, ``auto`` included, refuses it with
the JAX error.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import resolve_storage_dtype
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    PCGResult,
    Solver,
    advance,
    init_state,
    reject_unported,
    result_of,
    unported,
)
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    resolve_device,
)

# One row per ported engine.
#   family   — "loop": the classical recurrence with the carry on the
#              device; "fused": the rotated two-kernel iteration;
#              "megakernel": the whole solve in one launch; "pipelined":
#              the one-bundle recurrence; "sstep": s iterations a body;
#              "batched": B lanes in one loop (``lanes=``)
#   kernels  — the hand-written kernels (ops._build launch-counter names)
#              the engine launches
#   capacity — the engine's rung on the capacity ladder "auto" walks
#              (None: not on it)
#   dtypes   — the dtypes the engine accepts
#   storage  — accepts ``storage_dtype`` (the JAX table's column; the port
#              of streamed's and xl's form is ROADMAP Queue A item 18)
ENGINE_CAPS = {
    "resident": dict(family="megakernel", kernels=("resident",), capacity=0,
                     dtypes=(torch.float32,), storage=False),
    "streamed": dict(family="megakernel", kernels=("streamed",), capacity=1,
                     dtypes=(torch.float32,), storage=True),
    "xl": dict(family="megakernel", kernels=("xl",), capacity=2,
               dtypes=(torch.float32,), storage=True),
    "xla": dict(family="loop", kernels=(), capacity=None,
                dtypes=(torch.float32, torch.float64), storage=True),
    "pallas": dict(family="loop", kernels=("stencil",), capacity=None,
                   dtypes=(torch.float32,), storage=True),
    "fused": dict(family="fused", kernels=("fused_k1", "fused_k2"),
                  capacity=None, dtypes=(torch.float32,), storage=False),
    "pipelined": dict(family="pipelined", kernels=(), capacity=None,
                      dtypes=(torch.float32, torch.float64), storage=True),
    "pipelined-pallas": dict(family="pipelined",
                             kernels=("stencil", "stencil_dots"),
                             capacity=None, dtypes=(torch.float32,),
                             storage=True),
    "sstep": dict(family="sstep", kernels=(), capacity=None,
                  dtypes=(torch.float32, torch.float64), storage=True),
    "sstep-pallas": dict(family="sstep", kernels=("stencil",), capacity=None,
                         dtypes=(torch.float32,), storage=True),
    "batched": dict(family="batched", kernels=(), capacity=None,
                    dtypes=(torch.float32, torch.float64), storage=True),
    "batched-pipelined": dict(family="batched", kernels=(), capacity=None,
                              dtypes=(torch.float32, torch.float64),
                              storage=False),
    "batched-pallas": dict(family="batched", kernels=("batched_stencil",),
                           capacity=None, dtypes=(torch.float32,),
                           storage=False),
    "batched-pipelined-pallas": dict(
        family="batched", kernels=("batched_stencil", "batched_stencil_dots"),
        capacity=None, dtypes=(torch.float32,), storage=False),
}

ENGINES = ("auto",) + tuple(ENGINE_CAPS)

# the s-step engines: ``build_solver``'s ``sstep_s`` sets their block size
SSTEP_ENGINES = tuple(
    e for e, c in ENGINE_CAPS.items() if c["family"] == "sstep"
)

# the lane-batched engines: ``build_solver``'s ``lanes`` sets their width
BATCHED_ENGINES = tuple(
    e for e, c in ENGINE_CAPS.items() if c["family"] == "batched"
)

# the engines that accept ``storage_dtype`` (the JAX package's tuple)
STORAGE_ENGINES = tuple(e for e, c in ENGINE_CAPS.items() if c["storage"])

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
                 capacity: DeviceCapacity | None = None, sstep_s: int = 4):
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

    ``sstep_s`` is the block size of the s-step engines (2 or 4).

    ``lanes`` is the width B of the lane-batched engines
    (``BATCHED_ENGINES``): their solver runs B solves of the problem in
    one loop and returns a ``batch.BatchedPCGResult``; every other engine
    takes ``lanes=1`` only.

    ``storage_dtype`` ("bf16", "f16", "f32", a torch dtype or None) stores
    the state and the rounded operands narrow on the ``STORAGE_ENGINES``
    (``ops.precision``); storage equal to ``dtype`` is the plain solve.
    """
    if lanes != 1 and engine not in BATCHED_ENGINES:
        raise ValueError(
            f"engine {engine!r} runs one solve per dispatch; lanes={lanes} "
            "needs the lane-batched engines ("
            + " / ".join(repr(e) for e in BATCHED_ENGINES) + ")"
        )
    # resolved early: a bad name or a widening request fails here, and
    # storage == compute normalises to None (the plain path)
    storage_dtype = resolve_storage_dtype(storage_dtype, dtype)
    if storage_dtype is not None and engine not in STORAGE_ENGINES:
        raise ValueError(
            f"engine {engine!r} has no storage-dtype form; choose from "
            f"{', '.join(STORAGE_ENGINES)} (or drop --storage-dtype)"
        )
    if storage_dtype is not None and ENGINE_CAPS[engine]["family"] == \
            "megakernel":
        raise unported(f"storage_dtype= on the {engine!r} engine",
                       "Queue A item 18")
    if engine in BATCHED_ENGINES:
        if history:
            raise ValueError(
                "the batched engines carry per-lane scalar recurrences, "
                "not the obs.convergence ring buffers; use a single-lane "
                "engine for history=True"
            )
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
    reject_unported(history, precond, storage_dtype, recycle=recycle,
                    geometry=geometry)
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

    family = ENGINE_CAPS[engine]["family"]
    stencil = "pallas" if engine.endswith("pallas") else "xla"
    if family == "batched":
        from poisson_ellipse_tpu_torch.batch import (
            batched_pcg,
            batched_pipelined,
        )

        mod = batched_pipelined if "pipelined" in engine else batched_pcg
        extra = ({"stencil": stencil} if mod is batched_pipelined
                 else {"storage_dtype": storage_dtype})

        def run(a, b, rhs):
            state, syncs = mod.advance(
                problem, a, b, rhs,
                mod.init_state(problem, a, b, rhs, **extra),
                stencil=stencil, chunk=chunk,
                **({} if mod is batched_pipelined else
                   {"storage_dtype": storage_dtype}))
            return mod.result_of(state), syncs

        return (Solver(run),
                batched_pcg.batched_operands(problem, lanes, dtype, dev),
                engine)
    if family == "pipelined":
        from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp

        def run(a, b, rhs):
            state, syncs = pp.advance(
                problem, a, b, rhs,
                pp.init_state(problem, a, b, rhs, stencil=stencil,
                              storage_dtype=storage_dtype),
                stencil=stencil, chunk=chunk, storage_dtype=storage_dtype)
            return pp.result_of(state), syncs
    elif family == "sstep":
        from poisson_ellipse_tpu_torch.ops import sstep_pcg as ss

        if sstep_s not in ss.SSTEP_CHOICES:
            raise ValueError(f"s must be one of {ss.SSTEP_CHOICES}, got "
                             f"{sstep_s}")

        def run(a, b, rhs):
            state, syncs = ss.advance(
                problem, a, b, rhs,
                ss.init_state(problem, a, b, rhs,
                              storage_dtype=storage_dtype),
                s=sstep_s, stencil=stencil, chunk=chunk,
                storage_dtype=storage_dtype)
            return result_of(state), syncs
    else:
        def run(a, b, rhs):
            state, syncs = advance(
                problem, a, b, rhs,
                init_state(problem, a, b, rhs, storage_dtype=storage_dtype),
                stencil=stencil, chunk=chunk, storage_dtype=storage_dtype)
            return result_of(state), syncs

    return Solver(run), assembly.assemble(problem, dtype, dev), engine


def solve(problem: Problem, engine: str = "auto", dtype=torch.float32,
          device=None, chunk: int = DEFAULT_CHUNK, **options) -> PCGResult:
    """Assemble and solve on one device with the selected engine."""
    solver, args, _ = build_solver(problem, engine, dtype, device, chunk,
                                   **options)
    return solver(*args)
