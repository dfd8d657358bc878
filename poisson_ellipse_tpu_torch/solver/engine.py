"""Engine selection: one entry point over the port's single-device engines.

The counterpart of ``poisson_ellipse_tpu.solver.engine``, holding the rows
this slice ports:

  engine   iteration                                   kernels
  ------   -----------------------------------------   ------------------
  xla      the classical loop in plain PyTorch         none
  pallas   the classical loop, stencil by kernel K-a   stencil
  fused    the rotated two-kernel iteration            fused_k1, fused_k2

Policy (``select_engine``): f64 takes ``xla``, as in the JAX package;
every other dtype takes ``fused``. On the TPU ``auto`` walks the
whole-solve kernels (resident → streamed → xl); those are not ported yet
(ROADMAP Queue B items 3-5), and until they are, ``fused`` is the port's
fastest engine. A kernel that fails to build raises: there is no degrade
chain.
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
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# One row per ported engine.
#   family  — "loop": the classical recurrence with the carry on the device;
#             "fused": the rotated two-kernel iteration
#   kernels — the hand-written kernels (ops._build launch-counter names)
#             one iteration launches
#   dtypes  — the dtypes the engine accepts
ENGINE_CAPS = {
    "xla": dict(family="loop", kernels=(),
                dtypes=(torch.float32, torch.float64)),
    "pallas": dict(family="loop", kernels=("stencil",),
                   dtypes=(torch.float32,)),
    "fused": dict(family="fused", kernels=("fused_k1", "fused_k2"),
                  dtypes=(torch.float32,)),
}

ENGINES = ("auto",) + tuple(ENGINE_CAPS)


def select_engine(problem: Problem, dtype=torch.float32) -> str:
    """The engine "auto" resolves to: ``xla`` for f64, else ``fused``
    (until the whole-solve kernels are ported)."""
    if dtype == torch.float64:
        return "xla"
    return "fused"


def build_solver(problem: Problem, engine: str = "auto",
                 dtype=torch.float32, device=None,
                 chunk: int = DEFAULT_CHUNK, history: bool = False,
                 lanes: int = 1, geometry=None, storage_dtype=None,
                 precond=None, recycle=None):
    """(solver, args, resolved_engine) for a single-device solve.

    Operands are assembled in f64 on the host and rounded once to
    ``dtype`` on ``device`` (cuda unless ``device='cpu'``). ``solver(*args)``
    returns a ``PCGResult`` and may be called many times;
    ``solver.host_syncs`` counts the host reads of its last call (one per
    ``chunk`` iterations).
    """
    reject_unported(history, precond, storage_dtype, recycle=recycle,
                    geometry=geometry, lanes=lanes)
    dev = resolve_device(device)
    if engine == "auto":
        engine = select_engine(problem, dtype)
    if engine not in ENGINE_CAPS:
        raise ValueError(f"unknown engine: {engine!r} (choose from {ENGINES})")
    if dtype not in ENGINE_CAPS[engine]["dtypes"]:
        raise ValueError(f"engine {engine!r} does not run {dtype}")
    if engine == "fused":
        from poisson_ellipse_tpu_torch.ops.fused_pcg import build_fused_solver

        solver, args = build_fused_solver(problem, dtype, dev, chunk)
        return solver, args, engine

    def run(a, b, rhs):
        state, syncs = advance(problem, a, b, rhs,
                               init_state(problem, a, b, rhs),
                               stencil=engine, chunk=chunk)
        return result_of(state), syncs

    return Solver(run), assembly.assemble(problem, dtype, dev), engine


def solve(problem: Problem, engine: str = "auto", dtype=torch.float32,
          device=None, chunk: int = DEFAULT_CHUNK, **unported_options
          ) -> PCGResult:
    """Assemble and solve on one device with the selected engine."""
    solver, args, _ = build_solver(problem, engine, dtype, device, chunk,
                                   **unported_options)
    return solver(*args)
