"""Chunked batched solves: quarantine as an observed event.

The counterpart of ``poisson_ellipse_tpu.batch.driver``. The batched
engines already mask a poisoned lane out inside the loop; what the loop
cannot do is tell anyone which lane, at which iteration. The driver issues
the engine's bodies a chunk at a time and, after each chunk, reads the
per-lane flag vector in one host read; each lane newly quarantined in that
chunk becomes one ``RecoveryEvent("lane-quarantine", iters[lane],
HEALTH_NONFINITE, engine, detail="lane j")``. Healthy lanes are untouched:
their trajectory is the loop's.

Each event is also emitted on the ambient trace (``obs.trace``) as
``recovery:lane-quarantine`` with the lane as the schema's top-level
``lane`` key, as the JAX guard's ``_record`` emits it. Not ported in this
slice: lane-addressed fault injection (``faults=``) and the graceful
timeout (``timeout=``), both ROADMAP Queue A item 9.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg, batched_pipelined
from poisson_ellipse_tpu_torch.batch.batched_pcg import (
    BatchedPCGResult,
    batched_operands,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.solver.engine import BATCHED_ENGINES
from poisson_ellipse_tpu_torch.solver.pcg import run_chunked, unported

# the port's copies of poisson_ellipse_tpu/resilience/guard.py's health bit
# for a non-finite carry and its chunk length
HEALTH_NONFINITE = 2
DEFAULT_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One recovery action: what fired, where, and what the guard did
    (``resilience.guard.RecoveryEvent`` in the JAX package)."""

    kind: str
    at_iter: int
    health: int
    engine: str
    detail: str = ""


# each engine's module (the JAX table's carry-slot addressing for fault
# injection comes with ROADMAP Queue A item 9)
_LAYOUT = {"batched": batched_pcg, "batched-pipelined": batched_pipelined}


class GuardedBatchedResult(NamedTuple):
    """A chunked batched solve's outcome: per-lane results plus the
    quarantine story (empty ``recoveries``: every lane ran healthy)."""

    result: BatchedPCGResult
    recoveries: tuple[RecoveryEvent, ...]
    engine: str


def solve_batched(
    problem: Problem,
    lanes: int,
    engine: str = "batched",
    dtype=torch.float32,
    *,
    operands=None,
    mask=None,
    chunk: int = DEFAULT_CHUNK,
    faults=None,
    timeout: Optional[float] = None,
    device=None,
    state=None,
) -> GuardedBatchedResult:
    """One chunked batched solve with lane-quarantine reporting.

    ``engine`` is one of ``BATCHED_ENGINES``; the ``-pallas`` forms run the
    layout of their plain engine through the kernels. ``operands`` is an
    optional (a, b, rhs) triple with a lane-stacked rhs; by default the
    problem is assembled on ``device`` (cuda unless ``device='cpu'``) and
    its RHS tiled over ``lanes``. ``state`` is a carry of the engine's
    layout to continue from (default: the engine's ``init_state``).
    """
    if engine not in BATCHED_ENGINES:
        raise ValueError(
            f"unknown batched engine {engine!r} (one of {BATCHED_ENGINES})"
        )
    if faults is not None:
        raise unported("faults=", "Queue A item 9")
    if timeout is not None:
        raise unported("timeout=", "Queue A item 9")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    stencil = "pallas" if engine.endswith("-pallas") else "xla"
    mod = _LAYOUT[engine.removesuffix("-pallas")]
    a, b, rhs = (operands if operands is not None
                 else batched_operands(problem, lanes, dtype, device))
    if rhs.shape[0] != lanes:
        raise ValueError(f"rhs carries {rhs.shape[0]} lanes, expected {lanes}")
    max_iter = problem.max_iterations
    body = mod.make_body(problem, a, b, rhs, max_iter, mask=mask,
                         stencil=stencil)
    if state is None:
        # the pipelined carry starts with a stencil (w0 = A·u0)
        extra = {"stencil": stencil} if mod is batched_pipelined else {}
        state = mod.init_state(problem, a, b, rhs, mask=mask, **extra)
    carry = [state]
    events: list[RecoveryEvent] = []
    seen = [False] * lanes

    def step(k: int):
        carry[0] = body(carry[0], k)

    def flags():
        # one host read a chunk: the loop's flags, then per lane the
        # quarantine flag and the iteration count
        st = carry[0]
        return torch.cat([batched_pcg.running(st),
                          st.quarantined.to(st.k.dtype), st.iters])

    def on_read(vals):
        quar, iters = vals[3:3 + lanes], vals[3 + lanes:]
        for lane in range(lanes):
            if quar[lane] and not seen[lane]:
                events.append(RecoveryEvent(
                    "lane-quarantine", iters[lane], HEALTH_NONFINITE, engine,
                    detail=f"lane {lane}"))
                obs_trace.event("recovery:lane-quarantine", lane=lane,
                                iter=iters[lane], health="nonfinite",
                                engine=engine, detail=f"lane {lane}")
        seen[:] = [bool(q) for q in quar]

    run_chunked(step, flags, max_iter, chunk, on_read=on_read)
    return GuardedBatchedResult(result=mod.result_of(carry[0]),
                                recoveries=tuple(events), engine=engine)
