"""Chunked batched solves: quarantine as an observed event.

The counterpart of ``poisson_ellipse_tpu.batch.driver``. The batched
engines already mask a poisoned lane out inside the loop; what the loop
cannot do is tell anyone which lane, at which iteration. The driver issues
the engine's bodies a chunk at a time and, after each chunk, reads the
loop's flags, the per-lane quarantine flags and iteration counts in one
host read; each lane newly quarantined in that chunk becomes one
``RecoveryEvent("lane-quarantine", iters[lane], HEALTH_NONFINITE, engine,
detail="lane j")``, also emitted on the ambient trace (``obs.trace``) as
``recovery:lane-quarantine`` with the lane as the schema's top-level
``lane`` key (``resilience.guard._record``). Healthy lanes are untouched:
their trajectory is the loop's, bit for bit.

``faults`` (``resilience.faultinject.FaultPlan``) injects lane-addressed
carry corruption at exact iterations: a chunk ends at each fault's
iteration and the fault corrupts that lane's slice of the carry there.
``timeout`` cancels at a chunk boundary with ``SolveTimeout``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg, batched_pipelined
from poisson_ellipse_tpu_torch.batch.batched_pcg import (
    BatchedPCGResult,
    batched_operands,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.resilience.faultinject import FaultPlan
from poisson_ellipse_tpu_torch.resilience.guard import (
    DEFAULT_CHUNK,
    HEALTH_NONFINITE,
    RecoveryEvent,
    _check_deadline,
    _record,
)
from poisson_ellipse_tpu_torch.solver.engine import BATCHED_ENGINES
from poisson_ellipse_tpu_torch.solver.pcg import run_chunked

# carry layouts per engine: the module, the field-name → index table the
# fault plans address (resilience.guard's adapters' contract), and the
# slots of the breakdown flags and of zr (γ₋₁ in the pipelined carry)
_LAYOUT = {
    "batched": {
        "module": batched_pcg,
        "fields": {"w": 1, "r": 2, "p": 3, "zr": 4},
        "zr": 4, "bd": 7,
    },
    "batched-pipelined": {
        "module": batched_pipelined,
        "fields": {
            "x": 1, "r": 2, "u": 3, "w": 4, "z": 5, "s": 6, "p": 7,
            "gamma": 8,
        },
        "zr": 8, "bd": 11,
    },
}


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
    faults: Optional[FaultPlan] = None,
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
    ``faults`` must be lane-addressed (``Fault(..., lane=j)``, j inside
    the batch); ``timeout`` is seconds, checked at each chunk boundary.
    """
    if engine not in BATCHED_ENGINES:
        raise ValueError(
            f"unknown batched engine {engine!r} (one of {BATCHED_ENGINES})"
        )
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    stencil = "pallas" if engine.endswith("-pallas") else "xla"
    lay = _LAYOUT[engine.removesuffix("-pallas")]
    mod = lay["module"]
    a, b, rhs = (operands if operands is not None
                 else batched_operands(problem, lanes, dtype, device))
    if rhs.shape[0] != lanes:
        raise ValueError(f"rhs carries {rhs.shape[0]} lanes, expected {lanes}")
    plan = faults if faults is not None else FaultPlan()
    for fault in plan.faults:
        if fault.lane is None:
            raise ValueError(
                "batched carries hold per-lane state: faults must be "
                "lane-addressed (Fault(..., lane=j)) so the corruption "
                "lands on one lane's slice"
            )
        if not 0 <= fault.lane < lanes:
            raise ValueError(
                f"fault lane {fault.lane} outside the {lanes}-lane batch"
            )
    events: list[RecoveryEvent] = []
    t0 = time.monotonic()
    max_iter = problem.max_iterations
    body = mod.make_body(problem, a, b, rhs, max_iter, mask=mask,
                         stencil=stencil)
    if state is None:
        # the pipelined carry starts with a stencil (w0 = A·u0)
        extra = {"stencil": stencil} if mod is batched_pipelined else {}
        state = mod.init_state(problem, a, b, rhs, mask=mask, **extra)
    carry = [state]
    seen = [False] * lanes

    def step(k: int):
        carry[0] = body(carry[0], k)

    def chunk_end(k: int):
        _check_deadline(timeout, t0, k)
        stop = plan.next_stop(k - 1)  # a fault AT k fires before this chunk
        if plan:
            carry[0] = plan.apply(k, carry[0], lay["fields"], lay["bd"],
                                  lay["zr"])
        return stop if stop is not None and k < stop else None

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
                _record(events, "lane-quarantine", iters[lane],
                        HEALTH_NONFINITE, engine, detail=f"lane {lane}",
                        lane=lane)
        seen[:] = [bool(q) for q in quar]

    run_chunked(step, flags, max_iter, chunk, on_read=on_read,
                chunk_end=chunk_end)
    return GuardedBatchedResult(result=mod.result_of(carry[0]),
                                recoveries=tuple(events), engine=engine)
