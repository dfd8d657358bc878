"""The serving request model: one solve ask, one classified outcome.

The port's own copy of ``poisson_ellipse_tpu.serve.request``: the same
fields, outcomes and journal form, so a request journaled by either
package replays in the other.

A production front-end never loses a request in an unnamed state: every
request admitted into the scheduler (:mod:`.scheduler`) carries an id,
an absolute deadline, and a retry budget, and every request *ends* in
exactly one of the :data:`OUTCOMES` — the terminal-state contract the
chaos harness (:mod:`.chaos`) asserts over the whole stream. Outcomes
map onto the process exit-code contract of ``resilience.errors``
(:data:`EXIT_BY_OUTCOME`), extended by the serving layer's shed code:

  ===============  ====  =====================================================
  outcome          exit  meaning
  ===============  ====  =====================================================
  completed        0     converged solution returned (possibly via the
                         guarded-fallback rung of the retry ladder)
  cap              1     iteration cap reached without convergence — the
                         harness's pre-existing exit-1 contract, per request
  failed           2     retry budget exhausted AND the guarded fallback
                         classified the solve diverged (or an unrecoverable
                         classified error)
  deadline-miss    4     the deadline passed — while queued (never dispatched)
                         or mid-solve (chunk-boundary cancel, partial result)
  shed             5     rejected at admission (queue full / projected
                         deadline miss); never queued, safe to resubmit after
                         ``retry_after_s``
  invalid          8     the request's geometry spec failed the admissibility
                         gate (``geom.validate``) AT ADMISSION — malformed,
                         empty, under-resolved, or operator-inadmissible; the
                         request was never journaled or dispatched (retracted
                         from the queue before anything durable saw it), so a
                         bad geometry can never poison a lane mid-batch
  ===============  ====  =====================================================

The wire/journal form of a request (:meth:`ServeRequest.spec`) is a flat
JSON object so the crash-safe journal (:mod:`.journal`) can persist and
replay it without pickling.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Optional

import numpy as np

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.resilience.errors import (
    EXIT_DIVERGED,
    EXIT_INVALID_GEOMETRY,
    EXIT_SHED,
    EXIT_TIMEOUT,
)

OUTCOMES = ("completed", "cap", "failed", "deadline-miss", "shed", "invalid")

EXIT_BY_OUTCOME = {
    "completed": 0,
    "cap": 1,
    "failed": EXIT_DIVERGED,
    "deadline-miss": EXIT_TIMEOUT,
    "shed": EXIT_SHED,
    "invalid": EXIT_INVALID_GEOMETRY,
}


def new_request_id() -> str:
    return uuid.uuid4().hex[:12]


@dataclasses.dataclass
class ServeRequest:
    """One queued solve: a problem plus its serving envelope.

    ``deadline`` is absolute on the scheduler's clock (``None`` = no
    deadline); ``max_retries`` bounds the degradation ladder's
    resubmissions (the final rung — the guarded single solve — rides on
    top of them). ``not_before`` / ``attempt`` are the retry-backoff
    bookkeeping the scheduler maintains; ``enqueued_t`` stamps the
    *current* queue visit (reset on every retry requeue — it feeds the
    per-wait ``time_in_queue_seconds`` histogram), ``admitted_t`` the
    first admission (it anchors the end-to-end ``total_s``).
    """

    problem: Problem
    deadline: Optional[float] = None
    max_retries: int = 1
    request_id: str = dataclasses.field(default_factory=new_request_id)
    # the JSON SDF spec of an arbitrary domain (None = the hard-coded
    # ellipse) and its degenerate-cut clamp threshold — validated at
    # ADMISSION (never mid-solve) against ``geom.validate``
    geometry: Optional[dict] = None
    theta: Optional[float] = None
    # the differentiable-solving kind (``diff.serving``): grad=True asks
    # for (value, gradient) of ``objective`` (a ``diff.objectives`` JSON
    # spec; None = Dirichlet energy) w.r.t. the geometry's parameters —
    # served as two consecutive lane solves (primal, then the IFT
    # adjoint with the same operator), terminally completing with
    # ``ServeResult.value``/``ServeResult.grad``
    grad: bool = False
    objective: Optional[dict] = None
    # multi-tenant admission class (``serve.queue``): ``tenant`` names
    # the accounting class (per-class queue quotas), ``priority`` its
    # weight — HIGHER is more important. Under pressure low-priority
    # work sheds first (queue-full preemption), ``pop_ready`` serves
    # priority-first, and a dying replica's high-priority work is
    # adopted first (``fleet.handoff``). Journal-round-tripped so a
    # replayed request keeps its class.
    tenant: str = "default"
    priority: int = 1
    # scheduler bookkeeping (not part of the wire spec)
    enqueued_t: Optional[float] = None
    admitted_t: Optional[float] = None
    not_before: float = 0.0
    attempt: int = 0
    dispatched: bool = False
    # journal-replayed (or peer-adopted) requests run COLD: the solve
    # cache is in-memory host state the journal never records, so a
    # replay's outcome must not depend on what it held — skipping the
    # warm-start consult is what pins replayed outcomes bit-identical
    # regardless of cache state (the chaos invariant)
    replayed: bool = False
    # the parsed SDF tree, cached after admission validation
    _geom_obj: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def geometry_sdf(self):
        """The parsed SDF tree of ``geometry``: None for the default
        ellipse; a spec raises until the geometry layer is ported."""
        if self.geometry is None:
            return None
        from poisson_ellipse_tpu_torch.solver.pcg import unported

        raise unported("a request's geometry=", "Queue A item 11")

    def spec(self) -> dict:
        """The flat JSON form the journal persists and replay rebuilds.

        Deadlines are journaled as *remaining seconds at admission*
        (``deadline_left_s``): the scheduler clock is monotonic and does
        not survive a process restart, so an absolute value would be
        meaningless to the replaying process.
        """
        p = self.problem
        return {
            "request_id": self.request_id,
            "M": p.M,
            "N": p.N,
            "delta": p.delta,
            "eps": p.eps,
            "norm": p.norm,
            "max_iter": p.max_iter,
            "deadline_left_s": (
                None if self.deadline is None or self.enqueued_t is None
                else max(self.deadline - self.enqueued_t, 0.0)
            ),
            "max_retries": self.max_retries,
            "geometry": self.geometry,
            "theta": self.theta,
            "grad": self.grad,
            "objective": self.objective,
            "tenant": self.tenant,
            "priority": self.priority,
        }

    @classmethod
    def from_spec(cls, spec: dict, now: float) -> "ServeRequest":
        """Rebuild a journaled request; the journaled remaining-deadline
        budget restarts from ``now`` (replay grants the request the time
        it had left when first admitted)."""
        left = spec.get("deadline_left_s")
        return cls(
            problem=Problem(
                M=spec["M"], N=spec["N"], delta=spec["delta"],
                eps=spec.get("eps"), norm=spec.get("norm", "weighted"),
                max_iter=spec.get("max_iter"),
            ),
            deadline=None if left is None else now + left,
            max_retries=spec.get("max_retries", 1),
            request_id=spec["request_id"],
            geometry=spec.get("geometry"),
            theta=spec.get("theta"),
            grad=bool(spec.get("grad", False)),
            objective=spec.get("objective"),
            tenant=spec.get("tenant", "default"),
            priority=int(spec.get("priority", 1)),
        )


@dataclasses.dataclass
class ServeResult:
    """One request's terminal state — every field host-side and final.

    ``partial`` marks a mid-solve deadline cancel: ``iters``/``diff``
    (and ``w`` when kept) describe the last chunk boundary reached, the
    ``run_report_partial`` stance applied per request. ``detail`` names
    the path that produced the outcome (``guarded-fallback``,
    ``expired-in-queue``, a shed reason, …).
    """

    request_id: str
    outcome: str
    iters: int = 0
    diff: float = float("inf")
    converged: bool = False
    partial: bool = False
    dispatched: bool = False
    attempts: int = 0
    time_in_queue_s: float = 0.0
    total_s: float = 0.0
    detail: Optional[str] = None
    retry_after_s: Optional[float] = None
    w: Optional[np.ndarray] = None
    # grad-kind terminals (``grad=True`` requests): the objective value
    # and the gradient w.r.t. the geometry's parameter vector
    value: Optional[float] = None
    grad: Optional[list] = None

    def __post_init__(self):
        if self.outcome not in OUTCOMES:
            raise ValueError(
                f"outcome {self.outcome!r} not one of {OUTCOMES}"
            )

    @property
    def exit_code(self) -> int:
        return EXIT_BY_OUTCOME[self.outcome]

    def json_dict(self) -> dict:
        """The loggable form (solution array elided — it belongs to the
        caller, not a trace line)."""
        out = dataclasses.asdict(self)
        out.pop("w")
        return out
