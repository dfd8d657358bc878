"""Bounded admission: backpressure and load-shedding at the front door.

The port's own copy of ``poisson_ellipse_tpu.serve.queue``, pure Python
over the port's ``obs.metrics`` and ``obs.trace``.

An unbounded queue converts overload into silent latency: every request
is "accepted" and then misses its deadline anyway, after holding memory
the whole time.
This queue is bounded twice — an explicit capacity check that *rejects*
(the backpressure contract: the caller learns now, with a
``retry_after_s`` hint) and a ``deque(maxlen=...)`` backstop that can
never silently drop because the check runs first.

Shedding is deadline-aware: when the projected wait (an EWMA of recent
per-request service time, scaled by queue depth over lane width)
already overruns a request's deadline, admitting it would only burn a
lane on a guaranteed miss — reject-with-retry-after instead. A shed
whose terminal outcome IS shed emits a ``serve:shed`` trace event
(request-addressed, schema v3) and bumps the ``shed_total`` counter;
rejections the scheduler classifies under another outcome (replay
``deadline-miss``, retry-overflow ``failed``) stay silent here so the
counter always equals the number of shed outcomes. Depth is published
as the ``queue_depth`` gauge on every transition.

Multi-tenant admission classes ride on the same bound: every request
carries ``tenant``/``priority`` (``serve.request``), and three policies
apply when they differ —

- **per-class quotas** (``class_quotas={tenant: max_queued}``): a
  tenant at its quota sheds with reason ``tenant-quota`` even while the
  queue has room, so one chatty tenant cannot monopolise the bound;
- **queue-full preemption**: a full queue admits a HIGHER-priority
  arrival by evicting the lowest-priority (most recently enqueued)
  queued request instead of shedding the arrival — low-priority work
  sheds first under pressure, never the other way around. Victims land
  in ``take_evicted()`` for the scheduler to classify (terminal
  ``shed`` with detail ``preempted-by-priority``), never dropped;
- **priority-first dispatch**: ``pop_ready`` serves the highest
  priority among ready requests, FIFO within a class.

Priority scheduling can starve: a class that stays ready-but-unserved
past ``starvation_after_s`` is a LOUD ``fleet:starvation`` event (and
``fleet_starvation_total`` count) once per episode — never silent. The
queue tracks detection (``starvation_episodes``) and announcement
(``starvation_announced``) separately so the chaos report can prove no
episode went unannounced.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional

from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.serve.request import ServeRequest

# starting estimate of per-request service seconds, before the EWMA has
# seen a completion (deliberately small: the first requests of a cold
# server should not be shed on a pessimistic guess)
_INITIAL_SERVICE_S = 0.05
_EWMA_ALPHA = 0.2


class AdmissionQueue:
    """FIFO admission with backpressure and deadline-aware shedding.

    ``lanes`` is the scheduler's concurrent lane width (the divisor of
    the projected-wait estimate); ``clock`` the scheduler's monotonic
    clock (injectable for deterministic deadline tests).
    """

    def __init__(self, capacity: int, lanes: int,
                 clock: Callable[[], float] = time.monotonic,
                 class_quotas: Optional[dict] = None,
                 starvation_after_s: Optional[float] = None):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self.capacity = capacity
        self.lanes = lanes
        self.clock = clock
        # maxlen is the structural backstop; admit()'s
        # explicit capacity check rejects BEFORE append, so the deque's
        # silent-drop-on-full behaviour is unreachable
        self._q: collections.deque = collections.deque(maxlen=capacity)
        self._service_ewma = _INITIAL_SERVICE_S
        # multi-tenant policy state (module docstring): quotas, the
        # preemption victim hand-off, and per-episode starvation
        # bookkeeping (detection and announcement counted separately so
        # "never silent" is checkable, not asserted)
        self.class_quotas = dict(class_quotas) if class_quotas else None
        self.starvation_after_s = starvation_after_s
        self._evicted: list[ServeRequest] = []
        self.starvation_episodes: dict[str, int] = {}
        self.starvation_announced: dict[str, int] = {}
        self._starving: set[str] = set()

    def __len__(self) -> int:
        return len(self._q)

    def holds(self, request_id: str) -> bool:
        """Whether a queued request carries this id (the scheduler's
        duplicate-admission guard)."""
        return any(r.request_id == request_id for r in self._q)

    # -- load model ---------------------------------------------------------

    def observe_service(self, seconds: float) -> None:
        """Fold one completed request's service time into the EWMA the
        projected-wait shed policy reads."""
        self._service_ewma = (
            (1 - _EWMA_ALPHA) * self._service_ewma + _EWMA_ALPHA * seconds
        )

    def projected_wait(self) -> float:
        """Expected queueing delay for a request admitted now: queued
        work ahead of it, spread over the lane width."""
        return self._service_ewma * (len(self._q) + 1) / self.lanes

    # -- admission ----------------------------------------------------------

    def admit(self, request: ServeRequest,
              record_shed: bool = True) -> tuple[bool, Optional[float],
                                                 Optional[str]]:
        """Admit or shed; returns ``(accepted, retry_after_s, reason)``.

        Shed reasons: ``queue-full`` (depth at capacity) and
        ``deadline-infeasible`` (projected wait alone overruns the
        request's deadline). ``retry_after_s`` estimates when capacity
        should free up — the backpressure hint a client honours instead
        of hammering. ``record_shed=False`` suppresses the shed
        counter/event for callers that classify the rejection under a
        different terminal outcome (the scheduler's replay path records
        ``deadline-miss``) — ``shed_total`` must equal the number of
        requests whose *outcome* is shed.
        """
        now = self.clock()
        if self.class_quotas is not None:
            quota = self.class_quotas.get(request.tenant)
            queued = sum(
                1 for r in self._q if r.tenant == request.tenant
            )
            if quota is not None and queued >= quota:
                retry_after = self.projected_wait()
                if record_shed:
                    self._shed(request, "tenant-quota", retry_after)
                return False, retry_after, "tenant-quota"
        if len(self._q) >= self.capacity:
            if not self._preempt_for(request):
                retry_after = self.projected_wait()
                if record_shed:
                    self._shed(request, "queue-full", retry_after)
                return False, retry_after, "queue-full"
        if request.deadline is not None:
            wait = self.projected_wait()
            if now + wait > request.deadline:
                retry_after = wait
                if record_shed:
                    self._shed(request, "deadline-infeasible", retry_after)
                return False, retry_after, "deadline-infeasible"
        request.enqueued_t = now
        if request.admitted_t is None:
            request.admitted_t = now
        self._q.append(request)
        obs_metrics.gauge("queue_depth").set(len(self._q))
        obs_trace.event(
            "serve:admit", request_id=request.request_id,
            depth=len(self._q), grid=[request.problem.M, request.problem.N],
        )
        return True, None, None

    def _preempt_for(self, request: ServeRequest) -> bool:
        """Queue-full arbitration: evict the lowest-priority (most
        recently enqueued among ties) queued request STRICTLY below the
        arrival's priority, or report False (equal priority never
        preempts — FIFO fairness within a class). The victim moves to
        the ``take_evicted()`` hand-off for the scheduler to classify
        terminally; it is never silently dropped."""
        victim_i = None
        victim = None
        for i, req in enumerate(self._q):
            if req.priority >= request.priority:
                continue
            if victim is None or req.priority < victim.priority or (
                req.priority == victim.priority
                and req.enqueued_t >= victim.enqueued_t
            ):
                victim_i, victim = i, req
        if victim is None:
            return False
        del self._q[victim_i]
        self._evicted.append(victim)
        obs_metrics.counter("preempted_total").inc()
        obs_metrics.gauge("queue_depth").set(len(self._q))
        obs_trace.event(
            "serve:preempt", request_id=victim.request_id,
            tenant=victim.tenant, priority=victim.priority,
            by=request.request_id, by_priority=request.priority,
            depth=len(self._q),
        )
        # the victim's terminal outcome IS shed (the scheduler
        # classifies it from take_evicted), so the shed counter/event
        # fire here to keep shed_total == shed outcomes
        self._shed(victim, "preempted-by-priority", self.projected_wait())
        return True

    def take_evicted(self) -> list[ServeRequest]:
        """Drain the preemption victims accumulated since the last call
        (the scheduler classifies each as a terminal ``shed``)."""
        victims, self._evicted = self._evicted, []
        return victims

    def retract(self, request: ServeRequest, reason: str) -> None:
        """Undo an admission that cannot be honoured after all (the
        scheduler's write-ahead journal refused it): remove the request,
        republish the depth gauge, and emit the compensating
        ``serve:retract`` event so the earlier ``serve:admit`` does not
        read as a live request in the trace."""
        self._q.remove(request)
        obs_metrics.gauge("queue_depth").set(len(self._q))
        obs_trace.event(
            "serve:retract", request_id=request.request_id, reason=reason,
            depth=len(self._q),
        )

    def requeue(self, request: ServeRequest) -> bool:
        """Put a retried request back (backpressure still applies: a
        full queue rejects the retry — overload must not be hidden
        inside the retry ladder; the scheduler classifies the rejection
        ``failed``, so no shed event fires here). Returns whether it
        was accepted."""
        if len(self._q) >= self.capacity:
            return False
        # a retry starts a NEW queue visit: re-stamp so its histogram
        # sample measures this wait, not this wait plus the failed
        # attempt's solve time (admitted_t keeps the end-to-end anchor)
        request.enqueued_t = self.clock()
        self._q.append(request)
        obs_metrics.gauge("queue_depth").set(len(self._q))
        return True

    def _shed(self, request: ServeRequest, reason: str,
              retry_after: float) -> None:
        obs_metrics.counter("shed_total").inc()
        obs_trace.event(
            "serve:shed", request_id=request.request_id, reason=reason,
            retry_after_s=round(retry_after, 4), depth=len(self._q),
        )

    # -- dispatch side ------------------------------------------------------

    def pop_ready(self, now: float) -> Optional[ServeRequest]:
        """The highest-priority request whose retry backoff has elapsed
        (``not_before <= now``), FIFO within a priority class, removed;
        None when none is ready. Every pop also runs the starvation
        scan: a class left ready-but-unserved past
        ``starvation_after_s`` announces loudly (module docstring)."""
        best_i = None
        best = None
        for i, req in enumerate(self._q):
            if req.not_before <= now and (
                best is None or req.priority > best.priority
            ):
                best_i, best = i, req
        if best is None:
            return None
        del self._q[best_i]
        obs_metrics.gauge("queue_depth").set(len(self._q))
        self._scan_starvation(now, served=best.tenant)
        return best

    def _scan_starvation(self, now: float, served: str) -> None:
        """Detect-and-announce, once per episode: any tenant with a
        ready request older than ``starvation_after_s`` while ANOTHER
        tenant gets served is starving. Detection
        (``starvation_episodes``) and the ``fleet:starvation`` event /
        counter (``starvation_announced``) are bumped in the same
        breath — the chaos report cross-checks the two so a refactor
        cannot keep detecting but stop announcing."""
        if self.starvation_after_s is None:
            return
        oldest: dict[str, float] = {}
        for req in self._q:
            if req.not_before <= now and req.enqueued_t is not None:
                wait = now - req.enqueued_t
                if wait > oldest.get(req.tenant, -1.0):
                    oldest[req.tenant] = wait
        # a served or drained tenant's episode is over; it may starve
        # (and announce) again later
        self._starving &= set(oldest)
        self._starving.discard(served)
        for tenant, wait in sorted(oldest.items()):
            if tenant == served or wait <= self.starvation_after_s:
                continue
            if tenant in self._starving:
                continue
            self._starving.add(tenant)
            self.starvation_episodes[tenant] = (
                self.starvation_episodes.get(tenant, 0) + 1
            )
            self.starvation_announced[tenant] = (
                self.starvation_announced.get(tenant, 0) + 1
            )
            obs_metrics.counter("fleet_starvation_total").inc()
            obs_trace.event(
                "fleet:starvation", tenant=tenant,
                waited_s=round(wait, 4), depth=len(self._q),
            )

    def request_ids(self) -> set[str]:
        """Ids currently queued (the fleet's co-ownership audit reads
        this alongside lanes, backlog and journal)."""
        return {r.request_id for r in self._q}

    def expire(self, now: float) -> list[ServeRequest]:
        """Remove and return every queued request whose deadline has
        passed — they are shed *from the queue* (never dispatched); the
        scheduler classifies them ``deadline-miss``."""
        expired = [
            r for r in self._q
            if r.deadline is not None and now > r.deadline
        ]
        if expired:
            for r in expired:
                self._q.remove(r)
            obs_metrics.gauge("queue_depth").set(len(self._q))
        return expired

    def push_front(self, request: ServeRequest) -> None:
        """Return a popped-but-undispatchable request to the head of the
        line (its bucket had no free lane this boundary) — FIFO order is
        preserved, and the slot it vacated moments ago bounds the depth,
        so the maxlen backstop cannot trip."""
        self._q.appendleft(request)
        obs_metrics.gauge("queue_depth").set(len(self._q))

    def next_ready_in(self, now: float) -> Optional[float]:
        """Seconds until the earliest backoff elapses (None when empty
        or something is ready now) — the drain loop's idle-wait hint."""
        if not self._q:
            return None
        waits = [r.not_before - now for r in self._q]
        soonest = min(waits)
        return None if soonest <= 0 else soonest
