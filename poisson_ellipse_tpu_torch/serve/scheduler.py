"""Continuous-batching scheduler: retire-and-refill at chunk boundaries.

The counterpart of ``poisson_ellipse_tpu.serve.scheduler``. The batched
engines freeze a finished lane in place until the whole batch drains —
fine for a fixed workload, wrong for a server, where a converged lane is
a free slot someone is queueing for. This scheduler generalizes the
in-loop freeze-out mask of ``batch.batched_pcg`` from *freeze* to
*swap-in*: between chunks (the only place the host touches the carry), a
finished lane's slice of the carry is re-initialised with the next queued
request's embedded operands, and the same bucket advance keeps running:
every per-request number (h1, h2, δ, the mask, the RHS) is a per-lane
tensor, the ``runtime.compile_cache`` embedding made per lane. This is
Orca-style iteration-level scheduling (Yu et al., OSDI '22) with PCG
chunks in place of decode steps.

The robustness envelope around the packing loop:

- **Admission** — bounded queue, backpressure, deadline-aware shedding
  (``serve.queue``); every rejection carries ``retry_after_s``.
- **Deadlines** — enforced at chunk granularity: expiry while queued is
  shed un-dispatched; expiry mid-solve cancels at the chunk boundary
  with a partial result; a request that converges at the same boundary
  its deadline passes gets its result (converged lanes retire *first*).
- **Retries** — a per-request budget with exponential backoff walking
  the degradation ladder: quarantined/broken lane → resubmit on a
  fresh lane → guarded single solve (``resilience.guard``, the plain
  ``xla`` loop) as the final rung; whatever the ladder ends in is a
  classified outcome.
- **Durability** — a crash-safe request journal (``serve.journal``):
  admissions are journaled before they are acknowledged, so a killed
  server replays every admitted-but-unfinished request on restart.
- **Observability** — every admission/refill/retirement/shed/retry/
  replay is a request-addressed ``obs.trace`` event (schema v3) and an
  ``obs.metrics`` counter/histogram (``queue_depth``,
  ``time_in_queue_seconds``, ``deadline_miss_total``, ``shed_total``).

On the device, a bucket's chunk is the plain per-lane loop
(``batched_pcg``'s bodies with per-lane operands, the counterpart of the
JAX package's XLA stencil: the lane kernels K-e/K-f take lane-shared
coefficients only). The host's work at a boundary is one stacked
device-to-host read of every lane's flags, count and step norm, and the
in-place slice writes of each refill; the batch's iteration counter is
mirrored on the host from that read, so issuing a chunk reads nothing.

Refill only targets the **classical** batched engine: a refilled lane is
bitwise the same request solved on a fresh lane of the same batch width,
and only the classical carry round-trips exactly through ``init_state``.
On the card that takes one layout choice: PyTorch's CUDA reductions load
a lane's elements in vectors and treat a misaligned lane start apart, so
a lane whose plane starts off a vector boundary sums in another order
than lane 0. A batch context's lane planes are therefore ``LANE_ALIGN``
elements a row-major multiple: the node grid's rows are padded from
Nb + 1 to ``lane_pitch`` columns of exact zeros, outside every lane's
mask (the bucket, its key and every cropped result stay the JAX
package's).

Not ported here: the lane-sharded mesh (``mesh=``, ROADMAP Queue A item
10b), geometry requests (item 11), warm starts (item 13) and the grad
kind (item 14); each raises naming its item.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.resilience import faultinject
from poisson_ellipse_tpu_torch.resilience.errors import SolveError
from poisson_ellipse_tpu_torch.resilience.faultinject import Fault, FaultPlan
from poisson_ellipse_tpu_torch.runtime.compile_cache import grid_bucket
from poisson_ellipse_tpu_torch.serve.journal import RequestJournal
from poisson_ellipse_tpu_torch.serve.queue import AdmissionQueue
from poisson_ellipse_tpu_torch.serve.request import ServeRequest, ServeResult
from poisson_ellipse_tpu_torch.solver.pcg import unported
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# the serve carry's global iteration ceiling: requests come and go, the
# batch's clock only moves forward — per-request caps are enforced
# host-side against each lane's swap-in offset
ITER_CEILING = 1 << 30

# classical batched carry layout (batch.batched_pcg.BatchedPCGState, the
# JAX carry's order; mirrors batch.driver._LAYOUT["batched"])
_IDX = {
    "k": 0, "w": 1, "r": 2, "p": 3, "zr": 4, "diff": 5,
    "conv": 6, "bd": 7, "quar": 8, "iters": 9,
}
_FIELDS = {"w": 1, "r": 2, "p": 3, "zr": 4}

DEFAULT_LANES = 4
DEFAULT_CHUNK = 16

# elements a batch context's lane plane is a multiple of: every lane then
# starts on the boundary of the card's widest reduction load (module
# docstring)
LANE_ALIGN = 8


def lane_pitch(g1: int, g2: int) -> int:
    """The row length, at least ``g2``, that makes a (g1, pitch) lane plane
    a multiple of ``LANE_ALIGN`` elements."""
    pitch = g2
    while (g1 * pitch) % LANE_ALIGN:
        pitch += 1
    return pitch


@functools.lru_cache(maxsize=32)
def _bucket_advance(Mb: int, Nb: int, dtype_name: str, norm: str,
                    device: str):
    """The bucket's chunk advance: one closure per (bucket, dtype, norm,
    device), shared by every scheduler in the process. Operands, per-lane
    h/δ, masks, carry and bound are all arguments, so retire, refill and
    replay build nothing new.

    ``fn(a3, b3, mask, h1, h2, delta, state, k, limit)`` issues the
    ``limit - k`` bodies of ``batched_pcg.advance(..., limit=, mask=,
    h1=, h2=, delta=)`` from the host's count ``k``, with no read of the
    loop's flags: bodies past every lane's exit change nothing, so the
    carry is bitwise ``advance``'s."""
    proto = Problem(M=Mb, N=Nb, norm=norm, max_iter=ITER_CEILING)

    def fn(a3, b3, mask, h1, h2, delta, state, k: int, limit: int):
        # the carry's own w supplies the rhs positional's dtype and
        # device (the rhs lives in r from init)
        body = batched_pcg.make_body(
            proto, a3, b3, state.w, min(limit, ITER_CEILING), mask=mask,
            h1=h1, h2=h2, delta=delta,
        )
        for i in range(k, limit):
            state = body(state, i)
        return state

    return fn, proto


def embed_operands(problem: Problem, bucket: tuple[int, int], dtype,
                   a, b, rhs, pitch: Optional[int] = None):
    """THE pad-and-mask bucket embedding, on the host: zero-padded
    operands plus the interior mask of the true problem (the
    ``runtime.compile_cache`` layout, sliced per lane), rounded to
    ``dtype`` from the f64 assembly; ``pitch`` (default Nb + 1) is the
    padded row length."""
    Mb, Nb = bucket
    pitch = Nb + 1 if pitch is None else pitch
    g1, g2 = problem.M + 1, problem.N + 1
    pad2 = ((0, Mb + 1 - g1), (0, pitch - g2))
    mask = np.zeros((Mb + 1, pitch))
    mask[1: problem.M, 1: problem.N] = 1.0
    return tuple(assembly.to_host(x, dtype) for x in (
        np.pad(a, pad2), np.pad(b, pad2), np.pad(rhs, pad2), mask))


def _embed_request(problem: Problem, bucket: tuple[int, int], dtype,
                   pitch: Optional[int] = None):
    """Pad-and-mask one request into a bucket via ``embed_operands``."""
    a, b, r = assembly.assemble_numpy(problem)
    return embed_operands(problem, bucket, dtype, a, b, r, pitch)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A device tensor as the caller's own host array (bf16, which numpy
    lacks, upcast exactly to f32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


class _InFlight:
    """One dispatched request: which lane hosts it and at which global
    iteration it swapped in (``base_k`` — per-request iteration counts
    are ``iters[lane] - base_k``)."""

    __slots__ = ("req", "lane", "base_k", "t_dispatch")

    def __init__(self, req: ServeRequest, lane: int, base_k: int,
                 t_dispatch: float):
        self.req = req
        self.lane = lane
        self.base_k = base_k
        self.t_dispatch = t_dispatch


class _BatchCtx:
    """One grid bucket's live batch: the advance, the carry, the per-lane
    operand stack (lane planes of Mb + 1 rows of ``pitch`` nodes), the
    slot table, and the host's mirror of the batch's iteration counter
    ``k``."""

    def __init__(self, bucket: tuple[int, int], lanes: int, dtype, norm: str,
                 device: torch.device):
        self.bucket = bucket
        self.norm = norm
        self.device = device
        self.fn, self.proto = _bucket_advance(
            bucket[0], bucket[1], str(dtype), norm, str(device)
        )
        self.pitch = lane_pitch(bucket[0] + 1, bucket[1] + 1)
        g = (lanes, bucket[0] + 1, self.pitch)

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.a3, self.b3, self.mask = zeros(g), zeros(g), zeros(g)
        self.h1 = torch.ones(lanes, dtype=dtype, device=device)
        self.h2 = torch.ones(lanes, dtype=dtype, device=device)
        self.delta = torch.full((lanes,), 1e-6, dtype=dtype, device=device)
        state = batched_pcg.init_state(
            self.proto, self.a3, self.b3, zeros(g), mask=self.mask,
            h1=self.h1, h2=self.h2,
        )
        # every field its own tensor (init_state shares one flag tensor
        # between the three flags; refills write fields in place), and
        # every lane parked: the breakdown flag freezes it until a refill
        # swaps a request in
        state = [t.clone() for t in state]
        state[_IDX["bd"]].fill_(True)
        self.state = batched_pcg.BatchedPCGState(*state)
        self.k = 0
        self.slots: list[Optional[_InFlight]] = [None] * lanes
        # per-bucket chunk override (None = the scheduler-wide default).
        # The JAX package sets it from its autotune registry; the port has
        # no registry until ROADMAP Queue A item 13, so it stays None.
        self.chunk: Optional[int] = None

    @property
    def active(self) -> bool:
        return any(s is not None for s in self.slots)

    def free_lane(self) -> Optional[int]:
        for lane, slot in enumerate(self.slots):
            if slot is None:
                return lane
        return None


class Scheduler:
    """The continuous-batching serve loop (see module docstring), on
    ``device`` (cuda unless ``device='cpu'``): every tensor of a batch
    context lives there.

    ``clock`` is injectable (monotonic seconds) so deadline semantics
    are deterministically testable; ``idle`` is what ``drain`` calls
    when every queued request is waiting out a retry backoff (default
    ``time.sleep`` — pass the fake clock's ``advance`` in tests).
    ``faults`` takes request-addressed injections
    (``Fault(request_id=...)``).
    """

    def __init__(
        self,
        lanes: int = DEFAULT_LANES,
        chunk: int = DEFAULT_CHUNK,
        queue_capacity: int = 64,
        dtype=torch.float32,
        max_retries: int = 1,
        backoff_base_s: float = 0.01,
        journal: RequestJournal | str | None = None,
        clock: Callable[[], float] = time.monotonic,
        idle: Callable[[float], None] = time.sleep,
        faults: Optional[FaultPlan] = None,
        keep_solutions: bool = True,
        mesh=None,
        class_quotas: Optional[dict] = None,
        starvation_after_s: Optional[float] = None,
        warm_start: bool = False,
        device=None,
    ):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if mesh is not None:
            raise unported("Scheduler(mesh=)", "Queue A item 10b")
        if warm_start:
            raise unported("warm_start=True", "Queue A item 13")
        self.faults = faults if faults is not None else FaultPlan()
        for fault in self.faults.faults:
            if fault.kind in faultinject.ADMISSION_KINDS:
                raise unported(f"the {fault.kind} fault", "Queue A item 11")
            if fault.kind in faultinject.CACHE_KINDS:
                raise unported(f"the {fault.kind} fault", "Queue A item 13")
        self.device = resolve_device(device)
        self.lanes = lanes
        self.chunk = chunk
        self.dtype = dtype
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.clock = clock
        self.idle = idle
        self.keep_solutions = keep_solutions
        self.journal = (
            RequestJournal(journal) if isinstance(journal, (str, bytes))
            or hasattr(journal, "__fspath__") else journal
        )
        self.queue = AdmissionQueue(
            queue_capacity, lanes, clock=clock,
            class_quotas=class_quotas,
            starvation_after_s=starvation_after_s,
        )
        self.results: dict[str, ServeResult] = {}
        self._ctxs: dict[tuple, _BatchCtx] = {}
        # journaled requests recovered by replay() that exceeded queue
        # capacity: fed back into the queue in waves as it drains —
        # never terminally shed (the write-ahead promise outlives one
        # queue's worth of backlog)
        self._replay_backlog: list[ServeRequest] = []
        # graceful-drain latch (begin_drain): a draining scheduler
        # refuses NEW admissions with a redirectable shed but finishes
        # everything already admitted — the harness's SIGTERM path flips
        # it
        self.draining = False
        # how many redirect sheds the draining latch issued: those
        # results are deliberately NOT recorded (begin_drain docstring),
        # so this count keeps a killed-mid-drain run's zero-lost
        # accounting provable
        self.drain_sheds = 0

    # -- admission -----------------------------------------------------------

    def submit(self, problem: Problem, deadline_s: float | None = None,
               max_retries: int | None = None,
               request_id: str | None = None,
               tenant: str = "default",
               priority: int = 1) -> Optional[ServeResult]:
        """Admit one request. Returns ``None`` on acceptance, or the
        terminal ``shed`` result (with ``retry_after_s``) when the
        admission policy rejects it."""
        req = ServeRequest(
            problem=problem,
            deadline=(
                None if deadline_s is None else self.clock() + deadline_s
            ),
            max_retries=(
                self.max_retries if max_retries is None else max_retries
            ),
            tenant=tenant,
            priority=priority,
        )
        if request_id is not None:
            req.request_id = request_id
        return self.submit_request(req)

    @staticmethod
    def _reject_unported(req: ServeRequest) -> None:
        """Refuse the request kinds whose layers are not ported, naming
        the ROADMAP.md item that will port them."""
        if req.geometry is not None or req.theta is not None:
            raise unported("a request's geometry=/theta=", "Queue A item 11")
        if req.grad:
            raise unported("a grad=True request", "Queue A item 14")

    def begin_drain(self) -> None:
        """The graceful-shutdown hook: stop admitting, keep working.

        New submissions are refused with a shed carrying the projected
        wait as ``retry_after_s`` (and detail ``draining``) WITHOUT
        being recorded as this scheduler's terminal outcome — the
        rejection is a redirect for the caller, not a lifecycle event of
        a request this scheduler never owned. Everything already admitted
        (queued, backlogged, in flight) still runs to a classified
        terminal state through the normal ``drain()``."""
        if not self.draining:
            self.draining = True
            obs_trace.event(
                "serve:drain-begin",
                queued=len(self.queue),
                in_flight=sum(
                    1 for c in self._ctxs.values()
                    for s in c.slots if s is not None
                ),
            )

    def adopt_request(self, req: ServeRequest) -> None:
        """Adopt a handed-off request from a dead peer's journal:
        journal-first (the write-ahead promise transfers to THIS
        scheduler before anything acknowledges the handoff), then the
        replay backlog's wave machinery — an adopted request is never
        terminally shed on capacity, exactly like a replayed one."""
        self._reject_unported(req)
        if self.journal is not None:
            self.journal.record_admit(req)
        req.replayed = True
        self._replay_backlog.append(req)
        self._admit_replay_wave()

    def submit_request(self, req: ServeRequest) -> Optional[ServeResult]:
        self._reject_unported(req)
        if self.draining:
            # the redirect shed stays unrecorded (begin_drain), but it
            # is COUNTED
            self.drain_sheds += 1
            return ServeResult(
                request_id=req.request_id, outcome="shed",
                detail="draining",
                retry_after_s=self.queue.projected_wait(),
            )
        prior = self.results.get(req.request_id)
        if prior is not None and prior.outcome == "shed" and not prior.dispatched:
            # shed-at-admission is "safe to resubmit after retry_after_s"
            # (the request.py outcome table): the resubmission supersedes
            # the rejection record instead of reading as a duplicate —
            # nothing was journaled or dispatched, so nothing can double
            del self.results[req.request_id]
        if self._knows(req.request_id):
            # a second live (or already-terminal) submission under the
            # same id can never get its own outcome slot — refuse it at
            # the door WITHOUT touching the original's lifecycle
            return ServeResult(
                request_id=req.request_id, outcome="shed",
                detail="duplicate-request-id",
            )
        accepted, retry_after, reason = self.queue.admit(req)
        self._classify_evicted()
        if not accepted:
            result = ServeResult(
                request_id=req.request_id, outcome="shed", detail=reason,
                retry_after_s=retry_after,
            )
            self.results[req.request_id] = result
            return result
        if self.journal is not None:
            # write-ahead: the admission is acknowledged only once the
            # journal holds it; a failed journal write un-queues the
            # request and surfaces the error instead of promising
            # durability the disk refused
            try:
                self.journal.record_admit(req)
            except BaseException:
                self.queue.retract(req, "journal-write-failed")
                raise
        return None

    def _knows(self, request_id: str) -> bool:
        """Whether an id is already spoken for: queued, backlogged,
        in flight, terminal in the result buffer, or journaled."""
        return (
            request_id in self.results
            or self.owns_request(request_id)
        )

    def owns_request(self, request_id: str) -> bool:
        """Whether this scheduler owns the id's LIFECYCLE: queued,
        backlogged, in flight, journaled, or terminal — except a
        recorded shed that was never dispatched, which is a rejection
        the outcome table promises is safe to resubmit, not ownership."""
        prior = self.results.get(request_id)
        if (prior is not None and prior.outcome == "shed"
                and not prior.dispatched):
            prior = None
        return (
            prior is not None
            or self.queue.holds(request_id)
            or any(r.request_id == request_id for r in self._replay_backlog)
            or self._slot_of(request_id) is not None
            or (
                self.journal is not None
                and self.journal.state_of(request_id) is not None
            )
        )

    def owned_live_ids(self) -> set[str]:
        """Ids whose lifecycle is LIVE here — queued, backlogged, in a
        lane, or journal-admitted (terminal/compacted records excluded)."""
        ids = set(self.queue.request_ids())
        ids.update(r.request_id for r in self._replay_backlog)
        ids.update(
            slot.req.request_id
            for ctx in self._ctxs.values()
            for slot in ctx.slots
            if slot is not None
        )
        if self.journal is not None:
            ids.update(self.journal.admitted_ids())
        return ids

    def prewarm(self, problem: Problem) -> None:
        """Build (or touch) the batch context for ``problem``'s bucket
        WITHOUT admitting anything, so the first real requests land on a
        warm context."""
        self._ctx_for(ServeRequest(problem=problem))

    def replay(self) -> int:
        """Recover every journaled admitted-but-unfinished request (a
        restarted server's first act). Requests beyond the bounded
        queue's capacity wait in a replay backlog and re-enter in waves
        as the queue drains — an acknowledged admission is never
        terminally shed just because the restart arrived with more
        backlog than one queue's worth (the write-ahead promise).
        Returns the number of requests recovered."""
        if self.journal is None:
            raise ValueError("replay needs a journal-backed scheduler")
        reqs = self.journal.unfinished(self.clock())
        for req in reqs:
            self._reject_unported(req)
        for req in reqs:
            req.replayed = True
            obs_trace.event(
                "serve:replay", request_id=req.request_id,
                grid=[req.problem.M, req.problem.N],
            )
        self._replay_backlog.extend(reqs)
        self._admit_replay_wave()
        return len(reqs)

    def _admit_replay_wave(self) -> None:
        """Move backlogged replay requests into the queue while it has
        room. A request whose restarted deadline budget is already
        infeasible ends ``deadline-miss`` — NOT ``shed``: shed means
        "never admitted, safe to resubmit", and these were durably
        acknowledged. Capacity overflow is deferred, never terminal."""
        while self._replay_backlog and len(self.queue) < self.queue.capacity:
            req = self._replay_backlog.pop(0)
            accepted, retry_after, reason = self.queue.admit(
                req, record_shed=False
            )
            self._classify_evicted()
            if not accepted:
                self._finish_queued(
                    req, "deadline-miss", detail=f"replay-{reason}",
                    retry_after=retry_after,
                )

    def _classify_evicted(self) -> None:
        """Give every queue-preemption victim its classified terminal:
        ``shed`` with detail ``preempted-by-priority`` (journaled too:
        the victim was journaled at its own admission)."""
        for victim in self.queue.take_evicted():
            self._finish_queued(
                victim, "shed", detail="preempted-by-priority",
                retry_after=self.queue.projected_wait(),
            )

    # -- the serve loop ------------------------------------------------------

    def step(self) -> bool:
        """One chunk across every active bucket: shed expired queued
        requests, refill free lanes, inject due faults, advance, retire.
        Returns True while work remains (in flight or queued)."""
        now = self.clock()
        for req in self.queue.expire(now):
            self._finish_queued(
                req, "deadline-miss", detail="expired-in-queue"
            )
        self._admit_replay_wave()
        self._fill_lanes()
        # lanes just drained the queue — top it back up so the next
        # boundary dispatches from a full line, not a replay-starved one
        self._admit_replay_wave()
        for ctx in list(self._ctxs.values()):
            if not ctx.active or ctx not in self._ctxs.values():
                continue
            self._apply_faults(ctx)
            if not ctx.active or ctx not in self._ctxs.values():
                continue
            k = ctx.k
            # the chunk stops early at the nearest per-request iteration
            # cap: caps land exactly, not at the next multiple of `chunk`
            limit = min(k + (ctx.chunk or self.chunk), ITER_CEILING)
            for slot in ctx.slots:
                if slot is not None:
                    limit = min(
                        limit,
                        slot.base_k + slot.req.problem.max_iterations,
                    )
            limit = max(limit, k + 1)
            try:
                ctx.state = ctx.fn(
                    ctx.a3, ctx.b3, ctx.mask, ctx.h1, ctx.h2, ctx.delta,
                    ctx.state, k, limit,
                )
            except Exception as e:  # noqa: BLE001 — classified; unknowns re-raised
                from poisson_ellipse_tpu_torch.resilience.errors import (
                    classify_error,
                )

                if classify_error(e) != "device-loss":
                    raise
                self._degrade_mesh("device-loss", getattr(e, "device", None))
                continue
            self._boundary(ctx)
        return bool(
            len(self.queue) or self._replay_backlog
        ) or any(c.active for c in self._ctxs.values())

    def drain(self, max_steps: int = 100_000) -> dict[str, ServeResult]:
        """Step until every admitted request is terminal. When the only
        remaining work is backoff-parked retries, waits them out via
        ``idle``. ``max_steps`` is a runaway backstop, not a policy."""
        steps = 0
        while True:
            in_flight = any(c.active for c in self._ctxs.values())
            if (not in_flight and not len(self.queue)
                    and not self._replay_backlog):
                return self.results
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"drain exceeded {max_steps} steps with work pending"
                )
            progressed_work = self.step()
            if progressed_work and not any(
                c.active for c in self._ctxs.values()
            ) and len(self.queue):
                wait = self.queue.next_ready_in(self.clock())
                if wait is not None:
                    self.idle(wait)

    def collect(self) -> dict[str, ServeResult]:
        """Hand off and evict every terminal result recorded so far.

        ``results`` (and the solution arrays it retains under
        ``keep_solutions``) otherwise grows for the scheduler's
        lifetime. A long-lived server drains results through here (the
        ``harness serve`` loop does); ``drain()`` keeps returning the
        accumulated dict for one-shot callers."""
        out = self.results
        self.results = {}
        return out

    # -- refill --------------------------------------------------------------

    def _ctx_for(self, req: ServeRequest) -> _BatchCtx:
        bucket = grid_bucket(req.problem.M, req.problem.N)
        key = (bucket, req.problem.norm)
        ctx = self._ctxs.get(key)
        if ctx is None:
            ctx = _BatchCtx(
                bucket, self.lanes, self.dtype, req.problem.norm,
                self.device,
            )
            # the JAX package consults its autotune registry for a tuned
            # per-bucket chunk here; that registry is ROADMAP Queue A
            # item 13, so ctx.chunk stays None (the scheduler's chunk)
            self._ctxs[key] = ctx
        return ctx

    def _fill_lanes(self) -> None:
        now = self.clock()
        deferred = []
        while True:
            req = self.queue.pop_ready(now)
            if req is None:
                break
            ctx = self._ctx_for(req)
            lane = ctx.free_lane()
            if lane is None:
                deferred.append(req)
                continue
            self._refill_lane(ctx, lane, req)
        for req in reversed(deferred):
            self.queue.push_front(req)

    def _refill_lane(self, ctx: _BatchCtx, lane: int,
                     req: ServeRequest) -> None:
        """Swap a request into a free lane between chunks: embed its
        operands into the lane's slices and re-initialise the lane's
        carry from a one-lane ``init_state`` — the freeze mask
        generalized to swap-in. Per-lane arithmetic is lane-decoupled, so
        the refilled lane's trajectory is the same request's on a fresh
        lane of the batch. Every write is an in-place slice copy queued
        on the device (the host operands go up from pinned memory), so a
        refill waits for nothing."""
        p = req.problem
        dev = ctx.device
        host = torch.stack(_embed_request(p, ctx.bucket, self.dtype,
                                          ctx.pitch))
        if dev.type == "cuda":
            host = host.pin_memory()
        a_p, b_p, r_p, m_p = host.to(dev, non_blocking=True)
        # the lane's fresh carry comes from the same init_state every
        # other entry path uses, at one lane
        unit = batched_pcg.init_state(
            ctx.proto, a_p[None], b_p[None], r_p[None], mask=m_p[None],
            h1=p.h1, h2=p.h2,
        )
        ctx.a3[lane].copy_(a_p)
        ctx.b3[lane].copy_(b_p)
        ctx.mask[lane].copy_(m_p)
        ctx.h1[lane] = p.h1
        ctx.h2[lane] = p.h2
        ctx.delta[lane] = p.delta
        for i, (dst, src) in enumerate(zip(ctx.state, unit)):
            if i != _IDX["k"]:
                dst[lane].copy_(src[0])
        base_k = ctx.k
        now = self.clock()
        ctx.slots[lane] = _InFlight(req, lane, base_k, now)
        req.dispatched = True
        if req.enqueued_t is not None:
            obs_metrics.histogram("time_in_queue_seconds").observe(
                now - req.enqueued_t
            )
        obs_metrics.counter("serve_refills_total").inc()
        obs_trace.event(
            "serve:refill", request_id=req.request_id, lane=lane,
            base_k=base_k, attempt=req.attempt,
            bucket=list(ctx.bucket),
        )

    def _park_lane(self, ctx: _BatchCtx, lane: int) -> None:
        """Return a lane to the parked pool: zeroed state, breakdown
        flag raised so the loop freezes it until the next refill."""
        s = ctx.state
        for t in (s.w, s.r, s.p, s.zr, s.converged, s.quarantined):
            t[lane] = 0
        s.breakdown[lane] = True
        ctx.slots[lane] = None

    # -- retirement ----------------------------------------------------------

    def _boundary(self, ctx: _BatchCtx) -> None:
        """The chunk-boundary host read: retire finished lanes.
        Ordering is the deadline contract — converged lanes first (a
        result beats a miss at the same boundary), then fault
        retirement into the retry ladder, then deadline cancels, then
        per-request iteration caps. One stacked copy brings k and every
        lane's flags, count and step norm to the host."""
        s = ctx.state
        read = torch.cat([
            s.k.to(torch.float64)[None],
            *(t.to(torch.float64) for t in (
                s.converged, s.breakdown, s.quarantined, s.iters, s.diff)),
        ]).tolist()
        lanes = len(ctx.slots)
        ctx.k = int(read[0])
        conv, bd, quar, iters, diffs = (
            read[1 + i * lanes: 1 + (i + 1) * lanes] for i in range(5))
        now = self.clock()
        for lane, slot in enumerate(ctx.slots):
            if slot is None:
                continue
            req = slot.req
            req_iters = int(iters[lane]) - slot.base_k
            diff = diffs[lane]
            if conv[lane]:
                self._finish(
                    ctx, lane, slot, "completed", iters=req_iters,
                    diff=diff, converged=True,
                )
            elif quar[lane] or bd[lane]:
                cause = "lane-quarantine" if quar[lane] else "breakdown"
                self._park_lane(ctx, lane)
                self._retry_or_fallback(slot, cause)
            elif req.deadline is not None and now > req.deadline:
                self._finish(
                    ctx, lane, slot, "deadline-miss", iters=req_iters,
                    diff=diff, partial=True, detail="expired-mid-solve",
                )
            elif req_iters >= req.problem.max_iterations:
                self._finish(
                    ctx, lane, slot, "cap", iters=req_iters, diff=diff
                )
        # rebase the batch's global clock: k only moves forward, and a
        # hot bucket on a long-lived server would otherwise walk it
        # into ITER_CEILING and wedge. The shift is uniform across k /
        # per-lane iters / slot base_k, so every per-request count and
        # cap is invariant under it.
        if ctx.active:
            base = min(s.base_k for s in ctx.slots if s is not None)
        else:
            base = ctx.k
        if base > 0:
            s = ctx.state
            ctx.state = s._replace(k=s.k - base, iters=s.iters - base)
            ctx.k -= base
            for slot in ctx.slots:
                if slot is not None:
                    slot.base_k -= base

    @staticmethod
    def _span_s(req: ServeRequest, now: float) -> float:
        """End-to-end seconds since the request's FIRST admission:
        ``admitted_t`` survives retry requeues, which re-stamp
        ``enqueued_t`` for the per-visit queue-wait histogram."""
        anchor = (
            req.admitted_t if req.admitted_t is not None else req.enqueued_t
        )
        return now - anchor if anchor is not None else 0.0

    def _finish(self, ctx: _BatchCtx, lane: int, slot: _InFlight,
                outcome: str, iters: int = 0, diff: float = float("inf"),
                converged: bool = False, partial: bool = False,
                detail: str | None = None) -> None:
        req = slot.req
        now = self.clock()
        w = None
        if self.keep_solutions and (converged or partial):
            g1, g2 = req.problem.M + 1, req.problem.N + 1
            w = _host_array(ctx.state.w[lane, :g1, :g2])
        self._park_lane(ctx, lane)
        self.queue.observe_service(now - slot.t_dispatch)
        result = ServeResult(
            request_id=req.request_id, outcome=outcome, iters=iters,
            diff=diff, converged=converged, partial=partial,
            dispatched=True, attempts=req.attempt + 1,
            time_in_queue_s=(
                slot.t_dispatch - req.enqueued_t
                if req.enqueued_t is not None else 0.0
            ),
            total_s=self._span_s(req, now),
            detail=detail, w=w,
        )
        self._record_terminal(result, lane=lane)

    def _finish_queued(self, req: ServeRequest, outcome: str,
                       detail: str | None = None,
                       retry_after: float | None = None) -> None:
        """Terminate a request while it is off-lane (queued expiry,
        replay shed, a failed fallback). ``dispatched`` reports the
        request's history, not this moment."""
        now = self.clock()
        result = ServeResult(
            request_id=req.request_id, outcome=outcome,
            dispatched=req.dispatched,
            attempts=req.attempt,
            time_in_queue_s=(
                now - req.enqueued_t if req.enqueued_t is not None else 0.0
            ),
            total_s=self._span_s(req, now),
            detail=detail, retry_after_s=retry_after,
        )
        self._record_terminal(result)

    def _record_terminal(self, result: ServeResult,
                         lane: int | None = None) -> None:
        # journal FIRST: the terminal record lives where the durability
        # promise does, and a fenced journal rejecting a stale write
        # must abort the completion BEFORE it lands in the result buffer
        if self.journal is not None:
            self.journal.record_outcome(
                result.request_id, result.outcome, detail=result.detail
            )
        self.results[result.request_id] = result
        if result.outcome == "deadline-miss":
            obs_metrics.counter("deadline_miss_total").inc()
        elif result.outcome == "completed":
            obs_metrics.counter("serve_completed_total").inc()
        obs_trace.event(
            "serve:retire", request_id=result.request_id, lane=lane,
            outcome=result.outcome, iters=result.iters,
            attempts=result.attempts, partial=result.partial,
            detail=result.detail,
        )

    # -- the retry ladder ----------------------------------------------------

    def _retry_or_fallback(self, slot: _InFlight, cause: str) -> None:
        """Walk the degradation ladder for a request whose lane went
        bad: within budget, back off exponentially and resubmit on a
        fresh lane; past it, fall to the guarded single solve. Every
        rung ends in a classified outcome."""
        req = slot.req
        req.attempt += 1
        if req.attempt <= req.max_retries:
            backoff = self.backoff_base_s * (2 ** (req.attempt - 1))
            req.not_before = self.clock() + backoff
            obs_metrics.counter("serve_retries_total").inc()
            obs_trace.event(
                "serve:retry", request_id=req.request_id, cause=cause,
                attempt=req.attempt, backoff_s=round(backoff, 4),
            )
            if not self.queue.requeue(req):
                self._finish_queued(
                    req, "failed", detail="requeue-shed-under-overload"
                )
            return
        self._guarded_fallback(req, cause)

    def _guarded_fallback(self, req: ServeRequest, cause: str) -> None:
        """The ladder's last rung: one guarded single solve of the true
        (un-embedded) problem on the plain ``xla`` loop, with the
        remaining deadline budget as the guard's timeout."""
        from poisson_ellipse_tpu_torch.resilience import guard

        # the fallback's dispatch instant: queue-wait accounting stops
        # here — the solve itself must not read as time spent queued
        t_dispatch = self.clock()
        timeout = None
        if req.deadline is not None:
            timeout = req.deadline - t_dispatch
            if timeout <= 0:
                self._finish_queued(
                    req, "deadline-miss",
                    detail=f"expired-before-fallback ({cause})",
                )
                return
        obs_trace.event(
            "serve:fallback", request_id=req.request_id, cause=cause,
            attempt=req.attempt,
        )
        try:
            guarded = guard.guarded_solve(
                req.problem, "xla", self.dtype, chunk=self.chunk,
                timeout=timeout, device=self.device,
            )
        except SolveError as e:
            outcome = (
                "deadline-miss" if e.classification == "timeout" else
                "failed"
            )
            self._finish_queued(
                req, outcome,
                detail=f"guarded-fallback-{e.classification}",
            )
            return
        result = guarded.result
        now = self.clock()
        converged = bool(result.converged)
        res = ServeResult(
            request_id=req.request_id,
            outcome="completed" if converged else "cap",
            iters=int(result.iters), diff=float(result.diff),
            converged=converged, dispatched=True,
            attempts=req.attempt + 1,
            time_in_queue_s=(
                t_dispatch - req.enqueued_t
                if req.enqueued_t is not None else 0.0
            ),
            total_s=self._span_s(req, now),
            detail="guarded-fallback",
            w=(
                _host_array(result.w)
                if self.keep_solutions and converged else None
            ),
        )
        self._record_terminal(res)

    # -- device loss ---------------------------------------------------------

    def _degrade_mesh(self, cause: str, device: int | None) -> None:
        """A device under the batch died: every live batch carry died
        with it, but no REQUEST does — each in-flight request re-enters
        through the same journal-backed retry ladder a lane fault uses,
        so the chaos invariants (zero lost / zero double) hold across a
        device kill exactly as they do across a process kill. Every
        batch context is dropped; ``_ctx_for`` rebuilds on demand. (The
        mesh's shrink-and-rebuild is ROADMAP Queue A item 10b.)"""
        in_flight = [
            slot
            for ctx in self._ctxs.values()
            for slot in ctx.slots
            if slot is not None
        ]
        obs_trace.event(
            "degrade:mesh",
            cause=cause,
            lost_devices=[device] if device is not None else [],
            in_flight=len(in_flight),
        )
        obs_metrics.counter("mesh_degrade_total").inc()
        self._ctxs.clear()
        for slot in in_flight:
            self._retry_or_fallback(slot, cause)

    # -- fault injection -----------------------------------------------------

    def _slot_of(self, request_id: str):
        for ctx in self._ctxs.values():
            for slot in ctx.slots:
                if slot is not None and slot.req.request_id == request_id:
                    return ctx, slot
        return None

    def _apply_faults(self, ctx: _BatchCtx) -> None:
        """Fire request-addressed faults due at this boundary.
        ``at_iter`` counts the request's own iterations; injection lands
        at the first chunk boundary at or past it. ``oom`` is a
        dispatch-level failure — the lane is freed and the request walks
        the retry ladder; ``device_loss`` drops every batch; carry
        faults corrupt the lane slice and let the in-loop quarantine
        detect them. The lane counts are read only while a fault is
        pending."""
        if not self.faults:
            return
        iters = None
        for fault in list(self.faults.faults):
            if fault.fired or fault.request_id is None:
                continue
            located = self._slot_of(fault.request_id)
            if located is None or located[0] is not ctx:
                continue
            _, slot = located
            if iters is None:
                iters = ctx.state.iters.tolist()
            req_iters = int(iters[slot.lane]) - slot.base_k
            if req_iters < fault.at_iter:
                continue
            if not fault.persistent:
                fault.fired = True
            obs_trace.event(
                "serve:fault", request_id=fault.request_id,
                lane=slot.lane, kind=fault.kind, at_iter=fault.at_iter,
            )
            if fault.kind == "oom":
                # what a real out-of-memory on the dispatch looks like to
                # the scheduler: the lane is lost, the request is not —
                # straight onto the retry ladder
                self._park_lane(ctx, slot.lane)
                self._retry_or_fallback(slot, "oom")
                continue
            if fault.kind == "device_loss":
                # a whole device under the batch: every in-flight
                # request re-enters; the addressed request only picks
                # WHEN the kill lands
                self._degrade_mesh("device-loss", fault.device)
                return
            lane_fault = Fault(
                fault.kind, at_iter=fault.at_iter, field=fault.field,
                rows=fault.rows, lane=slot.lane,
            )
            ctx.state = faultinject._corrupt(
                ctx.state, lane_fault, _FIELDS, _IDX["bd"], _IDX["zr"],
            )
