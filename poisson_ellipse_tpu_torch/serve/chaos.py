"""Chaos harness: the serving invariants proven under injected failure.

The counterpart of ``poisson_ellipse_tpu.serve.chaos`` on one device:
its report (every field kept, so the JSON is the JAX package's), the
NaN / OOM / kill-and-replay drills and the device-loss drill. The fleet
drills (``replicas > 1``) are ROADMAP Queue A item 15, the geometry
drills item 11, the grad requests item 14 and the warm-start drill item
13; each raises naming its item.

A serving layer's correctness claims are global, not per-request —
*zero lost* (every admitted request reaches a terminal state, across
kills), *zero double-completed* (no request finishes twice, across
replays), *all classified* (every terminal state is one of the named
outcomes). None of those can be unit-tested one code path at a time;
they have to survive a hostile stream. This module drives one: a
seeded Poisson arrival process of mixed shapes through the scheduler
while ``resilience.faultinject`` poisons lanes (request-addressed NaN),
fakes ``RESOURCE_EXHAUSTED`` on dispatch, and kills the server
mid-stream — the restarted scheduler replays the journal and the
stream keeps going. Everything is deterministic in ``seed``: the same
chaos reproduces bit-for-bit, which is what makes a failing run
debuggable instead of an anecdote.

``run_chaos`` is the single entry of the ``harness chaos`` subcommand.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Sequence

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.resilience.faultinject import Fault, FaultPlan
from poisson_ellipse_tpu_torch.serve.journal import RequestJournal
from poisson_ellipse_tpu_torch.serve.request import OUTCOMES, ServeRequest
from poisson_ellipse_tpu_torch.serve.scheduler import Scheduler
from poisson_ellipse_tpu_torch.solver.pcg import unported

DEFAULT_GRIDS = ((10, 10), (12, 12), (8, 8))


@dataclasses.dataclass
class ChaosReport:
    """One chaos run's verdict: the invariant booleans plus the
    evidence behind them."""

    n_requests: int
    outcomes: dict            # request_id -> outcome
    counts: dict              # outcome -> count
    lost: list                # submitted ids with no terminal outcome
    double_completed: list    # ids with >1 terminal outcome
    unclassified: list        # ids whose outcome is not in OUTCOMES
    replayed: int
    killed: bool
    faults_fired: int
    wall_s: float
    mesh_killed: bool = False  # a device-loss drill ran mid-stream
    # the fleet drill's evidence (replicas > 1): handoffs executed,
    # requests adopted by survivors, fenced zombie writes observed and
    # rejected, and whether the zombie-resurrection drill ran
    replicas: int = 1
    handoffs: int = 0
    adopted: int = 0
    stale_writes_rejected: int = 0
    zombie_drill: bool = False
    # the grad-kind drill (differentiable serving): grad requests in
    # the stream, and ids that completed WITHOUT a gradient — a grad
    # completion missing its payload is a classification failure
    grad_requests: int = 0
    grad_missing_payload: list = dataclasses.field(default_factory=list)
    # the survivability drills' evidence: rejoins executed, redirect
    # sheds issued by draining schedulers (unrecorded by design —
    # counted so zero-lost stays provable across a kill-mid-drain),
    # ids co-owned by two live replicas at ANY boundary (must stay
    # empty: the cross-epoch co-ownership violation), starvation
    # episodes observed and the tenants whose episodes outnumbered
    # their announcements (starved SILENTLY — must stay empty), and
    # per-tenant outcome counts for the mixed-tenant stream
    rejoins: int = 0
    drain_shed: int = 0
    co_owned: list = dataclasses.field(default_factory=list)
    starvation_events: int = 0
    starved_silent: list = dataclasses.field(default_factory=list)
    tenants: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not (self.lost or self.double_completed or self.unclassified
                    or self.grad_missing_payload or self.co_owned
                    or self.starved_silent)

    def json_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["ok"] = self.ok
        return out


def _chaos_id(i: int) -> str:
    return f"chaos-{i:04d}"


def run_chaos(
    n_requests: int = 50,
    seed: int = 0,
    grids: Sequence[tuple[int, int]] = DEFAULT_GRIDS,
    rate_per_s: float = 400.0,
    lanes: int = 4,
    chunk: int = 8,
    queue_capacity: int = 128,
    journal_path=None,
    kill_after: Optional[int] = None,
    nan_request: Optional[int] = 2,
    oom_request: Optional[int] = 5,
    deadline_s: Optional[float] = None,
    max_retries: int = 2,
    mesh_kill_request: Optional[int] = None,
    malformed_request: Optional[int] = None,
    degenerate_request: Optional[int] = None,
    grad_requests: Sequence[int] = (),
    replicas: int = 1,
    replica_kill: Optional[int] = None,
    kill_during_handoff: bool = False,
    zombie: bool = False,
    lease_s: float = 0.25,
    replica_rejoin: Optional[int] = None,
    replica_kill_again: Optional[int] = None,
    lease_store_outage: Optional[int] = None,
    lease_store_outage_s: float = 0.05,
    tenant_mix: Optional[Sequence[tuple[str, int]]] = None,
    class_quotas: Optional[dict] = None,
    starvation_after_s: Optional[float] = None,
    warm_start: bool = False,
    poison_request: Optional[int] = None,
    device=None,
) -> ChaosReport:
    """Drive one seeded chaos stream on ``device`` (cuda unless
    ``device='cpu'``); see the module docstring.

    ``kill_after`` (default: ``n_requests // 2``) is the request index
    after which the server is killed — the Scheduler object is dropped
    with requests queued and in flight, exactly what SIGKILL leaves
    behind — and a fresh scheduler on the same journal replays.
    ``nan_request`` / ``oom_request`` pick which request indices get a
    request-addressed NaN-poisoned lane and a fake out-of-memory (None
    disables either). Requires ``journal_path`` when a kill is scheduled
    (the replay is the point).

    ``mesh_kill_request`` arms the DEVICE-kill drill (the ``harness
    chaos --mesh`` flag): when that request is in flight, a simulated
    device loss takes out every live batch carry at once — every
    in-flight request re-enters through the journal/retry ladder
    (``Scheduler._degrade_mesh``) — and the zero-lost/zero-double/
    all-classified invariants are asserted across a device kill, not
    just a process kill.

    The fleet arguments (``replicas > 1``, ``replica_kill``,
    ``kill_during_handoff``, ``zombie``, ``lease_s``, ``replica_rejoin``,
    ``replica_kill_again``, ``lease_store_outage*``), the geometry drills
    (``malformed_request``, ``degenerate_request``), ``grad_requests`` and
    the warm-start drill (``warm_start``, ``poison_request``) raise naming
    their ROADMAP.md items. ``tenant_mix``, ``class_quotas`` and
    ``starvation_after_s`` are fleet drills in the JAX package too: on one
    scheduler they raise its ``ValueError``.
    """
    if n_requests < 1:
        raise ValueError("need at least one request")
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be > 0")
    fleet = {
        "replicas > 1": replicas > 1,
        "replica_kill": replica_kill is not None,
        "kill_during_handoff": kill_during_handoff,
        "zombie": zombie,
        "lease_s": lease_s != 0.25,
        "replica_rejoin": replica_rejoin is not None,
        "replica_kill_again": replica_kill_again is not None,
        "lease_store_outage": lease_store_outage is not None,
        "lease_store_outage_s": lease_store_outage_s != 0.05,
    }
    armed = [k for k, v in fleet.items() if v]
    if armed:
        raise unported(", ".join(armed), "Queue A item 15")
    fleet_only = {
        "tenant_mix": tenant_mix,
        "class_quotas": class_quotas,
        "starvation_after_s": starvation_after_s,
    }
    armed_fleet = [k for k, v in fleet_only.items() if v is not None]
    if armed_fleet:
        raise ValueError(
            f"{', '.join(armed_fleet)} are fleet drills the "
            "single-scheduler path (replicas == 1) does not run — "
            "use replicas > 1"
        )
    if malformed_request is not None or degenerate_request is not None:
        raise unported("malformed_request/degenerate_request",
                       "Queue A item 11")
    if tuple(grad_requests):
        raise unported("grad_requests", "Queue A item 14")
    if warm_start or poison_request is not None:
        raise unported("warm_start/poison_request", "Queue A item 13")
    if kill_after is None:
        kill_after = n_requests // 2
    kill = kill_after is not None and 0 < kill_after < n_requests
    if kill and journal_path is None:
        raise ValueError(
            "a kill/restart chaos run needs journal_path (replay is the "
            "invariant under test)"
        )
    rng = random.Random(seed)
    faults = []
    if nan_request is not None and nan_request < n_requests:
        faults.append(Fault(
            "nan", at_iter=4, field="r", request_id=_chaos_id(nan_request),
        ))
    if oom_request is not None and oom_request < n_requests:
        faults.append(Fault(
            "oom", at_iter=2, request_id=_chaos_id(oom_request),
        ))
    if mesh_kill_request is not None and mesh_kill_request < n_requests:
        faults.append(Fault(
            "device_loss", at_iter=1, device=0,
            request_id=_chaos_id(mesh_kill_request),
        ))

    def make_scheduler():
        return Scheduler(
            lanes=lanes, chunk=chunk, queue_capacity=queue_capacity,
            max_retries=max_retries, backoff_base_s=0.001,
            journal=(
                RequestJournal(journal_path) if journal_path is not None
                else None
            ),
            faults=FaultPlan(*faults),
            keep_solutions=False,
            device=device,
        )

    t0 = time.monotonic()
    sched = make_scheduler()
    results: dict[str, object] = {}
    completions_seen: dict[str, int] = {}

    def harvest(s: Scheduler):
        for rid, res in s.results.items():
            if rid in results:
                completions_seen[rid] = completions_seen.get(rid, 1) + 1
            results[rid] = res

    replayed = 0
    # the arrival stream: exponential gaps, mixed shapes; between
    # arrivals the scheduler keeps chewing chunks. Gaps are capped so a
    # low rate cannot stall the harness; outcomes stay deterministic in
    # the seed (arrival order and fault addressing are seed-driven, the
    # sleep only paces the wall clock)
    for i in range(n_requests):
        if kill and i == kill_after:
            # SIGKILL semantics: harvest what the dead server already
            # finished (its journal has it), drop it mid-flight, replay
            harvest(sched)
            obs_trace.event("serve:chaos-kill", at_request=i)
            sched = make_scheduler()
            replayed = sched.replay()
        time.sleep(min(rng.expovariate(rate_per_s), 0.01))
        M, N = rng.choice(list(grids))
        req = ServeRequest(
            problem=Problem(M=M, N=N),
            deadline=(
                None if deadline_s is None
                else sched.clock() + deadline_s
            ),
            max_retries=max_retries,
        )
        req.request_id = _chaos_id(i)
        sched.submit_request(req)
        # a chunk between arrivals, like a busy server
        sched.step()
    sched.drain()
    harvest(sched)

    submitted = [_chaos_id(i) for i in range(n_requests)]
    outcomes = {
        rid: results[rid].outcome for rid in submitted if rid in results
    }
    lost = [rid for rid in submitted if rid not in outcomes]
    unclassified = [
        rid for rid, out in outcomes.items() if out not in OUTCOMES
    ]
    double = sorted(rid for rid, n in completions_seen.items() if n > 1)
    counts: dict[str, int] = {}
    for out in outcomes.values():
        counts[out] = counts.get(out, 0) + 1
    report = ChaosReport(
        n_requests=n_requests,
        outcomes=outcomes,
        counts=counts,
        lost=lost,
        double_completed=double,
        unclassified=unclassified,
        replayed=replayed,
        killed=kill,
        faults_fired=sum(1 for f in faults if f.fired),
        wall_s=time.monotonic() - t0,
        mesh_killed=any(
            f.kind == "device_loss" and f.fired for f in faults
        ),
        drain_shed=sched.drain_sheds,
    )
    obs_trace.event("serve:chaos-report", **report.json_dict())
    return report
