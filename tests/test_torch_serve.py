"""The port's serving layer (``poisson_ellipse_tpu_torch.serve``) against the
JAX package's ``serve``, on the CPU.

Each case of JAX ``tests/test_serve.py`` that lies in one device's scope
runs here as a scenario written once and driven through both packages'
``Scheduler`` (the JAX one in f32 unless stated, as its own tests run it;
a hand-cranked clock wherever a deadline matters). The port is held to
the JAX test's own assertions, and the two runs to each other:

- per request (outcome, iterations, attempts, detail, dispatched,
  partial): equal;
- a returned w: within 1e-5 absolute at f32, 1e-10 at f64 (the JAX test's
  1e-5 against the single solve);
- counters the case reads: equal.

The mesh cases (the lane-sharded chunk advance, the scheduler on a mesh)
are ROADMAP Queue A item 10b here: their tests check the raise. The
refill pin is the port's own: a refilled lane is bitwise the same request
on lane 0 of a fresh context of the same width (the JAX pin, bitwise
against the single solve, holds in the port to round-off only; see
``batch.batched_pcg``).
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu import serve as jax_serve
from poisson_ellipse_tpu.harness.__main__ import main as jax_main
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import metrics as jax_metrics
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.resilience import faultinject as jax_fi
from poisson_ellipse_tpu.resilience import guard as jax_guard
from poisson_ellipse_tpu_torch import serve
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.resilience import faultinject as fi
from poisson_ellipse_tpu_torch.resilience import guard
from poisson_ellipse_tpu_torch.serve import scheduler as sched_mod

PORT = types.SimpleNamespace(
    name="port", Problem=Problem, Scheduler=serve.Scheduler,
    RequestJournal=serve.RequestJournal, ServeRequest=serve.ServeRequest,
    Fault=fi.Fault, FaultPlan=fi.FaultPlan, metrics=obs_metrics,
    trace=obs_trace, guard=guard, kw={"device": "cpu"},
)
JAX = types.SimpleNamespace(
    name="jax", Problem=JaxProblem, Scheduler=jax_serve.Scheduler,
    RequestJournal=jax_serve.RequestJournal,
    ServeRequest=jax_serve.ServeRequest, Fault=jax_fi.Fault,
    FaultPlan=jax_fi.FaultPlan, metrics=jax_metrics, trace=jax_trace,
    guard=jax_guard, kw={},
)
W_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_tracer():
    """One PyTorch thread a test, no ambient tracer and fresh metric
    registries in both packages."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for ns in (PORT, JAX):
        ns.trace.stop()
        ns.trace._env_checked = True
        ns.metrics.REGISTRY.reset()
    yield
    for ns in (PORT, JAX):
        ns.trace.stop()
        ns.metrics.REGISTRY.reset()
    torch.set_num_threads(before)


class FakeClock:
    """A hand-cranked monotonic clock: deadline semantics become
    deterministic instead of racing the test host."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make(ns, **kw):
    kw.setdefault("lanes", 2)
    kw.setdefault("chunk", 8)
    kw.setdefault("backoff_base_s", 0.001)
    return ns.Scheduler(**ns.kw, **kw)


def summary(results) -> dict:
    return {
        rid: (r.outcome, r.iters, r.attempts, r.detail, r.dispatched,
              r.partial)
        for rid, r in results.items()
    }


def twin(scenario, *args):
    """The scenario's results through the port and through JAX; their
    summaries equal and every returned w within W_TOL."""
    port = scenario(PORT, *args)
    want = scenario(JAX, *args)
    assert summary(port) == summary(want)
    for rid, res in port.items():
        assert (res.w is None) == (want[rid].w is None), rid
        if res.w is not None:
            np.testing.assert_allclose(res.w, np.asarray(want[rid].w),
                                       rtol=0, atol=W_TOL)
    return port


# -- admission / backpressure ------------------------------------------------


def _queue_full(ns):
    sched = make(ns, queue_capacity=2)
    assert sched.submit(ns.Problem(M=10, N=10), request_id="a") is None
    assert sched.submit(ns.Problem(M=10, N=10), request_id="b") is None
    shed = sched.submit(ns.Problem(M=10, N=10), request_id="c")
    assert shed is not None and shed.outcome == "shed"
    assert shed.detail == "queue-full"
    assert shed.retry_after_s > 0
    assert shed.exit_code == 5
    assert not shed.dispatched
    return sched.drain()


def test_queue_full_sheds_with_retry_after():
    results = twin(_queue_full)
    done = [r for r in results.values() if r.outcome == "completed"]
    assert len(done) == 2


def _resubmit(ns):
    sched = make(ns, lanes=1, queue_capacity=1)
    assert sched.submit(ns.Problem(M=10, N=10), request_id="first") is None
    shed = sched.submit(ns.Problem(M=10, N=10), request_id="again")
    assert shed is not None and shed.outcome == "shed"
    sched.drain()
    assert sched.submit(ns.Problem(M=10, N=10), request_id="again") is None
    return sched.drain()


def test_shed_at_admission_allows_same_id_resubmission():
    assert twin(_resubmit)["again"].outcome == "completed"


def test_journal_write_failure_retracts_the_admission(tmp_path):
    for ns in (PORT, JAX):
        sched = make(ns, journal=str(tmp_path / f"{ns.name}.journal"))

        def refuse(req):
            raise OSError("disk full")

        sched.journal.record_admit = refuse
        with pytest.raises(OSError):
            sched.submit(ns.Problem(M=10, N=10))
        assert len(sched.queue) == 0
        assert ns.metrics.REGISTRY.gauge("queue_depth").value == 0


def _infeasible(ns):
    clock = FakeClock()
    sched = make(ns, clock=clock, idle=clock.advance)
    shed = sched.submit(ns.Problem(M=10, N=10), deadline_s=0.0,
                        request_id="x")
    assert shed is not None and shed.outcome == "shed"
    assert shed.detail == "deadline-infeasible"
    return {"x": shed}


def test_infeasible_deadline_shed_at_admission():
    twin(_infeasible)


# -- deadline semantics ------------------------------------------------------


def _expired_queued(ns):
    clock = FakeClock()
    sched = make(ns, lanes=1, clock=clock, idle=clock.advance)
    sched.submit(ns.Problem(M=12, N=12, delta=1e-7), request_id="hog")
    sched.step()
    assert sched.submit(ns.Problem(M=10, N=10), deadline_s=10.0,
                        request_id="late") is None
    clock.advance(11.0)
    return sched.drain()


def test_deadline_expiry_while_queued_is_shed_never_dispatched():
    results = twin(_expired_queued)
    late = results["late"]
    assert late.outcome == "deadline-miss"
    assert late.detail == "expired-in-queue"
    assert not late.dispatched and not late.partial
    assert results["hog"].outcome == "completed"


def _mid_solve(ns):
    clock = FakeClock()
    sched = make(ns, clock=clock, idle=clock.advance)
    sched.submit(ns.Problem(M=12, N=12, delta=1e-7), deadline_s=5.0,
                 request_id="victim")
    sched.step()
    assert "victim" not in sched.results
    clock.advance(6.0)
    return sched.drain()


def test_deadline_expiry_mid_solve_cancels_with_partial_result():
    res = twin(_mid_solve)["victim"]
    assert res.outcome == "deadline-miss"
    assert res.detail == "expired-mid-solve"
    assert res.dispatched and res.partial
    assert res.iters > 0 and np.isfinite(res.diff)
    assert res.w is not None and res.w.shape == (13, 13)


def _at_completion(ns):
    clock = FakeClock()
    sched = make(ns, chunk=4096, clock=clock, idle=clock.advance)
    sched.submit(ns.Problem(M=10, N=10), deadline_s=1.0, request_id="edge")
    sched._fill_lanes()
    clock.advance(2.0)
    return sched.drain()


def test_deadline_expiry_exactly_at_completion_returns_result():
    res = twin(_at_completion)["edge"]
    assert res.outcome == "completed"
    assert res.converged and res.w is not None
    assert res.detail is None


def _miss_metric(ns):
    clock = FakeClock()
    sched = make(ns, clock=clock, idle=clock.advance)
    sched.submit(ns.Problem(M=12, N=12, delta=1e-7), deadline_s=5.0,
                 request_id="m")
    sched.step()
    clock.advance(6.0)
    out = sched.drain()
    snap = ns.metrics.REGISTRY.snapshot()
    assert snap["counters"]["deadline_miss_total"] == 1
    assert "time_in_queue_seconds" in snap["histograms"]
    return out


def test_deadline_miss_metric_counts():
    twin(_miss_metric)


# -- retire / refill ---------------------------------------------------------


def _mixed(ns):
    sched = make(ns)
    sched.submit(ns.Problem(M=10, N=10), request_id="small")
    sched.submit(ns.Problem(M=12, N=12), request_id="big")
    out = sched.drain()
    assert len(sched._ctxs) == 1  # one bucket context served both
    return out


def test_mixed_shapes_pack_one_bucket_and_solve_their_own_problems():
    from poisson_ellipse_tpu_torch.solver.pcg import solve as pcg_solve

    results = twin(_mixed)
    for rid, M in (("small", 10), ("big", 12)):
        single = pcg_solve(Problem(M=M, N=M), torch.float32, device="cpu")
        res = results[rid]
        assert res.outcome == "completed"
        assert res.w.shape == (M + 1, M + 1)
        assert res.iters == int(single.iters)
        np.testing.assert_allclose(res.w, single.w.numpy(), rtol=0,
                                   atol=1e-5)


def test_refill_reuses_the_bucket_advance():
    sched = make(PORT, lanes=1)
    before = sched_mod._bucket_advance.cache_info()
    for i in range(3):
        sched.submit(Problem(M=10, N=10), request_id=f"r{i}")
    assert {r.outcome for r in sched.drain().values()} == {"completed"}
    info = sched_mod._bucket_advance.cache_info()
    assert info.misses - before.misses <= 1


def _cap(ns):
    sched = make(ns)
    sched.submit(ns.Problem(M=12, N=12, delta=1e-12, max_iter=5),
                 request_id="capped")
    return sched.drain()


def test_iteration_cap_classifies_cap_outcome():
    res = twin(_cap)["capped"]
    assert res.outcome == "cap"
    assert res.iters == 5
    assert res.exit_code == 1


def _pair(ns, p_a, p_b, lanes=2, chunk=4):
    """A long request on lane 0, a short one retiring on lane 1, then the
    request ``p`` refilled into lane 1 mid-batch."""
    sched = make(ns, lanes=lanes, chunk=chunk)
    sched.submit(p_a, request_id="long")
    sched.submit(p_b, request_id="short")
    for _ in range(100):
        sched.step()
        if "short" in sched.results:
            break
    assert "short" in sched.results and "long" not in sched.results
    return sched


@pytest.mark.parametrize("M,N", [(12, 12), (10, 11)])
def test_refilled_lane_bitwise_a_fresh_lane(M, N):
    """The refill pin: a lane swapped in MID-batch (nonzero global k,
    another lane still iterating) gives the same bits as the same request
    on lane 0 of a fresh context of the same width — and JAX's count."""
    p = Problem(M=M, N=N)
    sched = _pair(PORT, Problem(M=12, N=12, delta=1e-7),
                  Problem(M=12, N=12, delta=5e-6))
    sched.submit(p, request_id="swapped")
    sched._fill_lanes()
    ctx, slot = sched._slot_of("swapped")
    assert slot.base_k > 0 and slot.lane == 1
    res = sched.drain()["swapped"]
    fresh = make(PORT, lanes=2, chunk=4)
    fresh.submit(p, request_id="alone")
    fresh._fill_lanes()
    assert fresh._slot_of("alone")[1].lane == 0
    alone = fresh.drain()["alone"]
    assert res.outcome == alone.outcome == "completed"
    assert res.iters == alone.iters
    assert res.diff == alone.diff
    assert np.array_equal(res.w, alone.w)
    jsched = _pair(JAX, JaxProblem(M=12, N=12, delta=1e-7),
                   JaxProblem(M=12, N=12, delta=5e-6))
    jsched.submit(JaxProblem(M=M, N=N), request_id="swapped")
    jres = jsched.drain()["swapped"]
    assert res.iters == jres.iters
    np.testing.assert_allclose(res.w, np.asarray(jres.w), rtol=0, atol=W_TOL)


# -- the retry ladder --------------------------------------------------------


def _nan(ns):
    plan = ns.FaultPlan(ns.Fault("nan", at_iter=4, field="r",
                                 request_id="victim"))
    sched = make(ns, faults=plan, max_retries=1)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    sched.submit(ns.Problem(M=10, N=10), request_id="bystander")
    out = sched.drain()
    assert plan.faults[0].fired
    return out


def test_nan_fault_retries_on_fresh_lane_and_completes():
    results = twin(_nan)
    assert results["victim"].outcome == "completed"
    assert results["victim"].attempts == 2
    assert results["bystander"].outcome == "completed"
    assert results["bystander"].attempts == 1


def _oom(ns):
    plan = ns.FaultPlan(ns.Fault("oom", at_iter=2, request_id="victim"))
    sched = make(ns, faults=plan, max_retries=1)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    return sched.drain()


def test_oom_fault_walks_ladder_and_completes():
    res = twin(_oom)["victim"]
    assert res.outcome == "completed"
    assert res.attempts == 2


def _total_s(ns):
    clock = FakeClock()
    plan = ns.FaultPlan(ns.Fault("nan", at_iter=2, field="r",
                                 request_id="victim"))
    sched = make(ns, faults=plan, max_retries=1, clock=clock,
                 idle=clock.advance, backoff_base_s=0.5)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    sched.step()
    clock.advance(10.0)
    return sched.drain()


def test_total_s_spans_retries_from_first_admission():
    res = twin(_total_s)["victim"]
    assert res.outcome == "completed" and res.attempts == 2
    assert res.total_s >= 10.0
    assert res.time_in_queue_s < 10.0


def _requeue_overflow(ns):
    plan = ns.FaultPlan(ns.Fault("nan", at_iter=2, field="r",
                                 request_id="victim"))
    sched = make(ns, lanes=1, queue_capacity=1, faults=plan, max_retries=1)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    sched.step()
    sched.submit(ns.Problem(M=10, N=10), request_id="filler")
    shed_before = ns.metrics.REGISTRY.counter("shed_total").value
    out = sched.drain()
    assert ns.metrics.REGISTRY.counter("shed_total").value == shed_before
    return out


def test_requeue_overflow_failure_reports_dispatched_and_no_shed():
    results = twin(_requeue_overflow)
    res = results["victim"]
    assert res.outcome == "failed"
    assert res.detail == "requeue-shed-under-overload"
    assert res.dispatched
    assert results["filler"].outcome == "completed"


def _slow_fallback(ns, monkeypatch):
    clock = FakeClock()
    plan = ns.FaultPlan(ns.Fault("nan", at_iter=2, field="r",
                                 request_id="victim", persistent=True))
    sched = make(ns, faults=plan, max_retries=0, clock=clock,
                 idle=clock.advance)
    real = ns.guard.guarded_solve

    def slow(*args, **kwargs):
        clock.advance(30.0)
        return real(*args, **kwargs)

    monkeypatch.setattr(ns.guard, "guarded_solve", slow)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    return sched.drain()


def test_guarded_fallback_queue_wait_excludes_solve_time(monkeypatch):
    res = twin(_slow_fallback, monkeypatch)["victim"]
    assert res.outcome == "completed" and res.detail == "guarded-fallback"
    assert res.time_in_queue_s < 30.0
    assert res.total_s >= 30.0


def _persistent(ns):
    plan = ns.FaultPlan(ns.Fault("nan", at_iter=2, field="r",
                                 request_id="victim", persistent=True))
    sched = make(ns, faults=plan, max_retries=2)
    sched.submit(ns.Problem(M=10, N=10), request_id="victim")
    return sched.drain()


def test_persistent_fault_exhausts_budget_then_guarded_fallback():
    res = twin(_persistent)["victim"]
    assert res.outcome == "completed"
    assert res.detail == "guarded-fallback"
    assert res.attempts == 4  # 1 initial + 2 retries + the fallback


# -- journal / replay --------------------------------------------------------


def _killed(ns, path):
    sched = make(ns, journal=ns.RequestJournal(path))
    for i in range(4):
        sched.submit(ns.Problem(M=10, N=10), request_id=f"r{i}")
    sched.step()
    assert not list(path.parent.glob(".journal-*")), "no temp litter"
    successor = make(ns, journal=ns.RequestJournal(path))
    assert successor.replay() == 4
    out = successor.drain()
    assert ns.RequestJournal(path).counts() == {
        "admitted": 4, "finished": 4, "unfinished": 0,
    }
    return out


def test_journal_snapshot_is_atomic_and_replay_complete(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = _killed(PORT, tmp_path / "p" / "journal.json")
    want = _killed(JAX, tmp_path / "j" / "journal.json")
    assert summary(port) == summary(want)
    assert {port[f"r{i}"].outcome for i in range(4)} == {"completed"}


def test_journal_refuses_double_completion(tmp_path):
    journal = serve.RequestJournal(tmp_path / "j.json")
    req = serve.ServeRequest(problem=Problem(M=10, N=10), request_id="once")
    journal.record_admit(req)
    journal.record_outcome("once", "completed")
    with pytest.raises(serve.DoubleCompletionError):
        journal.record_outcome("once", "completed")
    with pytest.raises(serve.DoubleCompletionError):
        journal.record_admit(req)
    with pytest.raises(KeyError):
        journal.record_outcome("never-admitted", "completed")
    with pytest.raises(ValueError):
        journal.record_outcome("once", "vanished")


def _backlog(ns, path):
    journal = ns.RequestJournal(path)
    for i in range(6):
        journal.record_admit(
            ns.ServeRequest(problem=ns.Problem(M=10, N=10),
                            request_id=f"r{i}")
        )
    successor = make(ns, journal=ns.RequestJournal(path), queue_capacity=2,
                     lanes=1)
    assert successor.replay() == 6
    assert len(successor.queue) == 2 and len(successor._replay_backlog) == 4
    out = successor.drain()
    assert ns.RequestJournal(path).counts()["unfinished"] == 0
    return out


def test_replay_overflow_waits_in_backlog_never_terminally_shed(tmp_path):
    port = _backlog(PORT, tmp_path / "p.json")
    assert summary(port) == summary(_backlog(JAX, tmp_path / "j.json"))
    assert {port[f"r{i}"].outcome for i in range(6)} == {"completed"}


def test_journal_compacts_finished_records_to_o_live_snapshots(tmp_path):
    path = tmp_path / "j.json"
    journal = serve.RequestJournal(path)
    for i in range(5):
        journal.record_admit(
            serve.ServeRequest(problem=Problem(M=10, N=10),
                               request_id=f"r{i}")
        )
        journal.record_outcome(f"r{i}", "completed")
    journal.record_admit(
        serve.ServeRequest(problem=Problem(M=10, N=10), request_id="live")
    )
    with open(path, encoding="utf-8") as fh:
        snap = json.load(fh)
    assert set(snap["requests"]) == {"live"}
    assert snap["finished"] == 5
    reloaded = serve.RequestJournal(path)
    assert reloaded.counts() == {
        "admitted": 6, "finished": 5, "unfinished": 1,
    }
    assert [r.request_id for r in reloaded.unfinished(0.0)] == ["live"]
    assert journal.state_of("r0") == {"state": "done"}
    assert journal.state_of("r0-nonexistent") is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_files_replay_in_the_other_package(tmp_path, writer):
    """A journal written by one package (a killed server's admitted and
    finished requests, deadlines, tenants) replays in the other: the same
    unfinished set, specs and counts, and the same outcomes after it."""
    src, dst = (PORT, JAX) if writer == "port" else (JAX, PORT)
    path = tmp_path / "journal.json"
    clock = FakeClock(50.0)
    sched = make(src, journal=src.RequestJournal(path), clock=clock,
                 idle=clock.advance)
    for i in range(5):
        sched.submit(src.Problem(M=10 + i % 3, N=10, delta=1e-6 * (1 + i)),
                     deadline_s=30.0 if i % 2 else None,
                     request_id=f"r{i}", tenant=f"t{i % 2}",
                     priority=1 + i % 3)
    sched.step()  # two lanes busy, three queued; then the "kill"
    with open(path, encoding="utf-8") as fh:
        snap = json.load(fh)
    assert snap["v"] == 1 and set(snap) == {"v", "requests", "finished"}
    back = dst.RequestJournal(path)
    mine = src.RequestJournal(path)
    assert back.counts() == mine.counts()
    assert [r.spec() for r in back.unfinished(0.0)] == \
        [r.spec() for r in mine.unfinished(0.0)]
    outcomes = {}
    for ns in (src, dst):
        copy = tmp_path / f"{ns.name}-copy.json"
        copy.write_bytes(path.read_bytes())
        clock2 = FakeClock(0.0)
        successor = make(ns, journal=ns.RequestJournal(copy), clock=clock2,
                         idle=clock2.advance)
        assert successor.replay() == 5
        outcomes[ns.name] = summary(successor.drain())
    assert outcomes["port"] == outcomes["jax"]
    assert set(outcomes["port"]) == {f"r{i}" for i in range(5)}


def test_request_spec_is_jax_s():
    kw = dict(deadline=12.5, max_retries=3, request_id="abc",
              tenant="gold", priority=7)
    req = serve.ServeRequest(problem=Problem(M=10, N=12, delta=2e-6,
                                             norm="unweighted", max_iter=9),
                             **kw)
    jreq = jax_serve.ServeRequest(
        problem=JaxProblem(M=10, N=12, delta=2e-6, norm="unweighted",
                           max_iter=9), **kw)
    req.enqueued_t = jreq.enqueued_t = 2.5
    assert req.spec() == jreq.spec()
    assert json.dumps(req.spec()) == json.dumps(jreq.spec())
    back = serve.ServeRequest.from_spec(jreq.spec(), now=100.0)
    assert back.spec() | {"deadline_left_s": None} == \
        jreq.spec() | {"deadline_left_s": None}
    assert back.deadline == 110.0
    assert serve.OUTCOMES == jax_serve.OUTCOMES
    assert serve.EXIT_BY_OUTCOME == jax_serve.EXIT_BY_OUTCOME
    res = serve.ServeResult(request_id="abc", outcome="shed",
                            retry_after_s=0.5)
    jres = jax_serve.ServeResult(request_id="abc", outcome="shed",
                                 retry_after_s=0.5)
    assert res.json_dict() == jres.json_dict()
    assert res.exit_code == jres.exit_code == 5
    with pytest.raises(ValueError):
        serve.ServeResult(request_id="x", outcome="lost")


def _duplicate(ns, path):
    sched = make(ns, journal=ns.RequestJournal(path))
    assert sched.submit(ns.Problem(M=10, N=10), request_id="dup") is None
    refused = sched.submit(ns.Problem(M=12, N=12), request_id="dup")
    assert refused is not None and refused.outcome == "shed"
    assert refused.detail == "duplicate-request-id"
    results = sched.drain()
    refused = sched.submit(ns.Problem(M=10, N=10), request_id="dup")
    assert refused is not None and refused.detail == "duplicate-request-id"
    return results


def test_duplicate_request_id_is_refused_without_touching_the_original(
        tmp_path):
    port = _duplicate(PORT, tmp_path / "p.json")
    assert summary(port) == summary(_duplicate(JAX, tmp_path / "j.json"))
    assert port["dup"].outcome == "completed"


def _replay_miss(ns, path):
    journal = ns.RequestJournal(path)
    req = ns.ServeRequest(problem=ns.Problem(M=10, N=10), request_id="r0",
                          deadline=0.0)
    req.enqueued_t = 0.0
    journal.record_admit(req)
    clock = FakeClock()
    successor = make(ns, journal=ns.RequestJournal(path), clock=clock,
                     idle=clock.advance)
    shed_before = ns.metrics.REGISTRY.counter("shed_total").value
    successor.replay()
    out = successor.drain()
    assert ns.metrics.REGISTRY.counter("shed_total").value == shed_before
    return out


def test_replay_infeasible_deadline_is_a_miss_not_a_shed(tmp_path):
    port = _replay_miss(PORT, tmp_path / "p.json")
    assert summary(port) == summary(_replay_miss(JAX, tmp_path / "j.json"))
    res = port["r0"]
    assert res.outcome == "deadline-miss"
    assert res.detail == "replay-deadline-infeasible"
    assert not res.dispatched


def test_idle_bucket_rebases_its_iteration_clock():
    sched = make(PORT)
    sched.submit(Problem(M=10, N=10), request_id="r0")
    sched.drain()
    (ctx,) = sched._ctxs.values()
    assert int(ctx.state[0]) == 0 and ctx.k == 0
    sched.submit(Problem(M=10, N=10), request_id="r1")
    assert sched.drain()["r1"].outcome == "completed"
    assert int(ctx.state.k) == ctx.k == 0


def test_collect_evicts_results():
    sched = make(PORT)
    sched.submit(Problem(M=10, N=10), request_id="r0")
    sched.drain()
    first = sched.collect()
    assert first["r0"].outcome == "completed"
    assert sched.results == {} and sched.collect() == {}
    sched.submit(Problem(M=10, N=10), request_id="r1")
    sched.drain()
    assert set(sched.collect()) == {"r1"}


def test_replayed_deadline_budget_restarts(tmp_path):
    clock = FakeClock(100.0)
    sched = make(PORT, journal=serve.RequestJournal(tmp_path / "j.json"),
                 clock=clock, idle=clock.advance)
    sched.submit(Problem(M=10, N=10), deadline_s=60.0, request_id="r0")
    clock2 = FakeClock(0.0)
    successor = make(PORT, journal=serve.RequestJournal(tmp_path / "j.json"),
                     clock=clock2, idle=clock2.advance)
    assert successor.replay() == 1
    req = successor.queue.pop_ready(clock2())
    assert req.deadline == pytest.approx(60.0, abs=1.0)


def _device_loss(ns, path):
    sched = ns.Scheduler(
        lanes=2, chunk=4, max_retries=1, backoff_base_s=0.0,
        journal=ns.RequestJournal(path),
        faults=ns.FaultPlan(
            ns.Fault("device_loss", at_iter=1, device=0, request_id="dl-0")
        ), **ns.kw,
    )
    for i in range(3):
        assert sched.submit(ns.Problem(M=10, N=10),
                            request_id=f"dl-{i}") is None
    return sched.drain()


def test_scheduler_device_loss_reenters_in_flight(tmp_path):
    results = _device_loss(PORT, tmp_path / "p.json")
    assert summary(results) == summary(_device_loss(JAX,
                                                    tmp_path / "j.json"))
    assert set(results) == {"dl-0", "dl-1", "dl-2"}
    assert all(r.outcome == "completed" for r in results.values())
    assert any(r.attempts > 1 for r in results.values())


# -- a seeded stream, request by request -------------------------------------


def _stream(ns, dtype, seed):
    """A seeded stream of mixed shapes (one bucket of 12x12 and one of
    16x16), caps, deadlines on a hand-cranked clock, a NaN lane, an OOM,
    a persistent fault down to the guarded fallback, and a queue that
    sheds."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    plan = ns.FaultPlan(
        ns.Fault("nan", at_iter=3, field="r", request_id="s02"),
        ns.Fault("oom", at_iter=2, request_id="s05"),
        ns.Fault("nan", at_iter=1, field="p", request_id="s09",
                 persistent=True),
    )
    sched = make(ns, lanes=3, chunk=6, queue_capacity=6, faults=plan,
                 max_retries=1, clock=clock, idle=clock.advance,
                 dtype=dtype)
    shed = {}
    grids = [(8, 8), (10, 10), (12, 12), (14, 16), (9, 12)]
    for i in range(20):
        M, N = grids[int(rng.integers(len(grids)))]
        cap = 6 if i == 7 else None
        deadline = 0.3 if i in (11, 15) else None
        out = sched.submit(ns.Problem(M=M, N=N, max_iter=cap),
                           deadline_s=deadline, request_id=f"s{i:02d}")
        if out is not None:
            shed[out.request_id] = out
        clock.advance(0.05)
        sched.step()
    results = dict(sched.drain())
    results.update(shed)
    return results


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_seeded_stream_matches_jax_request_by_request(dtype, seed):
    dt = {"f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64)}[dtype]
    port = _stream(PORT, dt[0], seed)
    want = _stream(JAX, dt[1], seed)
    assert summary(port) == summary(want)
    assert len(port) == 20
    tol = W_TOL if dtype == "f32" else 1e-10
    for rid, res in port.items():
        if res.w is not None:
            np.testing.assert_allclose(res.w, np.asarray(want[rid].w),
                                       rtol=0, atol=tol)
    assert port["s09"].detail == "guarded-fallback"
    assert {r.outcome for r in port.values()} >= {"completed", "cap"}


# -- what the port does not carry yet ----------------------------------------


def test_mesh_composition_names_item_10b():
    from poisson_ellipse_tpu_torch.parallel import batched_sharded

    with pytest.raises(NotImplementedError, match="Queue A item 10b"):
        serve.Scheduler(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 10b"):
        batched_sharded.build_sharded_chunk_advance((12, 12))


@pytest.mark.parametrize("case", ["warm_start", "malformed", "degenerate",
                                  "poison"])
def test_unported_scheduler_options_name_their_items(case):
    item = {"warm_start": "13", "malformed": "11", "degenerate": "11",
            "poison": "13"}[case]
    kw = {"warm_start": {"warm_start": True},
          "malformed": {"faults": fi.FaultPlan(fi.malformed_spec("a"))},
          "degenerate": {"faults": fi.FaultPlan(
              fi.degenerate_geometry(request_id="a"))},
          "poison": {"faults": fi.FaultPlan(fi.cache_poison("a"))}}[case]
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        serve.Scheduler(device="cpu", **kw)


@pytest.mark.parametrize("kind", ["geometry", "theta", "grad"])
def test_unported_request_kinds_name_their_items(kind, tmp_path):
    item = "14" if kind == "grad" else "11"
    kw = {"geometry": {"geometry": {"kind": "ellipse", "cx": 0.0, "cy": 0.0,
                                    "rx": 0.9, "ry": 0.45}},
          "theta": {"theta": 0.1},
          "grad": {"grad": True}}[kind]
    req = serve.ServeRequest(problem=Problem(M=10, N=10), request_id="g",
                             **kw)
    sched = make(PORT, journal=serve.RequestJournal(tmp_path / "j.json"))
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        sched.submit_request(req)
    assert len(sched.queue) == 0 and not sched.results
    # a journal written by the JAX package with such a request refuses
    # to replay it here, naming the item
    jreq = jax_serve.ServeRequest(problem=JaxProblem(M=10, N=10),
                                  request_id="g", **kw)
    jax_serve.RequestJournal(tmp_path / "jax.json").record_admit(jreq)
    successor = make(PORT, journal=serve.RequestJournal(tmp_path / "jax.json"))
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        successor.replay()
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        successor.adopt_request(req)


def test_scheduler_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Scheduler()


# -- observability -----------------------------------------------------------


def _lifecycle(ns, path):
    ns.trace.start(str(path))
    try:
        plan = ns.FaultPlan(ns.Fault("nan", at_iter=4, field="r",
                                     request_id="victim"))
        sched = make(ns, queue_capacity=1, faults=plan, max_retries=1)
        sched.submit(ns.Problem(M=10, N=10), request_id="victim")
        sched.submit(ns.Problem(M=10, N=10), request_id="overflow")
        out = sched.drain()
    finally:
        ns.trace.stop()
    assert ns.trace.validate_file(str(path)) == []
    return out


def test_lifecycle_events_are_request_addressed_schema_v3(tmp_path):
    port = _lifecycle(PORT, tmp_path / "p.jsonl")
    assert summary(port) == summary(_lifecycle(JAX, tmp_path / "j.jsonl"))
    names = {}
    for path in ("p.jsonl", "j.jsonl"):
        recs = obs_trace.read_jsonl(str(tmp_path / path))
        names[path] = [(r["name"], r.get("request_id"), r.get("lane"),
                        sorted(r.get("fields", {})))
                       for r in recs if r["name"].startswith("serve:")]
    # the same serve:* events, request ids, lanes and field names, in order
    assert names["p.jsonl"] == names["j.jsonl"]
    by_name: dict = {}
    for name, rid, _, _ in names["p.jsonl"]:
        by_name.setdefault(name, []).append(rid)
    for name in ("serve:admit", "serve:refill", "serve:retire",
                 "serve:shed", "serve:fault", "serve:retry"):
        assert name in by_name, f"missing {name}"
        assert all(by_name[name])
    assert by_name["serve:shed"][0] == "overflow"


def _metrics(ns):
    sched = make(ns, queue_capacity=1)
    sched.submit(ns.Problem(M=10, N=10), request_id="a")
    sched.submit(ns.Problem(M=10, N=10), request_id="b")  # shed
    snap = ns.metrics.REGISTRY.snapshot()
    assert snap["counters"]["shed_total"] == 1
    assert snap["gauges"]["queue_depth"] == 1
    out = sched.drain()
    snap = ns.metrics.REGISTRY.snapshot()
    assert snap["gauges"]["queue_depth"] == 0
    assert snap["counters"]["serve_completed_total"] == 1
    return out, snap["counters"]


def test_queue_depth_and_shed_metrics():
    port, counters = _metrics(PORT)
    want, jax_counters = _metrics(JAX)
    assert summary(port) == summary(want)
    assert counters == jax_counters


# -- the command line --------------------------------------------------------


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_serve_subcommand(tmp_path, capsys):
    argv = ["serve", "--requests", "3", "--grids", "10x10", "--rate",
            "1000", "--json"]
    jax_rc = jax_main(argv + ["--trace", str(tmp_path / "j.jsonl")])
    jax_rec = _last_json(capsys)
    rc = cli_main(argv + ["--device", "cpu", "--trace",
                          str(tmp_path / "p.jsonl"),
                          "--metrics", str(tmp_path / "m.prom")])
    rec = _last_json(capsys)
    assert rc == jax_rc == 0
    assert set(rec) == set(jax_rec)
    assert rec["outcomes"] == jax_rec["outcomes"] == {"completed": 3}
    assert rec["solves_per_sec"] > 0
    assert obs_trace.validate_file(str(tmp_path / "p.jsonl")) == []
    from poisson_ellipse_tpu_torch.obs.export import validate_openmetrics

    text = (tmp_path / "m.prom").read_text()
    assert validate_openmetrics(text) == []
    assert "poisson_serve_completed_total" in text


def test_cli_serve_exit_code_is_the_worst_outcome(tmp_path, capsys):
    """--deadline 0 sheds every request at admission: exit 5, as JAX."""
    argv = ["serve", "--requests", "2", "--grids", "10x10", "--rate",
            "1000", "--deadline", "0", "--json"]
    jax_rc = jax_main(argv)
    jax_rec = _last_json(capsys)
    rc = cli_main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rc == jax_rc == 5
    assert rec["outcomes"] == jax_rec["outcomes"] == {"shed": 2}


def test_cli_serve_journal_and_replay(tmp_path, capsys):
    journal = tmp_path / "j.json"
    rc = cli_main(["serve", "--requests", "3", "--grids", "10x10",
                   "--journal", str(journal), "--json", "--device", "cpu"])
    assert rc == 0 and _last_json(capsys)["replayed"] == 0
    # a pure-replay restart on a finished journal replays nothing
    rc = cli_main(["serve", "--requests", "0", "--replay", "--journal",
                   str(journal), "--json", "--device", "cpu"])
    rec = _last_json(capsys)
    assert rc == 0 and rec["replayed"] == 0 and rec["outcomes"] == {}


def test_cli_serve_rejects_bad_args(capsys):
    for argv in (["--requests", "0"], ["--replay"], ["--rate", "0"],
                 ["--rate", "-5"], ["--grids", "10x10,"]):
        assert jax_main(["serve", *argv]) == 2
        assert cli_main(["serve", "--device", "cpu", *argv]) == 2
    assert cli_main(["serve", "--device", "cpu", "--warm-start"]) == 2
    assert "Queue A item 13" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli_main(["serve", "--requests", "1"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
