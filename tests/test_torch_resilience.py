"""The port's resilience layer (``poisson_ellipse_tpu_torch.resilience``,
the lane driver's faults and timeout, the command line's ``--guard``,
``--timeout``, ``--max-recoveries`` and ``inject``) against the JAX
package's, on the CPU.

The JAX package's own sizes: ``Problem(M=20, N=20)``, chunk 8, a fault at
iteration 10 (``tests/test_resilience.py``), 40×40 for the lanes
(``tests/test_batched.py``). The JAX Pallas engines interpret, as its own
tests run them. Tolerances:

- constants, classifications, fault plans and the corrupted carries:
  equal (bits for the bit flips);
- the fault matrix and the ladder's paths: the recovery events (kind,
  iteration, health word, engine) and the final iteration count equal
  JAX's; w within 5e-6 of JAX's (``assert_parity``'s tolerance), 1e-10 in
  f64;
- a guarded clean run against the unguarded port solve: bitwise, with no
  event and no more host reads than the plain loop's;
- bf16 storage through promotion: l2 at most 1.05× the f32 run's.
"""

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.batch.driver import solve_batched as jax_solve_batched
from poisson_ellipse_tpu.harness.__main__ import main as jax_main
from poisson_ellipse_tpu.harness.run import run_once as jax_run_once
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.resilience import errors as jax_errors
from poisson_ellipse_tpu.resilience import faultinject as jax_fi
from poisson_ellipse_tpu.resilience import guard as jax_guard
from poisson_ellipse_tpu.solver.engine import solve as jax_engine_solve
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch import resilience
from poisson_ellipse_tpu_torch.batch import driver
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.resilience import errors, faultinject as fi
from poisson_ellipse_tpu_torch.resilience import guard
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

PROBLEM = Problem(M=20, N=20)
JAX_PROBLEM = JaxProblem(M=20, N=20)
CHUNK = 8
FAULT_AT = 10
LOOP_ENGINES = ("xla", "pallas", "pipelined", "pipelined-pallas")
FAULTS = ("nan", "breakdown", "stagnation", "oom")
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_tracer():
    """One PyTorch thread a test, and no ambient tracer in either
    package around it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (obs_trace, jax_trace):
        mod.stop()
        mod._env_checked = True
    yield
    obs_trace.stop()
    jax_trace.stop()
    torch.set_num_threads(before)


def _plan(module, fault: str, **kw):
    make = {"nan": lambda: module.inject_nan(FAULT_AT, "r", **kw),
            "breakdown": lambda: module.force_breakdown(FAULT_AT),
            "stagnation": lambda: module.inject_stagnation(FAULT_AT),
            "oom": lambda: module.simulate_oom(FAULT_AT)}[fault]
    return module.FaultPlan(make())


def _events(recoveries) -> list:
    return [(e.kind, e.at_iter, e.health, e.engine) for e in recoveries]


_JAX_ADAPTERS: dict = {}


def _jax_guarded_solve(problem, engine_name, dtype, *, faults=None,
                       chunk=jax_guard.DEFAULT_CHUNK, max_recoveries=3,
                       **kw):
    """JAX's ``guarded_solve`` (``_make_adapter`` then ``_run_chunked``)
    with each plain loop engine's f32 adapter built once for the file: an
    adapter holds no carry, and a new one compiles its chunk anew."""
    if kw or problem != JAX_PROBLEM or dtype != jnp.float32 or (
            engine_name not in LOOP_ENGINES):
        return jax_guard.guarded_solve(problem, engine_name, dtype,
                                       faults=faults, chunk=chunk,
                                       max_recoveries=max_recoveries, **kw)
    if engine_name not in _JAX_ADAPTERS:
        _JAX_ADAPTERS[engine_name] = jax_guard._make_adapter(
            problem, engine_name, dtype, None, None)
    return jax_guard._run_chunked(
        problem, _JAX_ADAPTERS[engine_name], chunk=chunk,
        max_recoveries=max_recoveries, timeout=None, t0=time.monotonic(),
        plan=faults if faults is not None else jax_fi.FaultPlan(),
        events=[])


def _run_both(engine_name: str, dtype=torch.float32, fault=None, **kw):
    """(JAX outcome, port outcome) of the same guarded solve: each the
    GuardedResult or the SolveError class name with its iters."""
    out = []
    for solve, mod, problem, dt, extra in (
            (_jax_guarded_solve, jax_fi, JAX_PROBLEM, JAX_DTYPE[dtype], {}),
            (guard.guarded_solve, fi, PROBLEM, dtype, {"device": "cpu"})):
        if fault is None:
            plan = None
        elif isinstance(fault, str):
            plan = _plan(mod, fault)
        else:
            plan = mod.FaultPlan(mod.Fault(**fault))
        try:
            out.append(solve(problem, engine_name, dt, faults=plan, **kw,
                             **extra))
        except (jax_errors.SolveError, errors.SolveError) as e:
            out.append((type(e).__name__, e.exit_code, e.iters))
    return out


def _same_outcome(ref, got, atol: float = 5e-6) -> None:
    if isinstance(ref, tuple) and not hasattr(ref, "result"):
        assert got == ref
        return
    assert _events(got.recoveries) == _events(ref.recoveries)
    assert got.engine == ref.engine and got.dtype == ref.dtype
    assert int(got.result.iters) == int(ref.result.iters)
    assert bool(got.result.converged) == bool(ref.result.converged)
    w = got.result.w.double().numpy()
    assert np.isfinite(w).all()
    np.testing.assert_allclose(w, np.asarray(ref.result.w, np.float64),
                               rtol=0, atol=atol)


# ------------------------------------------------------------ the contract


def test_exit_codes_and_classes_equal_jax():
    names = [n for n, v in vars(jax_errors).items()
             if isinstance(v, type) and issubclass(v, BaseException)
             and v.__module__ == jax_errors.__name__]
    assert len(names) == 12
    for name in names:
        ref, got = getattr(jax_errors, name), getattr(errors, name)
        assert got.__mro__[1].__name__ == ref.__mro__[1].__name__, name
        assert getattr(got, "classification", None) == getattr(
            ref, "classification", None), name
        assert getattr(got, "exit_code", None) == getattr(
            ref, "exit_code", None), name
    for name in (n for n in dir(jax_errors) if n.startswith("EXIT_")):
        assert getattr(errors, name) == getattr(jax_errors, name), name
    assert [errors.DivergedError("x").exit_code,
            errors.OutOfMemoryError("x").exit_code,
            errors.SolveTimeout("x").exit_code] == [2, 3, 4]
    assert errors._OOM_MARKERS == jax_errors._OOM_MARKERS
    assert errors._DEVICE_LOSS_MARKERS == jax_errors._DEVICE_LOSS_MARKERS
    assert set(resilience.__all__) == set(
        __import__("poisson_ellipse_tpu.resilience",
                   fromlist=["__all__"]).__all__)


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: foo"),
    RuntimeError("Out of memory allocating"),
    MemoryError(),
    ValueError("nope"),
    RuntimeError("DEVICE_LOST: gone"),
    RuntimeError("Attempting to allocate 4.0G"),
], ids=lambda e: type(e).__name__ + ":" + str(e)[:12])
def test_classify_error_equals_jax(exc):
    assert errors.classify_error(exc) == jax_errors.classify_error(exc)


def test_classify_error_on_the_ports_own_failures():
    # JAX's classified errors keep their tags across the packages' names
    assert errors.classify_error(errors.SolveTimeout("t")) == "timeout"
    assert errors.classify_error(errors.LeaseStoreOutageError("x")) == (
        jax_errors.classify_error(jax_errors.LeaseStoreOutageError("x")))
    # a real CUDA allocation failure
    assert errors.classify_error(
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")) \
        == "oom"
    assert errors.is_oom_error(torch.OutOfMemoryError("x"))
    # a kernel that did not build, even if nvcc itself ran out of memory,
    # and the sticky CUDA errors: never retried, never a fallback
    for text in ("kernel build failed:\nstencil: nvcc exit 1\nout of memory",
                 "nvcc not found (set CUDA_HOME)",
                 "CUDA error: an illegal memory access was encountered",
                 "stencil: CUDA launch failed (719: unspecified launch "
                 "failure)",
                 # a launch refused for memory is a kernel failure too
                 "stencil: CUDA launch failed (2: out of memory)",
                 "resident: the kernel did not run to its end (status "
                 "[0, 0, 0, 0])"):
        assert errors.classify_error(RuntimeError(text)) == "unknown", text
    assert errors.classify_error(
        fi.SimulatedResourceExhausted("RESOURCE_EXHAUSTED: x")) == "oom"
    assert errors.classify_error(fi.SimulatedDeviceLoss("DEVICE_LOST")) == (
        "device-loss")


def test_health_constants_and_names_equal_jax():
    for name in ("HEALTH_BREAKDOWN", "HEALTH_NONFINITE", "HEALTH_STAGNATION",
                 "HEALTH_CONVERGED", "HEALTH_SDC", "DEFAULT_CHUNK",
                 "RESIDUAL_DRIFT_TOL", "_CAPACITY_LADDER", "_UNHEALTHY"):
        assert getattr(guard, name) == getattr(jax_guard, name), name
    for word in range(32):
        assert guard.health_name(word) == jax_guard.health_name(word)
    assert [f.name for f in dataclasses.fields(guard.RecoveryEvent)] == [
        f.name for f in dataclasses.fields(jax_guard.RecoveryEvent)]
    assert guard.GuardedResult._fields[:4] == jax_guard.GuardedResult._fields


# ---------------------------------------------------------- fault plans


def test_fault_kinds_constructors_and_specs_equal_jax():
    for name in ("FAULT_KINDS", "DISPATCH_KINDS", "ADMISSION_KINDS",
                 "REPLICA_KINDS", "LEASE_STORE_KINDS", "CACHE_KINDS",
                 "MALFORMED_SPEC"):
        assert getattr(fi, name) == getattr(jax_fi, name), name
    calls = [
        ("inject_nan", (3,), {"field": "p", "lane": 1}),
        ("force_breakdown", (4,), {}),
        ("inject_stagnation", (5,), {}),
        ("corrupt_halo", (6,), {"field": "w", "rows": 2}),
        ("simulate_oom", (7,), {}),
        ("halo_bitflip", (8,), {"bit": 3, "persistent": True}),
        ("psum_corrupt", (9,), {"lane": 0}),
        ("device_loss", (2,), {"device": 3}),
        ("straggler", (0.5,), {"at_iter": 4}),
        ("malformed_spec", (), {"request_id": "r1"}),
        ("degenerate_geometry", (0.01,), {}),
        ("cache_poison", ("r2",), {}),
        ("replica_kill", (3,), {"replica": 1}),
        ("replica_hang", (2.0,), {}),
        ("lease_clock_skew", (1.5,), {}),
        ("lease_store_outage", (2.0,), {}),
        ("lease_store_latency", (0.1,), {}),
    ]
    for name, args, kw in calls:
        assert dataclasses.asdict(getattr(fi, name)(*args, **kw)) == \
            dataclasses.asdict(getattr(jax_fi, name)(*args, **kw)), name
    assert fi.sliver_spec(2e-3) == jax_fi.sliver_spec(2e-3)
    assert np.array_equal(fi.poisoned_guess((5, 7), np.float32),
                          jax_fi.poisoned_guess((5, 7), np.float32))
    bad = [dict(kind="melt"), dict(kind="nan", at_iter=-1),
           dict(kind="nan", lane=0, request_id="x"),
           dict(kind="halo_bitflip", shard=2, shards=2),
           dict(kind="straggler", delay_s=-1.0),
           dict(kind="replica_kill", replica=-1),
           dict(kind="lease_store_outage", delay_s=0.0)]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            jax_fi.Fault(**kw)
        with pytest.raises(ValueError, match=str(ref.value)[:20]):
            fi.Fault(**kw)
    faults = [fi.inject_nan(12), fi.force_breakdown(5), fi.simulate_oom(20)]
    plan = fi.FaultPlan(*faults)
    ref = jax_fi.FaultPlan(jax_fi.inject_nan(12), jax_fi.force_breakdown(5),
                           jax_fi.simulate_oom(20))
    for k in (-1, 4, 5, 12, 20):
        assert plan.next_stop(k) == ref.next_stop(k)
    assert bool(plan) and not bool(fi.FaultPlan())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_flip_bit_equals_jax(dtype):
    values = np.array([0.0, 1.0, -2.5, 3.0e-3, 1234.5], np.float64)
    width = {"float32": 32, "float64": 64, "bfloat16": 16, "float16": 16}
    for v in values:
        x = torch.tensor(v).to(getattr(torch, dtype))
        for bit in (None, 0, 3, width[dtype] - 2):
            ref = np.asarray(jax_fi._flip_bit(jnp.asarray(v, dtype), bit))
            got = fi._flip_bit(x, bit)
            assert torch.equal(interop.tensor_from_numpy(ref).view(
                got.dtype), got), (dtype, v, bit)
        # the sign bit, which JAX's XOR mask overflows on: a negation
        sign = fi._flip_bit(x, width[dtype] - 1)
        assert torch.equal(sign, -x) and (sign.signbit() != x.signbit())
    with pytest.raises(ValueError, match="out of range"):
        fi._flip_bit(torch.tensor(1.0), 32)


def _carries(engine_name: str):
    """(JAX carry, the port's same carry) of ``engine_name`` advanced to
    iteration 6 in f64 at 20x20."""
    from poisson_ellipse_tpu.ops import assembly as jax_assembly
    from poisson_ellipse_tpu.ops import pipelined_pcg as jax_pp
    from poisson_ellipse_tpu.solver.pcg import advance, init_state

    a, b, rhs = jax_assembly.assemble(JAX_PROBLEM, jnp.float64)
    if engine_name == "xla":
        st = advance(JAX_PROBLEM, a, b, rhs,
                     init_state(JAX_PROBLEM, a, b, rhs), limit=6)
        port = interop.pcg_state_from_reference(PROBLEM, st, device="cpu")
        return st, port, jax_guard._ClassicalAdapter
    st = jax_pp.advance(JAX_PROBLEM, a, b, rhs,
                        jax_pp.init_state(JAX_PROBLEM, a, b, rhs), limit=6)
    port = interop.pipelined_state_from_reference(PROBLEM, st, device="cpu")
    return st, port, jax_guard._PipelinedAdapter


@pytest.mark.parametrize("engine_name", ["xla", "pipelined"])
def test_corrupted_carries_equal_jax(engine_name):
    """Each carry fault on the same carry in both packages: the same
    fields, bit for bit, and the port's carry of its own NamedTuple type
    with the input untouched."""
    ref_state, state, adapter = _carries(engine_name)
    before = [x.clone() for x in state]
    for kw in (dict(kind="nan"), dict(kind="nan", field="p"),
               dict(kind="nan", field=list(adapter.FIELDS)[-1]),
               dict(kind="breakdown"), dict(kind="stagnation"),
               dict(kind="halo", rows=2), dict(kind="psum_corrupt"),
               dict(kind="halo_bitflip"),
               dict(kind="halo_bitflip", bit=62, shard=1, shards=3)):
        ref = jax_fi.FaultPlan(jax_fi.Fault(at_iter=6, **kw)).apply(
            6, ref_state, adapter.FIELDS, adapter.BD, adapter.ZR)
        got = fi.FaultPlan(fi.Fault(at_iter=6, **kw)).apply(
            6, state, adapter.FIELDS, adapter.BD, adapter.ZR)
        assert type(got) is type(state), kw
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert np.array_equal(g.numpy(), r.astype(g.numpy().dtype),
                                  equal_nan=True), kw
    for x, y in zip(state, before):
        assert torch.equal(x, y) or bool(torch.isnan(x).all())
    with pytest.raises(ValueError, match="no field"):
        fi.FaultPlan(fi.inject_nan(6, "nope")).apply(
            6, state, adapter.FIELDS, adapter.BD, adapter.ZR)
    with pytest.raises(fi.SimulatedResourceExhausted, match="RESOURCE"):
        fi.FaultPlan(fi.simulate_oom(6)).apply(
            6, state, adapter.FIELDS, adapter.BD, adapter.ZR)
    with pytest.raises(fi.SimulatedDeviceLoss, match="DEVICE_LOST"):
        fi.FaultPlan(fi.device_loss(6, device=2)).apply(
            6, state, adapter.FIELDS, adapter.BD, adapter.ZR)


def test_lane_corruption_equals_jax():
    from poisson_ellipse_tpu.batch import batched_pcg as jax_bp

    problem, jp = Problem(M=12, N=12), JaxProblem(M=12, N=12)
    a, b, rhs = jax_bp.batched_operands(jp, 3, jnp.float64)
    ref_state = jax_bp.advance(jp, a, b, rhs,
                               jax_bp.init_state(jp, a, b, rhs), limit=4)
    state = interop.batched_state_from_reference(problem, ref_state,
                                                 "batched", device="cpu")
    fields = driver._LAYOUT["batched"]["fields"]
    for kw in (dict(kind="nan", lane=1), dict(kind="nan", field="zr",
                                                lane=2),
               dict(kind="breakdown", lane=0), dict(kind="stagnation",
                                                    lane=2),
               dict(kind="halo", lane=1, rows=3),
               dict(kind="psum_corrupt", lane=1),
               dict(kind="halo_bitflip", lane=2)):
        ref = jax_fi.FaultPlan(jax_fi.Fault(at_iter=4, **kw)).apply(
            4, ref_state, fields, 7, 4)
        got = fi.FaultPlan(fi.Fault(at_iter=4, **kw)).apply(
            4, state, fields, 7, 4)
        assert type(got) is type(state)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(
                g.numpy().dtype), equal_nan=True), kw
    with pytest.raises(ValueError, match="lane-stacked"):
        fi.FaultPlan(fi.Fault("halo", at_iter=4, field="zr", lane=0)).apply(
            4, state, fields, 7, 4)


def test_simulated_vmem_walks_auto_down_the_ladder():
    """The port's counterpart of ``vmem_capacity_override``: the gates of
    a hand-built H100 capacity, shrunk, walk ``auto`` from resident to
    streamed to xl at 800x1200; the launch shapes keep the card's
    budget, and the override ends with the context."""
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.utils.device import DeviceCapacity

    cap = DeviceCapacity(name="H100 (hand-built)", sm_count=132,
                         smem_per_block=232448, smem_per_sm=233472,
                         l2_bytes=50 * 2**20, total_memory=80 * 2**30)
    problem = Problem(M=800, N=1200)
    assert engine.select_engine(problem, torch.float32, cap) == "resident"
    with fi.simulated_vmem(150_000):
        assert engine.select_engine(problem, torch.float32, cap) == "streamed"
        assert rp.layout(problem, cap).fits  # the launch's own budget
    with resilience.simulated_vmem(4 * 1024 * 1024 // 64):
        assert engine.select_engine(problem, torch.float32, cap) == "xl"
    assert engine.select_engine(problem, torch.float32, cap) == "resident"


# ------------------------------------------------------ the fault matrix


@pytest.mark.parametrize("engine_name", LOOP_ENGINES)
def test_guarded_clean_run_is_bitwise_the_unguarded_solve(engine_name):
    """No fault: no event, the iterates bitwise the plain loop's (the
    guard issues the same bodies; chunking moves only where the host
    looks), one host read a chunk, and JAX's count."""
    got = guard.guarded_solve(PROBLEM, engine_name, torch.float32,
                              chunk=CHUNK, device="cpu")
    solver, args, _ = engine.build_solver(PROBLEM, engine_name,
                                          torch.float32, "cpu")
    plain = solver(*args)
    assert got.recoveries == () and got.engine == engine_name
    for x, y in zip(got.result, plain):
        assert torch.equal(x, y), engine_name
    n = int(plain.iters)
    assert got.host_syncs == -(-n // CHUNK) + 1  # + the drift check
    ref = jax_engine_solve(JAX_PROBLEM, engine_name, jnp.float32)
    assert n == int(ref.iters) == 26


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("engine_name", LOOP_ENGINES)
def test_fault_matrix_equals_jax(engine_name, fault):
    """engines × {nan, breakdown, stagnation, oom} at iteration 10, chunk
    8: the port's recovery events, final engine, count and w are JAX's
    (the oom cell on xla: OutOfMemoryError, exit 3, in both)."""
    ref, got = _run_both(engine_name, fault=fault, chunk=CHUNK)
    _same_outcome(ref, got)
    if fault == "oom" and engine_name == "xla":
        assert got == ("OutOfMemoryError", 3, FAULT_AT)
    elif fault == "oom":
        assert _events(got.recoveries) == [("engine-fallback", FAULT_AT, 0,
                                            "xla")]
    else:
        assert [e.kind for e in got.recoveries] == ["residual-restart"]
        assert int(got.result.iters) == 26


def test_false_convergence_is_never_returned():
    """A drifted pipelined recurrence (s = 1e12 at 10) satisfies the
    step-norm rule at a garbage iterate; the guard rejects the claim by
    the residual drift and returns the true solution, as JAX's does."""
    ref, got = _run_both("pipelined", fault="stagnation", chunk=CHUNK)
    _same_outcome(ref, got)
    adapter = guard._ClassicalAdapter(PROBLEM, torch.float32, device="cpu")
    state = adapter.advance(adapter.init(), 0, PROBLEM.max_iterations)
    assert guard._residual_drift(adapter, state) < 1e-3
    drifted = fi.FaultPlan(fi.inject_stagnation(0)).apply(
        0, guard._PipelinedAdapter(PROBLEM, torch.float32,
                                   device="cpu").init(),
        guard._PipelinedAdapter.FIELDS, 11, 8)
    assert torch.equal(drifted.s, torch.full_like(drifted.s, 1e12))


@pytest.mark.parametrize("case", ["persistent", "budget", "persistent-f64"])
def test_exhausted_ladder_equals_jax(case):
    """A persistent NaN walks restart → f64 escalation and ends in
    DivergedError (exit 2, iters 10); a zero budget ends at the first
    fault; in f64 there is no escalation rung. JAX's outcome each time."""
    dtype = torch.float64 if case.endswith("f64") else torch.float32
    fault = (dict(kind="nan", at_iter=FAULT_AT, field="r", persistent=True)
             if case != "budget" else "nan")
    kw = dict(max_recoveries=5) if case != "budget" else dict(
        max_recoveries=0)
    ref, got = _run_both("xla", dtype, fault=fault, chunk=CHUNK, **kw)
    assert got == ref
    assert got[:2] == ("DivergedError", 2)
    if case != "budget":
        assert got[2] == FAULT_AT


def test_escalation_to_f64_equals_jax():
    """A persistent breakdown-free stall: restart, then f64 escalation
    (the recast carry and f64 operands), then the f64 restart budget: the
    events and final dtype as JAX's."""
    fault = dict(kind="nan", at_iter=FAULT_AT, field="r", persistent=True)
    jax_plan = jax_fi.FaultPlan(jax_fi.Fault(**fault))
    with pytest.raises(jax_errors.DivergedError):
        jax_guard.guarded_solve(JAX_PROBLEM, "xla", jnp.float32, chunk=CHUNK,
                                max_recoveries=2, faults=jax_plan)
    events = []
    with pytest.raises(errors.DivergedError):
        guard._run_chunked(
            PROBLEM, guard._make_adapter(PROBLEM, "xla", torch.float32,
                                         device="cpu"),
            chunk=CHUNK, max_recoveries=2, timeout=None, t0=0.0,
            plan=fi.FaultPlan(fi.Fault(**fault)), events=events)
    assert [(e.kind, e.at_iter, e.engine) for e in events] == [
        ("residual-restart", 10, "xla"), ("precision-escalation", 10, "xla")]
    assert events[1].detail == "float32 -> float64"


def test_timeout_cancels_gracefully():
    with pytest.raises(errors.SolveTimeout) as exc:
        guard.guarded_solve(PROBLEM, "xla", torch.float32, chunk=4,
                            timeout=0.0, device="cpu")
    assert exc.value.exit_code == 4 and exc.value.iters == 0
    with pytest.raises(jax_errors.SolveTimeout) as ref:
        jax_guard.guarded_solve(JAX_PROBLEM, "xla", jnp.float32, chunk=4,
                                timeout=0.0)
    assert ref.value.iters == exc.value.iters


# ------------------------------------------ the s-step and storage cells


@pytest.mark.parametrize("fault", ["nan", "breakdown"])
def test_sstep_cells_equal_jax(fault):
    ref, got = _run_both("sstep", fault=fault, chunk=CHUNK)
    _same_outcome(ref, got)
    assert [e.kind for e in got.recoveries] == ["residual-restart"]


def test_sstep_fallback_hands_the_carry_to_pipelined_then_classical():
    """The s-step ladder rung by rung: the carry at iteration 12 hands
    over to the pipelined recurrence through a ground-truth rebuild, which
    reconverges to the clean answer; the pipelined rung falls back to the
    classical loop. JAX's handed-over carry and solve beside it."""
    ad = guard._ClassicalAdapter(PROBLEM, torch.float32, sstep_s=4,
                                 device="cpu")
    assert ad.engine == "sstep"
    mid = ad.advance(ad.init(), 0, 12)
    pipe, convert = ad.fallback()
    assert pipe.engine == "pipelined"
    state = pipe.recover(convert(mid))
    assert type(state).__name__ == "PipelinedState"
    done = pipe.advance(state, int(state.k), PROBLEM.max_iterations)
    res = pipe.result(done)
    assert bool(res.converged)
    ref_ad = jax_guard._ClassicalAdapter(JAX_PROBLEM, jnp.float32, sstep_s=4)
    ref_mid = ref_ad.advance(ref_ad.init(), 12)
    ref_pipe, ref_convert = ref_ad.fallback()
    ref_done = ref_pipe.advance(ref_pipe.recover(ref_convert(ref_mid)),
                                JAX_PROBLEM.max_iterations)
    ref_res = ref_pipe.result(ref_done)
    assert int(res.iters) == int(ref_res.iters)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref_res.w),
                               rtol=0, atol=5e-5)
    cl, _ = pipe.fallback()
    assert cl.engine == "xla"


def test_sstep_persistent_fault_exhausts_the_ladder():
    fault = dict(kind="nan", at_iter=FAULT_AT, field="r", persistent=True)
    ref, got = _run_both("sstep", fault=fault, chunk=CHUNK, max_recoveries=6)
    assert got == ref
    assert got[:2] == ("DivergedError", 2)


@pytest.mark.parametrize("engine_name,fault", [
    ("xla", "nan"), ("xla", "breakdown"), ("xla", None),
    ("pipelined", None)])
def test_bf16_storage_recovers_through_promotion(engine_name, fault):
    """bf16 storage under the guard: the fault's restart, then the storage
    promotion (the narrow solve's designed finish), a full-width converged
    result with l2 at most 1.05× the f32 run's and w within 2e-5 of JAX's;
    JAX's kinds of event and finishing engine and dtype. The iterations
    at which bf16 storage converges or stalls move with the order of the
    sums (ROADMAP Queue C: 32 here against JAX's 33 raw at 20x20), and
    with them the promotion's iteration and the final count."""
    ref, got = _run_both(engine_name, fault=fault,
                         chunk=CHUNK if fault else 64, storage_dtype="bf16",
                         max_recoveries=5)
    assert [e.kind for e in got.recoveries] == [
        e.kind for e in ref.recoveries]
    assert got.recoveries[-1].kind == "storage-promotion"
    assert got.engine == ref.engine == "xla"
    assert got.dtype == ref.dtype == "float32"
    assert got.result.w.dtype == torch.float32
    assert bool(got.result.converged) and bool(ref.result.converged)
    clean = engine.solve(PROBLEM, "xla", torch.float32, device="cpu")
    got_l2 = float(l2_error_vs_analytic(PROBLEM, got.result.w))
    assert got_l2 <= 1.05 * float(l2_error_vs_analytic(PROBLEM, clean.w))
    np.testing.assert_allclose(got.result.w.numpy(),
                               np.asarray(ref.result.w, np.float32),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("engine_name,fault", [
    ("xla", "breakdown"), ("pipelined", "nan"), ("sstep", None)])
def test_storage_promotion_equals_jax_event_for_event(engine_name, fault):
    """The promotion rung where rounding to storage cannot move the
    trajectory: f64 compute, f32 storage. The restart, the promotion's
    iteration and health word, and the final count are JAX's."""
    ref, got = _run_both(engine_name, torch.float64, fault=fault,
                         chunk=CHUNK if fault else 64, storage_dtype="f32",
                         max_recoveries=5)
    _same_outcome(ref, got)
    last = got.recoveries[-1]
    assert (last.kind, last.at_iter) == ("storage-promotion", 26)
    assert int(got.result.iters) == 27


# ---------------------------------------------------- the whole solve


@pytest.mark.parametrize("engine_name", ["resident", "xl"])
def test_whole_solve_ladder_equals_jax(engine_name):
    """The whole-solve engines, named (``auto`` resolves by capacity,
    which the CPU has none of): a clean run returns as it is; a simulated
    OOM falls back one rung (resident → streamed; xl → the chunked guarded
    xla loop), the event naming the engine fallen back to, and
    reconverges at the clean count, as in JAX."""
    ref, got = _run_both(engine_name)
    assert got.recoveries == () and got.engine == engine_name
    assert int(got.result.iters) == int(ref.result.iters) == 26
    ref, got = _run_both(engine_name, fault="oom", chunk=CHUNK)
    assert _events(got.recoveries) == _events(ref.recoveries)
    assert got.engine == ref.engine
    assert got.recoveries[0].engine == got.engine
    assert int(got.result.iters) == int(ref.result.iters) == 26
    assert bool(got.result.converged)
    np.testing.assert_allclose(got.result.w.numpy(), np.asarray(ref.result.w),
                               rtol=0, atol=5e-6)


def test_whole_solve_guard_refusals():
    with pytest.raises(ValueError, match="chunked engine"):
        guard.guarded_solve(PROBLEM, "resident", torch.float32,
                            faults=fi.FaultPlan(fi.inject_nan(5, "r")),
                            device="cpu")
    with pytest.raises(ValueError, match="chunked loop"):
        guard.guarded_solve(PROBLEM, "xl", torch.float32,
                            storage_dtype="bf16", device="cpu")
    # auto without a capacity takes xl on the CPU
    got = guard.guarded_solve(PROBLEM, "auto", torch.float32, device="cpu")
    assert got.engine == "xl" and int(got.result.iters) == 26


def test_unported_and_refused_options():
    """The guarded mesh and ABFT are ported (a one-rank mesh here; the
    2×2 runs are ``tests/test_torch_mesh_abft.py``'s): ABFT off the mesh,
    narrow storage and the fused iteration on it raise the JAX package's
    ValueError word for word; geometry and the multigrid engines name
    their items."""
    from jax.sharding import Mesh as JaxMesh

    import jax

    from poisson_ellipse_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh

    one = make_mesh(device="cpu")
    jax_one = JaxMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                      (AXIS_X, AXIS_Y))
    got = guard.guarded_solve(PROBLEM, "xla", torch.float32, mesh=one,
                              abft=True, device="cpu")
    assert got.recoveries == () and int(got.result.iters) == 26
    assert got.result.w.shape == (21, 21)
    for kw, jax_kw in ((dict(abft=True), dict(abft=True)),
                       (dict(mesh=one, storage_dtype="bf16"),
                        dict(mesh=jax_one, storage_dtype="bf16")),
                       (dict(mesh=one, engine="fused"),
                        dict(mesh=jax_one, engine="fused"))):
        engine_name = kw.pop("engine", "xla")
        jax_kw.pop("engine", None)
        with pytest.raises(ValueError) as exc:
            guard.guarded_solve(PROBLEM, engine_name, torch.float32,
                                device="cpu", **kw)
        with pytest.raises(ValueError) as ref:
            jax_guard.guarded_solve(JAX_PROBLEM, engine_name, jnp.float32,
                                    **jax_kw)
        assert str(exc.value) == str(ref.value)
    for name in ("mg-pcg", "cheb-pcg"):
        with pytest.raises(NotImplementedError, match="Queue A item 21c"):
            guard.guarded_solve(PROBLEM, name, torch.float32, mesh=one,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        guard.guarded_solve(PROBLEM, "xla", torch.float32, device="cpu",
                            geometry={"kind": "ellipse"})
    for name in ("mg-pcg", "cheb-pcg", "fmg"):
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            guard.guarded_solve(PROBLEM, name, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="lane ") as exc:
        guard.guarded_solve(PROBLEM, "batched", torch.float32, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_guard.guarded_solve(JAX_PROBLEM, "batched", jnp.float32)
    assert str(exc.value) == str(ref.value)
    with pytest.raises(ValueError, match="does not run"):
        guard.guarded_solve(PROBLEM, "pallas", torch.float64, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        guard.guarded_solve(PROBLEM, "xla", torch.float32, chunk=0,
                            device="cpu")


def test_unknown_failures_stay_loud(monkeypatch):
    """A kernel that does not build is raised as it is: no retry, no
    engine fallback, no event."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk

    def broken(*args, **kw):
        raise RuntimeError("kernel build failed:\nstencil: nvcc exit 1")

    monkeypatch.setattr(hk, "apply_a_kernel", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        guard.guarded_solve(PROBLEM, "pallas", torch.float32, chunk=CHUNK,
                            device="cpu")


@pytest.mark.parametrize("engine_name,module,name", [
    ("pallas", "hopper_kernels", "apply_a_kernel"),
    ("pipelined-pallas", "hopper_kernels", "apply_a_dots_kernel"),
    ("resident", "resident_pcg", "resident_plain"),
])
def test_a_launch_refused_for_memory_is_never_retried(monkeypatch, tmp_path,
                                                      engine_name, module,
                                                      name):
    """A kernel whose launch fails with cudaErrorMemoryAllocation (its text
    holds "out of memory") is raised from the first call: no engine
    fallback to the plain loop, no step down the capacity ladder."""
    import importlib

    mod = importlib.import_module(f"poisson_ellipse_tpu_torch.ops.{module}")
    calls = []

    def refused(*args, **kw):
        calls.append(1)
        raise RuntimeError("stencil: CUDA launch failed (2: out of memory)")

    monkeypatch.setattr(mod, name, refused)
    path = tmp_path / "trace.jsonl"
    obs_trace.start(str(path))
    try:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            guard.guarded_solve(PROBLEM, engine_name, torch.float32,
                                chunk=CHUNK, device="cpu")
    finally:
        obs_trace.stop()
    assert not [r for r in obs_trace.read_jsonl(path)
                if r["name"].startswith("recovery:")]
    assert calls == [1]


def test_run_chunked_ends_a_chunk_where_chunk_end_says():
    """``run_chunked(chunk_end=)``, the loop the lane driver and the
    checkpointing solver share: the hook sees k before each chunk, a stop
    it returns ends that chunk there, one read a chunk, and a stop that is
    not past k is refused."""
    from poisson_ellipse_tpu_torch.solver.pcg import run_chunked

    k = [0]
    seen = []

    def step(it):
        k[0] = it + 1

    def flags():
        return torch.tensor([k[0], 0, 0])

    def chunk_end(at):
        seen.append(at)
        return 10 if at < 10 else None

    syncs = run_chunked(step, flags, 40, chunk=8, chunk_end=chunk_end)
    assert seen == [0, 8, 10, 18, 26, 34] and k[0] == 40 and syncs == 7
    k[0] = 0
    with pytest.raises(ValueError, match="not past"):
        run_chunked(step, flags, 40, chunk=8, chunk_end=lambda at: at)


# ------------------------------------------------------------- lanes


@pytest.fixture(scope="module")
def lane_problem():
    return Problem(M=40, N=40), JaxProblem(M=40, N=40)


def test_nan_lane_faults_equal_jax(lane_problem):
    """JAX's ``tests/test_batched.py`` quarantine cell through ``faults=``:
    lane 1 poisoned at 10, masked out at 11; the healthy lanes converge at
    50 and are bitwise a clean batch's; the events JAX's."""
    problem, jp = lane_problem
    ref = jax_solve_batched(jp, 3, "batched", jnp.float32, chunk=16,
                            faults=jax_fi.FaultPlan(
                                jax_fi.inject_nan(10, "r", lane=1)))
    got = driver.solve_batched(problem, 3, "batched", torch.float32,
                               chunk=16, device="cpu",
                               faults=fi.FaultPlan(
                                   fi.inject_nan(10, "r", lane=1)))
    res = got.result
    assert res.quarantined.tolist() == [False, True, False]
    assert res.converged.tolist() == [True, False, True]
    assert res.iters.tolist() == np.asarray(ref.result.iters).tolist()
    assert int(res.iters[1]) == 11
    assert [(e.kind, e.at_iter, e.health, e.engine, e.detail)
            for e in got.recoveries] == [
        (e.kind, e.at_iter, e.health, e.engine, e.detail)
        for e in ref.recoveries] == [
        ("lane-quarantine", 11, guard.HEALTH_NONFINITE, "batched", "lane 1")]
    clean = driver.solve_batched(problem, 3, "batched", torch.float32,
                                 chunk=16, device="cpu")
    for lane in (0, 2):
        assert torch.equal(res.w[lane], clean.result.w[lane])
        assert int(res.iters[lane]) == 50


@pytest.mark.parametrize("engine_name,kw", [
    ("batched", dict(kind="nan", at_iter=10, field="zr", lane=0)),
    ("batched-pipelined", dict(kind="nan", at_iter=10, field="r", lane=1)),
    ("batched-pallas", dict(kind="breakdown", at_iter=7, lane=1)),
    ("batched-pipelined-pallas", dict(kind="stagnation", at_iter=9, lane=0)),
])
def test_lane_faults_on_every_batched_engine_equal_jax(lane_problem,
                                                       engine_name, kw):
    """A lane fault on each batched engine (the ``-pallas`` engines run
    the layout of their plain engine through K-e and K-f, JAX's
    ``stencil="pallas"``): the per-lane flags, counts and events equal
    JAX's, the other lane bitwise a clean batch's."""
    problem, jp = lane_problem
    base = engine_name.removesuffix("-pallas")
    ref = jax_solve_batched(jp, 2, base, jnp.float32, chunk=16,
                            faults=jax_fi.FaultPlan(jax_fi.Fault(**kw)))
    got = driver.solve_batched(problem, 2, engine_name, torch.float32,
                               chunk=16, device="cpu",
                               faults=fi.FaultPlan(fi.Fault(**kw)))
    for field in ("quarantined", "converged", "breakdown", "iters"):
        assert getattr(got.result, field).tolist() == np.asarray(
            getattr(ref.result, field)).tolist(), field
    assert [(e.kind, e.at_iter, e.detail) for e in got.recoveries] == [
        (e.kind, e.at_iter, e.detail) for e in ref.recoveries]
    other = 1 - kw["lane"]
    clean = driver.solve_batched(problem, 2, engine_name, torch.float32,
                                 chunk=16, device="cpu")
    assert torch.equal(got.result.w[other], clean.result.w[other])


def test_lane_driver_refusals_equal_jax(lane_problem):
    problem, jp = lane_problem
    for plan, ref_plan, text in (
            (fi.FaultPlan(fi.inject_nan(10, "r")),
             jax_fi.FaultPlan(jax_fi.inject_nan(10, "r")), "lane-addressed"),
            (fi.FaultPlan(fi.inject_nan(10, "r", lane=5)),
             jax_fi.FaultPlan(jax_fi.inject_nan(10, "r", lane=5)),
             "outside")):
        with pytest.raises(ValueError, match=text) as exc:
            driver.solve_batched(problem, 2, "batched", torch.float32,
                                 faults=plan, device="cpu")
        with pytest.raises(ValueError) as ref:
            jax_solve_batched(jp, 2, "batched", jnp.float32, faults=ref_plan)
        assert str(exc.value) == str(ref.value)
    with pytest.raises(errors.SolveTimeout):
        driver.solve_batched(problem, 2, "batched", torch.float32,
                             timeout=0.0, device="cpu")


def test_quarantine_event_reaches_the_trace(lane_problem, tmp_path):
    problem, _ = lane_problem
    path = tmp_path / "quarantine.jsonl"
    obs_trace.start(str(path))
    try:
        driver.solve_batched(problem, 2, "batched", torch.float32, chunk=16,
                             device="cpu",
                             faults=fi.FaultPlan(fi.inject_nan(8, "r",
                                                               lane=0)))
    finally:
        obs_trace.stop()
    assert jax_trace.validate_file(str(path)) == []
    recs = [r for r in jax_trace.read_jsonl(str(path))
            if r["name"] == "recovery:lane-quarantine"]
    assert len(recs) == 1 and recs[0]["lane"] == 0


def test_guarded_lanes_through_run_once(lane_problem):
    problem, jp = lane_problem
    report = run_once(problem, engine="batched", lanes=2, guard=True,
                      device="cpu")
    ref = jax_run_once(jp, mode="single", engine="batched", lanes=2,
                       guard=True)
    assert report.converged and report.recoveries == [] == ref.recoveries
    assert report.lanes == 2 and report.iters == ref.iters == 50


# --------------------------------------------------------- the CLI


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_guard_flag_and_recoveries_field(capsys):
    rc, out, _ = _cli(cli_main, ["20", "20", "--engine", "xla", "--guard",
                                 "--json", "--device", "cpu"], capsys)
    rec = json.loads(out.strip())
    assert rc == 0 and rec["converged"] is True and rec["iters"] == 26
    assert "recoveries" not in rec  # a healthy run: the key is absent
    report = run_once(PROBLEM, engine="pallas", guard=True, device="cpu")
    assert report.recoveries == [] and report.iters == 26
    assert report.host_syncs == 2  # one 128-iteration chunk, the drift
    with_rec = dataclasses.replace(report, recoveries=["residual-restart"])
    assert with_rec.json_dict()["recoveries"] == ["residual-restart"]
    assert "Recoveries: 1 (residual-restart)" in with_rec.summary()


def test_cli_timeout_exit_code_and_partial_artifact(tmp_path, capsys):
    trace_file = str(tmp_path / "t.jsonl")
    rc, out, err = _cli(cli_main, ["40", "40", "--timeout", "0", "--json",
                                   "--trace", trace_file, "--device", "cpu"],
                        capsys)
    assert rc == 4 and "timeout" in err
    rec = json.loads(out.strip())
    assert rec["aborted"] == "timeout" and rec["iters"] == 0
    assert jax_trace.validate_file(trace_file) == []
    names = {r["name"] for r in jax_trace.read_jsonl(trace_file)}
    assert {"recovery:timeout", "run_report_partial", "cli-exit"} <= names


def test_cli_inject_record_equals_jax(tmp_path, capsys):
    trace_file = str(tmp_path / "inject.jsonl")
    argv = ["inject", "nan", "20", "--engine", "pallas", "--at", "10",
            "--json"]
    rc, out, _ = _cli(cli_main, argv + ["--device", "cpu", "--trace",
                                        trace_file], capsys)
    ref_rc, ref_out, _ = _cli(jax_main, argv, capsys)
    assert rc == ref_rc == 0
    assert json.loads(out.strip()) == json.loads(ref_out.strip()) == {
        "fault": "nan", "at": 10, "engine_requested": "pallas",
        "engine_final": "pallas", "dtype_final": "float32", "iters": 26,
        "converged": True, "recoveries": ["residual-restart"]}
    assert jax_trace.validate_file(trace_file) == []
    names = {r["name"] for r in jax_trace.read_jsonl(trace_file)}
    assert {"recovery:residual-restart", "inject_report"} <= names


def test_cli_inject_classified_and_invalid_exits(tmp_path, capsys):
    argv = ["inject", "nan", "20", "20", "--at", "10", "--chunk", "8",
            "--persistent", "--json"]
    rc, out, _ = _cli(cli_main, argv + ["--device", "cpu"], capsys)
    ref_rc, ref_out, _ = _cli(jax_main, argv, capsys)
    assert rc == ref_rc == 2
    assert json.loads(out.strip()) == json.loads(ref_out.strip())
    trace_file = str(tmp_path / "bad.jsonl")
    rc, _, err = _cli(cli_main, ["inject", "nan", "20", "20", "--at", "-1",
                                 "--trace", trace_file, "--device", "cpu"],
                      capsys)
    assert rc == 2 and "at_iter" in err
    assert obs_trace.active() is None
    rc, _, err = _cli(cli_main, ["inject", "oom", "20", "--engine", "xla",
                                 "--json", "--device", "cpu"], capsys)
    assert rc == 3


@pytest.mark.parametrize("flags,text", [
    (["--timeout", "5", "--checkpoint-dir", "CK"],
     "guarded/timeout runs and checkpointed runs are separate"),
    (["--guard", "--repeat", "2"], "one wall-clocked chunked solve"),
    (["--checkpoint-dir", "CK", "--storage-dtype", "bf16"],
     "checkpoint fingerprints do not cover a storage dtype"),
    (["--checkpoint-dir", "CK", "--lanes", "2"],
     "checkpointing persists the single-solve PCG carry"),
    (["--checkpoint-dir", "CK", "--engine", "fused"],
     "--engine must be xla or pallas"),
    (["--guard", "--lanes", "2", "--engine", "xla"],
     "runs one solve per dispatch"),
])
def test_cli_refusals_equal_jax(flags, text, tmp_path, capsys):
    """Options that cannot go together: exit 2 with the JAX harness's
    refusal, word for word."""
    flags = [str(tmp_path / "ck") if f == "CK" else f for f in flags]
    rc, _, err = _cli(cli_main, ["20", "20", *flags, "--device", "cpu"],
                      capsys)
    ref_rc, _, ref_err = _cli(jax_main, ["20", "20", "--mode", "single",
                                         *flags], capsys)
    assert rc == ref_rc == 2
    assert text in err and err.strip() == ref_err.strip()


def test_cli_guard_on_the_mesh_names_its_item(capsys):
    """``--mode sharded --guard`` runs the guarded mesh (item 21b is
    ported): JAX's count and fields on a 1×2 mesh of rank processes."""
    argv = ["20", "20", "--mode", "sharded", "--mesh", "1", "2", "--guard",
            "--json"]
    rc, out, _ = _cli(cli_main, [*argv, "--device", "cpu"], capsys)
    ref_rc, ref_out, _ = _cli(jax_main, argv, capsys)
    got, ref = json.loads(out.strip()), json.loads(ref_out.strip())
    assert rc == ref_rc == 0
    assert got["iters"] == ref["iters"] == 26
    assert got["mesh"] == ref["mesh"] == [1, 2]
    assert got["engine"] == ref["engine"] == "xla"
    assert got["converged"] is ref["converged"] is True