"""The port's observability layer (``poisson_ellipse_tpu_torch.obs``)
against the JAX package's, on the CPU.

The JAX engines run as its own tests run them (Pallas in interpret mode,
the mesh on the virtual CPU devices of ``tests/conftest.py``); the port's
mesh ranks are processes of one gloo spawn of 2×2 for the whole file.

Tolerances, from measured gaps at 40² (δ = 1e-6, the ring's series
relative to JAX's, entry by entry):

- ``xla`` f64: equal ``iters``, every series within 1e-12 (measured
  2.7e-14); ``pipelined`` f64 within 1e-10 (measured 2e-11: the bundle's
  sums are added in another order);
- f32, equal ``iters`` (50) and the series within ``F32_RTOL``: ``xla``
  and ``pallas`` 5e-4 (measured 7.3e-5, the step norm's), ``fused`` 5e-4
  (1.8e-4); ``pipelined`` and ``pipelined-pallas`` 5e-2 (1.3e-2: the f32
  recurrence drifts from JAX's along the solve, as the f32 pipelined
  solves of the two packages do);
- the mesh's ring (2×2, f64, 20²) the same bits on every rank, and within
  1e-12 of JAX's sharded ring (``xla`` and ``pallas``);
- spectrum: the port's ``spectrum_report`` of a trace equals JAX's of the
  same trace exactly (the module is a copy), and κ and the predicted
  iterations of the two packages' own rings agree within 1e-9 and exactly;
- the ring contract: iterates bitwise with the ring on and off, the same
  host reads, zeros past ``iters``, α = 0 on a breakdown, and the ring
  independent of the chunk (no-op bodies write zeros past ``iters``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import export as jax_export
from poisson_ellipse_tpu.obs import spectrum as jax_spectrum
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.parallel import mesh as jmesh
from poisson_ellipse_tpu.parallel.pcg_sharded import (
    solve_sharded as jax_solve_sharded,
)
from poisson_ellipse_tpu.solver.engine import (
    ENGINE_CAPS as JAX_CAPS,
)
from poisson_ellipse_tpu.solver.engine import (
    HISTORY_ENGINES as JAX_HISTORY_ENGINES,
)
from poisson_ellipse_tpu.solver.engine import solve as jax_engine_solve
from poisson_ellipse_tpu_torch.batch import driver
from poisson_ellipse_tpu_torch.batch.batched_pcg import batched_operands
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import convergence, export, metrics
from poisson_ellipse_tpu_torch.obs import profile as obs_profile
from poisson_ellipse_tpu_torch.obs import spectrum, static_cost
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.parallel import multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps
from poisson_ellipse_tpu_torch.solver import engine, pcg
from poisson_ellipse_tpu_torch.utils.timing import PhaseTimer

HISTORY = ("xla", "pallas", "fused", "pipelined", "pipelined-pallas")
F64_RTOL = {"xla": 1e-12, "pipelined": 1e-10}
F32_RTOL = {"xla": 5e-4, "pallas": 5e-4, "fused": 5e-4, "pipelined": 5e-2,
            "pipelined-pallas": 5e-2}
MESH_RTOL = 1e-12
G40 = (40, 40)
MESH_GRID = (20, 20)


@pytest.fixture(autouse=True)
def _clean_trace_state():
    """No ambient tracer and an empty default registry around each test
    (both are process-global), in both packages."""
    for mod in (obs_trace, jax_trace):
        mod.stop()
        mod._env_checked = True
    metrics.REGISTRY.reset()
    yield
    obs_trace.stop()
    metrics.REGISTRY.reset()


def _series_close(got: dict, want: dict, rtol: float) -> None:
    for name in convergence.HISTORY_FIELDS:
        g = np.asarray(got[name], np.float64)
        w = np.asarray(want[name], np.float64)
        assert g.shape == w.shape, name
        err = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        # β₀ = 0 in the pipelined series: exactly 0 in both
        err[(g == 0) & (w == 0)] = 0.0
        assert float(err.max()) <= rtol, (name, float(err.max()))


def _port_history(name, dtype, grid=G40, **kw):
    solver, args, resolved = engine.build_solver(
        Problem(M=grid[0], N=grid[1], **kw), name, dtype, "cpu",
        history=True)
    (result, trace), syncs = solver(*args), solver.host_syncs
    return resolved, result, trace, syncs


# -- the ring against JAX -------------------------------------------------


@pytest.mark.parametrize("name", ["xla", "pipelined"])
def test_f64_ring_is_the_jax_ring(name):
    _, result, trace, _ = _port_history(name, torch.float64)
    ref, ref_trace = jax_engine_solve(JaxProblem(M=40, N=40), name,
                                      jnp.float64, history=True)
    assert int(result.iters) == int(ref.iters) == 50
    _series_close(trace.valid(), ref_trace.valid(), F64_RTOL[name])
    tail = trace.zr[int(result.iters):]
    assert tail.numel() and not bool(tail.any())


@pytest.mark.parametrize("name", HISTORY)
def test_f32_ring_against_the_jax_ring(name):
    _, result, trace, _ = _port_history(name, torch.float32)
    ref, ref_trace = jax_engine_solve(JaxProblem(M=40, N=40), name,
                                      jnp.float32, history=True)
    assert int(result.iters) == int(ref.iters) == 50
    _series_close(trace.valid(), ref_trace.valid(), F32_RTOL[name])


def test_pcg_history_return_matches_the_jax_contract():
    """``pcg(..., history=True)`` returns (PCGResult, ConvergenceTrace),
    the trace's last diff the solver's own, the buffers full length."""
    p = Problem(M=20, N=20)
    a, b, rhs = assembly.assemble(p, torch.float64, "cpu")
    result, trace = pcg.pcg(p, a, b, rhs, history=True)
    assert isinstance(trace, convergence.ConvergenceTrace)
    assert trace.zr.shape == (p.max_iterations,)
    v = trace.valid()
    assert v["diff"][-1] == float(result.diff) < p.delta
    assert (v["zr"] > 0).all() and v["alpha"].shape == (int(result.iters),)


# -- the ring contract -----------------------------------------------------


@pytest.mark.parametrize("name", HISTORY)
def test_ring_on_and_off_give_the_same_bits_and_host_reads(name):
    p = Problem(M=20, N=20)
    solver, args, _ = engine.build_solver(p, name, torch.float32, "cpu")
    plain = solver(*args)
    plain_syncs = solver.host_syncs
    _, result, trace, syncs = _port_history(name, torch.float32,
                                            grid=(20, 20))
    assert torch.equal(plain.w, result.w)
    assert int(plain.iters) == int(result.iters)
    assert torch.equal(plain.diff, result.diff)
    assert syncs == plain_syncs
    n = int(result.iters)
    for field in convergence.HISTORY_FIELDS:
        buf = getattr(trace, field)
        assert not bool(buf[n:].any()), field
    assert float(trace.diff[n - 1]) == float(result.diff)


@pytest.mark.parametrize("name", ["xla", "pipelined"])
def test_ring_does_not_depend_on_the_chunk(name):
    """Bodies issued after the exit (up to a chunk of them) are no-ops on
    the carry and write zeros past ``iters``: the ring of a chunk-3 run is
    the chunk-64 run's, bit for bit."""
    p = Problem(M=20, N=20)
    a, b, rhs = assembly.assemble(p, torch.float64, "cpu")
    mod = pcg if name == "xla" else pp
    rings = []
    for chunk in (3, 64):
        ring = pcg.new_ring(p, rhs)
        init = (pcg.init_state(p, a, b, rhs) if name == "xla"
                else pp.init_state(p, a, b, rhs))
        state, _ = mod.advance(p, a, b, rhs, init, chunk=chunk, history=ring)
        rings.append(ring)
    assert torch.equal(rings[0], rings[1])
    n = int(state.k)
    assert not bool(rings[0][:, n:].any())


def test_breakdown_records_zero_alpha():
    """a = b = 0: the first denominator trips the guard, and every
    engine's ring records α = 0 for that iteration (JAX's test)."""
    p = Problem(M=10, N=10)
    _, _, rhs = assembly.assemble(p, torch.float64, "cpu")
    zeros = torch.zeros_like(rhs)
    for fn in (pcg.pcg, pp.pcg_pipelined):
        result, trace = fn(p, zeros, zeros, rhs, history=True)
        assert bool(result.breakdown) and int(result.iters) == 1, fn
        assert float(trace.alpha[0]) == 0.0, fn
    r32, z32 = rhs.float(), zeros.float()
    result, trace = fp.pcg_fused(p, z32, z32, r32, history=True)
    assert bool(result.breakdown) and float(trace.alpha[0]) == 0.0


def test_history_engines_and_refusals_follow_the_jax_table():
    assert engine.HISTORY_ENGINES == ("auto",) + HISTORY
    assert set(engine.HISTORY_ENGINES) <= set(JAX_HISTORY_ENGINES)
    for name in HISTORY:
        assert engine.ENGINE_CAPS[name]["history"] == JAX_CAPS[name][
            "history"]
    p = Problem(M=10, N=10)
    _, _, resolved = engine.build_solver(p, "auto", torch.float32, "cpu",
                                         history=True)
    assert resolved == "xla"
    for name, text in (("resident", "cannot record history"),
                       ("xl", "cannot record history"),
                       ("sstep", "coordinate blocks"),
                       ("batched", "per-lane scalar recurrences")):
        with pytest.raises(ValueError, match=text):
            engine.build_solver(p, name, torch.float32, "cpu",
                                history=True, lanes=2 if name == "batched"
                                else 1)


def test_advance_takes_only_a_ring():
    p = Problem(M=10, N=10)
    a, b, rhs = assembly.assemble(p, torch.float32, "cpu")
    with pytest.raises(ValueError, match="new_ring"):
        pcg.advance(p, a, b, rhs, pcg.init_state(p, a, b, rhs), history=True)
    with pytest.raises(ValueError, match="new_ring"):
        pcg.advance(p, a, b, rhs, pcg.init_state(p, a, b, rhs),
                    history=torch.zeros(4, p.max_iterations + 1))


# -- the mesh -------------------------------------------------------------


def _mesh_problem():
    return Problem(M=MESH_GRID[0], N=MESH_GRID[1])


@pytest.fixture(scope="module")
def ranks():
    """Every 2x2 result of this file, from one spawn of 4 ranks."""
    jobs = {
        **{f"{impl}_{h}": (ps.solve_report, (_mesh_problem(), torch.float64),
                           dict(stencil_impl=impl, history=h, device="cpu"))
           for impl in ("xla", "pallas") for h in (False, True)},
        **{f"cost_{e}": (static_cost.sharded_counts,
                         (_mesh_problem(), e, torch.float32),
                         dict(lanes=4 if e == "batched" else 1,
                              device="cpu", mesh_shape=(2, 2)))
           for e in ("xla", "pallas", "pipelined", "sstep", "batched")},
    }
    names, calls = zip(*jobs.items())
    return dict(zip(names, multihost.spawn(
        multihost.run_jobs, 4, (list(calls),), device="cpu", timeout=600)))


def _jax_mesh(n):
    px, py = jmesh.choose_process_grid(n)
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(px, py),
                   (jmesh.AXIS_X, jmesh.AXIS_Y))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mesh_ring_is_the_jax_sharded_ring(ranks, impl):
    plain, hist = ranks[f"{impl}_False"], ranks[f"{impl}_True"]
    assert hist["history_same_on_every_rank"]
    np.testing.assert_array_equal(plain["w"], hist["w"])
    assert plain["iters"] == hist["iters"] == 26
    assert plain["host_syncs"] == hist["host_syncs"]
    assert plain["ranks"][0]["collectives"] == hist["ranks"][0][
        "collectives"]
    ref, ref_trace = jax_solve_sharded(
        JaxProblem(M=MESH_GRID[0], N=MESH_GRID[1]), _jax_mesh(4),
        jnp.float64, stencil_impl=impl, history=True)
    assert int(ref.iters) == hist["iters"]
    n = hist["iters"]
    _series_close({k: v[:n] for k, v in hist["history"].items()},
                  ref_trace.valid(), MESH_RTOL)
    assert not any(v[n:].any() for v in hist["history"].values())


def test_mesh_history_refuses_fused_and_pipelined():
    one = ps.make_mesh(device="cpu")
    for impl in ("fused", "pipelined"):
        with pytest.raises(ValueError, match="classical sharded loops"):
            ps.build_sharded_solver(_mesh_problem(), one, torch.float32,
                                    stencil_impl=impl, history=True)


@pytest.mark.parametrize("name", ["xla", "pallas", "pipelined", "sstep",
                                  "batched"])
def test_static_cost_mesh_counts_are_the_jax_cadence(ranks, name):
    """The collectives a body, counted over two capped runs on every rank,
    against the JAX table's declared cadence (``ENGINE_CAPS`` contracts):
    a halo exchange is 4 ppermutes there, one exchange here."""
    (l1, c1, b1), (l2, c2, b2) = ranks[f"cost_{name}"]
    per_body, _once = static_cost._difference(c1, c2, b2 - b1)
    contracts = JAX_CAPS[name]["contracts"]
    if name == "batched":
        assert per_body.get("reduce", 0) == contracts["batched_psum"]
        assert per_body.get("halo", 0) == contracts["batched_halo"]
    else:
        assert per_body.get("reduce", 0) == contracts["sharded_psum"]
        # the pipelined halo is unpinned in JAX's table (its replacement
        # branch); the plain body makes one
        assert per_body.get("halo", 0) == (contracts.get("sharded_halo")
                                           or 1)
    assert l1 == l2 == {}  # the plain versions launch nothing on the CPU


# -- spectrum -------------------------------------------------------------


def test_spectrum_is_the_jax_spectrum():
    _, result, trace, _ = _port_history("xla", torch.float64)
    ref, ref_trace = jax_engine_solve(JaxProblem(M=40, N=40), "xla",
                                      jnp.float64, history=True)
    delta = 1e-6
    ours = spectrum.spectrum_report(trace, delta=delta,
                                    actual_iters=int(result.iters))
    theirs_on_ours = jax_spectrum.spectrum_report(
        trace.valid(), delta=delta, actual_iters=int(result.iters))
    assert ours == theirs_on_ours
    theirs = jax_spectrum.spectrum_report(ref_trace, delta=delta,
                                          actual_iters=int(ref.iters))
    assert ours["available"] and theirs["available"]
    assert ours["kappa"] == pytest.approx(theirs["kappa"], rel=1e-9)
    assert ours["predicted_iters"] == theirs["predicted_iters"] == 50
    assert spectrum.eigenvalue_bounds(trace) == pytest.approx(
        jax_spectrum.eigenvalue_bounds(ref_trace), rel=1e-9)


# -- trace, metrics, export -----------------------------------------------


def test_port_trace_validates_under_the_jax_validator(tmp_path):
    path = tmp_path / "t.jsonl"
    obs_trace.start(path)
    timer = PhaseTimer()
    with timer.phase("solver"):
        pass
    obs_trace.event("run_report", iters=1)
    a, b, rhs = batched_operands(Problem(M=10, N=10), 3, torch.float64,
                                 "cpu")
    rhs = rhs.clone()
    rhs[1, 5, 5] = float("nan")
    out = driver.solve_batched(Problem(M=10, N=10), 3, operands=(a, b, rhs))
    metrics.counter("runs").inc()
    metrics.REGISTRY.emit()
    obs_trace.stop()
    assert [e.kind for e in out.recoveries] == ["lane-quarantine"]
    assert jax_trace.validate_file(path) == []
    assert obs_trace.validate_file(path) == []
    recs = obs_trace.read_jsonl(path)
    assert {r["v"] for r in recs} == {obs_trace.SCHEMA_VERSION} == {3}
    quarantine = [r for r in recs if r["name"] == "recovery:lane-quarantine"]
    assert len(quarantine) == 1 and quarantine[0]["lane"] == 1
    assert quarantine[0]["fields"]["health"] == "nonfinite"
    spans = [r for r in recs if r["name"] == "phase:solver"]
    assert len(spans) == 1 and spans[0]["kind"] == "span"


def test_port_openmetrics_parses_under_the_jax_validator():
    reg = metrics.MetricsRegistry()
    reg.counter("runs").inc(2)
    reg.gauge("last_iters").set(50)
    for v in (0.1, 0.2, 0.3):
        reg.histogram("solve_seconds").observe(v)
    text = export.render_openmetrics(reg.snapshot())
    assert jax_export.validate_openmetrics(text) == []
    assert export.validate_openmetrics(text) == []


def test_poisson_trace_environment_starts_the_tracer(tmp_path, monkeypatch):
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv(obs_trace.ENV_VAR, str(path))
    obs_trace._env_checked = False
    obs_trace.event("hello")
    obs_trace.stop()
    assert [r["name"] for r in obs_trace.read_jsonl(path)] == [
        "trace-start", "hello"]


# -- profile and static cost ----------------------------------------------


def test_profile_record_has_the_jax_columns():
    rec = obs_profile.profile_engine(Problem(M=20, N=20), "xla",
                                     torch.float32, repeat=2, device="cpu")
    for phase in obs_profile.PROFILE_PHASES:
        assert rec[f"t_{phase}_s"] >= 0.0
    assert rec["iters"] == 26 and rec["converged"]
    for key in ("est_hbm_bytes_per_iter", "hbm_gbps_xla", "flops_per_s",
                "pct_of_model", "hbm_gbps", "hbm_peak_frac"):
        assert rec[key] is None, key  # no compiler analysis, no card rate
    assert rec["modeled_passes_per_iter"] == 13.0
    with pytest.raises(ValueError, match="lane-batched"):
        obs_profile.profile_engine(Problem(M=20, N=20), "batched",
                                   device="cpu")


def test_static_cost_single_device_report():
    rep = static_cost.engine_report(Problem(M=20, N=20), "sstep",
                                    torch.float32, device="cpu", sstep_s=2)
    assert rep["iters_per_body"] == 2 and rep["bodies"] == [1, 2]
    assert rep["launches_per_body"] == {} and rep["collectives_per_body"] == {}
    assert rep["flops_per_iter_est"] is None
    assert rep["modeled_passes_per_iter"] == pytest.approx(74.71875)


# -- the command line -----------------------------------------------------


def test_cli_trace_and_metrics(tmp_path, capsys):
    tpath, mpath = tmp_path / "run.jsonl", tmp_path / "run.prom"
    rc = cli_main(["--grids", "10x10,20x20", "--device", "cpu", "--trace",
                   str(tpath), "--metrics", str(mpath), "--json"])
    assert rc == 0
    assert jax_trace.validate_file(tpath) == []
    names = [r["name"] for r in obs_trace.read_jsonl(tpath)]
    assert names[1] == "cli-args" and names[-1] == "cli-exit"
    assert names.count("run_report") == 2 and "phase:solver" in names
    text = mpath.read_text()
    assert jax_export.validate_openmetrics(text) == []
    parsed = export.parse_openmetrics(text)
    assert parsed["counters"] == {"poisson_runs": 2.0,
                                  "poisson_runs_converged": 2.0}
    assert parsed["gauges"] == {"poisson_last_iters": 26.0}
    assert parsed["histograms"]["poisson_solve_seconds"]["count"] == 2.0
    capsys.readouterr()


def test_cli_unwritable_paths_exit_2_before_a_solve(tmp_path, capsys):
    bad = str(tmp_path / "missing" / "x")
    assert cli_main(["10", "10", "--device", "cpu", "--metrics", bad]) == 2
    assert "cannot write --metrics" in capsys.readouterr().err
    assert cli_main(["10", "10", "--device", "cpu", "--trace", bad]) == 2
    assert "cannot write --trace" in capsys.readouterr().err
    assert cli_main(["diagnose", "--device", "cpu", "--metrics", bad]) == 2


@pytest.mark.parametrize("name", ["fused", "pipelined-pallas"])
def test_cli_diagnose(tmp_path, capsys, name):
    tpath, mpath = tmp_path / "d.jsonl", tmp_path / "d.prom"
    rc = cli_main(["diagnose", name, "--grid", "20x20", "--device", "cpu",
                   "--repeat", "1", "--json", "--trace", str(tpath),
                   "--metrics", str(mpath)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["engine"] == name and rec["bit_identical"]
    assert rec["host_syncs"]["history"] == rec["host_syncs"]["plain"]
    assert rec["spectrum"]["available"] and rec["iters"] == 26
    assert rec["profile"]["t_solve_s"] > 0
    assert jax_trace.validate_file(tpath) == []
    assert jax_export.validate_openmetrics(mpath.read_text()) == []
    assert cli_main(["diagnose", "sstep", "--device", "cpu"]) == 2


def test_cli_inspect(capsys):
    assert cli_main(["inspect", "fused", "--grid", "20x20", "--device",
                     "cpu", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["engine"] == "fused" and rec["modeled_passes_per_iter"] == 17
    assert cli_main(["inspect", "pipelined", "--mode", "sharded", "--mesh",
                     "1", "2", "--grid", "20x20", "--device", "cpu",
                     "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["mesh"] == [1, 2]
    assert rec["collectives_per_body"] == {"halo": 1.0, "reduce": 1.0}
    assert rec["collectives_once"] == {"halo": 3.0}
    assert cli_main(["inspect", "resident", "--mode", "sharded",
                     "--device", "cpu"]) == 2
