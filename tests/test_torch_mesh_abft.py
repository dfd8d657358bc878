"""The port's silent-corruption checks on the mesh (``resilience.abft``
in ``parallel.pcg_sharded``, ``pipelined_sharded`` and ``sstep_sharded``)
and the guard's mesh adapters, against the JAX package's, on the CPU.

The port's 2×2 mesh is four gloo rank processes, every case of this file
from one spawn (``resilience.mesh_drills``); the JAX package runs its
mesh on four of the 8 virtual CPU devices of ``tests/conftest.py``. The
JAX package's own sizes (``tests/test_elastic.py``): 40×40 f64 (oracle
50), faults at ``ENGINE_FAULT_AT`` (13; 12 for the s-step engine, a block
boundary), the guard's chunk there too. Tolerances:

- abft on against off: w bitwise, the count JAX's, no alarm; the chunked
  stepper bitwise the straight sharded solve (chunks of 13, 12 for the
  s-step engine, whose blocks a chunk inside them would move);
- a body's halo exchanges and reductions equal with abft on and off (the
  counterpart of JAX's jaxpr-pinned ``test_abft_adds_zero_collectives_*``):
  the difference of two dispatches, 8 and 24 iterations from 0;
- the SDC matrix: JAX's recovery events kind for kind and iteration for
  iteration, counts within ±2 of the clean guarded run, l2 at most 1.01×
  its; persistent corruption ``SilentCorruptionError`` (exit 6).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.parallel.mesh import AXIS_X, AXIS_Y
from poisson_ellipse_tpu.parallel.pcg_sharded import (
    solve_sharded as jax_solve_sharded,
)
from poisson_ellipse_tpu.resilience import errors as jax_errors
from poisson_ellipse_tpu.resilience import faultinject as jax_fi
from poisson_ellipse_tpu.resilience import guard as jax_guard
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.parallel import multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps
from poisson_ellipse_tpu_torch.parallel import sstep_sharded as sss
from poisson_ellipse_tpu_torch.resilience import abft
from poisson_ellipse_tpu_torch.resilience import faultinject as fi
from poisson_ellipse_tpu_torch.resilience import mesh_drills as md

PROBLEM = Problem(M=40, N=40)
JAX_PROBLEM = JaxProblem(M=40, N=40)
ORACLE = 50
ENGINES = ("xla", "pipelined", "sstep")
FAULT_AT = {"xla": 13, "pipelined": 13, "sstep": 12}
FAULTS = ("halo_bitflip", "psum_corrupt", "nan")
SDC_EVENTS = {"sdc-rollback", "residual-restart"}
SPANS = (8, 24)


def _plans(module, at: int) -> dict:
    return {
        "clean": None,
        "halo_bitflip": module.FaultPlan(module.halo_bitflip(at, field="p")),
        "psum_corrupt": module.FaultPlan(module.psum_corrupt(at)),
        "nan": module.FaultPlan(module.inject_nan(at, "r")),
        "persistent": module.FaultPlan(module.halo_bitflip(
            at, field="p", persistent=True)),
    }


@pytest.fixture(scope="module")
def ranks():
    """Every 2×2 result this file compares, from one spawn of 4 ranks."""
    f64 = torch.float64
    jobs = []
    for engine in ENGINES:
        at = FAULT_AT[engine]
        jobs.append((md.guard_matrix, (PROBLEM, engine, f64, at,
                                       _plans(fi, at)),
                     dict(abft=True, device="cpu")))
        jobs.append((md.stepper_runs, (PROBLEM, f64, engine, at),
                     dict(spans=SPANS, device="cpu")))
    jobs += [
        (ps.solve_report, (PROBLEM, f64), dict(device="cpu")),
        (ps.solve_report, (PROBLEM, f64),
         dict(stencil_impl="pipelined", device="cpu")),
        (sss.solve_report, (PROBLEM, f64), dict(device="cpu")),
    ]
    out = multihost.spawn(multihost.run_jobs, 4, (jobs,), device="cpu",
                          timeout=600)
    got = {}
    for i, engine in enumerate(ENGINES):
        got[engine] = {"matrix": out[2 * i], "stepper": out[2 * i + 1],
                       "straight": out[6 + i]}
    return got


@pytest.fixture(scope="module")
def jax_matrix():
    """The JAX guard's SDC matrix on its 2×2 virtual mesh, one adapter an
    engine (as its own tests build them): {engine: {cell: outcome}}."""
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                   (AXIS_X, AXIS_Y))
    out = {}
    for engine in ENGINES:
        at = FAULT_AT[engine]
        adapter = jax_guard._make_adapter(JAX_PROBLEM, engine, jnp.float64,
                                          mesh, None, abft=True)
        cells = {}
        for name, plan in _plans(jax_fi, at).items():
            try:
                g = jax_guard._run_chunked(
                    JAX_PROBLEM, adapter, chunk=at, max_recoveries=3,
                    timeout=None, t0=time.monotonic(),
                    plan=plan if plan is not None else jax_fi.FaultPlan(),
                    events=[])
                from poisson_ellipse_tpu.utils.error import (
                    l2_error_vs_analytic,
                )

                cells[name] = {
                    "events": [(e.kind, e.at_iter) for e in g.recoveries],
                    "iters": int(g.result.iters),
                    "l2": float(l2_error_vs_analytic(JAX_PROBLEM,
                                                     g.result.w))}
            except jax_errors.SolveError as e:
                cells[name] = {"error": (type(e).__name__, e.exit_code,
                                         e.classification)}
        out[engine] = cells
    out["straight"] = int(jax_solve_sharded(JAX_PROBLEM, mesh,
                                            jnp.float64).iters)
    return out


def _per_body(run: dict, kind: str, engine: str) -> float:
    """A dispatch's collectives of ``kind`` a body: the difference of the
    two spans over the bodies between them."""
    lo, hi = (span["collectives"].get(kind, 0) for span in run["spans"])
    bodies = (SPANS[1] - SPANS[0]) // (4 if engine == "sstep" else 1)
    return (hi - lo) / bodies


# -- abft keeps the plain loop --------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_abft_keeps_the_plain_solve(ranks, jax_matrix, engine):
    """abft on: w bitwise the port's abft-off solve, JAX's count, no
    alarm on the healthy path."""
    plain, on = ranks[engine]["stepper"]["plain"], ranks[engine][
        "stepper"]["abft"]
    assert on["sdc"] is False and on["converged"] and not on["breakdown"]
    np.testing.assert_array_equal(on["w"], plain["w"])
    assert on["iters"] == plain["iters"] == jax_matrix["straight"] == ORACLE


@pytest.mark.parametrize("engine", ENGINES)
def test_abft_adds_no_collective_a_body(ranks, engine):
    """A body makes the same halo exchanges and reductions with the
    checks as without (the ten partials ride an existing reduction); the
    checksum field is one stencil call a dispatch, outside the loop."""
    plain, on = ranks[engine]["stepper"]["plain"], ranks[engine][
        "stepper"]["abft"]
    want = {"xla": (1, 2), "pipelined": (1, 1), "sstep": (1, 1)}[engine]
    for run in (plain, on):
        assert (_per_body(run, "halo", engine),
                _per_body(run, "reduce", engine)) == want
    extra_halo = 1 if engine == "xla" else 0  # c = A·1 each dispatch
    for span_plain, span_on in zip(plain["spans"], on["spans"]):
        assert span_on["collectives"]["halo"] == (
            span_plain["collectives"]["halo"] + extra_halo)
        assert span_on["collectives"]["reduce"] == span_plain[
            "collectives"]["reduce"]
        assert span_on["launches"] == span_plain["launches"] == {}


@pytest.mark.parametrize("engine", ENGINES)
def test_stepper_chunked_is_the_straight_solve(ranks, engine):
    got = ranks[engine]
    plain, straight = got["stepper"]["plain"], got["straight"]
    assert plain["iters"] == straight["iters"] == ORACLE
    np.testing.assert_array_equal(plain["w"], straight["w"])


# -- the SDC matrix -------------------------------------------------------


@pytest.mark.parametrize("fault", ("clean",) + FAULTS)
@pytest.mark.parametrize("engine", ENGINES)
def test_sdc_matrix_takes_jax_events(ranks, jax_matrix, engine, fault):
    """Each fault at JAX's iteration: JAX's recovery events kind for kind
    and iteration for iteration (pure corruption rolls back, NaN walks
    the restart), the count within ±2 of the clean guarded run and l2 at
    most 1.01× its; the clean run raises no alarm."""
    cells = ranks[engine]["matrix"]
    got, ref = cells[fault], jax_matrix[engine][fault]
    clean = cells["clean"]
    assert got["error"] is None
    assert [(k, at) for k, at, _, _ in got["events"]] == ref["events"]
    kinds = {k for k, *_ in got["events"]}
    assert kinds <= SDC_EVENTS
    if fault == "clean":
        assert got["events"] == [] and got["iters"] == ref["iters"]
    assert got["converged"] and abs(got["iters"] - clean["iters"]) <= 2
    assert got["l2"] <= clean["l2"] * 1.01 + 1e-12
    assert abs(got["l2"] - ref["l2"]) <= 1e-9
    # every rank issued the same collectives: no rank branched alone
    first = got["counts"][0]["collectives"]
    assert all(c["collectives"] == first for c in got["counts"])


@pytest.mark.parametrize("engine", ENGINES)
def test_persistent_corruption_is_classified(ranks, jax_matrix, engine):
    got = ranks[engine]["matrix"]["persistent"]["error"]
    ref = jax_matrix[engine]["persistent"]["error"]
    assert got[0] == ref[0] == "SilentCorruptionError"
    assert got[1] == ref[1] == 6 and got[3] == ref[2] == "sdc"


# -- the tail layout and the band -----------------------------------------


def test_tail_layout_and_rtol_are_jax_s():
    from poisson_ellipse_tpu.parallel import pipelined_sharded as jax_pipe
    from poisson_ellipse_tpu.resilience import abft as jax_abft
    from poisson_ellipse_tpu_torch.parallel import pipelined_sharded as pps

    assert (abft.SR, abft.SW, abft.SP_PRED, abft.SDC,
            abft.N_ABFT_SCALARS) == (jax_abft.SR, jax_abft.SW,
                                     jax_abft.SP_PRED, jax_abft.SDC,
                                     jax_abft.N_ABFT_SCALARS)
    assert abft.ABFTState._fields.index("sdc") == abft.SDC
    assert (pps.PIPE_PRED, pps.PIPE_SDC) == (jax_pipe.PIPE_PRED,
                                             jax_pipe.PIPE_SDC)
    assert pps.PipelinedABFTState._fields.index("sdc") == pps.PIPE_SDC
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32),
                     (torch.float64, jnp.float64)):
        assert abft.abft_rtol(tdt) == jax_abft.abft_rtol(jdt)
    assert abft.ABFT_TINY == jax_abft.ABFT_TINY
