"""bf16 compute on the port's pipelined, s-step and lane-sharded mesh against
the JAX package's, on the CPU.

The port's ranks are processes of a gloo group (``multihost.spawn``, one
spawn of 2×2 for the whole file); the JAX package runs its mesh on the
virtual CPU devices of ``tests/conftest.py``, its Grams in f64 (x64 is on
there, as the JAX s-step engine needs it).

What holds, and why:

- The pipelined mesh keeps the JAX module's replacement cadence, 32 at
  every dtype. bf16 pipelined solves on the mesh converge at neither
  cadence: at δ = 1e-4 JAX's sharded engine breaks down at iteration 11
  (10²), 17 (20²) and 15 (40²) on 2×2; the port's at 11 and 13, and at 40²
  it runs to the cap unconverged; at cadence 8 the port's diverges
  (step norm 8.2 at 10², 2.7e8 at 20², 5.9e5 at 40², measured). So there
  is no departure to make (ROADMAP Queue C keeps no entry for it).
- One body from JAX's sharded bf16 carry (its stepper on 2×2, advanced to
  iteration 10, before the breakdown) through the port's body on a one-
  rank mesh: every array within 2⁻⁵ of its scale, as the single-device
  ``pipelined`` bf16 body is held (``tests/test_torch_bf16_loops.py``): the
  port sums each reduction in double and rounds once, JAX adds bf16
  partials; k and the flags equal, the scalars within ``SCALAR_REL``.
- Whole solves (δ = 1e-4, 2×2): neither package converges; where JAX
  breaks down the port breaks down too within ``BREAKDOWN_BAND``
  iterations at 10² and 20² (measured 0 and 4), and at 40² (JAX: breakdown
  at 15) the port's runs unconverged to the ``CAP`` it is given. A bf16
  count is chaotic (ROADMAP Queue C).
- s-step, s ∈ {2, 4}: one block from JAX's sharded carry at iteration 8,
  the arrays within 2⁻⁵ of their scale (the Grams are f64 in both; the
  basis is bf16 in both), k and flags equal; whole solves capped at
  ``CAP``: both at the cap, unconverged, neither broken down.
- lane-sharded, B = 4 lanes of distinct scales, classical and pipelined:
  each bf16 lane bitwise the port's unsharded bf16 lane (JAX's own
  lane-sharded solver fails on jax 0.9.0, ROADMAP Queue C), one reduction
  a body and no halo.
- cadence at bf16 as at f32 (``chip_smoke.MESH_CADENCE``): pipelined 1
  reduction and 1 halo a body, 2 halos more a replacement body, 3 halos
  once; s-step 1 reduction and 1 deep halo a body, 3 deep halos and zr0's
  reduction once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.parallel import mesh as jmesh
from poisson_ellipse_tpu.parallel import pipelined_sharded as jax_pps
from poisson_ellipse_tpu.parallel import sstep_sharded as jax_ss
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
from poisson_ellipse_tpu_torch.batch import batched_pipelined as bpp
from poisson_ellipse_tpu_torch.harness.run import run_sharded_jobs
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.pipelined_pcg import PipelinedState
from poisson_ellipse_tpu_torch.parallel import batched_sharded as bs
from poisson_ellipse_tpu_torch.parallel import mesh, multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps
from poisson_ellipse_tpu_torch.parallel import pipelined_sharded as pps
from poisson_ellipse_tpu_torch.parallel import sstep_sharded as sss
from poisson_ellipse_tpu_torch.solver.pcg import PCGState

BF16 = torch.bfloat16
DELTA = 1e-4
BODY_TOL = 2.0 ** -5
SCALAR_REL = 2.0 ** -5
BREAKDOWN_BAND = 4
CAP = 200
LANES = 4
SCALES = (1.0, 0.5, 2.0, 0.25)
PIPE_GRIDS = (10, 20, 40)
BODY_AT = 10       # JAX's pipelined carry, before its breakdown at 15
BLOCK_AT = 8       # JAX's s-step carry, two blocks of 4 (four of 2) in


def _problem(g, cap=None):
    return Problem(M=g, N=g, delta=DELTA, max_iter=cap)


def _jax_problem(g, cap=None):
    return JaxProblem(M=g, N=g, delta=DELTA, max_iter=cap)


def _jax_mesh(n):
    px, py = jmesh.choose_process_grid(n)
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(px, py),
                   (jmesh.AXIS_X, jmesh.AXIS_Y))


@pytest.fixture(scope="module")
def ranks():
    """Every 2x2 result this file compares, from one spawn of 4 ranks."""
    jobs = {
        **{f"pipe{g}": (ps.solve_report, (_problem(g, CAP if g == 40
                                                   else None), BF16),
                        dict(stencil_impl="pipelined", device="cpu"))
           for g in PIPE_GRIDS},
        **{f"sstep{s}": (sss.solve_report, (_problem(40, CAP), BF16),
                         dict(s=s, device="cpu")) for s in (2, 4)},
        **{f"lanes_{kind}": (bs.solve_report, (_problem(40), LANES, BF16),
                             dict(pipelined=kind == "pipe", scales=SCALES,
                                  device="cpu"))
           for kind in ("cls", "pipe")},
        "run": (run_sharded_jobs, ([dict(problem=_problem(20, CAP),
                                         dtype="bf16", engine=e,
                                         mesh_shape=(2, 2), lanes=lanes,
                                         repeat=1)
                                    for e, lanes in (("pipelined", 1),
                                                     ("sstep", 1),
                                                     ("batched-pipelined",
                                                      4))],),
                dict(device="cpu")),
    }
    names, calls = zip(*jobs.items())
    return dict(zip(names, multihost.spawn(
        multihost.run_jobs, 4, (list(calls),), device="cpu", timeout=600)))


# -- the pipelined mesh ---------------------------------------------------


def _within(name, got, want, tol=BODY_TOL):
    got, want = got.double(), torch.as_tensor(np.asarray(want, np.float64))
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (name, err, scale)


def test_pipelined_bf16_body_is_the_jax_sharded_body():
    jp, p = _jax_problem(40), _problem(40)
    init, advance = jax_pps.build_pipelined_sharded_stepper(
        jp, _jax_mesh(4), jnp.bfloat16)
    carry = advance(init(), BODY_AT)
    ref = advance(carry, BODY_AT + 1)
    g1, g2 = p.node_shape
    crop = [np.asarray(x)[:g1, :g2] if np.ndim(x) == 2 else np.asarray(x)
            for x in carry]
    state = interop.pipelined_state_from_reference(p, crop, device="cpu")
    assert int(state.k) == BODY_AT and not bool(state.breakdown)
    one = mesh.make_mesh(device="cpu")
    a, b, rhs = ps._host_sharded_args(p, one, BF16)
    _state0, body = pps._pipelined_parts(p, one, g1, g2, a, b, rhs, BF16)
    got = body(state, BODY_AT, p.max_iterations)
    for name, x, y in zip(PipelinedState._fields, got, ref):
        y = np.asarray(y)
        if name in ("k", "converged", "breakdown"):
            assert x.item() == y.item(), name
        elif x.dim() == 0:
            _within(name, x, y, SCALAR_REL)
        else:
            _within(name, x, y[:g1, :g2])


@pytest.mark.parametrize("g", PIPE_GRIDS)
def test_pipelined_bf16_whole_solves_against_jax(ranks, g):
    port = ranks[f"pipe{g}"]
    ref = jax_pps.solve_pipelined_sharded(
        _jax_problem(g, CAP if g == 40 else None), _jax_mesh(4), jnp.bfloat16)
    assert port["w_dtype"] == str(BF16)
    assert not port["converged"] and not bool(ref.converged)
    assert bool(ref.breakdown)
    if g < 40:
        assert port["breakdown"]
        assert abs(port["iters"] - int(ref.iters)) <= BREAKDOWN_BAND
    else:
        assert port["iters"] == CAP and not port["breakdown"]
        assert int(ref.iters) < CAP


@pytest.mark.parametrize("g", PIPE_GRIDS)
def test_pipelined_bf16_cadence_on_every_rank(ranks, g):
    port = ranks[f"pipe{g}"]
    b = port["bodies"]
    for counts in port["ranks"]:
        assert counts["collectives"] == {
            "halo": b + 2 * ((b - 1) // pps.REPLACE_EVERY) + 3,
            "reduce": b}
        assert counts["launches"] == {}


def test_pipelined_mesh_keeps_the_jax_cadence_at_bf16():
    assert pps.REPLACE_EVERY == jax_pps.REPLACE_EVERY == 32


# -- the s-step mesh ------------------------------------------------------


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_bf16_block_is_the_jax_sharded_block(s):
    jp, p = _jax_problem(40), _problem(40)
    init, advance = jax_ss.build_sstep_sharded_stepper(
        jp, _jax_mesh(4), jnp.bfloat16, s=s)
    carry = advance(init(), BLOCK_AT)
    ref = advance(carry, BLOCK_AT + s)
    g1, g2 = p.node_shape
    crop = [np.asarray(x)[:g1, :g2] if np.ndim(x) == 2 else np.asarray(x)
            for x in carry]
    state = interop.pcg_state_from_reference(p, crop, device="cpu")
    one = mesh.make_mesh(device="cpu")
    run, args = sss.make_sstep_parts(p, one, BF16, s)
    got, _, bodies = run(*args, limit=BLOCK_AT + s, state=state)
    assert bodies == 1
    for name, x, y in zip(PCGState._fields, got, ref):
        y = np.asarray(y)
        if name in ("k", "converged", "breakdown"):
            assert x.item() == y.item(), name
        elif x.dim() == 0:
            _within(name, x, y, SCALAR_REL)
        else:
            _within(name, x, y[:g1, :g2])


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_bf16_whole_solves_against_jax(ranks, s):
    port = ranks[f"sstep{s}"]
    ref = jax_ss.solve_sstep_sharded(_jax_problem(40, CAP), _jax_mesh(4),
                                     jnp.bfloat16, s=s)
    assert port["w_dtype"] == str(BF16)
    assert (port["iters"], port["converged"], port["breakdown"]) == (
        int(ref.iters), bool(ref.converged), bool(ref.breakdown)) == (
        CAP, False, False)
    b = port["bodies"]
    assert b == CAP // s
    for counts in port["ranks"]:
        assert counts["collectives"] == {"halo": b + 3, "reduce": b + 1}


# -- the lane-sharded mesh ------------------------------------------------


@pytest.mark.parametrize("kind", ["cls", "pipe"])
def test_bf16_lanes_are_the_unsharded_lanes_bitwise(ranks, kind):
    port = ranks[f"lanes_{kind}"]
    p = _problem(40)
    a, b, rhs = bp.batched_operands(p, LANES, BF16, "cpu")
    rhs = rhs * torch.tensor(SCALES, dtype=BF16)[:, None, None]
    ref = (bpp.pcg_batched_pipelined if kind == "pipe"
           else bp.pcg_batched)(p, a, b, rhs)
    np.testing.assert_array_equal(port["w"], ref.w.float().numpy())
    np.testing.assert_array_equal(port["iters"], ref.iters.numpy())
    np.testing.assert_array_equal(port["diff"], ref.diff.float().numpy())
    for field in ("converged", "breakdown", "quarantined"):
        np.testing.assert_array_equal(port[field],
                                      getattr(ref, field).numpy())
    assert port["local_lanes"] == LANES // 4
    for counts in port["ranks"]:
        assert counts["collectives"] == {"reduce": port["bodies"]}


# -- the harness ----------------------------------------------------------


def test_run_once_takes_bf16_on_the_rest_of_the_mesh(ranks):
    for report, engine_name in zip(ranks["run"], ("pipelined", "sstep",
                                                  "batched-pipelined")):
        assert report.engine == engine_name and report.dtype == "bf16"
        assert report.backend == "gloo" and report.mesh_shape == (2, 2)
        assert report.iters <= CAP and not report.converged
        d = report.json_dict()
        assert d["dtype"] == "bf16" and d["mesh"] == [2, 2]

