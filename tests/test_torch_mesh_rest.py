"""The port's pipelined, s-step and lane-sharded mesh engines against the
JAX package's, on the CPU.

The port's ranks are processes of a gloo group (``multihost.spawn``); every
solve of one mesh shape runs in one spawn (a module-scoped fixture a
shape), which returns host arrays and every rank's collectives. The JAX
package runs its mesh on the 8 virtual CPU devices of ``tests/conftest.py``.

Tolerances, as the JAX tests hold these engines:

- pipelined (``parallel.pipelined_sharded``): f64 at 40² on 1, 2 and 4
  ranks and 13×17 on 2×4, JAX's count and w within 1e-10 of JAX's sharded
  w (both add each reduction's terms in double); f32 on 2×2 within ±2
  iterations and w within 5e-6, the f32 bound of
  ``tests/test_torch_parallel.py`` (the port adds in double, rounded once;
  JAX sums in f32 in its own order, and its own f32 w moves by 8.9e-7, 9e-6
  of its scale, between its single-device and 2×2 pipelined solves);
- s-step (``parallel.sstep_sharded``), s ∈ {2, 4}: f64 JAX's count, w
  within 1e-10; f32 within ±2 of JAX and rel l2 to JAX's single-device
  ``pcg`` below 5e-3 (``tests/test_sstep.py``); bf16 and f16 storage: a
  capped run, stored narrow, finite, with JAX's flags and JAX's bound on
  the step norm (a narrow count is chaotic, ROADMAP Queue C);
- lane-sharded (``parallel.batched_sharded``), B = 4 lanes of distinct
  scales: each lane bitwise the port's unsharded lane; JAX's unsharded
  ``batched_pcg`` / ``batched_pipelined`` lanes in iterations, w within
  1e-12 (f64) and 5e-6 (f32) (``tests/test_torch_batched.py``);
- cadence, every rank: pipelined 1 reduction and 1 halo exchange a body
  plus 2 halos a replacement body; s-step 1 reduction and 1 deep halo a
  body (s iterations); lanes 1 reduction and no halo; the coefficient
  halos and the init reductions once a solve.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.batch import batched_pcg as jax_bp
from poisson_ellipse_tpu.batch import batched_pipelined as jax_bpp
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.parallel import batched_sharded as jax_bs
from poisson_ellipse_tpu.parallel import mesh as jmesh
from poisson_ellipse_tpu.parallel import sstep_sharded as jax_ss
from poisson_ellipse_tpu.parallel.pipelined_sharded import (
    solve_pipelined_sharded as jax_solve_pipelined,
)
from poisson_ellipse_tpu.solver.engine import ENGINE_CAPS as JAX_CAPS
from poisson_ellipse_tpu.solver.pcg import solve as jax_solve
from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
from poisson_ellipse_tpu_torch.batch import batched_pipelined as bpp
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once, run_sharded_jobs
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.parallel import batched_sharded as bs
from poisson_ellipse_tpu_torch.parallel import mesh, multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps
from poisson_ellipse_tpu_torch.parallel import pipelined_sharded as pps
from poisson_ellipse_tpu_torch.parallel import sstep_sharded as sss
from poisson_ellipse_tpu_torch.solver import engine

W_ATOL_F64 = 1e-10
W_ATOL_F32 = 5e-6
LANE_ATOL = {torch.float64: 1e-12, torch.float32: 5e-6}
SSTEP_REL_L2 = 5e-3
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}

G40 = (40, 40)
UNEVEN = (13, 17)      # 14x18 nodes: padding on both axes over 2x4
LANES = 4
SCALES = (1.0, 0.5, 2.0, 0.25)
NARROW_CAP = 100
REPLACE = 32           # the sharded pipelined cadence at every dtype


def _pipe(grid, dtype):
    return (ps.solve_report, (Problem(M=grid[0], N=grid[1]), dtype),
            dict(stencil_impl="pipelined", device="cpu"))


def _sstep(grid, dtype, s, storage=None, cap=None):
    return (sss.solve_report,
            (Problem(M=grid[0], N=grid[1], max_iter=cap), dtype),
            dict(s=s, storage_dtype=storage, device="cpu"))


def _lanes(dtype, pipelined):
    return (bs.solve_report, (Problem(M=40, N=40), LANES, dtype),
            dict(pipelined=pipelined, scales=SCALES, device="cpu"))


def _harness(**job):
    return (run_sharded_jobs, ([dict(problem=Problem(M=40, N=40),
                                     repeat=1, **job)],),
            dict(device="cpu"))


def _spawn(world, named):
    names, jobs = zip(*named.items())
    return dict(zip(names, multihost.spawn(
        multihost.run_jobs, world, (list(jobs),), device="cpu",
        timeout=600)))


def _sstep_jobs():
    return {
        "sstep2_64": _sstep(G40, torch.float64, 2),
        "sstep4_64": _sstep(G40, torch.float64, 4),
        "sstep4_32": _sstep(G40, torch.float32, 4),
        "sstep_bf16": _sstep(G40, torch.float32, 4, "bf16", NARROW_CAP),
        "sstep_f16": _sstep(G40, torch.float32, 4, "f16", NARROW_CAP),
    }


def _lane_jobs():
    return {f"lanes_{'pipe' if pipe else 'cls'}_{str(dt)[-2:]}": _lanes(dt,
                                                                        pipe)
            for dt in (torch.float32, torch.float64)
            for pipe in (False, True)}


@pytest.fixture(scope="module")
def one_rank():
    return _spawn(1, {"pipe64": _pipe(G40, torch.float64)})


@pytest.fixture(scope="module")
def two_ranks():
    """Every 1x2 result this file compares, from one spawn of 2 ranks."""
    return _spawn(2, {
        "pipe64": _pipe(G40, torch.float64),
        **_sstep_jobs(),
        **_lane_jobs(),
        "run_pipelined": _harness(engine="pipelined", dtype="f64",
                                  mesh_shape=(1, 2)),
        "run_sstep": _harness(engine="sstep-pallas", dtype="f64", sstep_s=2,
                              mesh_shape=(1, 2)),
        "run_lanes": _harness(engine="batched-pipelined", dtype="f32",
                              lanes=LANES, mesh_shape=(1, 2)),
    })


@pytest.fixture(scope="module")
def four_ranks():
    """Every 2x2 result this file compares, from one spawn of 4 ranks."""
    return _spawn(4, {
        "pipe64": _pipe(G40, torch.float64),
        "pipe32": _pipe(G40, torch.float32),
        "pipe_direct": (pps.solve_report, (Problem(M=40, N=40),
                                           torch.float32),
                        dict(device="cpu")),
        **_sstep_jobs(),
        **_lane_jobs(),
    })


@pytest.fixture(scope="module")
def eight_ranks():
    """The one 2x4 case: 13x17 nodes, blocks padded on both axes."""
    return _spawn(8, {"pipe64": _pipe(UNEVEN, torch.float64)})


def _ranks(request, world):
    return request.getfixturevalue(
        {1: "one_rank", 2: "two_ranks", 4: "four_ranks", 8: "eight_ranks"}[
            world])


def _jax_mesh(n):
    px, py = jmesh.choose_process_grid(n)
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(px, py),
                   (jmesh.AXIS_X, jmesh.AXIS_Y))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's sharded solves, by (engine, grid, devices, dtype,
    s, storage)."""
    cache = {}

    def get(kind, grid, n, dtype, s=None, storage=None, cap=None):
        key = (kind, grid, n, dtype, s, storage, cap)
        if key not in cache:
            problem = JaxProblem(M=grid[0], N=grid[1], max_iter=cap)
            if kind == "pipelined":
                cache[key] = jax_solve_pipelined(problem, _jax_mesh(n), dtype)
            else:
                cache[key] = jax_ss.solve_sstep_sharded(
                    problem, _jax_mesh(n), dtype, s=s, storage_dtype=storage)
        return cache[key]

    return get


# -- the pipelined engine -------------------------------------------------


@pytest.mark.parametrize("world,grid", [(1, G40), (2, G40), (4, G40),
                                        (8, UNEVEN)])
def test_pipelined_f64_takes_jax_count_and_w(request, jax_runs, world, grid):
    got = _ranks(request, world)["pipe64"]
    ref = jax_runs("pipelined", grid, world, jnp.float64)
    assert got["converged"] and bool(ref.converged)
    assert got["iters"] == int(ref.iters)
    if grid == G40:
        assert got["iters"] == 50
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=W_ATOL_F64)


def test_pipelined_f32_within_two_of_jax(four_ranks, jax_runs):
    got = four_ranks["pipe32"]
    ref = jax_runs("pipelined", G40, 4, jnp.float32)
    assert got["converged"] and abs(got["iters"] - int(ref.iters)) <= 2
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=W_ATOL_F32)


def test_stencil_impl_pipelined_is_the_direct_builder(four_ranks):
    """``build_sharded_solver(stencil_impl="pipelined")`` and
    ``build_pipelined_sharded_solver`` give the same bits."""
    direct, via = four_ranks["pipe_direct"], four_ranks["pipe32"]
    assert direct["iters"] == via["iters"]
    assert direct["diff"] == via["diff"]
    np.testing.assert_array_equal(direct["w"], via["w"])


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_pipelined_cadence(request, world):
    """Every rank: 1 reduction and 1 halo exchange a body, 2 more halo
    exchanges in each replacement body, and 3 halo exchanges once a solve
    (a, b and w₀ = A·u₀)."""
    got = _ranks(request, world)["pipe64"]
    caps = engine.ENGINE_CAPS["pipelined"]
    assert caps["sharded_reductions"] == JAX_CAPS["pipelined"]["contracts"][
        "sharded_psum"]
    bodies = got["bodies"]
    replaced = (bodies - 1) // REPLACE
    assert replaced >= 1
    for counts in got["ranks"]:
        assert counts["collectives"] == {
            "halo": caps["sharded_halo"] * bodies + 2 * replaced + 3,
            "reduce": caps["sharded_reductions"] * bodies}


# -- the s-step engine ----------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("s", [2, 4])
def test_sstep_f64_takes_jax_count_and_w(request, jax_runs, world, s):
    got = _ranks(request, world)[f"sstep{s}_64"]
    ref = jax_runs("sstep", G40, world, jnp.float64, s)
    assert got["converged"] and bool(ref.converged)
    assert got["iters"] == int(ref.iters) == 50
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=W_ATOL_F64)


@pytest.mark.parametrize("world", [2, 4])
def test_sstep_f32_within_two_of_jax_and_near_pcg(request, jax_runs, world):
    got = _ranks(request, world)["sstep4_32"]
    ref = jax_runs("sstep", G40, world, jnp.float32, 4)
    assert got["converged"] and abs(got["iters"] - int(ref.iters)) <= 2
    single = np.asarray(jax_solve(JaxProblem(M=40, N=40), jnp.float32).w)
    rel = np.linalg.norm(got["w"] - single) / np.linalg.norm(single)
    assert rel < SSTEP_REL_L2


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("storage,dtype", [("bf16", "torch.bfloat16"),
                                           ("f16", "torch.float16")])
def test_sstep_narrow_storage_ships_narrow_state(request, jax_runs, world,
                                                 storage, dtype):
    """The narrow run: capped, stored narrow, finite, JAX's flags, and the
    step norm under JAX's bound for it (``tests/test_sstep.py``)."""
    got = _ranks(request, world)[f"sstep_{storage}"]
    ref = jax_runs("sstep", G40, world, jnp.float32, 4, storage, NARROW_CAP)
    assert got["w_dtype"] == dtype
    assert got["iters"] == NARROW_CAP or got["converged"]
    assert (got["converged"], got["breakdown"]) == (
        bool(ref.converged), bool(ref.breakdown))
    assert np.isfinite(got["w"]).all()
    assert got["diff"] < 1e-3 and float(ref.diff) < 1e-3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["sstep2_64", "sstep4_64", "sstep_bf16"])
def test_sstep_cadence(request, world, name):
    """Every rank: 1 reduction and 1 deep halo exchange a body (s
    iterations), the deep a, b and rhs halos and zr₀'s reduction once a
    solve, whatever the storage."""
    got = _ranks(request, world)[name]
    caps = engine.ENGINE_CAPS["sstep"]
    contract = JAX_CAPS["sstep"]["contracts"]
    assert (caps["sharded_reductions"], caps["sharded_halo"]) == (
        contract["sharded_psum"], contract["sharded_halo"])
    bodies = got["bodies"]
    for counts in got["ranks"]:
        assert counts["collectives"] == {
            "halo": caps["sharded_halo"] * bodies + 3,
            "reduce": caps["sharded_reductions"] * bodies + 1}


def _one_rank_problem(M, N):
    return Problem(M=M, N=N), JaxProblem(M=M, N=N)


def test_sstep_refusals_carry_jax_text():
    """s ∉ {2, 4}, and a halo as deep as the blocks: the narrow storage
    exchange is one cell deeper, so 5×5 blocks take s = 4 at full width
    and refuse it narrow."""
    port_mesh = mesh.make_mesh(device="cpu")
    for (M, N), kw in (((10, 10), dict(s=3)),
                       ((4, 4), dict(s=4, storage_dtype="bf16"))):
        ours, theirs = _one_rank_problem(M, N)
        with pytest.raises(ValueError) as jax_err:
            jax_ss.make_sstep_parts(theirs, _jax_mesh(1), jnp.float32, **kw)
        with pytest.raises(ValueError) as port_err:
            sss.make_sstep_parts(ours, port_mesh, torch.float32, **kw)
        assert str(port_err.value) == str(jax_err.value)
    full = sss.solve_sstep_sharded(Problem(M=4, N=4), port_mesh,
                                   torch.float64, s=4)
    ref = jax_ss.solve_sstep_sharded(JaxProblem(M=4, N=4), _jax_mesh(1),
                                     jnp.float64, s=4)
    assert int(full.iters) == int(ref.iters) > 0
    assert bool(full.converged) == bool(ref.converged)


@pytest.mark.parametrize("call", ["abft", "stepper"])
def test_sstep_resilience_hooks_name_item_21b(call):
    """The s-step mesh's resilience hooks (item 21b) are ported: with
    ``abft`` the solve is bitwise the plain one, unflagged; the stepper
    chunked on its blocks (12 iterations) is the straight solve."""
    p, m = Problem(M=10, N=10), mesh.make_mesh(device="cpu")
    straight, _, _ = sss.make_sstep_parts(p, m, torch.float64, 4)[0](
        *sss.make_sstep_parts(p, m, torch.float64, 4)[1])
    if call == "abft":
        run, args = sss.make_sstep_parts(p, m, torch.float64, 4, abft=True)
        state, _, _ = run(*args)
        assert not bool(state.sdc)
    else:
        init, advance = sss.build_sstep_sharded_stepper(p, m, torch.float64)
        state, limit = init(), 0
        while not bool(state.converged) and limit < p.max_iterations:
            limit += 12
            state = advance(state, limit)
    assert int(state.k) == int(straight.k) and bool(state.converged)
    assert torch.equal(state.w, straight.w)


# -- the lane-sharded engine ----------------------------------------------


def _port_lanes(dtype, pipelined):
    """The port's unsharded lanes of the same scaled stack, one thread."""
    problem = Problem(M=40, N=40)
    a, b, rhs = bp.batched_operands(problem, LANES, dtype, "cpu")
    rhs = rhs * torch.tensor(SCALES, dtype=dtype)[:, None, None]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = bpp.pcg_batched_pipelined if pipelined else bp.pcg_batched
        return run(problem, a, b, rhs)
    finally:
        torch.set_num_threads(before)


def _jax_lanes(dtype, pipelined):
    jd = JAX_DTYPE[dtype]
    problem = JaxProblem(M=40, N=40)
    a, b, rhs = jax_assembly.assemble(problem, jd)
    stack = jnp.stack([rhs * jnp.asarray(s, jd) for s in SCALES])
    run = jax_bpp.pcg_batched_pipelined if pipelined else jax_bp.pcg_batched
    return run(problem, a, b, stack)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["classical", "pipelined"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_lanes_are_the_unsharded_lanes(request, world, pipelined, dtype):
    got = _ranks(request, world)[
        f"lanes_{'pipe' if pipelined else 'cls'}_{str(dtype)[-2:]}"]
    assert got["local_lanes"] == LANES // world
    ref = _port_lanes(dtype, pipelined)
    for field in ("w", "iters", "diff", "converged", "breakdown",
                  "quarantined"):
        np.testing.assert_array_equal(got[field],
                                      getattr(ref, field).numpy())
    jref = _jax_lanes(dtype, pipelined)
    assert got["converged"].all() and not got["quarantined"].any()
    np.testing.assert_array_equal(got["iters"], np.asarray(jref.iters))
    # the scaled lanes differ, so a lane out of order would show
    assert len(set(got["iters"].tolist())) > 1
    np.testing.assert_allclose(got["w"], np.asarray(jref.w), rtol=0,
                               atol=LANE_ATOL[dtype])


@pytest.mark.parametrize("world", [2, 4])
def test_lanes_cadence(request, world):
    """Every rank: 1 reduction a body (the active-lane count) and no halo
    exchange, whatever the recurrence."""
    for key, got in _ranks(request, world).items():
        if not key.startswith("lanes_"):
            continue
        recurrence = "batched-pipelined" if "pipe" in key else "batched"
        caps = engine.ENGINE_CAPS[recurrence]
        contract = JAX_CAPS[recurrence]["contracts"]
        assert (caps["batched_reductions"], caps["batched_halo"]) == (
            contract["batched_psum"], contract["batched_halo"]) == (1, 0)
        for counts in got["ranks"]:
            assert counts["collectives"] == {
                "reduce": caps["batched_reductions"] * got["bodies"]}


def test_lanes_refuse_a_lane_count_off_the_mesh():
    """``lanes % world`` is refused with the JAX text (a two-rank view of
    the mesh: the check comes before any collective)."""
    two = mesh.Mesh(px=1, py=2, rank=0, device=torch.device("cpu"),
                    backend="gloo")
    with pytest.raises(ValueError) as port_err:
        bs.build_batched_sharded_solver(Problem(M=10, N=10), two, lanes=3)
    with pytest.raises(ValueError) as jax_err:
        jax_bs.build_batched_sharded_solver(JaxProblem(M=10, N=10),
                                            _jax_mesh(2), lanes=3)
    assert str(port_err.value) == str(jax_err.value)


def test_lane_refill_advance_names_item_10():
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        bs.build_sharded_chunk_advance((10, 10))


@pytest.mark.parametrize("build", ["pipelined", "sstep", "lanes"])
def test_bf16_compute_names_item_21d(build):
    """Item 21d is ported: bf16 compute builds and runs on the pipelined,
    s-step and lane-sharded mesh (one rank here; held to the JAX package
    in tests/test_torch_mesh_bf16_rest.py), the state in bf16."""
    p, m = Problem(M=10, N=10, max_iter=8), mesh.make_mesh(device="cpu")
    calls = {
        "pipelined": lambda: ps.build_sharded_solver(
            p, m, torch.bfloat16, stencil_impl="pipelined"),
        "sstep": lambda: sss.build_sstep_sharded_solver(p, m, torch.bfloat16),
        "lanes": lambda: bs.build_batched_sharded_solver(
            p, m, 1, torch.bfloat16),
    }
    solver, args = calls[build]()
    result = solver(*args)
    assert result.w.dtype == torch.bfloat16
    assert int(torch.as_tensor(result.iters).max()) <= 8


# -- the harness ----------------------------------------------------------


@pytest.mark.parametrize("name,engine_name,iters", [
    ("run_pipelined", "pipelined", 50), ("run_sstep", "sstep", 50),
    ("run_lanes", "batched-pipelined", 50)])
def test_run_once_in_the_group(two_ranks, name, engine_name, iters):
    (report,) = two_ranks[name]
    assert report.engine == engine_name and report.mesh_shape == (1, 2)
    assert report.backend == "gloo" and report.converged
    assert report.iters == iters
    assert report.l2_error < 1e-2
    per_body = engine.ENGINE_CAPS[engine_name]
    for counts in report.rank_collectives:
        if engine_name.startswith("batched"):
            assert counts["reduce"] == report.bodies and "halo" not in counts
            assert report.lanes == LANES and report.solves_per_sec > 0
        else:
            assert counts["reduce"] == per_body["sharded_reductions"] * (
                report.bodies) + (1 if engine_name == "sstep" else 0)


@pytest.mark.parametrize("engine_name,extra", [
    ("pipelined", []), ("sstep", ["--sstep-s", "2"]),
    ("sstep-pallas", ["--sstep-s", "4"])])
def test_cli_runs_the_new_engines(capsys, engine_name, extra):
    rc = cli_main(["40", "40", "--mode", "sharded", "--mesh", "1", "2",
                   "--engine", engine_name, "--device", "cpu", "--dtype",
                   "f64", "--json", *extra])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["iters"] == 50 and rec["mesh"] == [1, 2]
    assert rec["engine"] == engine_name.removesuffix("-pallas")


def test_cli_lanes_and_narrow_storage_on_the_mesh(capsys):
    rc = cli_main(["20", "20", "--mode", "sharded", "--mesh", "1", "2",
                   "--lanes", "2", "--device", "cpu", "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["engine"] == "batched" and rec["lanes"] == 2
    assert rec["iters"] == 26
    rc = cli_main(["20", "20", "--mode", "sharded", "--mesh", "1", "2",
                   "--engine", "sstep", "--storage-dtype", "bf16",
                   "--device", "cpu", "--json"])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["storage_dtype"] == "bf16" and rec["engine"] == "sstep"
    assert rc in (0, 1)


@pytest.mark.parametrize("kw,error,text", [
    (dict(engine="pipelined", storage_dtype="bf16"), ValueError,
     "sharded --storage-dtype covers the sstep engine"),
    (dict(engine="xla", lanes=2), ValueError,
     "--lanes needs --engine batched"),
    (dict(engine="resident"), ValueError, "single-device only"),
    (dict(engine="sstep", lanes=2), ValueError,
     "--lanes needs --engine batched"),
    (dict(engine="batched", lanes=2, storage_dtype="bf16"), ValueError,
     "sharded --storage-dtype covers the sstep engine"),
    (dict(engine="pipelined-pallas"), ValueError, "single-device only"),
])
def test_run_once_sharded_refusals(kw, error, text):
    with pytest.raises(error, match=text):
        run_once(Problem(M=10, N=10), mode="sharded", device="cpu", **kw)


def test_pipelined_assembles_on_the_host():
    """The JAX package's refusal of device assembly for the pipelined
    mesh, with its text."""
    with pytest.raises(ValueError, match="assembles on the host"):
        ps.build_sharded_solver(Problem(M=10, N=10),
                                mesh.make_mesh(device="cpu"), torch.float64,
                                assembly_mode="device",
                                stencil_impl="pipelined")
