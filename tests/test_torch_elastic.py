"""The port's elastic mesh (``parallel.elastic``, ``resilience.meshguard``),
mesh checkpoints and the command line's resilient mesh runs, against the
JAX package's, on the CPU.

The port's 2×2 mesh is four gloo rank processes, every drill of this file
from one spawn (``resilience.mesh_drills``); a lost rank of the JAX
package (a device id) is a rank of the original group here, and stays a
live process that follows the survivors. The JAX package runs its mesh on
the virtual CPU devices of ``tests/conftest.py``. The JAX package's own
cases (``tests/test_elastic.py``, ``tests/test_checkpoint.py``): 40×40 f64,
chunk 8, faults at 16. Tolerances:

- ``elastic_solve``: JAX's final mesh shape, degrades, count and events;
  l2 at most 1.01× the uninterrupted run's; the trace's ``degrade:mesh``
  events valid by both packages' validators;
- a resharded carry and a mesh checkpoint resumed on 1×2: the straight
  1×2 count, w within 1e-11;
- a halo exchange on a survivors' group without rank 0: each extended
  block exactly the padded global array's neighbourhood, zeros outside;
- the command line: JAX's fields and refusals, word for word.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.harness.__main__ import main as jax_main
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.parallel import elastic as jax_elastic
from poisson_ellipse_tpu.parallel.mesh import AXIS_X, AXIS_Y
from poisson_ellipse_tpu.parallel.pcg_sharded import (
    build_sharded_stepper as jax_stepper,
    sharded_result_of as jax_result_of,
    solve_sharded as jax_solve_sharded,
)
from poisson_ellipse_tpu.resilience import errors as jax_errors
from poisson_ellipse_tpu.resilience import faultinject as jax_fi
from poisson_ellipse_tpu.resilience import meshguard as jax_meshguard
from poisson_ellipse_tpu.utils.error import (
    l2_error_vs_analytic as jax_l2,
)
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.parallel import elastic, mesh, multihost
from poisson_ellipse_tpu_torch.resilience import errors
from poisson_ellipse_tpu_torch.resilience import faultinject as fi
from poisson_ellipse_tpu_torch.resilience import mesh_drills as md

PROBLEM = Problem(M=40, N=40)
JAX_PROBLEM = JaxProblem(M=40, N=40)
CHUNK = 8
AT = 16
HALO_GRID = np.arange(41 * 43, dtype=np.float64).reshape(41, 43) + 1.0

# the drills, as (port fault plan, JAX fault plan, elastic keywords)
DRILLS = {
    "loss": (lambda m: m.FaultPlan(m.device_loss(AT, device=3),
                                   m.device_loss(AT, device=2)), {}),
    "straggler": (lambda m: m.FaultPlan(m.straggler(2.0, at_iter=AT,
                                                    device=1)),
                  dict(chunk_deadline_s=0.9)),
    "budget": (lambda m: m.FaultPlan(m.device_loss(CHUNK, device=0)),
               dict(max_degrades=0)),
    "abft": (lambda m: m.FaultPlan(m.halo_bitflip(AT, field="p")),
             dict(abft=True)),
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("elastic")


@pytest.fixture(scope="module")
def ranks(work):
    """Every 2×2 drill of this file, from one spawn of 4 ranks."""
    f64 = torch.float64
    jobs = [(md.elastic, (PROBLEM, f64, str(work / f"ck-{name}"), CHUNK),
             dict(faults=plan(fi), device="cpu",
                  trace=str(work / f"{name}.jsonl"), **kw))
            for name, (plan, kw) in DRILLS.items()]
    jobs += [
        (md.reshard_resume, (PROBLEM, f64, AT, [2, 3]), dict(device="cpu")),
        (md.survivors_halo, (HALO_GRID, [0]), dict(device="cpu")),
        (md.checkpoint_reshard, (PROBLEM, f64, str(work / "ck-mesh"), CHUNK,
                                 2, [2, 3]), dict(device="cpu")),
    ]
    out = multihost.spawn(multihost.run_jobs, 4, (jobs,), device="cpu",
                          timeout=600)
    names = list(DRILLS) + ["reshard", "halo", "checkpoint"]
    return dict(zip(names, out))


def _jax_mesh(n, px, py):
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(px, py),
                   (AXIS_X, AXIS_Y))


@pytest.fixture(scope="module")
def jax_runs(work):
    """The JAX package's drills on its virtual mesh."""
    mesh22 = _jax_mesh(4, 2, 2)
    out = {"clean": jax_solve_sharded(JAX_PROBLEM, mesh22, jnp.float64)}
    for name, (plan, kw) in DRILLS.items():
        try:
            r = jax_meshguard.elastic_solve(
                JAX_PROBLEM, mesh22, jnp.float64,
                directory=str(work / f"jax-{name}"), chunk=CHUNK,
                faults=plan(jax_fi), **kw)
            out[name] = {"iters": int(r.result.iters),
                         "mesh_shape": tuple(r.mesh_shape),
                         "degrades": r.degrades,
                         "events": [(e.kind, e.at_iter, e.cause,
                                     tuple(e.mesh_before),
                                     tuple(e.mesh_after))
                                    for e in r.events],
                         "l2": float(jax_l2(JAX_PROBLEM, r.result.w))}
        except jax_errors.SolveError as e:
            out[name] = {"error": (type(e).__name__, e.exit_code)}
    init, advance = jax_stepper(JAX_PROBLEM, mesh22, jnp.float64)
    small = _jax_mesh(2, 1, 2)
    moved = jax_elastic.reshard_state(JAX_PROBLEM, advance(init(), AT),
                                      small, jnp.float64)
    _, advance2 = jax_stepper(JAX_PROBLEM, small, jnp.float64)
    done = jax_result_of(JAX_PROBLEM, advance2(moved,
                                               JAX_PROBLEM.max_iterations))
    out["reshard_iters"] = int(done.iters)
    abft_init, _ = jax_stepper(JAX_PROBLEM, mesh22, jnp.float64, abft=True)
    with pytest.raises(ValueError) as refusal:
        jax_elastic.reshard_state(JAX_PROBLEM, abft_init(), mesh22,
                                  jnp.float64)
    out["refusal"] = str(refusal.value)
    return out


# -- elastic_solve --------------------------------------------------------


def test_device_loss_degrades_to_jax_mesh(ranks, jax_runs, work):
    """Ranks 3 then 2 lost at 16: 2×2 → 1×3 → 1×2, JAX's shape, count,
    degrades and events; l2 at most 1.01× the uninterrupted run's."""
    got, ref = ranks["loss"], jax_runs["loss"]
    assert got["error"] is None and got["converged"]
    assert got["mesh_shape"] == ref["mesh_shape"] == (1, 2)
    assert got["degrades"] == ref["degrades"] == 2
    assert got["iters"] == ref["iters"] == int(jax_runs["clean"].iters)
    assert [tuple(e[:3]) + (tuple(e[3]), tuple(e[4]))
            for e in got["events"]] == ref["events"]
    clean_l2 = float(jax_l2(JAX_PROBLEM, jax_runs["clean"].w))
    assert got["l2"] <= clean_l2 * 1.01 + 1e-12
    path = work / "loss.jsonl"
    assert obs_trace.validate_file(str(path)) == []
    assert jax_trace.validate_file(str(path)) == []
    degrade = [r for r in obs_trace.read_jsonl(str(path))
               if r["name"] == "degrade:mesh"]
    assert len(degrade) == 2
    assert degrade[0]["fields"]["from_mesh"] == [2, 2]
    assert degrade[0]["fields"]["lost_devices"] == [3]
    assert degrade[-1]["fields"]["to_mesh"] == [1, 2]


def test_lost_ranks_issue_nothing_after_their_degrade(ranks):
    """A dropped rank makes no halo exchange, reduction, gather, agreement
    or launch after its degrade, and ends with the survivors' outcome."""
    per_rank = ranks["loss"]["ranks"]
    assert [r["dropped"] is not None for r in per_rank] == [
        False, False, True, True]
    for r in per_rank:
        if r["dropped"] is not None:
            assert r["end"] == r["dropped"]
            assert r["end"]["launches"] == {}
    survivors = per_rank[0]["end"]["collectives"]
    assert per_rank[1]["end"]["collectives"] == survivors
    assert survivors["halo"] > per_rank[2]["end"]["collectives"]["halo"]


def test_straggler_deadline_degrades(ranks, jax_runs):
    got, ref = ranks["straggler"], jax_runs["straggler"]
    assert got["error"] is None and got["converged"]
    assert got["degrades"] == ref["degrades"] == 1
    assert got["events"][0][2] == ref["events"][0][2] == "straggler-deadline"
    assert got["mesh_shape"] == ref["mesh_shape"] == (1, 3)
    assert got["iters"] == ref["iters"] == int(jax_runs["clean"].iters)
    # the named straggler, rank 1, is the one dropped
    assert [r["dropped"] is not None for r in got["ranks"]] == [
        False, True, False, False]


def test_degrade_budget_raises_exit_7(ranks, jax_runs):
    got, ref = ranks["budget"]["error"], jax_runs["budget"]["error"]
    assert got[:2] == ref == ("DeviceLossError", 7)
    assert got[3] == "device-loss"


def test_abft_bitflip_reloads_the_checkpoint(ranks, jax_runs):
    got, ref = ranks["abft"], jax_runs["abft"]
    assert got["error"] is None and got["converged"]
    assert [e[0] for e in got["events"]] == [
        e[0] for e in ref["events"]] == ["sdc-rollback"]
    assert got["events"][0][1] == ref["events"][0][1] == AT
    assert got["degrades"] == ref["degrades"] == 0
    assert got["iters"] == ref["iters"]


# -- elastic surgery ------------------------------------------------------


def test_reshard_resumes_to_the_straight_count(ranks, jax_runs):
    got = ranks["reshard"]
    assert got["mesh"] == (1, 2) and got["ranks"] == (0, 1)
    assert got["converged"]
    assert got["iters"] == got["straight_iters"] == jax_runs["reshard_iters"]
    assert got["max_abs_w"] <= 1e-11


def test_reshard_refuses_an_extended_carry(ranks, jax_runs):
    assert ranks["reshard"]["refusal"] == jax_runs["refusal"]
    assert "8-field" in jax_runs["refusal"]


def test_halo_on_a_survivor_group_without_rank_0(ranks):
    """Ranks 1, 2 and 3 as a 1×3 group: grid positions 0, 1, 2 are global
    ranks 1, 2, 3, and each extended block is the padded grid's
    neighbourhood of its block, zeros past the grid."""
    got = ranks["halo"]
    assert got["mesh"] == (1, 3) and got["ranks"] == (1, 2, 3)
    full = got["padded"]
    bn = full.shape[1] // 3
    ring = np.pad(full, 1)
    for iy, block in enumerate(got["blocks"]):
        np.testing.assert_array_equal(
            block, ring[:, iy * bn:iy * bn + bn + 2])


def test_shrink_mesh_shapes_and_floor():
    """The survivors' grid is near-square as JAX's: 3 of 4 → 1×3, 2 of 4
    → 1×2; nothing left raises the classified error."""
    m = mesh.Mesh(px=2, py=2, rank=0, device=torch.device("cpu"),
                  backend="gloo")
    assert elastic.surviving_devices(m, [3]) == [0, 1, 2]
    assert elastic.shrink_mesh(m, [3]).shape == (1, 3)
    small = elastic.shrink_mesh(m, [2, 3])
    assert small.shape == (1, 2) and small.global_ranks == (0, 1)
    assert elastic.shrink_mesh(m, [0]) is None
    with pytest.raises(errors.DeviceLossError) as exc:
        elastic.shrink_mesh(m, [0, 1, 2, 3])
    assert exc.value.exit_code == 7


# -- mesh checkpoints -----------------------------------------------------


def test_mesh_checkpoint_written_on_2x2_resumes_on_1x2(ranks, jax_runs):
    got = ranks["checkpoint"]
    assert got["written"] == got["resumed_from"] == 2 * CHUNK
    assert got["mesh"] == (1, 2) and got["converged"]
    assert got["iters"] == got["straight_iters"] == jax_runs["reshard_iters"]
    assert got["max_abs_w"] <= 1e-11


# -- the command line -----------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def no_tracer():
    for module in (obs_trace, jax_trace):
        module.stop()
        module._env_checked = True
    yield
    obs_trace.stop()
    jax_trace.stop()


def test_cli_guard_on_the_mesh(capsys, no_tracer):
    """``--mode sharded --guard`` on 2×2: JAX's fields (the port adds the
    backend), no recovery."""
    argv = ["40", "40", "--mode", "sharded", "--mesh", "2", "2", "--guard",
            "--dtype", "f64", "--json"]
    rc, out, _ = _cli(cli_main, [*argv, "--device", "cpu"], capsys)
    ref_rc, ref_out, _ = _cli(jax_main, argv, capsys)
    got, ref = json.loads(out.strip()), json.loads(ref_out.strip())
    assert rc == ref_rc == 0
    for key in ("M", "N", "mesh", "dtype", "engine", "iters", "converged",
                "delta"):
        assert got[key] == ref[key], key
    assert "recoveries" not in got and "recoveries" not in ref
    assert got["backend"] == "gloo" and got["iters"] == 50


def test_cli_checkpoint_dir_on_the_mesh_resumes(tmp_path, capsys,
                                                no_tracer):
    """``--checkpoint-dir`` run twice on 2×2: the second run resumes at
    the newest step (nothing left to time), then once on 1×2 from the
    2×2 steps; JAX's fields."""
    directory = str(tmp_path / "ck")
    argv = ["40", "40", "--mode", "sharded", "--mesh", "2", "2",
            "--checkpoint-dir", directory, "--chunk", "20", "--dtype", "f64",
            "--json", "--device", "cpu"]
    assert cli_main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip())
    assert first["iters"] == 50 and first["converged"] is True
    assert sorted(os.listdir(directory)) == ["40", "50"]
    assert cli_main(argv) == 0
    second = json.loads(capsys.readouterr().out.strip())
    assert second["iters"] == 50 and second["l2_error"] == first["l2_error"]
    argv[5:7] = ["1", "2"]
    assert cli_main(argv) == 0
    third = json.loads(capsys.readouterr().out.strip())
    assert third["mesh"] == [1, 2] and third["iters"] == 50
    ref_dir = str(tmp_path / "jax")
    rc, out, _ = _cli(jax_main, ["40", "40", "--mode", "sharded", "--mesh",
                                 "2", "2", "--checkpoint-dir", ref_dir,
                                 "--chunk", "20", "--dtype", "f64",
                                 "--json"], capsys)
    ref = json.loads(out.strip())
    assert rc == 0
    for key in ("mesh", "engine", "iters", "converged"):
        assert first[key] == ref[key], key


@pytest.mark.parametrize("flags,text", [
    (["--guard", "--engine", "fused"], "no resumable stepper form"),
    (["--guard", "--storage-dtype", "bf16", "--engine", "sstep"],
     "the guarded mesh ladder runs at full width"),
    (["--checkpoint-dir", "CK", "--engine", "pipelined"],
     "--engine must be xla or pallas"),
])
def test_cli_mesh_refusals_equal_jax(flags, text, tmp_path, capsys,
                                     no_tracer):
    flags = [str(tmp_path / "ck") if f == "CK" else f for f in flags]
    argv = ["20", "20", "--mode", "sharded", "--mesh", "1", "2", *flags]
    rc, _, err = _cli(cli_main, [*argv, "--device", "cpu"], capsys)
    ref_rc, _, ref_err = _cli(jax_main, argv, capsys)
    assert rc == ref_rc == 2
    assert text in err and err.strip() == ref_err.strip()


def test_cli_classified_exits_through_the_ranks(capsys, no_tracer):
    """A classified error raised in the rank processes reaches the
    command line as it is: ``--timeout 0`` on the guarded mesh ends with
    exit 4 and the partial record, as on one device."""
    from poisson_ellipse_tpu_torch.harness import run

    with pytest.raises(errors.SilentCorruptionError):
        run.raise_failed([errors.SilentCorruptionError("x", iters=13)])
    assert run.raise_failed([]) == []
    t0 = time.perf_counter()
    rc, _, err = _cli(cli_main, ["20", "20", "--mode", "sharded", "--mesh",
                                 "1", "2", "--timeout", "0", "--json",
                                 "--device", "cpu"], capsys)
    assert rc == 4 and "timeout" in err
    assert time.perf_counter() - t0 < 60
