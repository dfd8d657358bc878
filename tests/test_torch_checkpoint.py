"""The port's checkpoint/resume (``poisson_ellipse_tpu_torch.solver.
checkpoint``, ``torch.save`` with the ``integrity.json`` manifest) against
the JAX package's (orbax), on the CPU.

The JAX package's own cases (``tests/test_checkpoint.py``): 20×20 and
10×10, f64, chunks of 4-6. Tolerances: a checkpointed or resumed solve is
bitwise the port's straight solve (the chunks issue the loop's own
bodies), and its iteration count equals JAX's ``solve_with_checkpoints``;
w within 1e-12 of JAX's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.solver.checkpoint import (
    solve_with_checkpoints as jax_solve_with_checkpoints,
)
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.resilience import truncate_latest_checkpoint
from poisson_ellipse_tpu_torch.solver import checkpoint as ck
from poisson_ellipse_tpu_torch.solver.pcg import (
    advance,
    init_state,
    pcg,
    result_of,
)

F64 = torch.float64


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    obs_trace.stop()
    obs_trace._env_checked = True
    yield
    obs_trace.stop()
    torch.set_num_threads(before)


def _straight(problem: Problem, dtype=F64, stencil="xla"):
    return pcg(problem, *assembly.assemble(problem, dtype, "cpu"),
               stencil=stencil)


def _bitwise(got, want) -> None:
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _solve(problem, directory, **kw):
    kw.setdefault("dtype", F64)
    return ck.solve_with_checkpoints(problem, str(directory), device="cpu",
                                     **kw)


def _steps(directory) -> list:
    return sorted((d for d in os.listdir(directory) if d.isdigit()), key=int)


def test_chunked_advance_is_bit_identical_to_straight():
    problem = Problem(M=20, N=20)
    a, b, rhs = assembly.assemble(problem, F64, "cpu")
    straight = pcg(problem, a, b, rhs)
    state = init_state(problem, a, b, rhs)
    for limit in (7, 14, 21, 28, 100):
        state, _ = advance(problem, a, b, rhs, state, limit=limit)
    _bitwise(result_of(state), straight)
    assert int(straight.iters) == 26


@pytest.mark.parametrize("dtype,stencil", [(F64, "xla"),
                                           (torch.float32, "pallas")])
def test_checkpointed_solve_is_bitwise_the_straight_one(tmp_path, dtype,
                                                        stencil):
    """Bitwise the port's straight solve, at JAX's count and within 1e-12
    of its w (f64; the f32 pallas solve at 5e-6)."""
    problem = Problem(M=20, N=20)
    res = _solve(problem, tmp_path / "ck", chunk=5, dtype=dtype,
                 stencil=stencil)
    _bitwise(res, _straight(problem, dtype, stencil))
    assert bool(res.converged)
    ref = jax_solve_with_checkpoints(
        JaxProblem(M=20, N=20), str(tmp_path / "jax"), chunk=5,
        dtype={F64: jnp.float64}.get(dtype, jnp.float32), stencil=stencil)
    assert int(res.iters) == int(ref.iters) == 26
    np.testing.assert_allclose(res.w.double().numpy(), np.asarray(ref.w),
                               rtol=0, atol=1e-12 if dtype == F64 else 5e-6)
    # the steps on disk: the newest two (keep=2), each with its fingerprint
    # (dtype named as the JAX package names it) and its manifest
    steps = _steps(tmp_path / "ck")
    assert steps == ["25", "26"]
    meta = json.loads((tmp_path / "ck" / "26" / ck.META_NAME).read_text())
    assert meta["dtype"] == str(jnp.dtype({F64: jnp.float64}.get(
        dtype, jnp.float32)))
    assert meta["stencil"] == stencil and meta["mesh"] == [1, 1]


def test_resume_continues_from_disk(tmp_path):
    problem = Problem(M=20, N=20)
    directory = str(tmp_path / "ck")
    # a run killed mid-solve: one chunk, saved, the state dropped
    with ck.CheckpointingSolver(problem, directory, chunk=5, dtype=F64,
                                device="cpu") as s1:
        state = s1.initial_state()
        for it in range(5):
            state = s1._body(state, it)
        s1.save(state)
        assert s1.latest_step() == 5
    with ck.CheckpointingSolver(problem, directory, chunk=5, dtype=F64,
                                device="cpu") as s2:
        assert s2.latest_step() == 5
        res = s2.run(resume=True)
        # the resumed run read its start and saved 5 chunks
        assert s2.host_syncs == 1 + 5
    # close() joined the writes
    assert len(s2.save_seconds) == len(s2.write_seconds) == 5
    _bitwise(res, _straight(problem))


def test_resume_false_ignores_checkpoints(tmp_path):
    problem = Problem(M=10, N=10)
    directory = tmp_path / "ck"
    _solve(problem, directory, chunk=4)
    res = _solve(problem, directory, chunk=4, resume=False)
    assert bool(res.converged) and int(res.iters) == 15
    _bitwise(res, _straight(problem))


@pytest.mark.parametrize("change", [dict(problem=Problem(M=12, N=10)),
                                    dict(dtype=torch.float32),
                                    dict(stencil="pallas")])
def test_mismatched_checkpoint_is_refused(tmp_path, change):
    directory = tmp_path / "ck"
    _solve(Problem(M=10, N=10), directory, chunk=4)
    kw = dict(chunk=4)
    kw.update({k: v for k, v in change.items() if k != "problem"})
    with pytest.raises(ck.CheckpointMismatchError,
                       match="different problem"):
        _solve(change.get("problem", Problem(M=10, N=10)), directory, **kw)
    assert _steps(directory)  # a refusal quarantines nothing


def test_bad_arguments_rejected(tmp_path):
    with pytest.raises(ValueError, match="chunk"):
        ck.CheckpointingSolver(Problem(M=10, N=10), str(tmp_path), chunk=0,
                               device="cpu")
    with pytest.raises(ValueError, match="stencil"):
        ck.CheckpointingSolver(Problem(M=10, N=10), str(tmp_path),
                               stencil="fused", device="cpu")


def test_finalized_steps_carry_integrity_manifests(tmp_path):
    directory = tmp_path / "ck"
    _solve(Problem(M=20, N=20), directory, chunk=5)
    steps = _steps(directory)
    assert steps
    assert not [n for n in os.listdir(directory) if n.startswith("tmp-")]
    for step in steps:
        manifest = json.loads((directory / step / ck.MANIFEST_NAME)
                              .read_text())
        assert set(manifest) == {ck.STATE_NAME, ck.META_NAME}
        for rel, size in manifest.items():
            assert os.path.getsize(directory / step / rel) == size


def test_truncated_latest_step_is_quarantined_and_previous_used(tmp_path):
    """The kill-during-write shape: the newest step's largest file cut in
    half; the resume quarantines it (a warning and a trace event JAX's
    validator accepts) and continues from the previous step, bitwise."""
    problem = Problem(M=20, N=20)
    directory = tmp_path / "ck"
    first = _solve(problem, directory, chunk=5)
    path = truncate_latest_checkpoint(str(directory))
    assert path.endswith(os.path.join("26", ck.STATE_NAME))
    trace = tmp_path / "t.jsonl"
    obs_trace.start(str(trace))
    try:
        with pytest.warns(RuntimeWarning, match="quarantined"):
            res = _solve(problem, directory, chunk=5)
    finally:
        obs_trace.stop()
    assert int(res.iters) == int(first.iters) == 26
    _bitwise(res, first)
    assert "quarantined-26" in os.listdir(directory)
    assert jax_trace.validate_file(str(trace)) == []
    events = [r for r in jax_trace.read_jsonl(str(trace))
              if r["name"] == "recovery:checkpoint-quarantine"]
    assert len(events) == 1 and events[0]["fields"]["step"] == 26


def test_corrupt_step_without_manifest_falls_back_via_load_failure(
        tmp_path):
    problem = Problem(M=20, N=20)
    directory = tmp_path / "ck"
    first = _solve(problem, directory, chunk=5)
    os.remove(directory / _steps(directory)[-1] / ck.MANIFEST_NAME)
    truncate_latest_checkpoint(str(directory))
    with pytest.warns(RuntimeWarning, match="restore failed"):
        res = _solve(problem, directory, chunk=5)
    assert bool(res.converged) and int(res.iters) == int(first.iters)
    _bitwise(res, first)


def test_all_steps_corrupt_restarts_from_zero(tmp_path):
    problem = Problem(M=10, N=10)
    directory = tmp_path / "ck"
    first = _solve(problem, directory, chunk=4)
    steps = _steps(directory)
    for step in steps:
        with open(directory / step / ck.STATE_NAME, "r+b") as fh:
            fh.truncate(7)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        res = _solve(problem, directory, chunk=4)
    assert bool(res.converged) and int(res.iters) == int(first.iters) == 15
    assert len([n for n in os.listdir(directory)
                if n.startswith("quarantined-")]) == len(steps)
    with ck.CheckpointingSolver(problem, str(directory), chunk=6, dtype=F64,
                                device="cpu") as s2:
        res = s2.run(resume=True)
    _bitwise(res, _straight(problem))


@pytest.mark.parametrize("failure", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 92 MiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_a_device_failure_on_restore_quarantines_nothing(tmp_path,
                                                         monkeypatch,
                                                         failure):
    """A restore the device fails (out of memory, a sticky CUDA error) is
    raised as it is: the step's files are sound, so no step is moved out
    and a later run resumes from it."""
    problem = Problem(M=20, N=20)
    directory = tmp_path / "ck"
    first = _solve(problem, directory, chunk=5)
    steps = _steps(directory)

    def failing(*args, **kw):
        raise failure

    with monkeypatch.context() as m:
        m.setattr(ck.torch, "load", failing)
        with pytest.raises(type(failure)):
            _solve(problem, directory, chunk=5)
    assert _steps(directory) == steps
    assert not [n for n in os.listdir(directory)
                if n.startswith("quarantined-")]
    _bitwise(_solve(problem, directory, chunk=5), first)


def test_mesh_checkpoints_name_their_item(tmp_path):
    """Mesh checkpoints are ported: a one-rank mesh's checkpointed solve
    takes the single-device count, w within 1e-10 (f64; its reductions
    add in double), with the same steps (the 2×2 → 1×2 resume is
    ``tests/test_torch_elastic.py``'s); a step written on another mesh
    shape, its arrays on that mesh's padded grid, restores resharded:
    cropped to the node grid, the resume bitwise the straight solve."""
    from poisson_ellipse_tpu_torch.parallel.mesh import (
        make_mesh,
        padded_dims_of,
    )

    problem = Problem(M=10, N=10)
    single = _solve(problem, tmp_path / "single", chunk=4)
    with ck.CheckpointingSolver(problem, str(tmp_path / "mesh"), chunk=4,
                                dtype=F64,
                                mesh=make_mesh(device="cpu")) as solver:
        on_mesh = solver.run()
    assert int(on_mesh.iters) == int(single.iters)
    assert _steps(tmp_path / "mesh") == _steps(tmp_path / "single")
    np.testing.assert_allclose(on_mesh.w.numpy(), single.w.numpy(), rtol=0,
                               atol=1e-10)
    # a step written on another mesh shape: the resharded restore
    directory = tmp_path / "ck"
    with ck.CheckpointingSolver(problem, str(directory), chunk=4,
                                dtype=F64, device="cpu") as first:
        state = first.initial_state()
        for k in (4, 8):
            state = first._body(first._body(first._body(first._body(
                state, k - 4), k - 3), k - 2), k - 1)
            first.save(state)
    g1p, g2p = padded_dims_of(problem.node_shape, 2, 2)
    for step in _steps(directory):
        path = directory / step / ck.STATE_NAME
        tree = torch.load(path, weights_only=True)
        for key in ("w", "r", "p"):
            full = torch.zeros((g1p, g2p), dtype=tree[key].dtype)
            full[:11, :11] = tree[key]
            tree[key] = full
        torch.save(tree, path)
        meta_path = directory / step / ck.META_NAME
        meta = json.loads(meta_path.read_text())
        meta["mesh"] = [2, 2]
        meta_path.write_text(json.dumps(meta))
        (directory / step / ck.MANIFEST_NAME).unlink()
    with ck.CheckpointingSolver(problem, str(directory), chunk=4,
                                dtype=F64, device="cpu") as resumed:
        assert resumed.latest_step() == 8
        _bitwise(resumed.run(), single)
    assert not [n for n in os.listdir(directory)
                if n.startswith("quarantined-")]


def test_cli_checkpoint_dir_runs_twice_and_resumes(tmp_path, capsys):
    directory = str(tmp_path / "ck")
    argv = ["40", "40", "--engine", "pallas", "--checkpoint-dir", directory,
            "--chunk", "20", "--json", "--device", "cpu"]
    assert cli_main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip())
    assert first["iters"] == 50 and first["converged"] is True
    assert _steps(directory) == ["40", "50"]
    # the second run resumes at 50, converged: nothing left to time
    assert cli_main(argv) == 0
    second = json.loads(capsys.readouterr().out.strip())
    assert second["iters"] == 50 and second["passes_per_iter"] == 0.0
    assert second["l2_error"] == first["l2_error"]
    # a sweep keeps one directory a grid
    assert cli_main(["--grids", "10x10,12x12", "--checkpoint-dir", directory,
                     "--chunk", "8", "--json", "--device", "cpu"]) == 0
    assert {"10x10", "12x12"} <= set(os.listdir(directory))
