"""The port's PCG loop and engines against the JAX package, on the CPU.

- ``xla`` in f64: the reference's exact iteration counts, and w within
  1e-12 of the JAX ``pcg``.
- The chunked loop: any chunk size and any sequence of limits give the
  bits of one straight run.
- ``fused`` and ``pallas`` in f32 (their plain versions, on the CPU)
  against JAX ``solve_fused`` and the JAX ``pallas`` engine, whose Pallas
  kernels run in interpret mode: equal iteration counts, w within 5e-6
  (the bar of tests/test_engines.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops.fused_pcg import solve_fused as jax_solve_fused
from poisson_ellipse_tpu.solver.pcg import pcg as jax_pcg
from poisson_ellipse_tpu.solver.pcg import solve as jax_solve
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.solver import engine, pcg

UNWEIGHTED = {(10, 10): 17, (20, 20): 31, (40, 40): 61}
WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}
ORACLE_CASES = ([(m, n, "unweighted", k) for (m, n), k in UNWEIGHTED.items()]
                + [(m, n, "weighted", k) for (m, n), k in WEIGHTED.items()])


def _cpu_operands(problem, dtype=torch.float64):
    a, b, rhs = jax_assembly.assemble_numpy(
        JaxProblem(M=problem.M, N=problem.N, norm=problem.norm,
                   delta=problem.delta, max_iter=problem.max_iter))
    return interop.operands_from_reference(problem, a, b, rhs, device="cpu",
                                           dtype=dtype)


@pytest.mark.parametrize("M,N,norm,want", ORACLE_CASES)
def test_xla_f64_oracle_counts_and_w_match_jax(M, N, norm, want):
    problem = Problem(M=M, N=N, norm=norm)
    got = engine.solve(problem, "auto", torch.float64, device="cpu")
    assert int(got.iters) == want
    assert bool(got.converged) and not bool(got.breakdown)
    jp = JaxProblem(M=M, N=N, norm=norm)
    a, b, rhs = (jnp.asarray(x) for x in jax_assembly.assemble_numpy(jp))
    ref = jax_pcg(jp, a, b, rhs)
    assert int(ref.iters) == want
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-12)
    assert float(got.diff) == pytest.approx(float(ref.diff), rel=1e-10)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_run_equals_straight_run(chunk):
    problem = Problem(M=20, N=30)
    a, b, rhs = _cpu_operands(problem)
    straight = pcg.pcg(problem, a, b, rhs, chunk=10_000)
    chunked = pcg.pcg(problem, a, b, rhs, chunk=chunk)
    assert int(chunked.iters) == int(straight.iters)
    assert torch.equal(chunked.w, straight.w)
    assert torch.equal(chunked.diff, straight.diff)


def test_advance_in_limits_equals_straight_run():
    """Resuming the carry at limits 5, 12, 30, ... gives the same bits as
    one run, and each stop lands exactly on its limit."""
    problem = Problem(M=20, N=30)
    a, b, rhs = _cpu_operands(problem)
    straight = pcg.pcg(problem, a, b, rhs)
    state = pcg.init_state(problem, a, b, rhs)
    for limit in (5, 12, 30, None):
        state, _ = pcg.advance(problem, a, b, rhs, state, limit=limit,
                               chunk=4)
        if limit is not None:
            assert int(state.k) == limit
    assert torch.equal(state.w, straight.w)
    assert int(state.k) == int(straight.iters)


def test_host_reads_once_per_chunk():
    problem = Problem(M=40, N=40)
    solver, args, resolved = engine.build_solver(problem, "xla",
                                                 torch.float64, "cpu",
                                                 chunk=16)
    result = solver(*args)
    iters = int(result.iters)
    # one read before each chunk, and one that sees the loop has exited
    assert solver.host_syncs == -(-iters // 16) + 1
    assert resolved == "xla"


def test_breakdown_keeps_the_pre_update_iterates():
    """delta = 1e-30 is never met: the loop ends on the denominator guard,
    and the reported w is the last one before the breakdown iteration."""
    kw = dict(M=20, N=20, delta=1e-30)
    problem = Problem(**kw)
    a, b, rhs = _cpu_operands(problem)
    got = pcg.pcg(problem, a, b, rhs)
    jp = JaxProblem(**kw)
    ref = jax_pcg(jp, *(jnp.asarray(x)
                        for x in jax_assembly.assemble_numpy(jp)))
    assert bool(got.breakdown) and bool(ref.breakdown)
    assert not bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-12)
    k = int(got.iters)
    before = pcg.pcg(Problem(**kw, max_iter=k - 1), a, b, rhs)
    assert torch.equal(got.w, before.w)
    assert float(got.diff) == float(before.diff)


@pytest.mark.parametrize("M,N,norm", [(20, 20, "unweighted"),
                                      (40, 40, "unweighted"),
                                      (20, 20, "weighted"),
                                      (40, 40, "weighted")])
def test_fused_plain_matches_jax_solve_fused(M, N, norm):
    problem = Problem(M=M, N=N, norm=norm)
    got = engine.solve(problem, "fused", torch.float32, device="cpu")
    ref = jax_solve_fused(JaxProblem(M=M, N=N, norm=norm), jnp.float32,
                          interpret=True)
    table = UNWEIGHTED if norm == "unweighted" else WEIGHTED
    assert int(got.iters) == int(ref.iters) == table[(M, N)]
    assert bool(got.converged) and not bool(got.breakdown)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("M,N,norm", [(20, 20, "unweighted"),
                                      (40, 40, "weighted")])
def test_pallas_engine_plain_matches_jax_pallas_engine(M, N, norm):
    problem = Problem(M=M, N=N, norm=norm)
    got = engine.solve(problem, "pallas", torch.float32, device="cpu")
    ref = jax_solve(JaxProblem(M=M, N=N, norm=norm), jnp.float32,
                    stencil="pallas")
    assert int(got.iters) == int(ref.iters)
    assert bool(got.converged)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=5e-6)


def test_fused_chunked_equals_straight():
    problem = Problem(M=24, N=36)
    solver, args = fp.build_fused_solver(problem, device="cpu", chunk=1)
    one = solver(*args)
    solver64, _ = fp.build_fused_solver(problem, device="cpu", chunk=64)
    many = solver64(*args)
    assert int(one.iters) == int(many.iters)
    assert torch.equal(one.w, many.w)
    assert solver.host_syncs == int(one.iters) + 1


def test_pcg_fused_on_assembled_tensors():
    """pcg_fused normalises the coefficients in the tensors' dtype; at 20²
    that still lands on the oracle count."""
    problem = Problem(M=20, N=20, norm="unweighted")
    a, b, rhs = _cpu_operands(problem, torch.float32)
    got = fp.pcg_fused(problem, a, b, rhs)
    assert int(got.iters) == 31 and bool(got.converged)


def test_select_engine_policy():
    """f64 takes xla; f32 walks the capacity ladder, which on the CPU (no
    capacity: no on-chip memory) ends at the xl plain version."""
    problem = Problem(M=400, N=600)
    assert engine.select_engine(problem, torch.float64) == "xla"
    assert engine.select_engine(problem, torch.float32) == "xl"
    _, _, resolved = engine.build_solver(Problem(M=10, N=10), "auto",
                                         torch.float32, "cpu")
    assert resolved == "xl"


@pytest.mark.parametrize("kw,item", [
    (dict(geometry="ellipse"), "Queue A item 11"),
    (dict(history=True), "Queue A item 8"),
    # the JAX streamed and xl engines stream bf16 operands; that form is
    # not ported (the other storage engines are: test_storage_dtype_runs)
    (dict(engine="streamed", storage_dtype=torch.bfloat16), "Queue A item 18"),
    (dict(engine="xl", storage_dtype=torch.bfloat16), "Queue A item 18"),
    (dict(precond="mg"), "Queue A item 11"),
    (dict(recycle=8), "Queue A item 13"),
])
def test_unported_options_name_their_roadmap_item(kw, item):
    kw = dict(kw)
    name = kw.pop("engine", "auto")
    with pytest.raises(NotImplementedError, match=item):
        engine.build_solver(Problem(M=10, N=10), name, torch.float32,
                            "cpu", **kw)


@pytest.mark.parametrize("name,lanes", [("xla", 1), ("pallas", 1),
                                        ("batched", 4)])
def test_storage_dtype_runs(name, lanes):
    """The storage engines take ``storage_dtype``: the state comes back
    in it, at the JAX package's bf16 count (18 at 10x10 weighted, both
    its flavours, against 15 at f32)."""
    solver, args, _ = engine.build_solver(Problem(M=10, N=10), name,
                                          torch.float32, "cpu", lanes=lanes,
                                          storage_dtype=torch.bfloat16)
    result = solver(*args)
    assert result.w.dtype == torch.bfloat16
    assert bool(result.converged.all())
    assert result.iters.tolist() == ([18] * lanes if lanes > 1 else 18)


@pytest.mark.parametrize("name", ["auto", "fused", "resident",
                                  "batched-pallas", "batched-pipelined",
                                  "batched-pipelined-pallas"])
def test_storage_dtype_refused_as_in_jax(name):
    """Engines with no storage form refuse it with the JAX package's
    error, ``auto`` included; storage equal to compute is the plain
    solve on any engine."""
    lanes = 2 if name.startswith("batched") else 1
    with pytest.raises(ValueError, match="has no storage-dtype form"):
        engine.build_solver(Problem(M=10, N=10), name, torch.float32, "cpu",
                            lanes=lanes, storage_dtype="bf16")
    solver, args, _ = engine.build_solver(Problem(M=10, N=10), name,
                                          torch.float32, "cpu", lanes=lanes,
                                          storage_dtype="f32")
    assert solver(*args).w.dtype == torch.float32


def test_engine_rejects_what_it_does_not_run():
    with pytest.raises(ValueError):
        engine.build_solver(Problem(M=10, N=10), "fused", torch.float64,
                            "cpu")
    with pytest.raises(ValueError):
        engine.build_solver(Problem(M=10, N=10), "pallas", torch.float64,
                            "cpu")
    for name in ("resident", "streamed", "xl"):
        with pytest.raises(ValueError):
            engine.build_solver(Problem(M=10, N=10), name, torch.float64,
                                "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        engine.build_solver(Problem(M=10, N=10), "megakernel", torch.float32,
                            "cpu")
    with pytest.raises(NotImplementedError, match="Queue B item 10"):
        fp.build_fused_solver(Problem(M=10, N=10), torch.bfloat16, "cpu")
