"""The port's s-step recurrence, and the four recurrence engines' rows,
against the JAX package, on the CPU.

- f64, s ∈ {2, 4}: exactly the reference's 15/26/50, equal to the JAX
  ``pcg_sstep``'s counts, w within 1e-10.
- 400×600 f32, s ∈ {2, 4}: exactly 546, the JAX engine's own contract
  (it needs the f64 Gram, ``gram_dtype``).
- ``shift_matrix`` equal to JAX's; ``sstep_inner`` on a random SPD Gram
  equal to JAX's to 1e-14 of each output's scale (the two libraries'
  matrix-vector products sum in their own order).
- A limit inside a block stops at exactly that iteration; ``sstep-pallas``
  at 44×132 against the JAX engine with ``stencil="pallas"`` (its Pallas
  stencil in interpret mode): equal counts.
- The engine table: the four engines are registered, ``auto`` never picks
  them, unported options raise naming their ROADMAP item, and the harness
  reports them with the JAX report's keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.harness.run import run_once as jax_run_once
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import sstep_pcg as jax_ss
from poisson_ellipse_tpu.solver import pcg as jax_pcg
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness import roofline
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import sstep_pcg as ss
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.solver.pcg import PCGState
from poisson_ellipse_tpu_torch.utils.device import DeviceCapacity

WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}
RECURRENCE_ENGINES = ("pipelined", "pipelined-pallas", "sstep",
                      "sstep-pallas")



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test: at 400×600 PyTorch's CPU operations run
    multi-threaded, and several test workers' thread pools on one host's
    cores then slow every operation by two orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _operands(problem, dtype=torch.float64):
    jp = JaxProblem(M=problem.M, N=problem.N, norm=problem.norm,
                    delta=problem.delta, max_iter=problem.max_iter)
    a, b, rhs = jax_assembly.assemble_numpy(jp)
    ours = interop.operands_from_reference(problem, a, b, rhs, device="cpu",
                                           dtype=dtype)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return jp, ours, tuple(jnp.asarray(x, jdtype) for x in (a, b, rhs))


@pytest.mark.parametrize("s", ss.SSTEP_CHOICES)
@pytest.mark.parametrize("grid", sorted(WEIGHTED))
def test_f64_oracle_counts_and_w_match_jax(grid, s):
    problem = Problem(M=grid[0], N=grid[1])
    jp, ours, theirs = _operands(problem)
    got = ss.pcg_sstep(problem, *ours, s=s)
    ref = jax_ss.pcg_sstep(jp, *theirs, s=s)
    assert int(got.iters) == int(ref.iters) == WEIGHTED[grid]
    assert bool(got.converged) and not bool(got.breakdown)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("s", ss.SSTEP_CHOICES)
def test_headline_grid_f32_exact(s):
    problem = Problem(M=400, N=600)
    got = engine.solve(problem, "sstep", torch.float32, device="cpu",
                       sstep_s=s)
    assert bool(got.converged) and not bool(got.breakdown)
    assert int(got.iters) == 546


@pytest.mark.parametrize("s", ss.SSTEP_CHOICES)
def test_shift_matrix_equals_jax(s):
    got = ss.shift_matrix(s, torch.float64)
    want = np.asarray(jax_ss.shift_matrix(s, jnp.float64))
    assert got.shape == (ss.basis_size(s),) * 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_gram_dtype():
    assert ss.gram_dtype(torch.float32) == torch.float64
    assert ss.gram_dtype(torch.bfloat16) == torch.float64
    assert ss.gram_dtype(torch.float64) == torch.float64


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("s", ss.SSTEP_CHOICES)
def test_sstep_inner_matches_jax(s, weighted):
    """The s coordinate iterations on the Gram pair of a random SPD
    operator's ρ-scaled Krylov basis (so the shift matrix is Â in those
    coordinates, as in a solve), from a mid-solve k with a limit inside
    the block, against JAX's."""
    rng = np.random.default_rng(11 + s)
    n = 40
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ahat = q @ np.diag(rng.uniform(0.05, 2.0, n)) @ q.T
    dmat = np.diag(rng.uniform(0.5, 2.0, n))
    vs = [rng.standard_normal(n)]
    for _ in range(s):
        vs.append(ahat @ vs[-1] / ss.BASIS_SCALE)
    zs = [rng.standard_normal(n)]
    for _ in range(s - 1):
        zs.append(ahat @ zs[-1] / ss.BASIS_SCALE)
    V = np.stack(vs + zs)
    Gm = V @ dmat @ V.T
    Ge = V @ V.T
    B = np.asarray(jax_ss.shift_matrix(s, jnp.float64))
    k0, limit = 7, 7 + s - 1
    args = dict(s=s, limit=limit, weighted=weighted)
    scal = (1e-9, 0.5, 3.0)  # delta, hw, diff0
    ref = jax_ss.sstep_inner(
        jnp.asarray(Gm), jnp.asarray(Ge), jnp.asarray(B), k=jnp.int32(k0),
        delta=jnp.float64(scal[0]), hw=jnp.float64(scal[1]),
        diff0=jnp.float64(scal[2]), conv0=jnp.asarray(False),
        bd0=jnp.asarray(False), dtype=jnp.float64, **args)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    got = ss.sstep_inner(
        f64(Gm), f64(Ge), f64(B), k=torch.tensor(k0, dtype=torch.int32),
        delta=f64(scal[0]), hw=f64(scal[1]), diff0=f64(scal[2]),
        conv0=torch.tensor(False), bd0=torch.tensor(False),
        dtype=torch.float64, **args)
    assert int(got[0]) == int(ref[0]) == limit
    for g, r in zip(got[1:6], ref[1:6]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-14 * max(1.0, np.abs(r).max()))
    assert bool(got[6]) == bool(ref[6]) and bool(got[7]) == bool(ref[7])


def test_limit_inside_a_block_stops_exactly():
    """Limits 13, 26, 39 fall inside s = 4 blocks: each stops there, and
    the chunked run converges at the straight run's count."""
    problem = Problem(M=40, N=40)
    _, (a, b, rhs), _ = _operands(problem, torch.float32)
    straight = ss.pcg_sstep(problem, a, b, rhs, s=4)
    state = ss.init_state(problem, a, b, rhs)
    for limit in (13, 26, 39, problem.max_iterations):
        state, _ = ss.advance(problem, a, b, rhs, state, s=4, limit=limit)
        if not bool(state.converged):
            assert int(state.k) == limit
    assert bool(state.converged)
    assert int(state.k) == int(straight.iters)


def test_bodies_past_the_exit_change_nothing():
    problem = Problem(M=20, N=20)
    _, (a, b, rhs), _ = _operands(problem)
    state, _ = ss.advance(problem, a, b, rhs, ss.init_state(problem, a, b,
                                                            rhs), s=4)
    again, _ = ss.advance(problem, a, b, rhs, state, s=4)
    for name, x, y in zip(PCGState._fields, state, again):
        assert torch.equal(x, y), name


def test_chunk_size_moves_only_the_host_reads():
    problem = Problem(M=40, N=40)
    _, (a, b, rhs), _ = _operands(problem)
    runs = []
    for chunk in (4, 64):
        st, syncs = ss.advance(problem, a, b, rhs,
                               ss.init_state(problem, a, b, rhs), s=4,
                               chunk=chunk)
        runs.append((st, syncs))
    (one, reads_4), (two, reads_64) = runs
    for name, x, y in zip(PCGState._fields, one, two):
        assert torch.equal(x, y), name
    # one read before each chunk and one that sees the exit
    assert reads_4 == -(-int(one.k) // 4) + 1
    assert reads_64 == -(-int(one.k) // 64) + 1


def test_jax_classical_carry_resumed_in_the_port():
    """A JAX s-step carry at k = 12 (the classical 8-tuple), carried over
    by ``interop`` and finished by the port, converges at JAX's count."""
    problem = Problem(M=40, N=40)
    jp, ours, theirs = _operands(problem)
    half = jax_ss.advance(jp, *theirs, jax_ss.init_state(jp, *theirs), s=4,
                          limit=12)
    ref = jax_ss.pcg_sstep(jp, *theirs, s=4)
    state = interop.pcg_state_from_reference(
        problem, [np.asarray(x) for x in half], device="cpu")
    assert int(state.k) == 12 and state.zr.shape == ()
    got, _ = ss.advance(problem, *ours, state, s=4)
    assert int(got.k) == int(ref.iters) and bool(got.converged)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-10)
    with pytest.raises(ValueError, match="8-field"):
        interop.pcg_state_from_reference(problem, list(half)[:5],
                                         device="cpu")


def test_replacement_is_block_containment():
    fires = [k for k in range(0, 100) if ss.replaces(k, 4)]
    assert fires == [29, 30, 31, 32, 61, 62, 63, 64, 93, 94, 95, 96]
    # from block-aligned starts it fires once every 32 iterations
    assert [k for k in range(0, 100, 4) if ss.replaces(k, 4)] == [32, 64, 96]
    assert not ss.replaces(0, 2)


@pytest.mark.parametrize("s", ss.SSTEP_CHOICES)
def test_sstep_pallas_general_grid_matches_jax(s):
    problem = Problem(M=44, N=132)
    jp, ours, theirs = _operands(problem, torch.float32)
    _build.reset_launches()
    got = engine.solve(problem, "sstep-pallas", torch.float32, device="cpu",
                       sstep_s=s)
    assert sum(_build.LAUNCHES.values()) == 0  # the plain K-a on the CPU
    ref = jax_ss.pcg_sstep(jp, *theirs, s=s, stencil="pallas",
                           interpret=True)
    assert int(got.iters) == int(ref.iters)
    assert bool(got.converged)


def test_s_must_be_two_or_four():
    problem = Problem(M=10, N=10)
    _, ours, _ = _operands(problem)
    with pytest.raises(ValueError, match="s must be one of"):
        ss.pcg_sstep(problem, *ours, s=3)
    with pytest.raises(ValueError, match="s must be one of"):
        engine.build_solver(problem, "sstep", torch.float64, "cpu",
                            sstep_s=3)


# -- the engine table ---------------------------------------------------------

H100 = DeviceCapacity(name="H100 (by hand)", sm_count=132,
                      smem_per_block=232448, smem_per_sm=233472,
                      l2_bytes=50 * 2**20, total_memory=80 * 2**30)


def test_engines_are_registered_and_auto_never_picks_them():
    assert set(RECURRENCE_ENGINES) <= set(engine.ENGINES)
    assert engine.SSTEP_ENGINES == ("sstep", "sstep-pallas")
    for name in RECURRENCE_ENGINES:
        assert engine.ENGINE_CAPS[name]["capacity"] is None
        assert name not in engine.CAPACITY_LADDER
    assert engine.ENGINE_CAPS["pipelined-pallas"]["kernels"] == (
        "stencil", "stencil_dots")
    assert engine.ENGINE_CAPS["sstep-pallas"]["kernels"] == ("stencil",)
    for grid in ((40, 40), (400, 600), (2400, 3200)):
        for dtype in (torch.float32, torch.float64):
            for cap in (None, H100):
                assert engine.select_engine(Problem(*grid), dtype,
                                            cap) not in RECURRENCE_ENGINES


@pytest.mark.parametrize("name", RECURRENCE_ENGINES)
def test_engine_dtypes(name):
    problem = Problem(M=10, N=10)
    _, _, resolved = engine.build_solver(problem, name, torch.float32, "cpu")
    assert resolved == name
    if name.endswith("pallas"):
        with pytest.raises(ValueError, match="does not run"):
            engine.build_solver(problem, name, torch.float64, "cpu")
    else:
        solver, args, _ = engine.build_solver(problem, name, torch.float64,
                                              "cpu")
        assert int(solver(*args).iters) == 15


@pytest.mark.parametrize("name", RECURRENCE_ENGINES)
@pytest.mark.parametrize("kw,item", [
    # history= is ported: the pipelined engines record the ring
    # (tests/test_torch_obs.py), the s-step engines refuse it as the JAX
    # package does
    (dict(history=True), "coordinate blocks"),
    # storage_dtype is ported (the storage runs below); storage wider than
    # compute is refused as in the JAX package
    (dict(storage_dtype=torch.float64), "wider than compute"),
])
def test_unported_options_name_their_roadmap_item(name, kw, item):
    if "history" in kw and name.startswith("pipelined"):
        solver, args, _ = engine.build_solver(Problem(M=10, N=10), name,
                                              torch.float32, "cpu", **kw)
        result, trace = solver(*args)
        assert trace.valid()["diff"][-1] == float(result.diff)
        return
    with pytest.raises(ValueError, match=item):
        engine.build_solver(Problem(M=10, N=10), name, torch.float32, "cpu",
                            **kw)


@pytest.mark.parametrize("name", RECURRENCE_ENGINES)
def test_recurrence_engines_take_storage_dtype(name):
    """A narrow recurrence need not converge (ROADMAP Queue C): a capped
    bf16 run comes back at its cap, stored in bf16, finite."""
    problem = Problem(M=20, N=20, max_iter=24)
    solver, args, _ = engine.build_solver(problem, name, torch.float32,
                                          "cpu", storage_dtype="bf16")
    result = solver(*args)
    assert result.w.dtype == torch.bfloat16
    assert bool(torch.isfinite(result.w).all())
    assert int(result.iters) == 24 or bool(result.converged)


def test_module_entry_points_reject_unported_options():
    from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp

    problem = Problem(M=10, N=10)
    _, ours, _ = _operands(problem)
    # history= is ported: the module entry points return the trace too
    for call in (lambda: pp.pcg_pipelined(problem, *ours, history=True),
                 lambda: pp.solve(problem, device="cpu", history=True)):
        result, trace = call()
        assert int(trace.iters) == int(result.iters)
        assert bool(result.converged)
    # a ring is not part of the carry, and advance records only into one
    with pytest.raises(TypeError):
        pp.init_state(problem, *ours, history=True)
    with pytest.raises(ValueError, match="new_ring"):
        pp.advance(problem, *ours, pp.init_state(problem, *ours),
                   history=True)
    # storage_dtype is ported: the module entry points run it (f64 compute
    # with bf16 storage here, f32 through solve)
    for call in (lambda: pp.pcg_pipelined(problem, *ours, storage_dtype="bf16"),
                 lambda: ss.pcg_sstep(problem, *ours, storage_dtype="bf16"),
                 lambda: ss.solve(problem, device="cpu",
                                  storage_dtype="bf16")):
        result = call()
        assert result.w.dtype == torch.bfloat16
        assert bool(torch.isfinite(result.w).all())


@pytest.fixture(scope="module")
def jax_keys():
    report = jax_run_once(JaxProblem(M=10, N=10), mode="single", dtype="f32",
                          engine="xla")
    return set(report.json_dict())


@pytest.mark.parametrize("name,s", [("pipelined", 4), ("pipelined-pallas", 4),
                                    ("sstep", 2), ("sstep-pallas", 4)])
def test_run_once_reports_the_jax_keys(jax_keys, name, s):
    report = run_once(Problem(M=10, N=10), dtype="f32", engine=name,
                      device="cpu", sstep_s=s)
    d = report.json_dict()
    assert set(d) == jax_keys
    assert d["iters"] == 15 and d["converged"] is True
    assert d["engine"] == name and d["hbm_gbps"] is None
    assert d["passes_per_iter"] == roofline.passes_per_iter(name, sstep_s=s)


def test_cli_sstep_s(capsys):
    for s in ("2", "4"):
        assert cli_main(["20", "20", "--engine", "sstep", "--sstep-s", s,
                         "--dtype", "f64", "--device", "cpu"]) == 0
        assert "Converged after 26 iterations" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main(["20", "20", "--engine", "sstep", "--sstep-s", "3",
                  "--device", "cpu"])


def test_roofline_rows():
    """The port's own pass counts (harness/roofline.py's docstring)."""
    assert roofline.passes_per_iter("pipelined-pallas") == pytest.approx(
        57.78125)
    assert roofline.passes_per_iter("pipelined") == pytest.approx(68.78125)
    # K-d (9 passes) in place of the plain stencil and eight two-read sums
    assert (roofline.passes_per_iter("pipelined")
            - roofline.passes_per_iter("pipelined-pallas")) == 4 + 16 - 9
    for name in ("sstep", "sstep-pallas"):
        assert roofline.passes_per_iter(name, sstep_s=4) == pytest.approx(
            66.46875)
        assert roofline.passes_per_iter(name, sstep_s=2) == pytest.approx(
            74.71875)
    r = roofline.roofline(Problem(M=400, N=600), "sstep", 546, 0.5,
                          torch.float32, "cpu", sstep_s=2)
    assert r["passes_per_iter"] == pytest.approx(74.71875)
    assert r["hbm_gbps"] is None
