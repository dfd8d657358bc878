"""The port's lane-batched engines and K-e's and K-f's plain versions
against the JAX package (``poisson_ellipse_tpu.batch``), on the CPU.

Inputs are made from a numpy seed and handed to both packages. Sizes:
40×40 (50 iterations, weighted), 24×36 and 44×132, with B = 2-3.
Tolerances:

- the lane operators (``apply_a_batched``, ``diag_d_batched``,
  ``apply_dinv_batched``, ``lane_dots``) and K-e's and K-f's plain
  versions: within 1e-14 of scale in f64; in f32 within 1e-6 of scale for
  arrays (XLA on the CPU may contract a*b+c into an FMA, ROADMAP Queue C)
  and, for sums, within 2e-5 of Σ|x·y| (the K-d tolerance: the Pallas
  kernels sum in f32, the plain versions in double);
- ``pcg_batched`` and ``pcg_batched_pipelined`` with distinct per-lane
  right-hand sides: equal per-lane iterations; w within 1e-12 in f64 and
  5e-6 in f32 (the JAX package's own chunked-vs-fused gap,
  ``tests/test_batched.py``). The f32 pipelined recurrence is held at
  40×40: at 44×132 it carries sum-order round-off to 1.1e-4 of w's scale,
  where the JAX package's own two stencil flavours differ by 6.4e-5
  (ROADMAP Queue C);
- lane independence and chunked == straight: bitwise.
"""

import ctypes
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.batch import batched_pcg as jax_bp
from poisson_ellipse_tpu.batch import batched_pipelined as jax_bpp
from poisson_ellipse_tpu.batch.driver import solve_batched as jax_solve_batched
from poisson_ellipse_tpu.harness.run import run_once as jax_run_once
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import pallas_kernels as jax_pk
from poisson_ellipse_tpu.resilience.faultinject import FaultPlan, inject_nan
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
from poisson_ellipse_tpu_torch.batch import batched_pipelined as bpp
from poisson_ellipse_tpu_torch.batch import driver
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.solver import engine

MODULES = {"batched": (bp, jax_bp), "batched-pipelined": (bpp, jax_bpp)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test, as in the port's other test files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_problem(p: Problem) -> JaxProblem:
    return JaxProblem(M=p.M, N=p.N, norm=p.norm, delta=p.delta, eps=p.eps,
                      max_iter=p.max_iter)


def _operands(problem: Problem, lanes: int, dtype, seed=0):
    """Shared (a, b) and a (B, g1, g2) RHS whose lanes are the problem's
    RHS scaled by distinct factors from ``seed``: the port's tensors and
    the JAX arrays, rounded once from the same f64 host arrays."""
    a, b, rhs = jax_assembly.assemble_numpy(_jax_problem(problem))
    scale = np.random.default_rng(seed).uniform(0.5, 2.0, lanes)
    stacked = np.stack([rhs * s for s in scale])
    ours = tuple(torch.from_numpy(x).to(dtype) for x in (a, b, stacked))
    theirs = tuple(jnp.asarray(x, JAX_DTYPE[dtype]) for x in (a, b, stacked))
    return ours, theirs


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _close_sums(got, want, pairs, rtol=2e-5):
    """(k, B) sums each within rtol of its lane's Σ|x·y| (the sums of some
    random pairs cancel, so |Σ x·y| is no scale)."""
    want = np.asarray(want, dtype=np.float64)
    for j, (x, y) in enumerate(pairs):
        mag = (x * y).abs().double().sum(dim=(-2, -1)).numpy()
        err = np.abs(np.asarray(got[j], dtype=np.float64) - want[j])
        assert np.all(err <= rtol * mag), (j, err, mag)


# -- the lane operators -------------------------------------------------------


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("per_lane", [False, True])
def test_lane_operators_match_jax(dtype, rel, per_lane):
    """Shared or per-lane coefficients, scalar or (B,) per-lane spacings."""
    problem = Problem(M=24, N=36)
    g = problem.node_shape
    rng = np.random.default_rng(1)
    lanes = 3
    coef = (lanes,) + g if per_lane else g
    arrays = dict(w=rng.standard_normal((lanes,) + g),
                  a=rng.random(coef) + 0.5, b=rng.random(coef) + 0.5,
                  u=rng.standard_normal((lanes,) + g),
                  v=rng.standard_normal((lanes,) + g))
    arrays["a"][..., 3, 5] = 0.0  # a zero diagonal entry: the D⁻¹ guard
    arrays["b"][..., 3, 5] = 0.0
    arrays["a"][..., 4, 5] = 0.0
    arrays["b"][..., 3, 6] = 0.0
    h = ((np.array([0.05, 0.08, 0.1]), np.array([0.03, 0.04, 0.05]))
         if per_lane else (problem.h1, problem.h2))
    t = {k: torch.from_numpy(x).to(dtype) for k, x in arrays.items()}
    j = {k: jnp.asarray(x, JAX_DTYPE[dtype]) for k, x in arrays.items()}
    th = tuple(torch.as_tensor(x, dtype=dtype) for x in h)
    jh = tuple(jnp.asarray(x, JAX_DTYPE[dtype]) for x in h)
    a3, b3, _ = bp._lane_ops(t["a"], t["b"], None)
    ja3, jb3, _ = jax_bp._lane_ops(j["a"], j["b"], None)

    _close(bp.apply_a_batched(t["w"], a3, b3, *th),
           jax_bp.apply_a_batched(j["w"], ja3, jb3, *jh), rel)
    d = bp.diag_d_batched(a3, b3, *th)
    jd = jax_bp.diag_d_batched(ja3, jb3, *jh)
    _close(d, jd, rel)
    assert int((d == 0).sum()) == int((np.asarray(jd) == 0).sum())
    _close(bp.apply_dinv_batched(t["u"], d),
           jax_bp.apply_dinv_batched(j["u"], jd), rel)
    pairs = ((t["u"], t["v"]), (t["w"], t["w"]))
    got = bp.lane_dots(*pairs)
    want = jax_bp.lane_dots((j["u"], j["v"]), (j["w"], j["w"]))
    assert got.shape == (2, lanes)
    if dtype == torch.float64:
        _close(got, want, rel)
    else:
        _close_sums(got, want, pairs)


# -- K-e and K-f: the plain versions -------------------------------------------


def _kernel_inputs(seed, lanes=3):
    problem = Problem(M=44, N=132)
    a, b, _ = jax_assembly.assemble(_jax_problem(problem), jnp.float32)
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((lanes,) + problem.node_shape)
              .astype(np.float32) for _ in range(6)]
    ta, tb = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    return problem, (a, b), (ta, tb), arrays


@pytest.mark.parametrize("form", ["full", "block"])
def test_ke_plain_matches_the_batched_pallas_stencil(form):
    problem, (a, b), (ta, tb), arrays = _kernel_inputs(seed=5)
    w = arrays[0]
    h1, h2 = problem.h1, problem.h2
    if form == "full":
        want = jax_pk.apply_a_batched_pallas(jnp.asarray(w), a, b, h1, h2,
                                             interpret=True)
        kernel, single = hk.apply_a_batched_kernel, hk.apply_a_plain
    else:
        want = jax_pk.apply_a_batched_block_pallas(jnp.asarray(w), a, b, h1,
                                                   h2, interpret=True)
        kernel, single = (hk.apply_a_batched_block_kernel,
                          hk.apply_a_block_plain)
    _build.reset_launches()
    got = kernel(torch.from_numpy(w), ta, tb, h1, h2)
    assert sum(_build.LAUNCHES.values()) == 0  # the CPU runs the plain form
    assert got.shape == np.asarray(want).shape
    _close(got, want, 1e-6)
    # each lane is K-a's plain version on that lane, bit for bit
    for lane in range(w.shape[0]):
        assert torch.equal(got[lane], single(torch.from_numpy(w[lane]), ta,
                                             tb, h1, h2))


def test_kf_plain_matches_the_batched_pallas_stencil_dots():
    problem, (a, b), (ta, tb), arrays = _kernel_inputs(seed=6)
    m, r, u, w, s, p = arrays
    for x in arrays:  # operands are zero on the ring in the solvers
        x[:, 0] = x[:, -1] = 0.0
        x[:, :, 0] = x[:, :, -1] = 0.0
    tpairs = bpp._bundle(*(torch.from_numpy(x) for x in (r, u, w, s, p)))
    jpairs = bpp._bundle(*(jnp.asarray(x) for x in (r, u, w, s, p)))
    h1, h2 = problem.h1, problem.h2
    n_ref, sums_ref = jax_pk.apply_a_dots_batched_pallas(
        jnp.asarray(m), a, b, h1, h2, jpairs, interpret=True)
    _build.reset_launches()
    n, sums = hk.apply_a_dots_batched_kernel(torch.from_numpy(m), ta, tb, h1,
                                             h2, tpairs)
    assert sum(_build.LAUNCHES.values()) == 0
    assert sums.shape == (8, 3) and sums.dtype == torch.float32
    _close(n, n_ref, 1e-6)
    _close_sums(sums, sums_ref, tpairs)
    # n is K-e's plain version; sums[:, l] is K-d's plain version on lane l
    assert torch.equal(n, hk.apply_a_batched_plain(torch.from_numpy(m), ta,
                                                   tb, h1, h2))
    for lane in range(3):
        _, single = hk.apply_a_dots_plain(
            torch.from_numpy(m[lane]), ta, tb, h1, h2,
            tuple((x[lane], y[lane]) for x, y in tpairs))
        assert torch.equal(sums[:, lane], single)


def test_batched_dots_reject_zero_pairs():
    _, _, (ta, tb), arrays = _kernel_inputs(seed=7)
    m = torch.from_numpy(arrays[0])
    with pytest.raises(ValueError, match="pair"):
        hk.apply_a_dots_batched_kernel(m, ta, tb, 0.1, 0.1, ())
    with pytest.raises(ValueError, match="pair"):
        hk.apply_a_dots_batched_plain(m, ta, tb, 0.1, 0.1, ())


# -- the engines against the JAX package ----------------------------------------


@pytest.mark.parametrize("engine_name", list(MODULES))
@pytest.mark.parametrize("M,N,dtype,stencil,atol", [
    (40, 40, torch.float64, "xla", 1e-12),
    (24, 36, torch.float64, "xla", 1e-12),
    (40, 40, torch.float32, "xla", 5e-6),
    (40, 40, torch.float32, "pallas", 5e-6),
])
def test_engines_match_jax_with_distinct_lanes(engine_name, M, N, dtype,
                                               stencil, atol):
    ours_mod, jax_mod = MODULES[engine_name]
    problem = Problem(M=M, N=N)
    ours, theirs = _operands(problem, 3, dtype)
    run = (ours_mod.pcg_batched if engine_name == "batched"
           else ours_mod.pcg_batched_pipelined)
    jrun = (jax_mod.pcg_batched if engine_name == "batched"
            else jax_mod.pcg_batched_pipelined)
    got = run(problem, *ours, stencil=stencil)
    ref = jrun(_jax_problem(problem), *theirs, stencil=stencil,
               interpret=True)
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.converged.all() and not got.breakdown.any()
    assert not got.quarantined.any()
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("engine_name", list(MODULES))
def test_f32_general_grid_classical_counts_and_pipelined_band(engine_name):
    """44×132 f32 with distinct lanes: the classical engine within 5e-6 of
    the JAX one, the pipelined one within ±2 iterations of it."""
    problem = Problem(M=44, N=132)
    ours, theirs = _operands(problem, 3, torch.float32, seed=2)
    ours_mod, jax_mod = MODULES[engine_name]
    if engine_name == "batched":
        got = ours_mod.pcg_batched(problem, *ours)
        ref = jax_mod.pcg_batched(_jax_problem(problem), *theirs)
        assert got.iters.tolist() == np.asarray(ref.iters).tolist()
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                                   atol=5e-6)
    else:
        got = ours_mod.pcg_batched_pipelined(problem, *ours)
        ref = jax_mod.pcg_batched_pipelined(_jax_problem(problem), *theirs)
        assert np.all(np.abs(got.iters.numpy()
                             - np.asarray(ref.iters)) <= 2)
    assert got.converged.all()


@pytest.mark.parametrize("engine_name", list(MODULES))
def test_lane_is_bitwise_the_single_solve_on_the_cpu(engine_name):
    """On the CPU the per-lane sums add in the order of the single
    engine's whole-grid sum, so each lane of a batch of identical lanes is
    the single solve to the bit (on the card that is measured, not
    promised)."""
    problem = Problem(M=40, N=40)
    single = engine.solve(problem, "xla" if engine_name == "batched"
                          else "pipelined", torch.float32, device="cpu")
    solver, args, resolved = engine.build_solver(
        problem, engine_name, torch.float32, "cpu", lanes=3)
    got = solver(*args)
    assert resolved == engine_name
    assert got.iters.tolist() == [int(single.iters)] * 3 == [50] * 3
    for lane in range(3):
        assert torch.equal(got.w[lane], single.w)
        assert got.diff[lane].item() == single.diff.item()


def test_mixed_eps_operands_equal_jax_and_lanes_hit_their_counts():
    base = Problem(M=32, N=32)
    eps_values = (base.eps_value, 1e-2, 1e-4)
    for dtype in (torch.float64, torch.float32):
        ours = bp.batched_operands(base, 3, dtype, "cpu",
                                   eps_values=eps_values)
        theirs = jax_bp.batched_operands(_jax_problem(base), 3,
                                         JAX_DTYPE[dtype],
                                         eps_values=eps_values)
        assert ours[0].dim() == 3
        for x, y in zip(ours, theirs):
            assert np.array_equal(x.numpy(), np.asarray(y))
    got = bp.pcg_batched(base, *ours)
    assert got.converged.all()
    for lane, eps in enumerate(eps_values):
        single = engine.solve(Problem(M=32, N=32, eps=eps), "xla",
                              torch.float32, device="cpu")
        assert abs(int(got.iters[lane]) - int(single.iters)) <= 2
    with pytest.raises(ValueError, match="entries"):
        bp.batched_operands(base, 2, eps_values=eps_values, device="cpu")


def test_batched_operands_materialise_the_tiled_rhs():
    a, b, rhs = bp.batched_operands(Problem(M=10, N=12), 3, torch.float32,
                                    "cpu")
    assert a.shape == (11, 13) and rhs.shape == (3, 11, 13)
    assert rhs.is_contiguous() and rhs.stride()[0] == 11 * 13
    rhs[1] += 1.0  # an in-place update of one lane leaves the others
    assert torch.equal(rhs[0], rhs[2]) and not torch.equal(rhs[0], rhs[1])


def _embedded(lanes_problems, bucket: Problem, dtype):
    """Per-lane (a, b, rhs, mask) of ``lanes_problems`` zero-padded into the
    bucket's node grid, as numpy f64 arrays."""
    g = bucket.node_shape
    out = {k: np.zeros((len(lanes_problems),) + g)
           for k in ("a", "b", "rhs", "mask")}
    for lane, p in enumerate(lanes_problems):
        a, b, rhs = jax_assembly.assemble_numpy(_jax_problem(p))
        m1, n1 = p.node_shape
        out["a"][lane, :m1, :n1] = a
        out["b"][lane, :m1, :n1] = b
        out["rhs"][lane, :m1, :n1] = rhs
        out["mask"][lane, 1:p.M, 1:p.N] = 1.0
    return out


@pytest.mark.parametrize("engine_name", list(MODULES))
def test_mask_embedded_lanes_with_per_lane_h_and_delta_match_jax(
        engine_name):
    """Two problems of other sizes in one 24×36 bucket: per-lane (a, b),
    mask, h1, h2 and δ through ``advance``; the JAX ``advance`` with the
    same arguments gives the same counts and w (f64)."""
    bucket = Problem(M=24, N=36)
    lanes_problems = (Problem(M=24, N=36), Problem(M=18, N=30, delta=1e-7))
    ops = _embedded(lanes_problems, bucket, torch.float64)
    h1 = np.array([p.h1 for p in lanes_problems])
    h2 = np.array([p.h2 for p in lanes_problems])
    delta = np.array([p.delta for p in lanes_problems])
    t = {k: torch.from_numpy(x) for k, x in ops.items()}
    j = {k: jnp.asarray(x) for k, x in ops.items()}
    ours_mod, jax_mod = MODULES[engine_name]
    state = ours_mod.init_state(bucket, t["a"], t["b"], t["rhs"],
                                mask=t["mask"], h1=torch.from_numpy(h1),
                                h2=torch.from_numpy(h2))
    got, _ = ours_mod.advance(bucket, t["a"], t["b"], t["rhs"], state,
                              mask=t["mask"], h1=torch.from_numpy(h1),
                              h2=torch.from_numpy(h2),
                              delta=torch.from_numpy(delta))
    jp = _jax_problem(bucket)
    jstate = jax_mod.init_state(jp, j["a"], j["b"], j["rhs"], mask=j["mask"],
                                h1=jnp.asarray(h1), h2=jnp.asarray(h2))
    ref = jax_mod.advance(jp, j["a"], j["b"], j["rhs"], jstate,
                          mask=j["mask"], h1=jnp.asarray(h1),
                          h2=jnp.asarray(h2), delta=jnp.asarray(delta))
    got, ref = ours_mod.result_of(got), jax_mod.result_of(ref)
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.converged.all()
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-12)
    # outside each embedded interior w stays exactly zero
    assert not (got.w * (1 - t["mask"])).any()


# -- quarantine, lane independence, chunking ------------------------------------


def _poisoned(problem, lanes, lane, at, engine_name="batched"):
    """The port's carry advanced to ``at``, with lane ``lane``'s r set to
    NaN (what ``inject_nan(at, "r", lane=lane)`` does to the JAX carry)."""
    mod = MODULES[engine_name.removesuffix("-pallas")][0]
    a, b, rhs = bp.batched_operands(problem, lanes, torch.float32, "cpu")
    state, _ = mod.advance(problem, a, b, rhs,
                           mod.init_state(problem, a, b, rhs), limit=at)
    r = state.r.clone()
    r[lane] = float("nan")
    return (a, b, rhs), state._replace(r=r)


def test_nan_lane_quarantine_matches_jax():
    problem = Problem(M=40, N=40)
    ref = jax_solve_batched(_jax_problem(problem), 3, "batched", jnp.float32,
                            chunk=16,
                            faults=FaultPlan(inject_nan(10, "r", lane=1)))
    ops, state = _poisoned(problem, 3, lane=1, at=10)
    got = driver.solve_batched(problem, 3, "batched", torch.float32,
                               operands=ops, state=state, chunk=16)
    res = got.result
    assert res.quarantined.tolist() == [False, True, False] == list(
        np.asarray(ref.result.quarantined))
    assert res.converged.tolist() == [True, False, True]
    assert res.iters.tolist() == np.asarray(ref.result.iters).tolist()
    assert int(res.iters[1]) == 11
    assert [(e.kind, e.at_iter, e.health, e.detail) for e in got.recoveries] \
        == [(e.kind, e.at_iter, e.health, e.detail)
            for e in ref.recoveries] \
        == [("lane-quarantine", 11, driver.HEALTH_NONFINITE, "lane 1")]
    # the healthy lanes are bitwise those of a clean batch
    clean = driver.solve_batched(problem, 3, "batched", torch.float32,
                                 device="cpu", chunk=16)
    assert clean.recoveries == ()
    for lane in (0, 2):
        assert torch.equal(res.w[lane], clean.result.w[lane])
        assert int(res.iters[lane]) == int(clean.result.iters[lane]) == 50


@pytest.mark.parametrize("engine_name", engine.BATCHED_ENGINES)
def test_lane_independence(engine_name):
    """Lanes 0 and 2 give the same bits whatever lane 1 holds: another
    RHS, or a NaN that quarantines it."""
    problem = Problem(M=24, N=36)
    runs = []
    for middle in (1.0, 3.0, float("nan")):
        a, b, rhs = bp.batched_operands(problem, 3, torch.float32, "cpu")
        rhs[1] *= middle
        rhs[2] *= 0.5
        solver, _, _ = engine.build_solver(problem, engine_name,
                                           torch.float32, "cpu", lanes=3)
        runs.append(solver(a, b, rhs))
    assert runs[2].quarantined.tolist() == [False, True, False]
    assert int(runs[2].iters[1]) == 1
    for other in runs[1:]:
        for lane in (0, 2):
            assert torch.equal(other.w[lane], runs[0].w[lane])
            assert int(other.iters[lane]) == int(runs[0].iters[lane])
            assert other.diff[lane].item() == runs[0].diff[lane].item()


@pytest.mark.parametrize("engine_name", engine.BATCHED_ENGINES)
def test_chunked_equals_straight_bitwise(engine_name):
    """Limits across the replacement iteration k = 32 and a chunk of 5
    give the straight run's bits in every field; bodies issued past the
    last lane's exit change nothing."""
    problem = Problem(M=24, N=36)
    mod = MODULES[engine_name.removesuffix("-pallas")][0]
    stencil = "pallas" if engine_name.endswith("pallas") else "xla"
    ops, _ = _operands(problem, 3, torch.float32, seed=4)
    extra = {"stencil": stencil} if mod is bpp else {}
    init = mod.init_state(problem, *ops, **extra)
    straight, _ = mod.advance(problem, *ops, init, stencil=stencil)
    state = init
    for limit in (3, 32, 33, 50, None):
        state, _ = mod.advance(problem, *ops, state, limit=limit,
                               stencil=stencil, chunk=5)
    for name, x, y in zip(type(init)._fields, straight, state):
        assert torch.equal(x, y), name
    assert int(state.k) == int(state.iters.max())
    again, _ = mod.advance(problem, *ops, state, stencil=stencil, chunk=7)
    for name, x, y in zip(type(init)._fields, state, again):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("engine_name", list(MODULES))
def test_jax_carry_resumed_in_the_port(engine_name):
    """A JAX batched carry at k = 32, carried over by ``interop`` and
    advanced by the port, ends where the JAX straight run ends (f64)."""
    problem = Problem(M=40, N=40)
    ours, theirs = _operands(problem, 2, torch.float64, seed=3)
    ours_mod, jax_mod = MODULES[engine_name]
    jp = _jax_problem(problem)
    half = jax_mod.advance(jp, *theirs, jax_mod.init_state(jp, *theirs),
                           limit=32)
    straight = jax_mod.result_of(
        jax_mod.advance(jp, *theirs, jax_mod.init_state(jp, *theirs)))
    state = interop.batched_state_from_reference(
        problem, [np.asarray(x) for x in half], engine_name, device="cpu")
    assert int(state.k) == 32 and state.iters.dtype == torch.int32
    assert state.converged.shape == (2,) and state.converged.dtype == \
        torch.bool
    got, _ = ours_mod.advance(problem, *ours, state)
    got = ours_mod.result_of(got)
    assert got.iters.tolist() == np.asarray(straight.iters).tolist()
    assert got.converged.tolist() == list(np.asarray(straight.converged))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(straight.w),
                               rtol=0, atol=1e-12)


def test_batched_state_from_reference_checks_its_input():
    problem = Problem(M=4, N=4)
    carry = [0] + [np.zeros((2, 5, 5))] * 3 + [np.ones(2), np.full(2, np.inf)] \
        + [np.zeros(2, bool)] * 3 + [np.zeros(2, np.int32)]
    st = interop.batched_state_from_reference(problem, carry, "batched-pallas",
                                              device="cpu",
                                              dtype=torch.float32)
    assert st.w.shape == (2, 5, 5) and st.w.dtype == torch.float32
    assert st.quarantined.dtype == torch.bool and st.iters.shape == (2,)
    with pytest.raises(ValueError, match="14-field"):
        interop.batched_state_from_reference(problem, carry,
                                             "batched-pipelined",
                                             device="cpu")
    with pytest.raises(ValueError, match="unknown batched engine"):
        interop.batched_state_from_reference(problem, carry, "xla",
                                             device="cpu")
    bad = list(carry)
    bad[1] = np.zeros((2, 6, 5))
    with pytest.raises(ValueError, match="expected"):
        interop.batched_state_from_reference(problem, bad, "batched",
                                             device="cpu")


# -- the entry points ----------------------------------------------------------


def test_cli_lanes_runs_the_batched_engine(capsys):
    assert cli_main(["10", "10", "--lanes", "2", "--device", "cpu",
                     "--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["engine"] == "batched" and d["lanes"] == 2
    assert d["solves_per_sec"] > 0 and d["quarantined"] == 0
    assert d["iters"] == 15 and d["converged"] is True
    assert cli_main(["10", "10", "--lanes", "2", "--engine", "xla",
                     "--device", "cpu"]) == 2
    assert "runs one solve per dispatch" in capsys.readouterr().err


def test_batched_report_has_the_jax_keys():
    jax_keys = set(jax_run_once(JaxProblem(M=10, N=10), mode="single",
                                dtype="f32", lanes=2).json_dict())
    report = run_once(Problem(M=10, N=10), engine="batched-pipelined",
                      lanes=3, device="cpu")
    d = report.json_dict()
    assert set(d) == jax_keys
    assert d["lanes"] == 3 and d["iters"] == 15
    assert d["solves_per_sec"] == pytest.approx(3 / report.t_solver)
    assert d["passes_per_iter"] == 0.0 and d["hbm_gbps"] is None
    assert "Lanes: 3" in report.summary()
    # a one-lane run carries no lane keys
    single = run_once(Problem(M=10, N=10), engine="batched", device="cpu")
    assert "lanes" not in single.json_dict()


def test_build_solver_lane_rules():
    problem = Problem(M=10, N=10)
    with pytest.raises(ValueError, match="runs one solve per dispatch"):
        engine.build_solver(problem, "xla", torch.float32, "cpu", lanes=2)
    # as in JAX, auto with lanes > 1 is the harness's to resolve
    with pytest.raises(ValueError, match="lane-batched engines"):
        engine.build_solver(problem, "auto", torch.float32, "cpu", lanes=2)
    with pytest.raises(ValueError, match="history=True"):
        engine.build_solver(problem, "batched", torch.float32, "cpu",
                            lanes=2, history=True)
    with pytest.raises(ValueError, match="lanes must be >= 1"):
        engine.build_solver(problem, "batched", torch.float32, "cpu",
                            lanes=0)
    for name in ("batched-pallas", "batched-pipelined-pallas"):
        with pytest.raises(ValueError, match="does not run"):
            engine.build_solver(problem, name, torch.float64, "cpu", lanes=2)
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        engine.build_solver(problem, "batched", torch.float32, "cpu",
                            lanes=2, geometry="ellipse")
    assert engine.ENGINE_CAPS["batched-pipelined-pallas"]["kernels"] == (
        hk.BATCHED_KERNEL, hk.BATCHED_DOTS_KERNEL)


@pytest.mark.parametrize("engine_name", list(MODULES))
def test_kernel_forms_reject_what_the_kernels_do_not_take(engine_name):
    problem = Problem(M=20, N=20)
    mod = MODULES[engine_name][0]
    a, b, rhs = bp.batched_operands(problem, 2, torch.float32, "cpu",
                                    eps_values=(0.01, 0.02))
    state = mod.init_state(problem, a, b, rhs)
    with pytest.raises(ValueError, match="lane-shared"):
        mod.advance(problem, a, b, rhs, state, stencil="pallas")
    a, b, rhs = bp.batched_operands(problem, 2, torch.float32, "cpu")
    state = mod.init_state(problem, a, b, rhs)
    with pytest.raises(ValueError, match="compile-time"):
        mod.advance(problem, a, b, rhs, state, stencil="pallas", h1=0.1)
    with pytest.raises(ValueError, match="unknown stencil"):
        mod.advance(problem, a, b, rhs, state, stencil="triton")


def test_solve_batched_contract():
    problem = Problem(M=20, N=20)
    for kw, item in ((dict(faults=object()), "Queue A item 9"),
                     (dict(timeout=1.0), "Queue A item 9")):
        with pytest.raises(NotImplementedError, match=item):
            driver.solve_batched(problem, 2, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown batched engine"):
        driver.solve_batched(problem, 2, "xla", device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        driver.solve_batched(problem, 3, device="cpu",
                             operands=bp.batched_operands(problem, 2,
                                                          device="cpu"))
    # storage_dtype runs on the plain stencil, and K-e (f32) refuses it
    # with the JAX package's error
    narrow = bp.pcg_batched(problem, *bp.batched_operands(problem, 2,
                                                          device="cpu"),
                            storage_dtype=torch.bfloat16)
    assert narrow.w.dtype == torch.bfloat16
    assert bool(narrow.converged.all())
    with pytest.raises(ValueError, match="rides the XLA stencil"):
        bp.pcg_batched(problem, *bp.batched_operands(problem, 2,
                                                     device="cpu"),
                       stencil="pallas", storage_dtype=torch.bfloat16)
    # the chunked driver gives the loop's bits, in every engine
    for name in engine.BATCHED_ENGINES:
        solver, args, _ = engine.build_solver(problem, name, torch.float32,
                                              "cpu", lanes=2)
        want = solver(*args)
        got = driver.solve_batched(problem, 2, name, device="cpu", chunk=9)
        assert got.recoveries == () and got.engine == name
        for x, y in zip(got.result, want):
            assert torch.equal(x, y), name


def test_batched_launchers_match_their_c_prototypes():
    """The ctypes argument lists of K-e's and K-f's launchers are their C
    prototypes', argument for argument."""
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    for library, symbol, table in (
            (hk.KERNEL, "pe_batched_stencil_f32", hk._SIGNATURES),
            (hk.DOTS_KERNEL, "pe_batched_stencil_dots_f32",
             hk._DOTS_SIGNATURES)):
        source = _build.source_path(library).read_text()
        match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
        assert match, symbol
        kinds = []
        for param in match.group(1).split(","):
            param = " ".join(param.split())
            kinds.append("ptr" if "*" in param
                         else param.rsplit(" ", 1)[0].removeprefix("const "))
        assert [names[t] for t in table[symbol][1]] == kinds, symbol
