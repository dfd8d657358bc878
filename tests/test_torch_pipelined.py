"""The port's pipelined recurrence and K-d's plain version against the JAX
package, on the CPU.

- ``pipelined`` in f64: the JAX ``pcg_pipelined``'s iteration counts,
  within ±2 of the reference's, and w within 1e-12.
- ``pipelined`` and ``pipelined-pallas`` in f32 at 44×132 against the JAX
  engine with ``stencil="xla"`` and ``stencil="pallas"`` (its Pallas
  kernels in interpret mode): counts within ±2 (equal is expected), w
  within 5e-5 of its scale. The recurrence carries its f32 round-off
  from one iteration to the next, so sum order and XLA's FMA contraction
  show: the JAX engine's own two flavours differ by 2.5e-5 of w's scale
  there (the port: 1.8e-5 and 2.3e-5 from them, ROADMAP Queue C), and
  its f32 run differs from its f64 run by 4.5e-5.
- The chunked loop: any chunk and any sequence of limits give the bits of
  one straight run in every field of the carry, across the replacement
  iteration too.
- A JAX carry taken at k = 32 and advanced by the port to the end equals
  the JAX straight run: the same count and flags, x within 1e-12 (f64).
- K-d's plain version against ``apply_a_dots_pallas`` (interpret): n
  within 1e-6 of its scale (XLA on the CPU may contract a*b+c into an
  FMA, ROADMAP Queue C), sums within rel 2e-5 (the Pallas kernel sums in
  f32, the plain version in double).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import pallas_kernels as jax_pk
from poisson_ellipse_tpu.ops import pipelined_pcg as jax_pp
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

UNWEIGHTED = {(10, 10): 17, (20, 20): 31, (40, 40): 61}
WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}
ORACLE_CASES = ([(m, n, "unweighted", k) for (m, n), k in UNWEIGHTED.items()]
                + [(m, n, "weighted", k) for (m, n), k in WEIGHTED.items()])



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
    """The port's (a, b, rhs) on the CPU and the JAX package's, both
    rounded once from the same f64 host assembly."""
    jp = JaxProblem(M=problem.M, N=problem.N, norm=problem.norm,
                    delta=problem.delta, max_iter=problem.max_iter)
    a, b, rhs = jax_assembly.assemble_numpy(jp)
    ours = interop.operands_from_reference(problem, a, b, rhs, device="cpu",
                                           dtype=dtype)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return jp, ours, tuple(jnp.asarray(x, jdtype) for x in (a, b, rhs))


@pytest.mark.parametrize("M,N,norm,want", ORACLE_CASES)
def test_f64_counts_and_w_match_jax_pipelined(M, N, norm, want):
    problem = Problem(M=M, N=N, norm=norm)
    jp, ours, theirs = _operands(problem)
    got = pp.pcg_pipelined(problem, *ours)
    ref = jax_pp.pcg_pipelined(jp, *theirs)
    assert int(got.iters) == int(ref.iters)
    assert abs(int(got.iters) - want) <= 2
    assert bool(got.converged) and not bool(got.breakdown)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-12)
    assert float(got.diff) == pytest.approx(float(ref.diff), rel=1e-9)


@pytest.mark.parametrize("engine_name,stencil", [("pipelined", "xla"),
                                                 ("pipelined-pallas",
                                                  "pallas")])
def test_f32_general_grid_matches_jax(engine_name, stencil):
    problem = Problem(M=44, N=132)
    got = engine.solve(problem, engine_name, torch.float32, device="cpu")
    ref = jax_pp.solve(JaxProblem(M=44, N=132), jnp.float32, stencil=stencil,
                       interpret=True)
    assert abs(int(got.iters) - int(ref.iters)) <= 2
    assert bool(got.converged) and not bool(got.breakdown)
    want = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), want, rtol=0,
                               atol=5e-5 * np.abs(want).max())


def test_headline_grid_f32():
    """546 ± 2 at 400×600 f32, where the residual replacement is
    load-bearing (the JAX engine breaks down without it)."""
    problem = Problem(M=400, N=600)
    got = engine.solve(problem, "pipelined", torch.float32, device="cpu")
    assert bool(got.converged) and not bool(got.breakdown)
    assert abs(int(got.iters) - 546) <= 2
    assert float(l2_error_vs_analytic(problem, got.w)) < 1e-3


@pytest.mark.parametrize("stencil", ["xla", "pallas"])
def test_zero_coefficients_break_down_at_iteration_one(stencil):
    """A zero operator makes the α-denominator 0: the loop exits on the
    breakdown flag after one iteration with the update discarded, as the
    JAX engine does."""
    problem = Problem(M=10, N=10)
    jp, (a, b, rhs), (_, _, jrhs) = _operands(problem, torch.float32)
    zeros = torch.zeros_like(rhs)
    got = pp.pcg_pipelined(problem, zeros, zeros, rhs, stencil=stencil)
    jzeros = jnp.zeros_like(jrhs)
    ref = jax_pp.pcg_pipelined(jp, jzeros, jzeros, jrhs, stencil=stencil,
                               interpret=True)
    assert bool(got.breakdown) and bool(ref.breakdown)
    assert not bool(got.converged)
    assert int(got.iters) == int(ref.iters) == 1
    assert not got.w.any()
    assert float(got.diff) == float("inf")


@pytest.mark.parametrize("M,N,limits", [(20, 20, (3, 7, 11, 200)),
                                        (40, 40, (32, 33, 200))])
@pytest.mark.parametrize("stencil", ["xla", "pallas"])
def test_chunked_advance_equals_straight_run(M, N, limits, stencil):
    """Advancing in limits, and with any chunk, gives the straight run's
    bits in all twelve fields, including a boundary on the replacement
    iteration k = 32."""
    problem = Problem(M=M, N=N)
    _, (a, b, rhs), _ = _operands(problem)
    init = pp.init_state(problem, a, b, rhs, stencil=stencil)
    straight, _ = pp.advance(problem, a, b, rhs, init, stencil=stencil)
    state = init
    for limit in limits:
        state, _ = pp.advance(problem, a, b, rhs, state, limit=limit,
                              stencil=stencil, chunk=5)
        if not bool(state.converged):
            assert int(state.k) == limit
    assert int(straight.k) == WEIGHTED.get((M, N), int(straight.k))
    for name, x, y in zip(pp.PipelinedState._fields, straight, state):
        assert torch.equal(x, y), name
    # bodies issued past the exit change nothing
    again, _ = pp.advance(problem, a, b, rhs, state, stencil=stencil)
    for name, x, y in zip(pp.PipelinedState._fields, state, again):
        assert torch.equal(x, y), name


def test_jax_carry_resumed_in_the_port():
    """A JAX carry at k = 32, carried over by ``interop`` and advanced by
    the port, ends where the JAX straight run ends (60² f64: 73
    iterations, so the port runs one replacement, at k = 64)."""
    problem = Problem(M=60, N=60)
    jp, ours, theirs = _operands(problem)
    half = jax_pp.advance(jp, *theirs, jax_pp.init_state(jp, *theirs),
                          limit=32)
    straight = jax_pp.advance(jp, *theirs, jax_pp.init_state(jp, *theirs))
    state = interop.pipelined_state_from_reference(
        problem, [np.asarray(x) for x in half], device="cpu")
    assert int(state.k) == 32 and state.x.dtype == torch.float64
    got, _ = pp.advance(problem, *ours, state)
    assert int(got.k) == int(straight[0]) > 64
    fields = dict(zip(pp.PipelinedState._fields, straight))
    for name in ("k", "converged", "breakdown"):
        assert getattr(got, name).item() == fields[name].item(), name
    # the iterate and the preconditioned-space vectors to 1e-12 (their
    # gap is 5e-16); the images under A (r, w, z, s) to 1e-9 of their
    # scale, as the stiff 1/eps operator amplifies an ulp of x (their gap
    # is ~1e-10 of scale); the scalars to rel 1e-9
    for name in ("x", "u", "p"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(fields[name]), rtol=0,
                                   atol=1e-12, err_msg=name)
    for name in ("r", "w", "z", "s"):
        want = np.asarray(fields[name])
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max(),
                                   err_msg=name)
    for name in ("gamma_prev", "diff"):
        assert getattr(got, name).item() == pytest.approx(
            float(fields[name]), rel=1e-9), name


def test_pipelined_state_from_reference_checks_its_input():
    problem = Problem(M=4, N=4)
    ok = [0] + [np.zeros((5, 5))] * 7 + [1.0, np.inf, False, False]
    st = interop.pipelined_state_from_reference(problem, ok, device="cpu",
                                                dtype=torch.float32)
    assert st.k.dtype == torch.int32 and st.converged.dtype == torch.bool
    assert st.x.dtype == torch.float32 and st.gamma_prev.dtype == torch.float32
    with pytest.raises(ValueError, match="12-field"):
        interop.pipelined_state_from_reference(problem, ok[:8], device="cpu")
    bad = list(ok)
    bad[2] = np.zeros((6, 5))
    with pytest.raises(ValueError, match="expected"):
        interop.pipelined_state_from_reference(problem, bad, device="cpu")


# -- K-d's plain version ------------------------------------------------------


def _kd_inputs(seed=3):
    problem = Problem(M=44, N=132)
    jp = JaxProblem(M=44, N=132)
    a, b, _ = jax_assembly.assemble(jp, jnp.float32)
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(problem.node_shape).astype(np.float32)
              for _ in range(6)]
    ta, tb = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    return problem, (a, b), (ta, tb), arrays


def _close_sums(got, want, pairs, rtol=2e-5):
    """Each sum within rtol of Σ|x·y| over the interior: the Pallas
    kernel's f32 running sum errs in proportion to that, not to |Σ x·y|,
    which cancels for some random pairs (the plain version sums in double
    and rounds once)."""
    want = np.asarray(want, dtype=np.float64)
    for j, (x, y) in enumerate(pairs):
        mag = float((x * y).abs().double().sum())
        assert abs(float(got[j]) - want[j]) <= rtol * mag, (j, got[j], want[j])


def _bundle_and_aliases(m, r, u, w, s, p):
    return {
        "bundle": pp._bundle(r, u, w, s, p),
        # tests/test_pipelined.py's aliasing pairs
        "aliases": ((r, u), (w, u), (u, u), (u, p), (p, p)),
    }


@pytest.mark.parametrize("which", ["bundle", "aliases"])
def test_kd_plain_matches_apply_a_dots_pallas(which):
    problem, (a, b), (ta, tb), arrays = _kd_inputs()
    jpairs = _bundle_and_aliases(*(jnp.asarray(x) for x in arrays))[which]
    tpairs = _bundle_and_aliases(*(torch.from_numpy(x)
                                   for x in arrays))[which]
    m = arrays[0]
    n_ref, sums_ref = jax_pk.apply_a_dots_pallas(
        jnp.asarray(m), a, b, problem.h1, problem.h2, jpairs, interpret=True)
    _build.reset_launches()
    n, sums = hk.apply_a_dots_kernel(torch.from_numpy(m), ta, tb, problem.h1,
                                     problem.h2, tpairs)
    assert sum(_build.LAUNCHES.values()) == 0  # the CPU runs the plain form
    n_ref = np.asarray(n_ref)
    np.testing.assert_allclose(n.numpy(), n_ref, rtol=0,
                               atol=1e-6 * np.abs(n_ref).max())
    assert not n[0].any() and not n[-1].any()
    assert not n[:, 0].any() and not n[:, -1].any()
    assert sums.dtype == torch.float32 and sums.shape == (len(tpairs),)
    _close_sums(sums, sums_ref, tuple((x[1:-1, 1:-1], y[1:-1, 1:-1])
                                      for x, y in tpairs))
    # the stencil is K-a's plain version, bit for bit
    assert torch.equal(n, hk.apply_a_plain(torch.from_numpy(m), ta, tb,
                                           problem.h1, problem.h2))


def test_kd_block_form_matches_apply_a_block_dots_pallas():
    problem, (a, b), (ta, tb), arrays = _kd_inputs(seed=4)
    m, x, y = arrays[:3]
    crop = (slice(1, -1), slice(1, -1))
    jpairs = ((jnp.asarray(x[crop]), jnp.asarray(y[crop])),
              (jnp.asarray(y[crop]), jnp.asarray(y[crop])))
    tx, ty = torch.from_numpy(x[crop].copy()), torch.from_numpy(y[crop].copy())
    n_ref, sums_ref = jax_pk.apply_a_block_dots_pallas(
        jnp.asarray(m), a, b, problem.h1, problem.h2, jpairs, interpret=True)
    n, sums = hk.apply_a_block_dots_kernel(torch.from_numpy(m), ta, tb,
                                           problem.h1, problem.h2,
                                           ((tx, ty), (ty, ty)))
    n_ref = np.asarray(n_ref)
    assert n.shape == (problem.M - 1, problem.N - 1)
    np.testing.assert_allclose(n.numpy(), n_ref, rtol=0,
                               atol=1e-6 * np.abs(n_ref).max())
    _close_sums(sums, sums_ref, ((tx, ty), (ty, ty)))


def test_kd_sums_are_rounded_once_from_double():
    rng = np.random.default_rng(8)
    x, y = (torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32))
            for _ in range(2))
    want = np.float32(np.sum((x * y).numpy().astype(np.float64)))
    assert hk.dot_sums_plain(((x, y),)).item() == want


@pytest.mark.parametrize("call", [hk.apply_a_dots_kernel,
                                  hk.apply_a_block_dots_kernel,
                                  hk.apply_a_dots_plain,
                                  hk.apply_a_block_dots_plain])
def test_kd_rejects_zero_pairs(call):
    _, _, (ta, tb), arrays = _kd_inputs()
    with pytest.raises(ValueError, match="pair"):
        call(torch.from_numpy(arrays[0]), ta, tb, 0.1, 0.1, ())


def test_distinct_operands_dedupes_by_identity():
    u, p, r = (torch.zeros(3, 3) for _ in range(3))
    ops, xs, ys = hk.distinct_operands(((r, u), (u, u), (u, p), (p, p)))
    assert len(ops) == 3 and ops[0] is r and ops[1] is u and ops[2] is p
    assert xs == [0, 1, 1, 2] and ys == [1, 1, 2, 2]
    # the bundle of the pipelined loop has five distinct vectors
    vecs = [torch.zeros(2, 2) for _ in range(5)]
    ops, _, _ = hk.distinct_operands(pp._bundle(*vecs))
    assert len(ops) == 5


def _c_kinds(library: str, symbol: str) -> list:
    """The parameter kinds ("ptr", "int", "float") of ``symbol``'s C
    prototype in ``csrc/<library>.cu``."""
    source = _build.source_path(library).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in {library}.cu"
    kinds = []
    for param in match.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("ptr" if "*" in param
                     else param.rsplit(" ", 1)[0].removeprefix("const "))
    return kinds


@pytest.mark.parametrize("library,signatures", [
    (hk.KERNEL, hk._SIGNATURES), (hk.DOTS_KERNEL, hk._DOTS_SIGNATURES),
    (fs.LIBRARY, fs._SIGNATURES)])
def test_launcher_signatures_match_the_c_prototypes(library, signatures):
    """Each ctypes argument list of K-a's and K-d's libraries, and of the
    mesh's K1-shard / K2-shard, is its C prototype's, argument for
    argument: a mismatch is no error to ctypes and only misreads arguments
    on the card."""
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    # the storage axis's entries (K-g, K-h) and the bf16 forms of K-a and
    # K-d are in the tables too
    mixed = {hk.KERNEL: {f"pe_stencil_mixed_{w}_{ab}" for ab in
                         ("bf16", "f16") for w in (ab, "f32")}
             | {"pe_stencil_bf16"},
             hk.DOTS_KERNEL: {"pe_stencil_dots_mixed_bf16",
                              "pe_stencil_dots_mixed_f16",
                              "pe_stencil_dots_bf16"}}.get(library, set())
    assert mixed <= set(signatures)
    for symbol, (restype, argtypes) in signatures.items():
        if restype is not ctypes.c_int:
            continue  # the error-string functions
        assert [names[t] for t in argtypes] == _c_kinds(library, symbol), \
            symbol
