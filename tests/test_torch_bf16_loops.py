"""bf16 compute on the single-device kernel loops against the JAX package,
on the CPU: ``pallas``, ``pipelined``, ``pipelined-pallas``, ``sstep`` and
``sstep-pallas`` at ``dtype=torch.bfloat16``, and the bf16 forms of K-a
and K-d that their ``-pallas`` forms run.

The JAX engines run as the JAX package's own tests run them (Pallas in
interpret mode). What holds, and why:

- The bf16 forms compute in float on the exactly widened inputs and round
  once where they store, as the bf16 whole-solve forms do
  (``ops.whole_solve.rounder``); the JAX kernels in interpret mode round
  every operation in bf16. So K-a's bf16 plain version is bitwise the JAX
  kernel on about half the nodes, and within 2⁻⁵ of the stencil's term
  magnitude Σ|coefficient·difference|/h² everywhere (measured: 2⁻⁶·²); K-d's
  n likewise, and its sums within 2⁻⁸ of Σ|x·y| (one bf16 rounding).
- The plain bodies are the JAX package's: started from one JAX bf16
  carry (``interop``), one body of ``pipelined`` and one block of
  ``sstep`` give its bits in every field, and one body of the classical
  loop too, but for the step norm, within one bf16 ulp. The ``-pallas``
  bodies differ from JAX's only through the stencil: ``pallas`` and
  ``pipelined-pallas`` keep every array within 2⁻⁵ of its scale over one
  body; in ``sstep-pallas`` the monomial basis amplifies the stencil's
  rounding gap (r moves by its own scale over one block), so only the
  iteration count and flags are held there.
- The counts: bf16 ``pallas`` within ±3 (``ITERS_BAND``) of JAX's 32 at
  40² and 77 at 44×132, δ = 1e-4 (equal, measured). The recurrences at
  40² give JAX's (iterations, converged, breakdown): all four run to the
  cap, 1521, neither converged nor broken down. Where JAX's ``sstep`` and
  ``sstep-pallas`` w turns NaN, the port's stays finite with a step norm
  near 1e26 (ROADMAP Queue C); the port adds no NaN check the JAX package
  lacks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import pallas_kernels as pk
from poisson_ellipse_tpu.ops import pipelined_pcg as jax_pp
from poisson_ellipse_tpu.ops import sstep_pcg as jax_ss
from poisson_ellipse_tpu.solver import engine as jax_engine
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness import roofline
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.ops import sstep_pcg as ss
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.solver import pcg

jax_pcg = importlib.import_module("poisson_ellipse_tpu.solver.pcg")

BF16 = torch.bfloat16
LOOPS = ("pallas", "pipelined", "pipelined-pallas", "sstep", "sstep-pallas")
ITERS_BAND = 3  # tests/test_engines.py:107, as in tests/test_torch_bf16.py
# the stencil's gap to the per-operation JAX kernel, in units of its term
# magnitude; a -pallas body's gap to JAX's, in units of each array's scale
TERM_TOL = 2.0**-5
BODY_TOL = 2.0**-5
# the JAX package's (iterations, converged, breakdown) at 40², δ = 1e-4
JAX_40 = {"pallas": (32, True, False), "pipelined": (1521, False, False),
          "pipelined-pallas": (1521, False, False),
          "sstep": (1521, False, False), "sstep-pallas": (1521, False, False)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test: the thread count orders the bf16 loop's
    ``torch.sum``, and so moves its chaotic count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int16)


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _port(x) -> torch.Tensor:
    return interop.tensor_from_numpy(np.asarray(x))


def _terms(w, a, b, h1, h2) -> torch.Tensor:
    """Σ|coefficient·difference|/h² at each owned node of a block: the
    magnitude of the stencil's terms, which its rounding gap scales with."""
    w, a, b = (x.double() for x in (w, a, b))
    h1, h2 = (float(torch.tensor(h, dtype=BF16)) for h in (h1, h2))
    wc = w[1:-1, 1:-1]
    return (((a[2:, 1:-1] * (w[2:, 1:-1] - wc)).abs()
             + (a[1:-1, 1:-1] * (wc - w[:-2, 1:-1])).abs()) / h1**2
            + ((b[1:-1, 2:] * (w[1:-1, 2:] - wc)).abs()
               + (b[1:-1, 1:-1] * (wc - w[1:-1, :-2])).abs()) / h2**2)


def _seeded_block(bm, bn, seed=7):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((bm + 2, bn + 2))).to(BF16)
    a, b = (torch.from_numpy(rng.random((bm + 2, bn + 2)) + 0.5).to(BF16)
            for _ in range(2))
    return w, a, b


def _assembled_40(seed=7):
    jp = JaxProblem(M=40, N=40)
    a, b, _ = jax_assembly.assemble(jp, jnp.bfloat16)
    a, b = _port(a), _port(b)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal(a.shape)).to(BF16)
    return w, a, b, jp.h1, jp.h2


def _hold_stencil(got, w, a, b, h1, h2):
    want = _port(pk.apply_a_block_pallas(_jax(w), _jax(a), _jax(b), h1, h2))
    assert got.dtype == BF16 and got.shape == want.shape
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= TERM_TOL * _terms(w, a, b, h1, h2)).all())
    # bitwise where the once-rounded tree and the per-operation one agree
    assert float((_bits(got) == _bits(want)).float().mean()) > 0.3


@pytest.mark.parametrize("where", ["24x130", "assembled 40x40"])
def test_ka_bf16_plain_against_jax(where):
    if where == "24x130":
        w, a, b = _seeded_block(24, 130)
        h1, h2 = 0.01, 0.02
    else:
        w, a, b, h1, h2 = _assembled_40()
    got = hk.apply_a_block_kernel(w, a, b, h1, h2)
    _hold_stencil(got, w, a, b, h1, h2)
    # the form's definition: the f32 tree on the widened inputs and the
    # bf16-rounded spacings, rounded once
    hb = [torch.tensor(h, dtype=BF16).float() for h in (h1, h2)]
    from poisson_ellipse_tpu_torch.ops.stencil import apply_a_block

    once = apply_a_block(w.float(), a.float(), b.float(), *hb).to(BF16)
    assert torch.equal(_bits(got), _bits(once))
    full = hk.apply_a_kernel(w, a, b, h1, h2)
    assert torch.equal(_bits(full[1:-1, 1:-1]), _bits(got))
    assert not full[0].float().any() and not full[:, -1].float().any()


@pytest.mark.parametrize("where", ["24x130", "assembled 40x40"])
def test_kd_bf16_plain_against_jax(where):
    if where == "24x130":
        w, a, b = _seeded_block(24, 130)
        h1, h2 = 0.01, 0.02
    else:
        w, a, b, h1, h2 = _assembled_40()
    bm, bn = w.shape[0] - 2, w.shape[1] - 2
    rng = np.random.default_rng(11)
    vecs = [torch.from_numpy(rng.standard_normal((bm, bn))).to(BF16)
            for _ in range(5)]
    pairs = pp._bundle(*vecs)
    n, sums = hk.apply_a_block_dots_kernel(w, a, b, h1, h2, pairs)
    assert n.dtype == sums.dtype == BF16 and sums.shape == (8,)
    assert torch.equal(_bits(n), _bits(hk.apply_a_block_kernel(w, a, b, h1,
                                                               h2)))
    _hold_stencil(n, w, a, b, h1, h2)
    jn, jsums = pk.apply_a_block_dots_pallas(
        _jax(w), _jax(a), _jax(b), h1, h2,
        [(_jax(x), _jax(y)) for x, y in pairs])
    assert torch.equal(_bits(_port(jn)), _bits(_port(
        pk.apply_a_block_pallas(_jax(w), _jax(a), _jax(b), h1, h2))))
    for (x, y), got, want in zip(pairs, sums, _port(jsums)):
        exact = float((x.double() * y.double()).sum())
        magnitude = float((x.double() * y.double()).abs().sum())
        # ours: the exact sum rounded once (through f32) to bf16
        assert float(got) == float(torch.tensor(exact).float().to(BF16))
        assert abs(float(got) - float(want)) <= 2.0**-8 * magnitude


@pytest.mark.parametrize("name", LOOPS)
def test_bf16_loops_take_the_jax_triple_at_40(name):
    problem = Problem(M=40, N=40, delta=1e-4)
    _build.reset_launches()
    got = engine.solve(problem, name, BF16, device="cpu")
    ref = jax_engine.solve(JaxProblem(M=40, N=40, delta=1e-4), name,
                           jnp.bfloat16)
    triple = (int(got.iters), bool(got.converged), bool(got.breakdown))
    assert triple == (int(ref.iters), bool(ref.converged),
                      bool(ref.breakdown)) == JAX_40[name]
    assert got.w.dtype == got.diff.dtype == BF16
    assert sum(_build.LAUNCHES.values()) == 0  # plain versions on the CPU
    jax_finite = bool(np.isfinite(np.asarray(ref.w, np.float32)).all())
    assert jax_finite == (not name.startswith("sstep"))
    # the port's w stays finite where JAX's s-step w is NaN (Queue C)
    assert bool(torch.isfinite(got.w.float()).all())


def test_bf16_pallas_count_at_44x132_is_the_jax_packages():
    problem = Problem(M=44, N=132, delta=1e-4)
    got = engine.solve(problem, "pallas", BF16, device="cpu")
    ref = jax_engine.solve(JaxProblem(M=44, N=132, delta=1e-4), "pallas",
                           jnp.bfloat16)
    assert bool(got.converged) and bool(ref.converged)
    assert int(ref.iters) == 77
    assert abs(int(got.iters) - int(ref.iters)) <= ITERS_BAND


# -- one body from one JAX carry ---------------------------------------------


def _operands():
    problem = Problem(M=40, N=40, delta=1e-4)
    jp = JaxProblem(M=40, N=40, delta=1e-4)
    return (problem, jp, assembly.assemble(problem, BF16, "cpu"),
            jax_assembly.assemble(jp, jnp.bfloat16))


def _hold_body(fields, got, want, stencil, exact_but=()):
    """Every field of the port's carry against JAX's after one body: the
    plain bodies bitwise (``exact_but`` within one bf16 ulp), the -pallas
    bodies' arrays within BODY_TOL of their scale, k and flags equal."""
    for name, x, y in zip(fields, got, want):
        y = _port(y)
        if x.dtype in (torch.int32, torch.bool):
            assert torch.equal(x, y.to(x.dtype)), name
        elif stencil == "xla" and name not in exact_but:
            assert torch.equal(_bits(x), _bits(y)), name
        elif stencil == "xla" or x.dim() == 0:
            ulp = 2.0 ** (np.floor(np.log2(abs(float(y)))) - 7)
            assert abs(float(x) - float(y)) <= ulp, name
        else:
            scale = float(y.double().abs().max())
            assert float((x.double() - y.double()).abs().max()) <= \
                BODY_TOL * scale, name


@pytest.mark.parametrize("stencil", ["xla", "pallas"])
def test_classical_body_is_the_jax_body(stencil):
    problem, jp, ours, theirs = _operands()
    carry = jax_pcg.advance(jp, *theirs, jax_pcg.init_state(jp, *theirs),
                            limit=5, stencil=stencil)
    ref = jax_pcg.advance(jp, *theirs, carry, limit=6, stencil=stencil)
    state = interop.pcg_state_from_reference(
        problem, [np.asarray(x) for x in carry], device="cpu")
    assert state.w.dtype == state.zr.dtype == BF16
    got, _ = pcg.advance(problem, *ours, state, limit=6, stencil=stencil)
    _hold_body(pcg.PCGState._fields, got, ref, stencil, exact_but=("diff",))


@pytest.mark.parametrize("stencil", ["xla", "pallas"])
def test_pipelined_body_is_the_jax_body(stencil):
    problem, jp, ours, theirs = _operands()
    carry = jax_pp.advance(jp, *theirs,
                           jax_pp.init_state(jp, *theirs, stencil=stencil),
                           limit=20, stencil=stencil)
    ref = jax_pp.advance(jp, *theirs, carry, limit=21, stencil=stencil)
    state = interop.pipelined_state_from_reference(
        problem, [np.asarray(x) for x in carry], device="cpu")
    assert state.x.dtype == state.gamma_prev.dtype == BF16
    got, _ = pp.advance(problem, *ours, state, limit=21, stencil=stencil)
    _hold_body(pp.PipelinedState._fields, got, ref, stencil)


@pytest.mark.parametrize("stencil", ["xla", "pallas"])
def test_sstep_block_is_the_jax_block(stencil):
    problem, jp, ours, theirs = _operands()
    carry = jax_ss.advance(jp, *theirs, jax_ss.init_state(jp, *theirs), s=4,
                           limit=20, stencil=stencil)
    ref = jax_ss.advance(jp, *theirs, carry, s=4, limit=24, stencil=stencil)
    state = interop.pcg_state_from_reference(
        problem, [np.asarray(x) for x in carry], device="cpu")
    got, _ = ss.advance(problem, *ours, state, s=4, limit=24,
                        stencil=stencil)
    if stencil == "xla":
        _hold_body(pcg.PCGState._fields, got, ref, stencil)
        return
    # the basis amplifies the stencil's rounding gap: count and flags only
    for name in ("k", "converged", "breakdown"):
        assert getattr(got, name).item() == _port(
            ref[pcg.PCGState._fields.index(name)]).item(), name


# -- the engine table, the roofline ------------------------------------------


@pytest.mark.parametrize("name", LOOPS)
def test_engine_rows_open_bf16(name):
    assert BF16 in engine.ENGINE_CAPS[name]["dtypes"]
    solver, args, resolved = engine.build_solver(Problem(M=10, N=10), name,
                                                 BF16, "cpu")
    assert resolved == name and all(a.dtype == BF16 for a in args)
    got = solver(*args)
    assert got.w.dtype == BF16 and int(got.iters) > 0
    # the batched kernel engines run bf16 too (K-e's and K-f's bf16
    # forms), f64 not
    for other in ("batched-pallas", "batched-pipelined-pallas"):
        assert BF16 in engine.ENGINE_CAPS[other]["dtypes"]
        assert torch.float64 not in engine.ENGINE_CAPS[other]["dtypes"]


def test_roofline_counts_the_bf16_loops_at_two_bytes():
    """A bf16 loop moves each pass at 2 bytes, and the recurrences rebuild
    every 8 iterations at bf16 (``replace_every``), as with a 2-byte
    storage dtype."""
    big = Problem(M=2400, N=3200)
    want = {"pallas": 13.0, "pipelined-pallas": 48.0 + 25.0 / 8 + 9.0,
            "pipelined": 48.0 + 25.0 / 8 + 20.0,
            "sstep": 265.0 / 4 + 7.0 / 8, "sstep-pallas": 265.0 / 4 + 7.0 / 8}
    for name, passes in want.items():
        assert roofline.passes_per_iter(name, big, dtype=BF16) == \
            pytest.approx(passes)
        assert roofline.bytes_per_node(name, big, dtype=BF16) == \
            pytest.approx(2 * passes)
        assert roofline.passes_per_iter(name, big, storage_dtype="bf16") == \
            pytest.approx(passes)
