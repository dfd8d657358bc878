"""bf16 compute on the lane-batched engines against the JAX package, on
the CPU: K-e's and K-f's bf16 plain versions against
``apply_a_batched_block_pallas`` / ``apply_a_dots_batched_pallas`` in
interpret mode at 24×130 with B = 3, the four batched engines at 40²,
B = 2, δ = 1e-4, and a JAX bf16 lane carry resumed in the port.

The bf16 forms compute in float on the exactly widened inputs and round
once where they store (``ops.whole_solve.rounder``); the JAX kernels in
interpret mode round every operation in bf16. So, as for K-a's and K-d's
bf16 forms (tests/test_torch_bf16_loops.py):

- K-e's and K-f's stencil within 2⁻⁵ (``TERM_TOL``) of the stencil's term
  magnitude Σ|coefficient·difference|/h² at every node, and lane l bitwise
  the one-lane form (K-a bf16, K-d bf16) on lane l;
- K-f's sums each the exact sum rounded once (through f32) to bf16, and
  within 2⁻⁸ of Σ|x·y| of JAX's (which rounds each product and its
  accumulator to bf16);
- the engines: ``batched`` and ``batched-pallas`` converge within ±3
  (``ITERS_BAND``) of the JAX engine's count on every lane (32 at 40²);
  ``batched-pipelined`` and ``batched-pipelined-pallas`` give the JAX
  engine's (iterations, converged, breakdown) on every lane, the cap of
  1521 unconverged (the bf16 recurrence does not converge, in either
  package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.batch import batched_pcg as jax_bp
from poisson_ellipse_tpu.batch import batched_pipelined as jax_bpp
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import pallas_kernels as jax_pk
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
from poisson_ellipse_tpu_torch.batch import batched_pipelined as bpp
from poisson_ellipse_tpu_torch.batch import driver
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops.stencil import apply_a_block
from poisson_ellipse_tpu_torch.solver import engine

BF16 = torch.bfloat16
TERM_TOL = 2.0**-5
SUM_TOL = 2.0**-8
ITERS_BAND = 3
LANES = 3
ENGINES = ("batched", "batched-pallas", "batched-pipelined",
           "batched-pipelined-pallas")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test: the thread count orders the plain bf16
    sums, and so moves a chaotic count."""
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
    """Σ|coefficient·difference|/h² at each owned node of (·, bm+2, bn+2)
    blocks: the magnitude of the stencil's terms, which its rounding gap
    scales with."""
    w, a, b = (x.double() for x in (w, a, b))
    h1, h2 = (float(torch.tensor(h, dtype=BF16)) for h in (h1, h2))
    wc = w[..., 1:-1, 1:-1]
    return (((a[..., 2:, 1:-1] * (w[..., 2:, 1:-1] - wc)).abs()
             + (a[..., 1:-1, 1:-1] * (wc - w[..., :-2, 1:-1])).abs()) / h1**2
            + ((b[..., 1:-1, 2:] * (w[..., 1:-1, 2:] - wc)).abs()
               + (b[..., 1:-1, 1:-1] * (wc - w[..., 1:-1, :-2])).abs())
            / h2**2)


def _seeded(shape, seed):
    """(w stack of LANES, a, b) in bf16 at ``shape``: w standard normal,
    the coefficients in [0.5, 1.5), as the K-a bf16 tests seed them."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((LANES,) + shape)).to(BF16)
    a, b = (torch.from_numpy(rng.random(shape) + 0.5).to(BF16)
            for _ in range(2))
    return w, a, b


def test_ke_bf16_plain_against_jax():
    w, a, b = _seeded((26, 132), seed=5)  # bm, bn = 24, 130
    h1, h2 = 0.01, 0.02
    _build.reset_launches()
    got = hk.apply_a_batched_block_kernel(w, a, b, h1, h2)
    assert sum(_build.LAUNCHES.values()) == 0  # the CPU runs the plain form
    want = _port(jax_pk.apply_a_batched_block_pallas(
        _jax(w), _jax(a), _jax(b), h1, h2, interpret=True))
    assert got.dtype == want.dtype == BF16 and got.shape == (LANES, 24, 130)
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= TERM_TOL * _terms(w, a, b, h1, h2)).all())
    # the form's definition: the f32 tree on the widened inputs and the
    # bf16-rounded spacings, rounded once; lane l is K-a bf16 on lane l
    hb = [torch.tensor(h, dtype=BF16).float() for h in (h1, h2)]
    once = apply_a_block(w.float(), a.float(), b.float(), *hb).to(BF16)
    assert torch.equal(_bits(got), _bits(once))
    for lane in range(LANES):
        assert torch.equal(_bits(got[lane]), _bits(
            hk.apply_a_block_kernel(w[lane].contiguous(), a, b, h1, h2)))
    full = hk.apply_a_batched_kernel(w, a, b, h1, h2)
    assert torch.equal(_bits(full[:, 1:-1, 1:-1]), _bits(got))
    assert not full[:, 0].float().any() and not full[:, :, -1].float().any()


def test_kf_bf16_plain_against_jax():
    w, a, b = _seeded((25, 131), seed=6)  # the full grid of 24x130
    h1, h2 = 0.01, 0.02
    rng = np.random.default_rng(11)
    vecs = []
    for _ in range(5):  # zero on the ring, as in the solvers
        v = np.zeros((LANES, 25, 131))
        v[:, 1:-1, 1:-1] = rng.standard_normal((LANES, 23, 129))
        vecs.append(torch.from_numpy(v).to(BF16))
    pairs = bpp._bundle(*vecs)
    _build.reset_launches()
    n, sums = hk.apply_a_dots_batched_kernel(w, a, b, h1, h2, pairs)
    assert sum(_build.LAUNCHES.values()) == 0
    assert n.dtype == sums.dtype == BF16 and sums.shape == (8, LANES)
    # n is K-e bf16's; sums[:, l] is K-d bf16's on lane l
    assert torch.equal(_bits(n), _bits(hk.apply_a_batched_kernel(w, a, b, h1,
                                                                 h2)))
    for lane in range(LANES):
        _, single = hk.apply_a_dots_kernel(
            w[lane].contiguous(), a, b, h1, h2,
            tuple((x[lane].contiguous(), y[lane].contiguous())
                  for x, y in pairs))
        assert torch.equal(_bits(sums[:, lane]), _bits(single))
    jn, jsums = jax_pk.apply_a_dots_batched_pallas(
        _jax(w), _jax(a), _jax(b), h1, h2,
        [(_jax(x), _jax(y)) for x, y in pairs], interpret=True)
    jn, jsums = _port(jn), _port(jsums)
    gap = (n[:, 1:-1, 1:-1].double() - jn[:, 1:-1, 1:-1].double()).abs()
    assert bool((gap <= TERM_TOL * _terms(w, a, b, h1, h2)).all())
    for j, (x, y) in enumerate(pairs):
        prod = x.double() * y.double()
        exact = prod.sum(dim=(1, 2))
        magnitude = prod.abs().sum(dim=(1, 2))
        # ours: the exact sum rounded once (through f32) to bf16
        assert torch.equal(_bits(sums[j]), _bits(exact.float().to(BF16)))
        assert bool(((sums[j].double() - jsums[j].double()).abs()
                     <= SUM_TOL * magnitude).all())


def _problem():
    return Problem(M=40, N=40, delta=1e-4)


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX package's four batched engines on their tiled operands: the
    layout's solver with the engine's stencil, as its ``build_solver``
    runs them (Pallas in interpret mode)."""
    jp = JaxProblem(M=40, N=40, delta=1e-4)
    ops = jax_bp.batched_operands(jp, 2, jnp.bfloat16)
    out = {}
    for name in ENGINES:
        run = (jax_bpp.pcg_batched_pipelined if "pipelined" in name
               else jax_bp.pcg_batched)
        stencil = "pallas" if name.endswith("pallas") else "xla"
        out[name] = run(jp, *ops, stencil=stencil, interpret=True)
    return out


@pytest.mark.parametrize("name", ENGINES)
def test_bf16_batched_engines_against_jax_at_40(jax_engines, name):
    solver, args, resolved = engine.build_solver(_problem(), name, BF16,
                                                 "cpu", lanes=2)
    assert resolved == name and all(a.dtype == BF16 for a in args)
    _build.reset_launches()
    got = solver(*args)
    assert sum(_build.LAUNCHES.values()) == 0  # plain versions on the CPU
    ref = jax_engines[name]
    assert got.w.dtype == got.diff.dtype == BF16
    assert not got.quarantined.any()
    ref_iters = np.asarray(ref.iters).tolist()
    if name.startswith("batched-pipelined"):
        triples = list(zip(got.iters.tolist(), got.converged.tolist(),
                           got.breakdown.tolist()))
        want = list(zip(ref_iters, np.asarray(ref.converged).tolist(),
                        np.asarray(ref.breakdown).tolist()))
        assert triples == want == [(1521, False, False)] * 2
    else:
        assert ref_iters == [32, 32] and bool(np.all(ref.converged))
        assert all(abs(i - 32) <= ITERS_BAND for i in got.iters.tolist())
        assert got.converged.all() and not got.breakdown.any()


@pytest.mark.parametrize("name", ["batched-pallas",
                                  "batched-pipelined-pallas"])
def test_jax_bf16_lane_carry_resumes_in_the_port(name):
    """A JAX bf16 lane carry crosses bit for bit (``interop``) and the
    port's kernel engine advances it to the count the port reaches from
    its own start."""
    problem = _problem()
    jp = JaxProblem(M=40, N=40, delta=1e-4)
    jmod = jax_bp if name == "batched-pallas" else jax_bpp
    a, b, rhs = jax_bp.batched_operands(jp, 2, jnp.bfloat16)
    if name == "batched-pallas":
        state = jmod.init_state(jp, a, b, rhs)
    else:
        state = jmod.init_state(jp, a, b, rhs, stencil="pallas",
                                interpret=True)
    carry = interop.batched_state_from_reference(problem, state, name,
                                                 device="cpu")
    for got, want in zip(carry, state):
        want = _port(want)
        assert got.dtype == want.dtype or want.dtype == torch.bool
        if got.dtype == BF16:
            assert torch.equal(_bits(got), _bits(want))
    ours = tuple(_port(x) for x in (a, b, rhs))
    mod = bp if name == "batched-pallas" else bpp
    resumed, _ = mod.advance(problem, *ours, carry, stencil="pallas")
    fresh = driver.solve_batched(problem, 2, name, BF16, operands=ours,
                                 device="cpu").result
    assert resumed.iters.tolist() == fresh.iters.tolist()
