"""The fused K1/K2 kernels' plain versions against the JAX package's Pallas
K1/K2, run in interpret mode on the CPU.

Both packages get the same f64-rounded operand set: the JAX package's
``fused_operands`` padded to its (g1p, g2p) tiling, carried into the port
with the padding stripped (``interop.fused_operands_from_reference``). The
state arrays are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import fused_pcg as jax_fused
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp

ARRAY_TOL = 1e-6
SUM_RTOL = 1e-5

# 44x132 is unaligned in both axes; 600x20 spans two of the Pallas
# kernels' 512-row tiles, so the halo rows cross a tile boundary there
SHAPES = [(44, 132), (600, 20)]


def _setup(M, N, seed=0):
    jp, problem = JaxProblem(M=M, N=N), Problem(M=M, N=N)
    g1, g2 = problem.node_shape
    kern = jax_fused.build_kernels(jp, g1, g2, jnp.float32, interpret=True)
    jcoeffs = jax_fused.fused_operands(jp, kern.g1p, kern.g2p, jnp.float32)
    coeffs = interop.fused_operands_from_reference(problem, jcoeffs,
                                                   device="cpu")
    rng = np.random.default_rng(seed)
    state = {k: rng.standard_normal((g1, g2)).astype(np.float32)
             for k in ("z", "p", "w", "r")}
    return jp, problem, kern, jcoeffs, coeffs, state


def _pad(x, kern):
    g1, g2 = x.shape
    return jnp.asarray(np.pad(x, ((0, kern.g1p - g1), (0, kern.g2p - g2))))


def _carry(zr, beta, alpha=0.0):
    scal = torch.zeros(fp.N_SCAL, dtype=torch.float32)
    scal[fp.SCAL_ZR], scal[fp.SCAL_BETA], scal[fp.SCAL_ALPHA] = zr, beta, alpha
    scal[fp.SCAL_DIFF] = float("inf")
    return scal, torch.zeros(fp.N_FLAGS, dtype=torch.int32)


def _close(got: torch.Tensor, want, tol=ARRAY_TOL):
    """Within ``tol`` of the array's scale: XLA on the CPU may contract
    a*b+c into an FMA, which moves a result that cancels (ap = d*p − Σ)
    by an ulp of its operands, not of itself."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("M,N", SHAPES)
def test_k1_plain_matches_pallas_k1(M, N):
    jp, problem, kern, jcoeffs, coeffs, st = _setup(M, N)
    an, as_, bw, be, d, dinv = coeffs
    zr, beta = 1.25, 0.6
    pn_j, ap_j, denom_raw = kern.k1(
        jnp.float32(beta), _pad(st["z"], kern), _pad(st["p"], kern),
        *jcoeffs[:5])
    g1, g2 = problem.node_shape

    scal, flags = _carry(zr, beta)
    z, p = torch.from_numpy(st["z"]), torch.from_numpy(st["p"])
    pn, ap = torch.empty_like(z), torch.empty_like(z)
    fp.k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, torch.empty(0),
          max_iter=10, h1=problem.h1, h2=problem.h2)

    _close(pn, np.asarray(pn_j)[:g1, :g2])
    _close(ap, np.asarray(ap_j)[:g1, :g2])
    denom = float(np.float32(denom_raw[0]) * np.float32(problem.h1)
                  * np.float32(problem.h2))
    assert scal[fp.SCAL_DENOM].item() == pytest.approx(denom, rel=SUM_RTOL)
    # K2's in-kernel alpha on the TPU, from the same (zr, denom)
    assert scal[fp.SCAL_ALPHA].item() == pytest.approx(zr / denom,
                                                       rel=SUM_RTOL)
    assert int(flags[fp.FLAG_PENDING_BREAKDOWN]) == 0


@pytest.mark.parametrize("M,N", SHAPES)
def test_k2_plain_matches_pallas_k2(M, N):
    jp, problem, kern, jcoeffs, coeffs, st = _setup(M, N, seed=1)
    dinv = coeffs[5]
    g1, g2 = problem.node_shape
    zr, denom = 2.0, 5.0
    w_j, r_j, z_j, sums = kern.k2(
        jnp.float32(zr), jnp.float32(denom), _pad(st["w"], kern),
        _pad(st["r"], kern), _pad(st["p"], kern), _pad(st["z"], kern),
        jcoeffs[5])

    # the port's K2 takes α from K1 on the device carry
    scal, flags = _carry(zr, 0.3, alpha=float(np.float32(zr) /
                                              np.float32(denom)))
    w, r = torch.from_numpy(st["w"].copy()), torch.from_numpy(st["r"].copy())
    pn, ap = torch.from_numpy(st["p"]), torch.from_numpy(st["z"])
    z = torch.empty_like(w)
    fp.k2(w, r, pn, ap, dinv, z, scal, flags, torch.empty(0), max_iter=10,
          h1=problem.h1, h2=problem.h2, delta=problem.delta, weighted=True)

    _close(w, np.asarray(w_j)[:g1, :g2])
    _close(r, np.asarray(r_j)[:g1, :g2])
    _close(z, np.asarray(z_j)[:g1, :g2])
    h1, h2 = np.float32(problem.h1), np.float32(problem.h2)
    zr_new = float(np.float32(sums[0]) * h1 * h2)
    diff = float(np.sqrt(np.float32(sums[1]) * h1 * h2))
    assert scal[fp.SCAL_ZR].item() == pytest.approx(zr_new, rel=SUM_RTOL)
    assert scal[fp.SCAL_BETA].item() == pytest.approx(zr_new / zr,
                                                      rel=SUM_RTOL)
    assert scal[fp.SCAL_DIFF].item() == pytest.approx(diff, rel=SUM_RTOL)
    assert flags[:3].tolist() == [1, 0, 0]


def test_k2_breakdown_holds_the_carry():
    """A pending breakdown from K1 holds zr, β and diff, as the reference
    exits before touching them; α = 0 leaves w and r bitwise."""
    problem = Problem(M=12, N=16)
    g = problem.node_shape
    rng = np.random.default_rng(5)
    w, r, pn, ap, dinv = (torch.from_numpy(rng.standard_normal(g)
                                           .astype(np.float32))
                          for _ in range(5))
    w0, r0 = w.clone(), r.clone()
    scal, flags = _carry(3.0, 0.4, alpha=0.0)
    scal[fp.SCAL_DIFF] = 0.5
    flags[fp.FLAG_PENDING_BREAKDOWN] = 1
    before = scal.clone()
    fp.k2(w, r, pn, ap, dinv, torch.empty_like(w), scal, flags,
          torch.empty(0), max_iter=10, h1=problem.h1, h2=problem.h2,
          delta=problem.delta, weighted=True)
    assert torch.equal(w, w0) and torch.equal(r, r0)
    assert torch.equal(scal[:3], before[:3])
    assert flags[:3].tolist() == [1, 0, 1]


def test_k1_k2_write_nothing_once_the_loop_has_exited():
    problem = Problem(M=12, N=16)
    g = problem.node_shape
    rng = np.random.default_rng(6)
    arrays = [torch.from_numpy(rng.standard_normal(g).astype(np.float32))
              for _ in range(12)]
    z, p, an, as_, bw, be, d, pn, ap, w, r, dinv = arrays
    for flag in (fp.FLAG_CONVERGED, fp.FLAG_BREAKDOWN, fp.FLAG_K):
        scal, flags = _carry(1.0, 0.5, alpha=0.2)
        flags[flag] = 7  # k = 7 is the cap below
        before = [t.clone() for t in (*arrays, scal, flags)]
        fp.k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, torch.empty(0),
              max_iter=7, h1=problem.h1, h2=problem.h2)
        fp.k2(w, r, pn, ap, dinv, z, scal, flags, torch.empty(0), max_iter=7,
              h1=problem.h1, h2=problem.h2, delta=problem.delta,
              weighted=False)
        after = (*arrays, scal, flags)
        assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_plain_versions_count_no_launch():
    """The launch counters move only where a kernel is launched; the CPU
    path runs the plain versions and counts nothing."""
    _build.reset_launches()
    problem = Problem(M=10, N=10)
    fp.solve_fused(problem, device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0


def test_interior_normalized_matches_jax():
    jp, problem = JaxProblem(M=30, N=22), Problem(M=30, N=22)
    rng = np.random.default_rng(2)
    a, b = rng.random((2, 31, 23)) + 0.5
    ours = fp.interior_normalized(problem, a, b)
    ref = jax_fused.interior_normalized(jp, a, b)
    for x, y in zip(ours, ref):
        np.testing.assert_array_equal(x, np.asarray(y))
    # the torch form gives the same f64 values
    tours = fp.interior_normalized(problem, torch.from_numpy(a),
                                   torch.from_numpy(b))
    for x, y in zip(tours, ours):
        np.testing.assert_array_equal(x.numpy(), y)


def test_fused_operands_equal_stripped_jax_operands():
    jp, problem = JaxProblem(M=44, N=132), Problem(M=44, N=132)
    ours = fp.fused_operands(problem, torch.float32, "cpu")
    g1p, g2p = 48, 256
    ref = interop.fused_operands_from_reference(
        problem, jax_fused.fused_operands(jp, g1p, g2p, jnp.float32),
        device="cpu")
    for x, y in zip(ours, ref):
        assert x.dtype == torch.float32
        assert torch.equal(x, y)


def test_strip_padding_rejects_nonzero_padding():
    problem = Problem(M=4, N=4)
    x = np.zeros((8, 128), np.float32)
    assert interop.strip_padding(problem, x).shape == (5, 5)
    x[6, 3] = 1.0
    with pytest.raises(ValueError):
        interop.strip_padding(problem, x)
    with pytest.raises(ValueError):
        interop.strip_padding(problem, np.zeros((4, 5)))
