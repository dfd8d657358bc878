"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; whether there is one is decided inside the ``cuda`` fixture, never
while the module is imported. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: the kernels are built with ``-fmad=false``, so arrays agree
with the plain versions to 1e-6 (bitwise in practice); per-block sums are
added in another order than ``torch.sum``'s, so sums agree to rel 1e-5.
"""

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.solver import engine

pytestmark = pytest.mark.gpu

ARRAY_TOL = 1e-6
SUM_RTOL = 1e-5
NEVER = 2**31 - 1
# unaligned in both axes; one narrower than a 32-wide block
SHAPES = [(44, 132), (130, 20), (257, 301)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rand(shape, dev, seed, dtype=torch.float32, lo=None):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) + lo if lo is not None else rng.standard_normal(shape)
    return torch.from_numpy(x).to(dtype=dtype, device=dev)


def _close(got, want, tol=ARRAY_TOL):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("M,N", SHAPES)
def test_stencil_kernel_matches_plain(cuda, M, N):
    g = (M + 1, N + 1)
    w, a, b = (_rand(g, cuda, s, lo=lo) for s, lo in
               ((0, None), (1, 0.5), (2, 0.5)))
    h1, h2 = 2.0 / M, 1.2 / N
    _build.reset_launches()
    got = hk.apply_a_kernel(w, a, b, h1, h2)
    block = hk.apply_a_block_kernel(w, a, b, h1, h2)
    assert _build.LAUNCHES["stencil"] == 2
    _close(got, hk.apply_a_plain(w, a, b, h1, h2))
    _close(block, hk.apply_a_block_plain(w, a, b, h1, h2))
    assert torch.equal(got[1:-1, 1:-1], block)
    assert not got[0].any() and not got[-1].any()


def _carry(dev, zr=1.5, beta=0.7, alpha=0.0):
    scal = torch.zeros(fp.N_SCAL, dtype=torch.float32, device=dev)
    scal[fp.SCAL_ZR], scal[fp.SCAL_BETA], scal[fp.SCAL_ALPHA] = zr, beta, alpha
    scal[fp.SCAL_DIFF] = float("inf")
    return scal, torch.zeros(fp.N_FLAGS, dtype=torch.int32, device=dev)


def _scalar_close(got, want):
    assert float(got) == pytest.approx(float(want), rel=SUM_RTOL)


@pytest.mark.parametrize("M,N", SHAPES)
def test_fused_k1_k2_match_plain(cuda, M, N):
    problem = Problem(M=M, N=N)
    g = problem.node_shape
    an, as_, bw, be, d, dinv = fp.fused_operands(problem, torch.float32, cuda)
    z, p, w, r = (_rand(g, cuda, s) for s in range(4))
    partials = torch.empty(fp.scratch_len(*g), device=cuda)
    _build.reset_launches()

    outs = []
    for k1 in (fp.k1, fp.k1_plain):
        scal, flags = _carry(cuda)
        pn, ap = torch.empty_like(z), torch.empty_like(z)
        k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials,
           max_iter=NEVER, h1=problem.h1, h2=problem.h2)
        outs.append((pn, ap, scal, flags))
    (pn, ap, scal, flags), (pn_p, ap_p, scal_p, flags_p) = outs
    _close(pn, pn_p)
    _close(ap, ap_p)
    _scalar_close(scal[fp.SCAL_DENOM], scal_p[fp.SCAL_DENOM])
    _scalar_close(scal[fp.SCAL_ALPHA], scal_p[fp.SCAL_ALPHA])
    assert torch.equal(flags[:4], flags_p[:4])
    assert int(flags[fp.FLAG_TICKET_K1]) == 0  # the ticket is reset

    outs = []
    for k2 in (fp.k2, fp.k2_plain):
        scal, flags = _carry(cuda, alpha=0.3)
        ww, rr, zz = w.clone(), r.clone(), torch.empty_like(w)
        k2(ww, rr, pn_p, ap_p, dinv, zz, scal, flags, partials,
           max_iter=NEVER, h1=problem.h1, h2=problem.h2, delta=problem.delta,
           weighted=True)
        outs.append((ww, rr, zz, scal, flags))
    (ww, rr, zz, scal, flags), (ww_p, rr_p, zz_p, scal_p, flags_p) = outs
    for x, y in ((ww, ww_p), (rr, rr_p), (zz, zz_p)):
        _close(x, y)
    for i in (fp.SCAL_ZR, fp.SCAL_BETA, fp.SCAL_DIFF):
        _scalar_close(scal[i], scal_p[i])
    assert torch.equal(flags[:3], flags_p[:3])
    assert int(flags[fp.FLAG_TICKET_K2]) == 0
    assert _build.LAUNCHES["fused_k1"] == 1
    assert _build.LAUNCHES["fused_k2"] == 1


def test_fused_kernels_write_nothing_once_the_loop_has_exited(cuda):
    problem = Problem(M=64, N=96)
    g = problem.node_shape
    an, as_, bw, be, d, dinv = fp.fused_operands(problem, torch.float32, cuda)
    z, p, w, r, pn, ap = (_rand(g, cuda, s) for s in range(6))
    partials = torch.empty(fp.scratch_len(*g), device=cuda)
    for flag in (fp.FLAG_CONVERGED, fp.FLAG_BREAKDOWN, fp.FLAG_K):
        scal, flags = _carry(cuda, alpha=0.3)
        flags[flag] = 5  # k = 5 is the cap below
        state = (z, p, w, r, pn, ap, scal, flags)
        before = [t.clone() for t in state]
        fp.k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials,
              max_iter=5, h1=problem.h1, h2=problem.h2)
        fp.k2(w, r, pn, ap, dinv, z, scal, flags, partials, max_iter=5,
              h1=problem.h1, h2=problem.h2, delta=problem.delta,
              weighted=True)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(before, state))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = (21, 33)
    w, a, b = (_rand(g, cuda, s) for s in range(3))
    with pytest.raises(ValueError):
        hk.apply_a_kernel(w, a.double(), b, 0.1, 0.1)
    with pytest.raises(ValueError):
        hk.apply_a_kernel(w.t(), a.t(), b.t(), 0.1, 0.1)
    with pytest.raises(ValueError):
        hk.apply_a_kernel(w, a[:, :-1].contiguous(), b, 0.1, 0.1)
    problem = Problem(M=20, N=32)
    coeffs = fp.fused_operands(problem, torch.float32, cuda)
    scal, flags = _carry(cuda)
    partials = torch.empty(fp.scratch_len(*g), device=cuda)
    with pytest.raises(ValueError):
        fp.k1(w.double(), w.double(), *(c.double() for c in coeffs[:5]),
              w.double(), w.double(), scal, flags, partials, max_iter=NEVER,
              h1=problem.h1, h2=problem.h2)
    with pytest.raises(ValueError):
        fp.k1(w, w, *coeffs[:5], w, w, scal, flags, torch.empty(1, device=cuda),
              max_iter=NEVER, h1=problem.h1, h2=problem.h2)


UNWEIGHTED = {(10, 10): 17, (20, 20): 31, (40, 40): 61}
WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}


@pytest.mark.parametrize("engine_name,dtype", [("xla", torch.float64),
                                               ("pallas", torch.float32),
                                               ("fused", torch.float32)])
def test_oracle_counts_on_the_card(cuda, engine_name, dtype):
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        for (m, n), want in table.items():
            got = engine.solve(Problem(M=m, N=n, norm=norm), engine_name,
                               dtype, device=cuda)
            assert int(got.iters) == want, (engine_name, norm, m, n)
            assert bool(got.converged)


def test_fused_on_the_card_matches_its_plain_run(cuda):
    """The whole fused solve through the kernels against the same solve
    through the plain versions on the CPU: equal counts, w within 5e-6."""
    problem = Problem(M=60, N=90)
    _build.reset_launches()
    got = fp.solve_fused(problem, device=cuda, chunk=16)
    iters = int(got.iters)
    assert _build.LAUNCHES["fused_k1"] >= iters
    ref = fp.solve_fused(problem, device="cpu")
    assert iters == int(ref.iters)
    torch.testing.assert_close(got.w.cpu(), ref.w, rtol=0, atol=5e-6)
    # a chunked run on the card gives the bits of a straight one
    one = fp.solve_fused(problem, device=cuda, chunk=1)
    assert int(one.iters) == iters and torch.equal(one.w, got.w)
