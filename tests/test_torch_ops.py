"""The port's stencil, preconditioner, reductions and the stencil kernel's
plain version against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas stencil runs in interpret mode, as the JAX package's own tests run
it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import pallas_kernels as jax_pk
from poisson_ellipse_tpu.ops import reduction as jax_reduction
from poisson_ellipse_tpu.ops import stencil as jax_stencil
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import hopper_kernels, reduction, stencil

F64_RTOL = 1e-14


def _operands(M, N, dtype, seed=0):
    """Assembled (a, b) of the real problem and a random w, as numpy."""
    a, b, _ = jax_assembly.assemble_numpy(JaxProblem(M=M, N=N))
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(a.shape)
    return a.astype(dtype), b.astype(dtype), w.astype(dtype)


def _close(got: torch.Tensor, want, rtol):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("M,N", [(20, 30), (44, 132)])
def test_apply_a_diag_dinv_f64(M, N):
    a, b, w = _operands(M, N, np.float64)
    problem = Problem(M=M, N=N)
    ta, tb, tw = interop.operands_from_reference(problem, a, b, w,
                                                 device="cpu")
    h1 = stencil.spacing(problem.h1, ta)
    h2 = stencil.spacing(problem.h2, ta)
    _close(stencil.apply_a(tw, ta, tb, h1, h2),
           jax_stencil.apply_a(w, a, b, problem.h1, problem.h2), F64_RTOL)
    d = stencil.diag_d(ta, tb, h1, h2)
    jd = jax_stencil.diag_d(a, b, problem.h1, problem.h2)
    _close(d, jd, F64_RTOL)
    _close(stencil.apply_dinv(tw, d), jax_stencil.apply_dinv(w, jd),
           F64_RTOL)


def test_apply_dinv_zero_guard():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((16, 24))
    d[np.abs(d) < 0.4] = 0.0
    r = rng.standard_normal((16, 24))
    got = stencil.apply_dinv(torch.from_numpy(r), torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_stencil.apply_dinv(r, d)))
    assert np.all(got.numpy()[d == 0.0] == 0.0)


@pytest.mark.parametrize("M,N", [(44, 132), (132, 44)])
def test_stencil_plain_matches_pallas_interpret(M, N):
    """K-a's plain version against the Pallas stencil at an unaligned
    shape; 132x44 spans two of the Pallas kernel's 128-row tiles."""
    a, b, w = _operands(M, N, np.float32)
    problem = Problem(M=M, N=N)
    want = jax_pk.apply_a_pallas(jnp.asarray(w), jnp.asarray(a),
                                 jnp.asarray(b), problem.h1, problem.h2,
                                 interpret=True)
    tw, ta, tb = (torch.from_numpy(x) for x in (w, a, b))
    got = hopper_kernels.apply_a_kernel(tw, ta, tb, problem.h1, problem.h2)
    assert got.dtype == torch.float32 and got.shape == problem.node_shape
    _close(got, want, 1e-6)
    block = hopper_kernels.apply_a_block_kernel(tw, ta, tb, problem.h1,
                                                problem.h2)
    np.testing.assert_array_equal(block.numpy(), got.numpy()[1:-1, 1:-1])


def test_stencil_block_layout_matches_jax():
    rng = np.random.default_rng(7)
    w, a, b = (rng.standard_normal((17, 35)) for _ in range(3))
    got = hopper_kernels.apply_a_block_plain(
        *(torch.from_numpy(x) for x in (w, a, b)), 0.01, 0.02)
    _close(got, jax_stencil.apply_a_block(w, a, b, 0.01, 0.02), F64_RTOL)


def test_reductions_match_jax():
    rng = np.random.default_rng(2)
    u, v = rng.standard_normal((2, 33, 47))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    h1 = torch.tensor(0.01, dtype=torch.float64)
    h2 = torch.tensor(0.02, dtype=torch.float64)
    np.testing.assert_allclose(
        float(reduction.grid_dot(tu, tv, h1, h2)),
        float(jax_reduction.grid_dot(u, v, 0.01, 0.02)), rtol=F64_RTOL)
    np.testing.assert_allclose(float(reduction.grid_sumsq(tu)),
                               float(jax_reduction.grid_sumsq(u)),
                               rtol=F64_RTOL)
    np.testing.assert_allclose(
        reduction.grid_dots((tu, tv), (tu, tu)).numpy(),
        np.asarray(jax_reduction.grid_dots((u, v), (u, u))), rtol=F64_RTOL)
