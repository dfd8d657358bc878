"""The port's problem definition and host assembly against the JAX package.

Both packages assemble in float64 numpy, so the arrays must be identical,
not merely close.
"""

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models import ellipse as jax_ellipse
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu_torch.models import ellipse
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly

PROBLEMS = [
    dict(M=10, N=10),
    dict(M=20, N=20, norm="unweighted"),
    dict(M=44, N=132),
    dict(M=40, N=60, eps=0.01, delta=1e-8, max_iter=77),
    dict(M=7, N=3, a1=-2.0, b2=0.9, f_val=2.5),
]


@pytest.mark.parametrize("kw", PROBLEMS)
def test_problem_matches_jax(kw):
    ours, ref = Problem(**kw), JaxProblem(**kw)
    for name in ("h1", "h2", "eps_value", "max_iterations", "node_shape",
                 "norm", "delta", "M", "N"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("kw", [dict(M=1, N=5), dict(M=4, N=4, norm="l1"),
                                dict(M=4, N=4, eps=0.0)])
def test_problem_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JaxProblem(**kw)
    with pytest.raises(ValueError):
        Problem(**kw)


@pytest.mark.parametrize("kw", PROBLEMS)
def test_assemble_numpy_array_equal(kw):
    ours = assembly.assemble_numpy(Problem(**kw))
    ref = jax_assembly.assemble_numpy(JaxProblem(**kw))
    for x, y in zip(ours, ref):
        assert x.dtype == np.float64
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assemble_casts_once(dtype):
    problem = Problem(M=20, N=30)
    a64, b64, rhs64 = assembly.assemble_numpy(problem)
    a, b, rhs = assembly.assemble(problem, dtype, device="cpu")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    for t, x in ((a, a64), (b, b64), (rhs, rhs64)):
        assert t.dtype == dtype and t.shape == problem.node_shape
        np.testing.assert_array_equal(t.numpy(), x.astype(np_dtype))


def test_ellipse_closed_forms_match_jax():
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1.2, 1.2, 257)
    lo, hi = rng.uniform(-0.7, 0.1, 257), rng.uniform(0.0, 0.7, 257)
    for name in ("segment_length_vertical", "segment_length_horizontal"):
        want = np.asarray(getattr(jax_ellipse, name)(x0, lo, hi, np))
        np.testing.assert_array_equal(getattr(ellipse, name)(x0, lo, hi, np),
                                      want)
        # the torch form on f64 tensors: PyTorch's vectorised sqrt may
        # round one ulp away from numpy's
        got_t = getattr(ellipse, name)(*(torch.from_numpy(v)
                                         for v in (x0, lo, hi)), torch)
        np.testing.assert_allclose(got_t.numpy(), want, rtol=4e-16, atol=0)
    np.testing.assert_array_equal(ellipse.safe_sqrt(lo, np),
                                  np.asarray(jax_ellipse.safe_sqrt(lo, np)))
    np.testing.assert_array_equal(ellipse.is_in_d(x0, lo),
                                  jax_ellipse.is_in_d(x0, lo))
    np.testing.assert_array_equal(ellipse.analytic_solution(x0, lo),
                                  jax_ellipse.analytic_solution(x0, lo))
