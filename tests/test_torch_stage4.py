"""The stage-4 vector kernels' plain versions against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

``ops.stage4_kernels`` ports the last four ``pl.pallas_call`` sites of
``poisson_ellipse_tpu/ops/pallas_kernels.py`` (z = r/D, the weighted dot,
the fused w/r update, the p update). Their path in the JAX package is the
public functions that ``tests/test_pallas_kernels.py:45-86`` drives; these
tests mirror those, at f64 and f32, with the same numpy inputs from a seed
going through ``pk.*_pallas`` and the port's dispatcher on the CPU (which
runs the plain version). The tolerances are the JAX tests' own: dinv
bitwise; dot within rel 1e-12 (f64) or 1e-6 (f32); update_w_r within
rtol 1e-13 and dw2 within 1e-12 (f64); update_p within rtol 1e-13, atol
1e-14 (f64). At f32 the arrays are held within one f32 rounding of their
two terms of the JAX kernels' (XLA may contract them into an FMA) and the
sums to rel 1e-6; the dot's sum
cancels, so at f32 it is held to rel 1e-6 of the exact (f64) sum and to
1e-6 of h1·h2·Σ|xy| from the Pallas kernel's f32 sum.

The four composed with K-a's plain version into the reference's stage-4
iteration take exactly the weighted 40² oracle's 50 iterations at f64,
with w within 1e-12 of the port's ``xla``.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.ops import pallas_kernels as pk
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4
from poisson_ellipse_tpu_torch.solver import engine

DTYPES = {"f64": (torch.float64, jnp.float64, np.float64),
          "f32": (torch.float32, jnp.float32, np.float32)}
DOT_RTOL = {"f64": 1e-12, "f32": 1e-6}


def _arrays(name, shape, n, seed=7):
    """n numpy arrays of ``shape`` from one seed, at dtype ``name``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(DTYPES[name][2])
            for _ in range(n)]


def _pair(x, name):
    """(the port's CPU tensor, the JAX array) of one numpy array."""
    return torch.from_numpy(x.copy()), jnp.asarray(x, DTYPES[name][1])


def _scalar(v, name):
    return (torch.tensor(v, dtype=DTYPES[name][0]),
            jnp.asarray(v, DTYPES[name][1]))


def _within_a_term_ulp(got, want, x, y):
    """got within one f32 rounding of its two terms x and y of JAX's x + y:
    XLA on the CPU may contract the product and the sum into an FMA (ROADMAP
    Queue C), which moves a result that cancels by an ulp of its terms."""
    want = torch.from_numpy(np.array(want))
    bound = 2.0**-23 * (x.abs() + y.abs())
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dinv_is_bitwise_jax(name):
    r, d = _arrays(name, (32, 40), 2)
    d = np.where(np.abs(d) < 0.3, 0.0, d).astype(d.dtype)  # the zero guard
    (tr, jr), (td, jd) = _pair(r, name), _pair(d, name)
    got = s4.apply_dinv_pallas(tr, td)
    want = interop.tensor_from_numpy(np.asarray(pk.apply_dinv_pallas(jr, jd)))
    assert got.dtype == DTYPES[name][0] and torch.equal(got, want)
    assert bool((got[td == 0] == 0).all()) and int((td == 0).sum()) > 0


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dot_matches_jax(name):
    x, y = _arrays(name, (32, 40), 2)
    (tx, jx), (ty, jy) = _pair(x, name), _pair(y, name)
    got = s4.dot_pallas(tx, ty, 0.01, 0.02)
    want = float(pk.dot_pallas(jx, jy, 0.01, 0.02))
    assert got.dim() == 0 and got.dtype == DTYPES[name][0]
    exact = float((x.astype(np.float64) * y).sum()) * 0.01 * 0.02
    assert abs(float(got) - exact) <= DOT_RTOL[name] * abs(exact)
    if name == "f64":
        assert abs(float(got) - want) <= DOT_RTOL[name] * abs(want)
    else:
        # the Pallas kernel sums in f32 and this sum cancels (|Σxy| is
        # 0.04 of Σ|xy|): its error scales with Σ|xy|, not with the result
        magnitude = float(np.abs(x.astype(np.float64) * y).sum()) * 2e-4
        assert abs(float(got) - want) <= DOT_RTOL[name] * magnitude


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_update_w_r_matches_jax(name):
    w, r, p, ap = _arrays(name, (16, 24), 4)
    tw, jw = _pair(w, name)
    tr, jr = _pair(r, name)
    tp, jp = _pair(p, name)
    tap, jap = _pair(ap, name)
    ta, ja = _scalar(0.37, name)
    w_new, r_new, dw2 = s4.update_w_r_pallas(ta, tw, tr, tp, tap)
    jw_new, jr_new, jdw2 = pk.update_w_r_pallas(ja, jw, jr, jp, jap)
    assert dw2.dim() == 0 and dw2.dtype == DTYPES[name][0]
    if name == "f64":
        np.testing.assert_allclose(w_new.numpy(), np.asarray(jw_new),
                                   rtol=1e-13)
        np.testing.assert_allclose(r_new.numpy(), np.asarray(jr_new),
                                   rtol=1e-13)
        # the JAX test's own reference: Σ(αp)²
        assert abs(float(dw2) - float(jnp.sum((ja * jp) ** 2))) < 1e-12
    else:
        _within_a_term_ulp(w_new, jw_new, tw, ta * tp)
        _within_a_term_ulp(r_new, jr_new, tr, ta * tap)
        assert float(dw2) == pytest.approx(float(jdw2), rel=1e-6)
    # the realised increment, not α·p
    dw = (w_new - tw).double()
    assert float(dw2) == pytest.approx(float((dw * dw).sum()),
                                       rel=DOT_RTOL[name])


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_update_p_matches_jax(name):
    z, p = _arrays(name, (16, 24), 2)
    (tz, jz), (tp, jp) = _pair(z, name), _pair(p, name)
    tb, jb = _scalar(0.9, name)
    got = s4.update_p_pallas(tb, tz, tp)
    want = np.asarray(pk.update_p_pallas(jb, jz, jp))
    if name == "f64":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    else:
        _within_a_term_ulp(got, want, tz, tb * tp)


def test_ragged_row_counts_match_jax():
    """An odd row count, which the JAX kernels pad to a multiple of 8 and
    the port does not pad at all (401x601, the node grid of 400x600)."""
    w, r, p, ap = _arrays("f32", (41, 61), 4, seed=3)
    tensors = [torch.from_numpy(x) for x in (w, r, p, ap)]
    alpha = torch.tensor(0.25)
    got = s4.update_w_r_pallas(alpha, *tensors)
    want = pk.update_w_r_pallas(jnp.asarray(0.25, jnp.float32),
                                *(jnp.asarray(x) for x in (w, r, p, ap)))
    _within_a_term_ulp(got[0], want[0], tensors[0], alpha * tensors[2])
    _within_a_term_ulp(got[1], want[1], tensors[1], alpha * tensors[3])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-6)
    z = s4.apply_dinv_pallas(tensors[1], tensors[0])
    assert torch.equal(z, interop.tensor_from_numpy(np.asarray(
        pk.apply_dinv_pallas(jnp.asarray(r), jnp.asarray(w)))))


def test_other_dtypes_are_refused():
    x = torch.zeros(4, 5, dtype=torch.bfloat16)
    s = torch.zeros((), dtype=torch.bfloat16)
    for call in (lambda: s4.apply_dinv_pallas(x, x),
                 lambda: s4.dot_pallas(x, x, 0.1, 0.1),
                 lambda: s4.update_w_r_pallas(s, x, x, x, x),
                 lambda: s4.update_p_pallas(s, x, x)):
        with pytest.raises(ValueError, match="bfloat16"):
            call()
    f = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="0-d"):
        s4.update_p_pallas(0.5, f, f)
    with pytest.raises(ValueError, match="float64"):
        s4.update_p_pallas(torch.tensor(0.5, dtype=torch.float64), f, f)
    with pytest.raises(ValueError, match="one shape"):
        s4.dot_pallas(f, torch.zeros(5, 4), 0.1, 0.1)


def test_plain_versions_launch_nothing():
    _build.reset_launches()
    f = torch.ones(4, 5)
    s4.update_p_pallas(torch.tensor(0.5), f, f)
    s4.dot_pallas(f, f, 0.1, 0.1)
    assert sum(_build.LAUNCHES.values()) == 0


def _c_kinds(symbol: str) -> list:
    """The parameter kinds of ``symbol``'s prototype in csrc/stage4.cu."""
    source = _build.source_path(s4.LIBRARY).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in stage4.cu"
    kinds = []
    for param in match.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("ptr" if "*" in param
                     else param.rsplit(" ", 1)[0].removeprefix("const "))
    return kinds


def test_launcher_signatures_match_the_c_prototypes():
    """A ctypes list that drifts from its C prototype is no ctypes error:
    the kernel misreads its arguments on the card."""
    names = {ctypes.c_int: "int", ctypes.c_int64: "int64_t",
             ctypes.c_float: "float", ctypes.c_double: "double",
             ctypes.c_void_p: "ptr"}
    launchers = [s for s, (res, _) in s4.SIGNATURES.items()
                 if res is ctypes.c_int]
    assert len(launchers) == 9 and "stage4" in _build.SOURCES
    for symbol in launchers:
        argtypes = s4.SIGNATURES[symbol][1]
        assert [names[t] for t in argtypes] == _c_kinds(symbol), symbol


def test_composed_stage4_iteration_takes_the_oracle_count():
    """``chip_smoke.stage4_solve``, the loop the card runs, composed here
    from the four plain versions and K-a's."""
    from chip_smoke import stage4_solve

    problem = Problem(M=40, N=40)
    a, b, rhs = assembly.assemble(problem, torch.float64, "cpu")
    w, iters, converged = stage4_solve(problem, a, b, rhs, hk.apply_a_plain)
    ref = engine.solve(problem, "xla", torch.float64, device="cpu")
    assert converged and iters == int(ref.iters) == 50
    np.testing.assert_allclose(w.numpy(), ref.w.numpy(), rtol=0, atol=1e-12)
