"""K-a's and K-e's plain versions against the JAX package on the solver's
zero exterior, and the guarded division of the shared stencil tree.

The CUDA march (``csrc/stencil.cu``) divides every face flux and every
combination through ``div_pos`` (``csrc/stencil_tree.cuh``): a zero
dividend is its own quotient, signed as IEEE division signs it, and only a
nonzero one is divided. Its plain versions divide plainly, so the two
agree bit for bit; the card's tests (``tests/test_torch_gpu.py``) hold
them so on zero, ``-0.0`` and zero-exterior inputs. Here, on the CPU, the
plain versions meet the JAX package's stencils on the same data: w from
``chip_smoke.signed_zero_inputs``, a numpy-seeded field inside the
ellipse and a mix of +0.0 and -0.0 outside it (the solver's state outside
the ellipse is exactly zero), or all +0.0, or all -0.0; a and b are the
assembled coefficients, rounded once to f32 from the same f64 host
arrays. Tolerance: 1e-6 of the output's scale, the port's K-a / K-e
parity tolerance (XLA on the CPU may contract a*b+c into an FMA, ROADMAP
Queue C); and the output is zero exactly where JAX's is.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import signed_zero_inputs
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import pallas_kernels as jax_pk
from poisson_ellipse_tpu.ops import stencil as jax_stencil
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk

REL = 1e-6
SHAPES = [(44, 132), (24, 36)]
KINDS = ["zero exterior, signed zeros", "w = +0", "w = -0"]
LANES = 3
CSRC = Path(hk.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test, as in the port's other test files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(M, N, kind, seed, lead=()):
    """(w, a, b) as numpy f32 arrays and the f32-rounded spacings; w of
    ``kind`` from ``chip_smoke.signed_zero_inputs``."""
    jp = JaxProblem(M=M, N=N)
    a, b, _ = jax_assembly.assemble_numpy(jp)
    like = torch.empty(lead + a.shape, dtype=torch.float32)
    w = signed_zero_inputs(like, seed)[kind].numpy()
    assert not kind.startswith("zero exterior") or (w == 0).mean() > 0.1
    return w, a.astype(np.float32), b.astype(np.float32), jp.h1, jp.h2


def _check(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), np.finfo(np.float32).tiny)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N", SHAPES)
@pytest.mark.parametrize("form", ["block xla", "block pallas", "full pallas"])
def test_ka_plain_matches_jax_on_zero_exteriors(form, M, N, kind):
    w, a, b, h1, h2 = _inputs(M, N, kind, seed=M + N)
    ja, jb, jw = (jnp.asarray(x) for x in (a, b, w))
    if form == "block xla":
        want = jax_stencil.apply_a_block(jw, ja, jb, jnp.float32(h1),
                                         jnp.float32(h2))
    elif form == "block pallas":
        want = jax_pk.apply_a_block_pallas(jw, ja, jb, h1, h2,
                                           interpret=True)
    else:
        want = jax_pk.apply_a_pallas(jw, ja, jb, h1, h2, interpret=True)
    kernel = (hk.apply_a_kernel if form == "full pallas"
              else hk.apply_a_block_kernel)
    _build.reset_launches()
    got = kernel(*(torch.from_numpy(x) for x in (w, a, b)), h1, h2)
    assert sum(_build.LAUNCHES.values()) == 0  # the CPU runs the plain form
    _check(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", ["block", "full"])
def test_ke_plain_matches_jax_on_zero_exteriors(form, kind):
    M, N = SHAPES[0]
    w, a, b, h1, h2 = _inputs(M, N, kind, seed=7, lead=(LANES,))
    ja, jb, jw = (jnp.asarray(x) for x in (a, b, w))
    if form == "block":
        want = jax_pk.apply_a_batched_block_pallas(jw, ja, jb, h1, h2,
                                                   interpret=True)
        kernel, single = (hk.apply_a_batched_block_kernel,
                          hk.apply_a_block_plain)
    else:
        want = jax_pk.apply_a_batched_pallas(jw, ja, jb, h1, h2,
                                             interpret=True)
        kernel, single = hk.apply_a_batched_kernel, hk.apply_a_plain
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = kernel(torch.from_numpy(w), ta, tb, h1, h2)
    _check(got, want)
    # lane l is K-a's plain version on lane l, to the bit (signs of zero
    # included)
    for lane in range(LANES):
        one = single(torch.from_numpy(w[lane]), ta, tb, h1, h2)
        assert torch.equal(got[lane].view(torch.int32),
                           one.view(torch.int32))


def _code(path: Path) -> str:
    """A CUDA source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _body(code: str, name: str) -> str:
    """The body of the function ``name`` (its braces, balanced)."""
    start = code.index("{", re.search(rf"\b{name}\s*\(", code).end())
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[start:i + 1]
    raise AssertionError(f"{name}: unbalanced braces")


@pytest.mark.parametrize("name,divisions", [("face_flux", 1),
                                            ("stencil_of_fluxes", 2)])
def test_every_division_of_the_stencil_tree_goes_through_div_pos(name,
                                                                 divisions):
    code = _code(CSRC / "stencil_tree.cuh")
    body = _body(code, name)
    assert "/" not in body, f"{name} divides outside div_pos"
    assert body.count("div_pos(") == divisions
    # div_pos's own division is the only one in the header: PTX, on a
    # dividend that is never zero
    rest = code.replace(_body(code, "div_pos"), "")
    assert "/" not in rest
    assert "div.rn.f32" in _body(code, "div_pos")
    assert "_nz" not in code  # no second, unguarded tree beside it


def test_stencil_library_holds_one_kernel_design():
    """K-a f32 and bf16, K-e and K-g: one __global__ template,
    ``march_kernel``, reached from each of their C entry points; K-e's bf16
    form alone takes the vector-lane march (``lane_stencil_kernel``, the
    one other template, csrc/lane_march.cuh), from its one entry point."""
    code = _code(CSRC / "stencil.cu")
    assert re.findall(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s*"
                      r"(\w+)\(", code) == ["march_kernel",
                                           "lane_stencil_kernel"]
    assert code.count("__global__") == 2
    entries = re.findall(r"^int (pe_\w+)\(", code, flags=re.M)
    assert sorted(entries) == sorted(
        name for name in hk._SIGNATURES if name != "pe_stencil_error_string")
    lane = "pe_batched_stencil_bf16"
    for name in entries:
        body = _body(code, name)
        assert ("launch_lanes" in body) == (name == lane), name
        assert ("launch_march" in body) == (name != lane), name
    assert "lane_stencil_kernel" in _body(code, "launch_lanes")
    assert "march_kernel" not in _body(code, "launch_lanes")
