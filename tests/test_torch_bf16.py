"""The dtype axes of auto's ladder against the JAX package, on the CPU:
bf16 compute on ``xla``, ``fused``, ``resident``, ``streamed`` and ``xl``,
and f32 compute with the narrow operand streams of ``streamed`` and ``xl``.

On the CPU each engine runs its kernels' plain versions; the JAX engines
run as their own tests run them (Pallas in interpret mode). What holds,
and why:

- The bf16 operands are bitwise the JAX package's: the assembly (a, b,
  rhs) and the derived sets the kernels read (the fused set, the streamed
  set, r0). The JAX package rounds f64 to bf16 through ml_dtypes, which
  rounds through f32; ``assembly.to_device`` is held to ml_dtypes on a
  value where one rounding from f64 would differ.
- bf16 compute at 40², δ = 1e-4, the JAX package's own bf16 test
  (``tests/test_engines.py:93-108``): every port engine converges, within 3
  iterations of the JAX package's bf16 ``xla`` (32), with l2 < 1e-2; the
  port's bf16 ``xla`` is within 3 of JAX's at 40² and at 44×132 (77). The
  counts are chaotic in bf16, so nothing is held bitwise; one PyTorch
  thread a test keeps each count deterministic.
- The narrow streams (f32 compute): the operator differs from the f32
  one only by the bf16 rounding of dinv, a and b, and both packages round
  them from the same f32 values, so the counts are equal (50 at 40², 135
  at 44×132), w within 5e-6 of its scale and l2 within 1e-6 of JAX's; f16
  overflows (1/ε > 65504) into NaN in both, with the same (iterations,
  converged, breakdown).
- Beyond 40² the fused and resident forms' operand set (the diagonal d
  rounded apart from its four neighbours) stops being the operator in
  bf16: at 44×132 both packages end early, "converged" at an l2 near
  ‖u‖ (ROADMAP Queue C). The port is held to the same behaviour.
"""

import ctypes
import importlib
import json
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.ops import fused_pcg as jax_fused
from poisson_ellipse_tpu.ops import streamed_pcg as jax_streamed
from poisson_ellipse_tpu.ops import xl_pcg as jax_xl
from poisson_ellipse_tpu.solver import engine as jax_engine
from poisson_ellipse_tpu.utils.error import (
    l2_error_vs_analytic as jax_l2_error,
)
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness import roofline
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops import xl_pcg as xp
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.solver import pcg
from poisson_ellipse_tpu_torch.utils.device import DeviceCapacity
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

jax_pcg = importlib.import_module("poisson_ellipse_tpu.solver.pcg")

BF16_ENGINES = ("xla", "fused", "resident", "streamed", "xl")
ITERS_BAND = 3  # tests/test_engines.py:107

H100 = DeviceCapacity(name="H100 (hand-built)", sm_count=132,
                      smem_per_block=232448, smem_per_sm=233472,
                      l2_bytes=50 * 2**20, total_memory=80 * 10**9)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test: the thread count orders the bf16 loop's
    ``torch.sum``, and so moves its chaotic count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_problem(problem: Problem) -> JaxProblem:
    return JaxProblem(M=problem.M, N=problem.N, norm=problem.norm,
                      delta=problem.delta, max_iter=problem.max_iter)


def _bits(x) -> np.ndarray:
    """The 16-bit words of a bf16 port tensor or JAX/ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _jax_bf16_xla(M, N):
    problem = JaxProblem(M=M, N=N, delta=1e-4)
    return jax_pcg.solve(problem, jnp.bfloat16)


@pytest.fixture(scope="module")
def jax_xla_40():
    """The JAX package's bf16 ``xla`` at 40², δ = 1e-4: the band's center."""
    ref = _jax_bf16_xla(40, 40)
    assert bool(ref.converged)
    return int(ref.iters)


# -- the operands ------------------------------------------------------------


def test_to_device_rounds_bf16_as_ml_dtypes():
    """ml_dtypes (the JAX package's host cast) rounds f64 to bf16 through
    f32: 1 + 2⁻⁸ + 2⁻³⁰ is 1.0 there, where one rounding from f64 gives
    1 + 2⁻⁷. The port's cast gives ml_dtypes' bits on it and on 200000
    seeded values across bf16's range."""
    tie = 1.0 + 2.0**-8 + 2.0**-30
    rng = np.random.default_rng(0)
    values = np.concatenate([
        [tie, -tie, 1.0 + 2.0**-8, 0.0, -0.0, 1e-40, 3e38, 1e-3, 2.5e4],
        rng.standard_normal(100000) * 10.0 ** rng.integers(-30, 30, 100000),
        rng.random(100000),
    ])
    got = assembly.to_device(values, torch.bfloat16, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got), _bits(values.astype(ml_dtypes.bfloat16)))
    assert float(got[0]) == 1.0 and float(got[1]) == -1.0
    # f32 and f64 stay numpy's own astype
    assert torch.equal(assembly.to_device(values, torch.float32, "cpu"),
                       torch.from_numpy(values.astype(np.float32)))


@pytest.mark.parametrize("M,N", [(40, 40), (44, 132)])
def test_bf16_assembly_is_bitwise_jax(M, N):
    problem = Problem(M=M, N=N)
    ours = assembly.assemble(problem, torch.bfloat16, "cpu")
    theirs = jax_assembly.assemble(_jax_problem(problem), jnp.bfloat16)
    for x, y in zip(ours, theirs):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_bf16_operand_sets_are_bitwise_jax():
    """The sets the kernels read: the fused (an, as_, bw, be, d, dinv),
    the streamed and xl (dinv, an, bw, r0), and the resident (an, bw, d,
    dinv, r0), which holds the fused set's d and dinv and the streamed
    set's unmasked an, bw."""
    problem = Problem(M=44, N=132)
    jp = _jax_problem(problem)
    jplan = jax_streamed.StreamPlan(jp, jnp.bfloat16)
    fused_ref = interop.fused_operands_from_reference(
        problem, jax_fused.fused_operands(jp, jplan.g1p, jplan.g2p,
                                          jnp.bfloat16), device="cpu")
    streamed_ref = interop.streamed_operands_from_reference(
        problem, jax_streamed.streamed_operand_set(jp, jnp.bfloat16,
                                                   jplan.g1p, jplan.g2p),
        device="cpu")
    fused = fp.fused_operands(problem, torch.bfloat16, "cpu")
    streamed = sp.streamed_operands(problem, torch.bfloat16, "cpu")
    an, bw, d, dinv, r0 = rp.resident_operands(problem, torch.bfloat16,
                                               "cpu")
    pairs = (list(zip(fused, fused_ref)) + list(zip(streamed, streamed_ref))
             + [(an, streamed_ref[1]), (bw, streamed_ref[2]),
                (d, fused_ref[4]), (dinv, fused_ref[5]),
                (r0, streamed_ref[3])])
    for x, y in pairs:
        assert x.dtype == y.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype and bits."""
    if x.dtype != y.dtype:
        return False
    if x.element_size() == 2:
        return torch.equal(x.view(torch.int16), y.view(torch.int16))
    return torch.equal(x, y)


def test_narrow_operand_streams_round_from_the_f32_set():
    """``storage_dtype`` rounds dinv, an, bw from their f32 values, as the
    JAX ``build_xl_solver`` does; r0 stays f32."""
    problem = Problem(M=44, N=132)
    full = sp.streamed_operands(problem, torch.float32, "cpu")
    for st in ("bf16", "f16"):
        narrow = sp.streamed_operands(problem, torch.float32, "cpu", st)
        _, ref = jax_xl.build_xl_solver(_jax_problem(problem), jnp.float32,
                                        storage_dtype=st)
        ref = interop.streamed_operands_from_reference(problem, ref,
                                                       device="cpu")
        for x, y, f in zip(narrow, ref, full):
            assert _same(x, y) and _same(x, f.to(x.dtype))
        assert narrow[3].dtype == torch.float32


# -- bf16 compute ------------------------------------------------------------


def test_bf16_xla_solves_where_the_jax_package_does(jax_xla_40):
    """The open fault of the port's first bf16 run: ``pcg.solve`` at bf16
    crashed in assembly."""
    problem = Problem(M=40, N=40, delta=1e-4)
    got = pcg.solve(problem, torch.bfloat16, device="cpu")
    assert got.w.dtype == torch.bfloat16 and bool(got.converged)
    assert abs(int(got.iters) - jax_xla_40) <= ITERS_BAND


@pytest.mark.parametrize("name", BF16_ENGINES)
def test_bf16_engines_converge_in_the_jax_band(name, jax_xla_40):
    problem = Problem(M=40, N=40, delta=1e-4)
    _build.reset_launches()
    got = engine.solve(problem, name, torch.bfloat16, device="cpu")
    assert got.w.dtype == torch.bfloat16 and got.diff.dtype == torch.bfloat16
    assert bool(got.converged) and not bool(got.breakdown)
    assert abs(int(got.iters) - jax_xla_40) <= ITERS_BAND, name
    assert float(l2_error_vs_analytic(problem, got.w)) < 1e-2
    # the plain versions on the CPU launch nothing
    assert sum(_build.LAUNCHES.values()) == 0


def test_bf16_xla_count_at_44x132_is_the_jax_packages():
    ours = pcg.solve(Problem(M=44, N=132, delta=1e-4), torch.bfloat16,
                     device="cpu")
    ref = _jax_bf16_xla(44, 132)
    assert bool(ours.converged) and bool(ref.converged)
    assert abs(int(ours.iters) - int(ref.iters)) <= ITERS_BAND


@pytest.mark.parametrize("name", ["fused", "resident"])
def test_bf16_cancelling_stencil_ends_early_as_in_jax(name):
    """Reference behaviour, not a port fault (ROADMAP Queue C): at 44×132
    the bf16 fused and resident forms "converge" early far from u, in the
    JAX package as in the port."""
    problem = Problem(M=44, N=132, delta=1e-4)
    got = engine.solve(problem, name, torch.bfloat16, device="cpu")
    ref = jax_engine.solve(_jax_problem(problem), name, jnp.bfloat16)
    ours_l2 = float(l2_error_vs_analytic(problem, got.w))
    jax_l2 = float(jax_l2_error(_jax_problem(problem),
                                jnp.asarray(ref.w, jnp.float32)))
    assert bool(got.converged) and bool(ref.converged)
    assert ours_l2 > 3e-2 and jax_l2 > 3e-2
    assert ours_l2 == pytest.approx(jax_l2, rel=0.2)


def test_bf16_plain_versions_store_bf16():
    """Every whole-solve plain version returns w and the step norm at the
    compute dtype; a capped run is the same whether it is issued through
    the engine or the module."""
    problem = Problem(M=30, N=22, max_iter=7)
    for name, run in (
            ("resident", lambda: rp.resident_plain(
                problem, *rp.resident_operands(problem, torch.bfloat16,
                                               "cpu"))[0]),
            ("streamed", lambda: sp.streamed_plain(
                problem, *sp.streamed_operands(problem, torch.bfloat16,
                                               "cpu"))[0]),
            ("xl", lambda: xp.xl_plain(
                problem, *sp.streamed_operands(problem, torch.bfloat16,
                                               "cpu"))[0])):
        got = run()
        assert got.w.dtype == got.diff.dtype == torch.bfloat16, name
        assert int(got.iters) == 7
        again = engine.solve(problem, name, torch.bfloat16, device="cpu")
        assert torch.equal(again.w, got.w), name


def test_rounder_is_the_identity_at_f32():
    x = torch.randn(5, dtype=torch.float32)
    assert ws.rounder(torch.float32)(x) is x
    q = ws.rounder(torch.bfloat16)
    assert torch.equal(q(x), x.to(torch.bfloat16).float())
    assert ws.held(x) is x and ws.held(x.bfloat16()).dtype == torch.float32


# -- the narrow operand streams ----------------------------------------------

JAX_BUILDERS = {"streamed": jax_streamed.build_streamed_solver,
                "xl": jax_xl.build_xl_solver}


@pytest.mark.parametrize("name", sorted(JAX_BUILDERS))
@pytest.mark.parametrize("M,N,want", [(40, 40, 50), (44, 132, 135)])
def test_bf16_streams_match_jax(name, M, N, want):
    problem = Problem(M=M, N=N)
    got = engine.solve(problem, name, torch.float32, device="cpu",
                       storage_dtype="bf16")
    solver, args = JAX_BUILDERS[name](_jax_problem(problem), jnp.float32,
                                      storage_dtype="bf16")
    ref = solver(*args)
    assert int(got.iters) == int(ref.iters) == want
    assert bool(got.converged) and bool(ref.converged)
    assert got.w.dtype == torch.float32
    ref_w = interop.strip_padding(problem, ref.w)
    scale = float(np.abs(ref_w).max())
    np.testing.assert_allclose(got.w.numpy(), ref_w, rtol=0,
                               atol=5e-6 * scale)
    ours_l2 = float(l2_error_vs_analytic(problem, got.w))
    jax_l2 = float(jax_l2_error(_jax_problem(problem), jnp.asarray(ref_w)))
    assert abs(ours_l2 - jax_l2) <= 1e-6


@pytest.mark.parametrize("name", sorted(JAX_BUILDERS))
def test_f16_streams_overflow_as_in_jax(name):
    problem = Problem(M=40, N=40)
    got = engine.solve(problem, name, torch.float32, device="cpu",
                       storage_dtype="f16")
    solver, args = JAX_BUILDERS[name](_jax_problem(problem), jnp.float32,
                                      storage_dtype="f16")
    ref = solver(*args)
    triple = lambda r: (int(r.iters), bool(r.converged), bool(r.breakdown))
    assert triple(got) == triple(ref) == (1521, False, False)
    assert bool(torch.isnan(got.w).any())
    assert bool(np.isnan(np.asarray(ref.w)).any())


def test_storage_forms_take_the_f32_plan():
    """The plan budgets the operands at the compute width under a narrow
    storage dtype, as JAX's does: the storage dtype never changes the
    plan a grid gets (here the passes it streams), nor auto's rung."""
    big = Problem(M=1100, N=1650)
    for st in (None, "bf16", "f16"):
        assert roofline.passes_per_iter("streamed", big, H100,
                                        storage_dtype=st) == 3.0
    solver, args = sp.build_streamed_solver(Problem(M=20, N=20),
                                            torch.float32, "cpu",
                                            storage_dtype="bf16")
    assert [a.dtype for a in args] == [torch.bfloat16] * 3 + [torch.float32]
    assert int(solver(*args).iters) == 26
    with pytest.raises(ValueError, match="no kernel"):
        # bf16 compute has no f16 operand form
        sp.build_streamed_solver(Problem(M=20, N=20), torch.bfloat16, "cpu",
                                 storage_dtype="f16")
    with pytest.raises(ValueError, match="no kernel"):
        xp.build_xl_solver(Problem(M=20, N=20), torch.float64, "cpu")


# -- the engine policy, the harness, the forms ------------------------------


@pytest.mark.parametrize("M,N,f32,bf16", [
    (400, 600, "resident", "resident"),
    (800, 1200, "resident", "resident"),
    (1100, 1650, "streamed", "resident"),
    (1600, 2400, "xl", "streamed"),
    (2400, 3200, "xl", "xl"),
])
def test_auto_walks_the_ladder_at_two_bytes_a_node(M, N, f32, bf16):
    problem = Problem(M=M, N=N)
    assert engine.select_engine(problem, torch.float32, H100) == f32
    assert engine.select_engine(problem, torch.bfloat16, H100) == bf16
    _, _, resolved = engine.build_solver(Problem(M=10, N=10), "auto",
                                         torch.bfloat16, "cpu")
    assert resolved == "xl"


def test_resident_gate_scales_with_the_element_size():
    """At bf16 a block holds twice the span (a span limit of 16384 nodes
    against f32's 8192): 1100×1650 needs 13771 nodes a block, 193 KB of
    227 KB, marched by 26 warps of two strips, ap in registers."""
    lay = rp.layout(Problem(M=1100, N=1650), H100, torch.bfloat16)
    assert lay.fits and lay.span == 13771
    assert lay.smem_bytes == 7 * 13771 * 2 + 528
    assert rp.SPAN_LIMIT == {4: 8192, 2: 16384}
    assert lay.threads == 832 and lay.ap_in_registers
    assert not rp.layout(Problem(M=1100, N=1650), H100, torch.float32).fits
    assert not rp.layout(Problem(M=1600, N=2400), H100, torch.bfloat16).fits
    assert not rp.layout(Problem(M=10, N=10), H100, torch.float64).fits


def test_harness_runs_bf16(capsys):
    rep = run_once(Problem(M=20, N=20), dtype="bf16", engine="auto",
                   device="cpu")
    d = rep.json_dict()
    assert d["dtype"] == "bf16" and d["engine"] == "xl" and d["converged"]
    assert cli_main(["20", "20", "--dtype", "bf16", "--engine", "xla",
                     "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dtype"] == "bf16" and out["engine"] == "xla"
    # bf16 reaches the kernel loops too (tests/test_torch_bf16_loops.py),
    # and the batched kernel engines (K-e's bf16 form)
    assert cli_main(["20", "20", "--dtype", "bf16", "--engine", "pallas",
                     "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dtype"] == "bf16" and out["engine"] == "pallas"
    assert cli_main(["20", "20", "--dtype", "bf16", "--engine",
                     "batched-pallas", "--lanes", "2", "--device", "cpu",
                     "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["dtype"], out["engine"], out["lanes"]) == (
        "bf16", "batched-pallas", 2) and out["converged"]


def test_auto_with_a_storage_dtype_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="has no storage-dtype form"):
        engine.build_solver(Problem(M=10, N=10), "auto", torch.float32,
                            "cpu", storage_dtype="bf16")
    with pytest.raises(ValueError):
        jax_engine.build_solver(JaxProblem(M=10, N=10), "auto", jnp.float32,
                                storage_dtype="bf16")


def test_forms_and_their_counters():
    assert ws.form_of(torch.float32) == "f32"
    assert ws.form_of(torch.bfloat16) == "bf16"
    assert ws.form_of(torch.float32, torch.bfloat16) == "f32_bf16"
    assert ws.form_of(torch.float32, torch.float16) == "f32_f16"
    for bad in ((torch.bfloat16, torch.float16), (torch.float64, None),
                (torch.float16, None)):
        with pytest.raises(ValueError, match="no kernel"):
            ws.form_of(*bad)
    assert ws.counter("xl", "f32") == "xl"
    assert ws.counter("xl", "f32_bf16") == "xl_f32_bf16"
    assert ws.counter(fp.K1, fp.DTYPES[torch.bfloat16]) == "fused_k1_bf16"


def test_roofline_counts_narrow_operands_and_bf16_passes():
    problem = Problem(M=2400, N=3200)
    full = roofline.bytes_per_node("xl", problem)
    assert full == pytest.approx(4 * xp.PASSES_PER_ITER)
    assert roofline.bytes_per_node("xl", problem, dtype=torch.bfloat16) == \
        pytest.approx(2 * xp.PASSES_PER_ITER)
    narrow = roofline.bytes_per_node("xl", problem, storage_dtype="bf16")
    assert narrow == pytest.approx(full - 2 * xp.OPERAND_PASSES)
    big = Problem(M=1100, N=1650)
    # on an H100 the f32 plan streams dinv, a and b: 3 passes, all narrow
    assert roofline.operand_passes("streamed", big, H100) == 3.0
    assert roofline.bytes_per_node("streamed", big, H100,
                                   storage_dtype="bf16") == 6.0
    # the state engines narrow every pass
    assert roofline.bytes_per_node("pallas", problem,
                                   storage_dtype="bf16") == 26.0


def _c_parameters(library: str, symbol: str) -> list:
    """The parameter kinds ("ptr", "int", "float") of ``symbol``'s C
    prototype in ``csrc/<library>.cu``."""
    source = _build.source_path(library).read_text()
    match = re.search(rf"\bint {symbol}\(([^)]*)\)", source)
    assert match, f"{symbol} not found in {library}.cu"
    return ["ptr" if "*" in p else " ".join(p.split()).rsplit(" ", 1)[0]
            .removeprefix("const ") for p in match.group(1).split(",")]


def _kinds(argtypes) -> list:
    names = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    return [names[t] for t in argtypes]


@pytest.mark.parametrize("module,forms", [
    (rp, ws.COMPUTE_FORMS), (sp, ws.FORMS), (xp, ws.FORMS)])
def test_every_form_launcher_matches_its_c_prototype(module, forms):
    """A ctypes list that drifts from a C prototype is no ctypes error: the
    kernel misreads its arguments on the card. Every form's launcher
    shares its module's list; xl's per-form launch queries the f32 one's."""
    for form in forms:
        assert _kinds(module._SIGNATURE) == _c_parameters(
            module.LIBRARY, f"pe_{module.LIBRARY}_{form}")
    if module is xp:
        for form in ws.FORMS[1:]:
            assert _c_parameters(xp.LIBRARY,
                                 f"pe_xl_pcg_{form}_launch_query") == [
                "int", "int", "ptr", "ptr"]


def test_fused_form_launchers_match_their_c_prototypes():
    for form in fp.DTYPES.values():
        for kernel in ("k1", "k2"):
            symbol = f"pe_fused_{kernel}_{form}"
            restype, argtypes = fp._SIGNATURES[symbol]
            assert restype is ctypes.c_int
            assert _kinds(argtypes) == _c_parameters(fp.LIBRARY, symbol)
