"""The port's whole-solve engines (resident, streamed, xl) on the CPU,
against the JAX package's Pallas kernels run in interpret mode.

On the CPU each engine runs its kernel's plain version. Both packages
assemble the same problem in f64 and round the operands once to f32; the
JAX kernels run as ``tests/test_engines.py`` runs them (interpret mode on
the CPU backend). The bar is that suite's own: equal iteration counts and
w within atol 5e-6 (``tests/test_engines.py:52-54``).

The gate tests use a hand-built H100 capacity (132 SMs, 232448 B of shared
memory a block may opt into), so they hold on a machine without a card.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import fused_pcg as jax_fused
from poisson_ellipse_tpu.ops import streamed_pcg as jax_streamed
from poisson_ellipse_tpu.ops.resident_pcg import solve_resident
from poisson_ellipse_tpu.ops.streamed_pcg import solve_streamed
from poisson_ellipse_tpu.ops.xl_pcg import build_xl_solver, solve_xl
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness import roofline
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
from poisson_ellipse_tpu_torch.ops import xl_pcg as xp
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.utils.device import DeviceCapacity

W_ATOL = 5e-6

JAX_SOLVERS = {"resident": solve_resident, "streamed": solve_streamed,
               "xl": solve_xl}

CASES = [(10, 10, "unweighted", 17), (20, 20, "unweighted", 31),
         (40, 40, "unweighted", 61), (20, 20, "weighted", 26),
         (40, 40, "weighted", 50), (44, 132, "weighted", None)]

H100 = DeviceCapacity(name="H100 (hand-built)", sm_count=132,
                      smem_per_block=232448, smem_per_sm=233472,
                      l2_bytes=50 * 2**20, total_memory=80 * 10**9)


def _jax_problem(problem: Problem) -> JaxProblem:
    return JaxProblem(M=problem.M, N=problem.N, norm=problem.norm,
                      delta=problem.delta, max_iter=problem.max_iter)


def _assert_same_solve(got, ref, want=None):
    assert int(got.iters) == int(ref.iters)
    if want is not None:
        assert int(got.iters) == want
    assert bool(got.converged) == bool(ref.converged)
    assert bool(got.breakdown) == bool(ref.breakdown)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=W_ATOL)


@pytest.mark.parametrize("engine_name", sorted(JAX_SOLVERS))
@pytest.mark.parametrize("M,N,norm,want", CASES)
def test_plain_matches_the_jax_kernel(engine_name, M, N, norm, want):
    problem = Problem(M=M, N=N, norm=norm)
    got = engine.solve(problem, engine_name, torch.float32, device="cpu")
    ref = JAX_SOLVERS[engine_name](_jax_problem(problem), jnp.float32)
    _assert_same_solve(got, ref, want)
    assert bool(got.converged)


@pytest.mark.parametrize("engine_name", sorted(JAX_SOLVERS))
def test_max_iter_cap(engine_name):
    problem = Problem(M=40, N=40, max_iter=5)
    got = engine.solve(problem, engine_name, torch.float32, device="cpu")
    ref = JAX_SOLVERS[engine_name](_jax_problem(problem), jnp.float32)
    assert int(got.iters) == int(ref.iters) == 5
    assert not bool(got.converged) and not bool(got.breakdown)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=W_ATOL)


@pytest.mark.parametrize("tm", [8, 16])
def test_xl_matches_the_jax_kernel_over_several_tiles(tm):
    problem = Problem(M=40, N=40)
    solver, args = build_xl_solver(_jax_problem(problem), tm=tm)
    ref = solver(*args)
    got = engine.solve(problem, "xl", torch.float32, device="cpu")
    _assert_same_solve(got, ref, 50)


def _all_streamed_budget(problem, monkeypatch, extra=0):
    """Shrink the JAX plan's VMEM budget so nothing but the state (and
    ``extra`` bytes) fits: the z-state regime (test_engines.py:140-164)."""
    base = jax_streamed.StreamPlan(_jax_problem(problem), jnp.float32, tm=64)
    state_bytes = (3 * base.g1p + 16) * base.g2p * 4
    monkeypatch.setattr(jax_streamed, "_VMEM_USABLE",
                        state_bytes + base.min_stream_bytes + extra)
    return base


def _small_card(problem, operands: int) -> DeviceCapacity:
    """A capacity whose blocks hold the state and ``operands`` operands."""
    plan = sp.StreamPlan(problem, H100)
    smem = plan.state_bytes + operands * plan.operand_bytes
    return DeviceCapacity(name="small card", sm_count=H100.sm_count,
                          smem_per_block=smem, smem_per_sm=smem,
                          l2_bytes=0, total_memory=0)


def test_streamed_z_state_matches_the_jax_all_streamed_kernel(monkeypatch):
    problem = Problem(M=200, N=132, norm="weighted")
    _all_streamed_budget(problem, monkeypatch)
    jplan = jax_streamed.StreamPlan(_jax_problem(problem), jnp.float32, tm=64)
    assert jplan.fits and not any(jplan.resident.values())
    solver, args = jax_streamed.build_streamed_solver(
        _jax_problem(problem), jnp.float32, tm=64)
    ref = solver(*args)

    cap = _small_card(problem, operands=0)
    plan = sp.StreamPlan(problem, cap)
    assert plan.fits and not any(plan.resident.values()) and plan.zstate
    got = engine.solve(problem, "streamed", torch.float32, device="cpu",
                       capacity=cap)
    _assert_same_solve(got, ref)
    assert bool(got.converged)
    # the r-state run of the same problem converges in the same count
    rstate = engine.solve(problem, "streamed", torch.float32, device="cpu")
    assert int(rstate.iters) == int(got.iters)


def test_streamed_plan_takes_ap_before_dinv(monkeypatch):
    """With room for one operand the plan keeps ap (2 passes saved) and
    streams dinv, as the JAX plan does: the z-state with ap resident."""
    problem = Problem(M=200, N=132, norm="weighted")
    base = jax_streamed.StreamPlan(_jax_problem(problem), jnp.float32, tm=64)
    ap_upgrade = (base.full_rows["ap"] - base.tile_rows["ap"]) * base.g2p * 4
    _all_streamed_budget(problem, monkeypatch, extra=ap_upgrade)
    jplan = jax_streamed.StreamPlan(_jax_problem(problem), jnp.float32, tm=64)
    assert jplan.resident["ap"] and not jplan.resident["dinv"]
    solver, args = jax_streamed.build_streamed_solver(
        _jax_problem(problem), jnp.float32, tm=64)
    ref = solver(*args)

    cap = _small_card(problem, operands=1)
    plan = sp.StreamPlan(problem, cap)
    assert plan.resident == {"ap": True, "dinv": False, "a": False,
                             "b": False}
    assert plan.streamed_passes_per_iter() == 3.0
    got = engine.solve(problem, "streamed", torch.float32, device="cpu",
                       capacity=cap)
    _assert_same_solve(got, ref)


# ---------------------------------------------------------------- the gates


@pytest.mark.parametrize("M,N,want", [
    (10, 10, "resident"), (400, 600, "resident"), (800, 1200, "resident"),
    (1100, 1650, "streamed"), (1600, 2400, "xl"), (2400, 3200, "xl"),
])
def test_auto_walks_the_ladder_on_an_h100(M, N, want):
    problem = Problem(M=M, N=N)
    assert engine.select_engine(problem, torch.float32, H100) == want
    assert engine.select_engine(problem, torch.float64, H100) == "xla"


def test_ladder_and_the_cpu_rule():
    assert engine.CAPACITY_LADDER == ("resident", "streamed", "xl")
    for name in engine.CAPACITY_LADDER:
        assert engine.ENGINE_CAPS[name]["dtypes"] == (torch.float32,
                                                      torch.bfloat16)
        assert engine.ENGINE_CAPS[name]["kernels"] == (name,)
    # without a capacity (the CPU) auto takes the xl plain version
    problem = Problem(M=20, N=20)
    assert engine.select_engine(problem, torch.float32) == "xl"
    solver, args, resolved = engine.build_solver(problem, "auto",
                                                 torch.float32, "cpu")
    assert resolved == "xl"
    assert int(solver(*args).iters) == 26
    # with one, it plans as on that card
    _, _, resolved = engine.build_solver(problem, "auto", torch.float32,
                                         "cpu", capacity=H100)
    assert resolved == "resident"


def test_gates_and_launch_shapes_agree():
    """The gate is the layout that sizes the launch: at 800x1200 a block
    holds 7288 nodes of seven arrays (204 KB) within 227 KB; at 1100x1650
    the resident arrays would take 386 KB, the streamed state 166 KB."""
    mid = rp.layout(Problem(M=800, N=1200), H100)
    assert (mid.nblocks, mid.span) == (132, 7288) and mid.fits
    assert mid.smem_bytes == 7 * 7288 * 4 + 320 <= H100.smem_per_block
    big = Problem(M=1100, N=1650)
    assert not rp.fits_resident(big, torch.float32, H100)
    plan = sp.StreamPlan(big, H100)
    assert plan.fits and plan.span == 13771
    assert plan.smem_bytes <= H100.smem_per_block
    # room for ap beside the state, not for dinv: the z-state regime
    assert plan.resident == {"ap": True, "dinv": False, "a": False,
                             "b": False}
    assert plan.zstate
    # forcing dinv on chip instead gives the r-state regime, and it fits
    forced = sp.StreamPlan(big, H100, resident=("dinv",))
    assert not forced.zstate and forced.smem_bytes <= H100.smem_per_block
    with pytest.raises(ValueError, match="do not fit"):
        sp.StreamPlan(big, H100, resident=("ap", "dinv"))
    assert not sp.fits_streamed(Problem(M=1600, N=2400), torch.float32, H100)


def test_hand_built_capacity_answers_no_launch_query():
    """A capacity built by hand describes a card for the gates only: the
    cooperative-launch attribute and the occupancy are the card's own."""
    for query in (lambda: H100.cooperative_launch("xl_pcg"),
                  lambda: H100.max_co_resident("xl_pcg", 0)):
        with pytest.raises(ValueError, match="hand-built"):
            query()


def test_explicit_engine_past_its_gate_raises():
    with pytest.raises(ValueError, match="resident gate"):
        engine.build_solver(Problem(M=1100, N=1650), "resident",
                            torch.float32, "cpu", capacity=H100)
    with pytest.raises(ValueError, match="state"):
        engine.build_solver(Problem(M=1600, N=2400), "streamed",
                            torch.float32, "cpu", capacity=H100)


def test_pass_models():
    assert roofline.passes_per_iter("resident") == 0.0
    assert roofline.passes_per_iter("xl") == pytest.approx(
        12.0 + 2 * 132 / 1024 + 2 / 32)
    big = Problem(M=1100, N=1650)
    assert roofline.passes_per_iter("streamed", big, H100) == 3.0
    # on the CPU every operand is resident
    assert roofline.passes_per_iter("streamed", big) == 0.0


# ---------------------------------------------------------------- operands


def test_streamed_operands_from_reference_equal_the_ports_own():
    problem = Problem(M=44, N=132)
    plan = jax_streamed.StreamPlan(_jax_problem(problem), jnp.float32)
    ref = jax_streamed.streamed_operand_set(_jax_problem(problem),
                                            jnp.float32, plan.g1p, plan.g2p)
    assert np.asarray(ref[1]).shape[0] == plan.g1p + 8
    ours = sp.streamed_operands(problem, torch.float32, "cpu")
    carried = interop.streamed_operands_from_reference(problem, ref,
                                                       device="cpu")
    for x, y in zip(ours, carried):
        assert x.dtype == y.dtype == torch.float32
        assert torch.equal(x, y)
    bad = [np.array(x) for x in ref]
    bad[1][problem.M + 3, 0] = 1.0
    with pytest.raises(ValueError, match="padding"):
        interop.streamed_operands_from_reference(problem, bad, device="cpu")
    with pytest.raises(ValueError):
        interop.streamed_operands_from_reference(problem, ref[:3],
                                                 device="cpu")


def test_resident_operands_hold_the_masked_set_values():
    """as_/be and the mask formed from the unmasked an, bw give the JAX
    resident kernel's masked operands element for element."""
    problem = Problem(M=30, N=22)
    an, bw, d, dinv, _ = rp.resident_operands(problem, torch.float32, "cpu")
    ref = interop.fused_operands_from_reference(
        problem, jax_fused.fused_operands(_jax_problem(problem), 32, 128,
                                          jnp.float32), device="cpu")
    from poisson_ellipse_tpu_torch.ops import whole_solve as ws

    inside = ws.interior(problem, an)
    zero = torch.zeros_like(an)
    ours = (torch.where(inside, an, zero),
            torch.where(inside, ws.next_row(an), zero),
            torch.where(inside, bw, zero),
            torch.where(inside, ws.next_col(bw), zero), d, dinv)
    for x, y in zip(ours, ref):
        assert torch.equal(x, y)


def _c_parameters(library: str, symbol: str) -> list:
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


def _ctypes_kind(t) -> str:
    if t is ctypes.c_int:
        return "int"
    if t is ctypes.c_float:
        return "float"
    assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), t
    return "ptr"


@pytest.mark.parametrize("module", [rp, sp, xp])
def test_launcher_signature_matches_the_c_prototype(module):
    """The ctypes argument list of each whole-solve launcher is the C
    prototype's, argument for argument: a mismatch is no error to ctypes
    and only misreads arguments on the card."""
    symbol = f"pe_{module.LIBRARY}_f32"
    assert ([_ctypes_kind(t) for t in module._SIGNATURE]
            == _c_parameters(module.LIBRARY, symbol))
    assert _c_parameters(module.LIBRARY, f"pe_{module.LIBRARY}_launch_query"
                         ) == ["int", "int", "ptr", "ptr"]


def test_plain_versions_count_no_launch():
    _build.reset_launches()
    for name in ("resident", "streamed", "xl"):
        engine.solve(Problem(M=10, N=10), name, device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0


def test_breakdown_holds_w_and_reports_the_count():
    """delta = 1e-30 is never met: every engine ends on the denominator
    guard with the JAX kernel's count, w held at its last update."""
    problem = Problem(M=20, N=20, delta=1e-30)
    for name, fn in JAX_SOLVERS.items():
        got = engine.solve(problem, name, torch.float32, device="cpu")
        ref = fn(_jax_problem(problem), jnp.float32)
        assert bool(got.breakdown) and bool(ref.breakdown), name
        assert int(got.iters) == int(ref.iters), name
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                                   atol=W_ATOL, err_msg=name)


def test_host_reads_and_solver_reuse():
    problem = Problem(M=20, N=20)
    solver, args = xp.build_xl_solver(problem, device="cpu")
    one = solver(*args)
    two = solver(*args)
    assert int(one.iters) == int(two.iters) == 26
    assert torch.equal(one.w, two.w)
    # the plain loop tests its condition once per body, plus the exit
    assert solver.host_syncs == int(one.iters) + 2
