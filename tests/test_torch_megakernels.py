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

import collections
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
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
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


@pytest.mark.parametrize("M,N,want", [
    (10, 10, "resident"), (400, 600, "resident"), (800, 1200, "resident"),
    (1100, 1650, "resident"), (1600, 2400, "streamed"), (2400, 3200, "xl"),
])
def test_auto_walks_the_bf16_ladder_on_an_h100(M, N, want):
    """At bf16 a block holds twice the span: resident to 1100x1650,
    streamed at 1600x2400, xl at 2400x3200."""
    problem = Problem(M=M, N=N)
    assert engine.select_engine(problem, torch.bfloat16, H100) == want


def _resident_gate_before_the_march(problem, item):
    """The resident gate as it was before the march: 512 threads of 16
    (f32) or 32 (bf16) nodes, and seven arrays and 40 doubles of sums
    within a block's shared memory."""
    g1, g2 = problem.node_shape
    span = -(-g1 * g2 // H100.sm_count)
    return (span <= 512 * {4: 16, 2: 32}[item]
            and 7 * span * item + 320 <= H100.smem_per_block)


@pytest.mark.parametrize("item,dtype", [(4, torch.float32),
                                        (2, torch.bfloat16)])
def test_resident_gate_admits_the_grids_it_admitted(item, dtype):
    """The march keeps the span limit: every grid on a sweep across the
    gate's edge is admitted exactly when it was before."""
    for m in range(100, 1500, 37):
        for n in (m, 3 * m // 2, 2 * m):
            problem = Problem(M=m, N=n)
            assert (rp.fits_resident(problem, dtype, H100)
                    == _resident_gate_before_the_march(problem, item)), (m, n)


def test_gates_and_launch_shapes_agree():
    """The gate is the layout that sizes the launch: at 800x1200 a block
    holds 7288 nodes of seven arrays (204 KB) within 227 KB, marched by
    19 warps of two 32-column strips each, ap in registers; at 1100x1650
    the resident arrays would take 386 KB, the streamed state 166 KB."""
    mid = rp.layout(Problem(M=800, N=1200), H100)
    assert (mid.nblocks, mid.span) == (132, 7288) and mid.fits
    assert mid.smem_bytes == 7 * 7288 * 4 + 528 <= H100.smem_per_block
    assert (mid.threads, mid.split.per_warp, mid.split.rows) == (608, 2, 7)
    assert mid.ap_in_registers
    big = Problem(M=1100, N=1650)
    assert not rp.fits_resident(big, torch.float32, H100)
    plan = sp.StreamPlan(big, H100)
    assert plan.fits and plan.span == 13771
    assert plan.smem_bytes <= H100.smem_per_block
    # 52 strips of 9 steps, a warp two of them
    shape = plan.launch_shape()
    assert (shape.strips, shape.rows, shape.per_warp) == (52, 9, 2)
    assert shape.threads == 832
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


# ---------------------------------------------------------------- the march

# the edge cases of the march's split (spans of 1 node and empty blocks;
# 43-node spans in 91-node rows; one whole row a block) and auto's grids
MARCH_GRIDS = [(10, 10), (60, 90), (131, 200), (400, 600), (800, 1200),
               (1100, 1650)]


def _block_lengths(problem, span):
    """The distinct span lengths of a launch's blocks (the march's split
    is span-local: a block's nodes depend on its length alone)."""
    g1, g2 = problem.node_shape
    n = g1 * g2
    return sorted({max(0, min(n, (b + 1) * span) - b * span)
                   for b in range(H100.sm_count)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N", MARCH_GRIDS)
def test_march_covers_every_node_of_every_span_once(M, N, dtype):
    """Each kernel's split (``ws.march_split``, as csrc/grid_sync.cuh cuts
    it) walked as the kernel walks it (``ws.march_nodes``): every node of
    every block's span is one step of one lane, the lanes of a warp on one
    step hold consecutive nodes (one shared-memory row, no bank
    conflict), and no lane takes more steps in a unit than the kernel's
    unrolled loop holds."""
    problem = Problem(M=M, N=N)
    g2 = problem.node_shape[1]
    item = torch.empty((), dtype=dtype).element_size()
    lay = rp.layout(problem, H100, dtype)
    plan = sp.StreamPlan(problem, H100, dtype)
    for split, steps, span, warps in (
            (lay.split, rp.MARCH_STEPS[item], lay.span, rp.MAX_WARPS[item]),
            (plan.launch_shape(), sp.MARCH_STEPS, plan.span, sp.MAX_WARPS)):
        assert split.warps <= warps
        assert split.warps * split.per_warp >= split.units
        assert split.rows <= split.segs * steps
        for length in _block_lengths(problem, span):
            visits = list(ws.march_nodes(split, length, g2))
            assert sorted(v[-1] for v in visits) == list(range(length))
            lane_steps = collections.Counter(v[:3] for v in visits)
            assert max(lane_steps.values(), default=0) <= steps
            rows = collections.defaultdict(list)
            for warp, j, lane, t, node in visits:
                rows[warp, j, t].append((lane, node))
            for row in rows.values():
                row.sort()
                assert all(b - a == lb - la
                           for (la, a), (lb, b) in zip(row, row[1:]))


@pytest.mark.parametrize("M,N,dtype,warps,per_warp", [
    (400, 600, torch.float32, 19, 1), (800, 1200, torch.float32, 19, 2),
    (400, 600, torch.bfloat16, 19, 1), (800, 1200, torch.bfloat16, 19, 2),
    (1100, 1650, torch.bfloat16, 26, 2),
])
def test_resident_keeps_ap_in_registers_on_autos_grids(M, N, dtype, warps,
                                                       per_warp):
    lay = rp.layout(Problem(M=M, N=N), H100, dtype)
    assert lay.fits and lay.ap_in_registers
    assert (lay.split.warps, lay.split.per_warp) == (warps, per_warp)


def test_resident_ap_goes_to_memory_where_the_split_outgrows_registers():
    """A wide grid of short spans (2086 nodes in 2101-node rows: 66 strips
    of one step) gives a warp 4 units (19 warps at most): ap in the
    device-memory scratch."""
    lay = rp.layout(Problem(M=130, N=2100), H100)
    assert lay.fits and lay.split.strips == 66 and lay.split.per_warp == 4
    assert not lay.ap_in_registers


# (M, N, blocks the card holds at once, segs, nblocks): the main grid at
# 3 and 4 blocks an SM of an H100 (a 1-column strip: g2 = 3201 = 100*32 +
# 1), strips of 31 columns, a grid cut to MIN_ROWS rows a unit, one of
# fewer units than a block has warps, and a card too small for a unit a
# warp
XL_SPLITS = [
    (2400, 3200, 528, 41, 518),
    (2400, 3200, 396, 31, 392),
    (94, 126, 528, 12, 6),
    (60, 90, 528, 8, 3),
    (10, 10, 528, 2, 1),
    (2400, 3200, 8, 1, 8),
]


@pytest.mark.parametrize("M,N,co_resident,segs,nblocks", XL_SPLITS)
def test_xl_work_split(M, N, co_resident, segs, nblocks):
    """The march's units (a 32-column strip and a segment of rows, a warp
    each) from the shape and the blocks the card holds: every warp has
    one unit where the card has warps enough, and the segments' rows
    differ by at most one, so every block ends the stencil phase after
    the same rows within one."""
    plan = xp.XLPlan(Problem(M=M, N=N))
    assert plan.strips == -(-(N + 1) // xp.STRIP)
    assert plan.split(co_resident) == (segs, nblocks)
    rows = plan.rows(segs)
    assert sum(rows) == M + 1 and max(rows) - min(rows) <= 1
    units = plan.strips * segs
    warps = xp.WARPS * nblocks
    assert nblocks <= co_resident
    if units <= xp.WARPS * co_resident:
        # one unit a warp, and no block without one
        assert warps - xp.WARPS < units <= warps
    # no more segments than MIN_ROWS-row ones
    assert segs <= -(-(M + 1) // xp.MIN_ROWS)


def test_xl_nblocks_follows_the_forms_occupancy(monkeypatch):
    """XLPlan.launch_shape and nblocks split for the blocks ``form``'s own
    kernel holds at once (the launch query's answer)."""
    asked = []

    def co_resident(self, library, smem, form="f32"):
        asked.append((library, smem, form))
        return {"f32": 528, "bf16": 396}[form]

    monkeypatch.setattr(DeviceCapacity, "max_co_resident", co_resident)
    plan = xp.XLPlan(Problem(M=2400, N=3200))
    assert plan.launch_shape(H100) == (41, 518)
    assert plan.nblocks(H100, "bf16") == 392
    assert asked == [("xl_pcg", 0, "f32"), ("xl_pcg", 0, "bf16")]


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
    # 12 passes and the march's halo: z and p a row above and below a
    # 120-row unit and a column either side of a 32-column strip, an a row
    # below, bw a column east
    assert roofline.passes_per_iter("xl") == pytest.approx(
        12.0 + 5 / 120 + 5 / 32)
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


# each whole-solve library's launchers: its forms, and the forms of its
# timing instantiation (the form's arguments and the stamps)
LAUNCHERS = {
    rp: ("f32", "bf16", "stamps_f32", "stamps_bf16"),
    sp: ("f32", "bf16", "f32_bf16", "f32_f16", "stamps_f32", "stamps_bf16",
         "stamps_f32_bf16", "stamps_f32_f16"),
    xp: ("f32", "bf16", "f32_bf16", "f32_f16", "stamps_f32"),
}


@pytest.mark.parametrize("module,form", [(m, f) for m, forms in
                                         LAUNCHERS.items() for f in forms])
def test_launcher_signature_matches_the_c_prototype(module, form):
    """The ctypes argument list of each whole-solve launcher is the C
    prototype's, argument for argument: a mismatch is no error to ctypes
    and only misreads arguments on the card."""
    symbol = f"pe_{module.LIBRARY}_{form}"
    stamps = [ws.PTR] if form.startswith("stamps") else []
    assert ([_ctypes_kind(t) for t in module._SIGNATURE + stamps]
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
