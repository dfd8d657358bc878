"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; whether there is one is decided inside the ``cuda`` fixture, never
while the module is imported. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: the kernels are built with ``-fmad=false``, so arrays agree
with the plain versions to 1e-6 (bitwise in practice); per-block sums are
added in another order than ``torch.sum``'s, so sums agree to rel 1e-5.
The whole-solve kernels (resident, streamed, xl) run capped solves against
their plain versions on the card: equal iterations and flags, w and the
step norm within rel 1e-5 of their scale (the reordered sums move α and β
in their last bits, and w follows). K-d's stencil is bitwise K-a's and its
plain version's; its sums, in double rounded once to f32 on both sides,
agree to rel 1e-6. The lane-batched kernels K-e and K-f are held lane by
lane, bitwise, against K-a and K-d on that lane, and against their plain
versions (arrays bitwise, K-f's sums to rel 1e-6); the two batched kernel
engines keep lane independence and chunked == straight to the bit. The
storage axis's K-g and K-h widen their narrow loads exactly, so they are
held bitwise against their plain versions and against K-a / K-d on the
upcast inputs (K-h's sums to rel 1e-6 of the plain version's, bitwise
K-d's); ``pallas`` with bf16 storage takes ``xla``'s iterations and flags.
The dtype forms (bf16 compute; f32 compute with bf16 or f16 operand
streams) are held like their f32 forms, NaN in the same places where an f16
stream overflows, and bitwise on seeded finite operands; K-b / K-c bf16,
which sum in double on both sides, bitwise in their arrays. K1-shard and
K2-shard (the mesh's kernels) are held bitwise in their arrays against
their plain versions, and their per-block sums, added in double and
rounded once to f32, equal to the plain version's rounded sums; the
sharded path runs through ``run_once`` on one rank over NCCL and on two
ranks sharing the card over gloo. The stage-4 kernels (dinv, dot,
update_w_r, update_p; f32 and f64) are held bitwise in their arrays and
their sums to rel 1e-6 (f32) / 1e-12 (f64), both summed in double; dot and
update_p also from 1x1 to 2401x3201 and on views one element past an
aligned buffer, one device kernel a call, a CUDA graph's launch equal to
the eager one, and dot the same bits on two launches; the bf16
forms of K-a and K-d bitwise in arrays and sums, as their plain versions
compute in float and round once where they store. The K-d family (K-d
f32 and bf16, K-h bf16 and f16, K-f) gives the same bits on the pipelined
bundle's table (compiled in) and on the bundle with each pair swapped
(the generic instantiation), one device kernel a call, and a K-d / K-f
launch captured in a CUDA graph equals the eager one. The plain-stencil
march (K-a f32 and bf16, K-e) is held bitwise, on integer views so the
sign of a zero counts, on seeded, +0, -0 and zero-exterior inputs at
ragged shapes, on capped solves' own w, lane by lane at B = 1, 3 and 32,
and in a CUDA graph. Device activities are counted in a fresh
process (``activities``): after the graph tests the profiler recorded no
activity for some calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
from poisson_ellipse_tpu_torch.batch import batched_pipelined as bpp
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4
from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops import xl_pcg as xp
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs
from poisson_ellipse_tpu_torch.solver import engine
from poisson_ellipse_tpu_torch.utils.device import capacity

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
    assert _same_bits(got, hk.apply_a_plain(w, a, b, h1, h2))
    assert _same_bits(block, hk.apply_a_block_plain(w, a, b, h1, h2))
    assert _same_bits(got[1:-1, 1:-1], block)
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
                                               ("fused", torch.float32),
                                               ("resident", torch.float32),
                                               ("streamed", torch.float32),
                                               ("xl", torch.float32)])
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


# -- the whole-solve kernels ------------------------------------------------

# the march's edges too: spans of one node and 11 empty blocks (10x10),
# one whole row a block (131x200)
WHOLE_SHAPES = [(60, 90), (200, 132), (257, 301), (10, 10), (131, 200)]
WHOLE_RTOL = 1e-5


def _whole(name, problem, dev, resident=None):
    """(operands, kernel run, plain run) of one whole-solve engine."""
    cap = capacity(dev)
    if name == "resident":
        ops = rp.resident_operands(problem, torch.float32, dev)
        return (ops, lambda: rp.resident(problem, *ops, cap=cap),
                lambda: rp.resident_plain(problem, *ops))
    if name == "xl":
        ops = sp.streamed_operands(problem, torch.float32, dev)
        return (ops, lambda: xp.xl(problem, *ops, cap=cap),
                lambda: xp.xl_plain(problem, *ops))
    plan = sp.StreamPlan(problem, cap, resident=resident)
    ops = sp.streamed_operands(problem, torch.float32, dev)
    return (ops, lambda: sp.streamed(problem, *ops, plan=plan),
            lambda: sp.streamed_plain(problem, *ops, zstate=plan.zstate))


WHOLE_CASES = [("resident", None), ("xl", None),
               ("streamed", ("ap", "dinv", "a", "b")),  # r-state, all on chip
               ("streamed", ("dinv",)),                  # r-state, ap streamed
               ("streamed", ("ap",)),                    # z-state
               ("streamed", ())]                         # z-state, all streamed


def _assert_whole_close(got, want):
    for f in ("iters", "converged", "breakdown"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    scale = float(want.w.abs().max())
    torch.testing.assert_close(got.w, want.w, rtol=WHOLE_RTOL,
                               atol=WHOLE_RTOL * scale)
    if torch.isfinite(want.diff):
        assert float(got.diff) == pytest.approx(float(want.diff),
                                                rel=WHOLE_RTOL)


@pytest.mark.parametrize("name,resident", WHOLE_CASES)
@pytest.mark.parametrize("M,N", WHOLE_SHAPES)
def test_whole_solve_kernel_matches_plain_on_capped_runs(cuda, name,
                                                         resident, M, N):
    for max_iter in (1, 2, 7):
        problem = Problem(M=M, N=N, max_iter=max_iter)
        _, kernel, plain = _whole(name, problem, cuda, resident)
        _build.reset_launches()
        got, reads = kernel()
        assert reads == 1 and _build.LAUNCHES[name] == 1
        want, _ = plain()
        assert int(got.iters) == max_iter
        _assert_whole_close(got, want)


@pytest.mark.parametrize("name,resident", WHOLE_CASES)
def test_whole_solve_kernel_converges_as_its_plain_version(cuda, name,
                                                           resident):
    problem = Problem(M=60, N=90)
    _, kernel, plain = _whole(name, problem, cuda, resident)
    got, _ = kernel()
    again, _ = kernel()
    want, _ = plain()
    assert bool(got.converged) and int(got.iters) == int(want.iters)
    torch.testing.assert_close(got.w, want.w, rtol=0, atol=5e-6)
    # one launch per solve, the same bits on a rerun
    assert int(again.iters) == int(got.iters)
    assert torch.equal(again.w, got.w)


# xl's march at its split's edges: a 1-column strip and rows = 1 mod 32
# (65x65), strips of 31 columns and rows = 31 mod 32 (95x127), a grid of
# 2 units (11x11, one block, 6 warps idle), and units of 7-8 rows over 9
# strips, the last of 31 columns (31x287)
XL_SHAPES = WHOLE_SHAPES + [(64, 64), (94, 126), (10, 10), (30, 286)]


@pytest.mark.parametrize("form", ws.FORMS)
@pytest.mark.parametrize("M,N", XL_SHAPES)
def test_xl_forms_match_plain_at_the_split_edges(cuda, form, M, N):
    """Every xl form against xl_plain on capped runs, one launch and one
    host read each, at the shapes where the march's units are ragged."""
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    storage = form.split("_")[1] if form.startswith("f32_") else None
    for max_iter in (1, 2, 7):
        problem = Problem(M=M, N=N, max_iter=max_iter)
        kernel, plain = _form("xl", problem, cuda, dtype, storage, None)
        _build.reset_launches()
        got, reads = kernel()
        assert reads == 1 and _build.LAUNCHES == {ws.counter("xl", form): 1}
        want, _ = plain()
        assert got.w.dtype == dtype and int(got.iters) <= max_iter
        _assert_form_close(got, want)


@pytest.mark.parametrize("M,N", [(94, 126), (30, 286)])
def test_xl_converges_as_its_plain_version_at_the_split_edges(cuda, M, N):
    problem = Problem(M=M, N=N)
    _, kernel, plain = _whole("xl", problem, cuda)
    got, _ = kernel()
    again, _ = kernel()
    want, _ = plain()
    assert bool(got.converged) and int(got.iters) == int(want.iters)
    torch.testing.assert_close(got.w, want.w, rtol=0, atol=5e-6)
    assert int(again.iters) == int(got.iters)
    assert torch.equal(again.w, got.w)


@pytest.mark.parametrize("name", ["resident", "streamed", "xl"])
def test_too_large_cooperative_launch_raises(cuda, name):
    """A capacity that claims 100 times the card's SMs makes each kernel's
    grid larger than the card can hold at once (xl's grid is capped at its
    1820 tiles here): the cooperative launch is refused and the wrapper
    raises, nothing runs and nothing hangs."""
    problem = Problem(M=1100, N=1650)
    real = capacity(cuda)
    fake = dataclasses.replace(real, sm_count=100 * real.sm_count)
    ops = sp.streamed_operands(problem, torch.float32, cuda)
    call = {
        "resident": lambda: rp.resident(
            problem, *rp.resident_operands(problem, torch.float32, cuda),
            cap=fake),
        "streamed": lambda: sp.streamed(problem, *ops,
                                        plan=sp.StreamPlan(problem, fake)),
        "xl": lambda: xp.xl(problem, *ops, cap=fake),
    }[name]
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        call()
    assert _build.LAUNCHES[name] == 0
    torch.cuda.synchronize()
    # the card is still usable
    assert int(engine.solve(Problem(M=40, N=40), name,
                            device=cuda).iters) == 50


def test_capacity_and_the_ladder_on_the_card(cuda):
    cap = capacity(cuda)
    assert cap.cooperative_launch(xp.LIBRARY) and cap.sm_count > 0
    assert cap.smem_per_sm >= cap.smem_per_block > 0
    assert cap.max_co_resident(xp.LIBRARY, 0) >= cap.sm_count
    lay = rp.layout(Problem(M=400, N=600), cap)
    assert cap.max_co_resident(rp.LIBRARY, lay.smem_bytes) >= lay.nblocks
    assert engine.select_engine(Problem(M=400, N=600), torch.float32,
                                cap) == "resident"
    assert engine.select_engine(Problem(M=2400, N=3200), torch.float32,
                                cap) == "xl"


# -- K-d, the stencil fused with dot products --------------------------------

DOTS_SHAPES = [(44, 132), (2400, 3200)]


def _dots_pairs(n_pairs, ops):
    """n_pairs pairs over the operands, with aliases: (u, u), (p, p) and
    the pipelined bundle's order."""
    r, u, w, s, p = ops[:5]
    table = [(u, u), (r, u), (p, p), (w, u), (w, p), (s, u), (s, p),
             (u, p)]
    return tuple(table[:n_pairs])


@pytest.mark.parametrize("form", ["full", "block"])
@pytest.mark.parametrize("M,N", DOTS_SHAPES)
def test_stencil_dots_kernel_matches_plain(cuda, M, N, form):
    g = (M + 1, N + 1)
    w, a, b = (_rand(g, cuda, s, lo=lo) for s, lo in
               ((0, None), (1, 0.5), (2, 0.5)))
    h1, h2 = 2.0 / M, 1.2 / N
    xg = g if form == "full" else (M - 1, N - 1)
    ops = [_rand(xg, cuda, 10 + i) for i in range(5)]
    if form == "full":
        kernel, plain = hk.apply_a_dots_kernel, hk.apply_a_dots_plain
        stencil = hk.apply_a_kernel(w, a, b, h1, h2)
    else:
        kernel, plain = hk.apply_a_block_dots_kernel, \
            hk.apply_a_block_dots_plain
        stencil = hk.apply_a_block_kernel(w, a, b, h1, h2)
    for n_pairs in range(1, 9):
        pairs = _dots_pairs(n_pairs, ops)
        _build.reset_launches()
        n, sums = kernel(w, a, b, h1, h2, pairs)
        again_n, again_sums = kernel(w, a, b, h1, h2, pairs)
        assert _build.LAUNCHES["stencil_dots"] == 2
        n_p, sums_p = plain(w, a, b, h1, h2, pairs)
        assert torch.equal(n, n_p) and torch.equal(n, stencil)
        assert sums.shape == (n_pairs,) and sums.dtype == torch.float32
        torch.testing.assert_close(sums, sums_p, rtol=1e-6, atol=0)
        # the launch shape depends on the shape alone: the same bits again
        assert torch.equal(again_n, n) and torch.equal(again_sums, sums)


def test_stencil_dots_rejects_what_it_does_not_take(cuda):
    g = (21, 33)
    w, a, b, x, y = (_rand(g, cuda, s) for s in range(5))
    for bad in (
        lambda: hk.apply_a_dots_kernel(w, a, b, 0.1, 0.1, ()),
        lambda: hk.apply_a_dots_kernel(w.double(), a.double(), b.double(),
                                       0.1, 0.1, ((x.double(), y.double()),)),
        lambda: hk.apply_a_dots_kernel(w, a, b, 0.1, 0.1, ((x.t(), y),)),
        lambda: hk.apply_a_dots_kernel(w, a, b, 0.1, 0.1,
                                       ((x[1:-1, 1:-1].contiguous(), y),)),
        lambda: hk.apply_a_block_dots_kernel(w, a, b, 0.1, 0.1, ((x, y),)),
        lambda: hk.apply_a_dots_kernel(w, a[:, :-1].contiguous(), b, 0.1,
                                       0.1, ((x, y),)),
        lambda: hk.apply_a_dots_kernel(w, a, b, 0.1, 0.1, ((x, y),) * 9),
        lambda: hk.apply_a_dots_kernel(
            w, a, b, 0.1, 0.1,
            tuple((_rand(g, cuda, 20 + 2 * i), _rand(g, cuda, 21 + 2 * i))
                  for i in range(5))),
    ):
        _build.reset_launches()
        with pytest.raises(ValueError):
            bad()
        assert _build.LAUNCHES["stencil_dots"] == 0


# the K-d family's entries: K-d f32 and bf16, K-h bf16 and f16, K-f
DOTS_FORMS = ["f32", "bf16", "mixed_bf16", "mixed_f16", "lanes"]
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _dots_call(form, M, N, dev):
    """(call, counter): ``call()`` runs one K-d-family entry on the
    pipelined bundle over numpy-seeded full (M+1, N+1) grids (3 lanes for
    K-f) and returns (n, sums); ``call(True)`` runs it on the bundle with
    each pair's operands swapped, a table the library runs generic;
    ``counter`` is the launch counter it counts under."""
    g = (M + 1, N + 1)
    h1, h2 = 2.0 / M, 1.2 / N
    if form == "lanes":
        w = _rand((3,) + g, dev, 0)
        a, b = _rand(g, dev, 1, lo=0.5), _rand(g, dev, 2, lo=0.5)
        pairs = pp._bundle(*(_rand((3,) + g, dev, 10 + i) for i in range(5)))
        return (lambda swap=False: hk.apply_a_dots_batched_kernel(
            w, a, b, h1, h2, _swapped(pairs) if swap else pairs),
            hk.BATCHED_DOTS_KERNEL)
    if form.startswith("mixed"):
        st = NARROW[form.split("_")[1]]
        m = _rand(g, dev, 0)
        a, b = (_rand(g, dev, s, lo=0.5).to(st) for s in (1, 2))
        pairs = pp._bundle(*(_rand(g, dev, 10 + i).to(st) for i in range(5)))
        return (lambda swap=False: hk.apply_a_dots_mixed_kernel(
            m, a, b, h1, h2, _swapped(pairs) if swap else pairs),
            hk.MIXED_DOTS_KERNEL)
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    w, a, b = (_rand(g, dev, s, dtype, lo=lo) for s, lo in
               ((0, None), (1, 0.5), (2, 0.5)))
    pairs = pp._bundle(*(_rand(g, dev, 10 + i, dtype) for i in range(5)))
    return (lambda swap=False: hk.apply_a_dots_kernel(
        w, a, b, h1, h2, _swapped(pairs) if swap else pairs),
            ws.counter(hk.DOTS_KERNEL, ws.form_of(dtype)))


def _swapped(pairs):
    """Each pair's operands swapped: the same products under another table."""
    return tuple((y, x) for x, y in pairs)


def _same_bits(x, y):
    return x.dtype == y.dtype and torch.equal(x.view(_INT_VIEW[x.dtype]),
                                              y.view(_INT_VIEW[y.dtype]))


@pytest.mark.parametrize("form", DOTS_FORMS)
@pytest.mark.parametrize("M,N", DOTS_SHAPES)
def test_stencil_dots_bundle_and_generic_instantiations_agree(cuda, M, N,
                                                              form):
    """The bundle's table through its compiled instantiation, and the
    bundle with each pair's operands swapped through the generic one: the
    same products, the same node split and the same order of every sum,
    so n and the sums are the same bits."""
    call, counter = _dots_call(form, M, N, cuda)
    _build.reset_launches()
    n_b, sums_b = call()
    n_g, sums_g = call(True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {counter: 2}
    assert _same_bits(n_b, n_g) and _same_bits(sums_b, sums_g)


@pytest.mark.parametrize("form", DOTS_FORMS)
def test_stencil_dots_family_issues_one_device_kernel(cuda, activities,
                                                      form):
    """After a first call on the stream a call is its kernel alone: the
    tickets the last block leaves at 0 are not filled again
    (torch.profiler, in a fresh process: ``activities``)."""
    assert activities[f"K-d {form}"] == 1


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("form", ["f32", "lanes"])
def test_stencil_dots_in_a_cuda_graph(cuda, form, warm):
    """A K-d / K-f launch captured in a CUDA graph and replayed twice
    equals the eager launch, with and without a first call on the capture
    stream (without one, the graph zeroes its own tickets)."""
    from chip_smoke import graph_and_eager

    call, _ = _dots_call(form, 400, 600, cuda)

    def fn():
        n, sums = call()
        return torch.cat((n.reshape(-1), sums.reshape(-1)))

    eager, captured = graph_and_eager(fn, warm)
    assert torch.equal(eager, captured)


@pytest.mark.parametrize("engine_name", ["pipelined-pallas", "sstep-pallas"])
def test_recurrence_engines_on_the_card(cuda, engine_name):
    """40² f32 within ±2 of the oracle counts, through the kernels: K-d
    once a body for pipelined-pallas, K-a in the s-step basis chain."""
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        problem = Problem(M=40, N=40, norm=norm)
        _build.reset_launches()
        got = engine.solve(problem, engine_name, torch.float32, device=cuda)
        iters = int(got.iters)
        assert bool(got.converged) and abs(iters - table[(40, 40)]) <= 2
        if engine_name == "pipelined-pallas":
            assert _build.LAUNCHES["stencil_dots"] >= iters
        assert _build.LAUNCHES["stencil"] >= 1
        ref = engine.solve(problem, engine_name, torch.float32, device="cpu")
        assert abs(iters - int(ref.iters)) <= 2


def test_pipelined_pallas_chunked_equals_straight_on_the_card(cuda):
    problem = Problem(M=60, N=90)
    a, b, rhs = assembly.assemble(problem, torch.float32, cuda)
    init = pp.init_state(problem, a, b, rhs, stencil="pallas")
    straight, _ = pp.advance(problem, a, b, rhs, init, stencil="pallas")
    state = init
    for limit in (32, 33, None):
        state, _ = pp.advance(problem, a, b, rhs, state, limit=limit,
                              stencil="pallas", chunk=7)
    for name, x, y in zip(pp.PipelinedState._fields, straight, state):
        assert torch.equal(x, y), name


# -- K-e and K-f, the lane-batched kernels -----------------------------------

BATCHED_SHAPES = [(44, 132, 3), (130, 20, 2), (400, 600, 32),
                  (800, 1200, 8), (2400, 3200, 2)]


@pytest.mark.parametrize("form", ["full", "block"])
@pytest.mark.parametrize("M,N,B", BATCHED_SHAPES)
def test_batched_stencil_kernel_is_k_a_on_every_lane(cuda, M, N, B, form):
    g = (M + 1, N + 1)
    w = _rand((B,) + g, cuda, 0)
    a, b = _rand(g, cuda, 1, lo=0.5), _rand(g, cuda, 2, lo=0.5)
    h1, h2 = 2.0 / M, 1.2 / N
    if form == "full":
        kernel, plain, single = (hk.apply_a_batched_kernel,
                                 hk.apply_a_batched_plain, hk.apply_a_kernel)
    else:
        kernel, plain, single = (hk.apply_a_batched_block_kernel,
                                 hk.apply_a_block_plain,
                                 hk.apply_a_block_kernel)
    _build.reset_launches()
    got = kernel(w, a, b, h1, h2)
    assert _build.LAUNCHES["batched_stencil"] == 1
    assert torch.equal(got, plain(w, a, b, h1, h2))
    for lane in range(B):
        assert torch.equal(got[lane], single(w[lane].contiguous(), a, b, h1,
                                             h2))


@pytest.mark.parametrize("M,N,B", BATCHED_SHAPES)
def test_batched_stencil_dots_kernel_is_k_d_on_every_lane(cuda, M, N, B):
    g = (M + 1, N + 1)
    w = _rand((B,) + g, cuda, 0)
    a, b = _rand(g, cuda, 1, lo=0.5), _rand(g, cuda, 2, lo=0.5)
    h1, h2 = 2.0 / M, 1.2 / N
    ops = [_rand((B,) + g, cuda, 10 + i) for i in range(5)]
    for n_pairs in (1, 5, 8):
        pairs = _dots_pairs(n_pairs, ops)
        _build.reset_launches()
        n, sums = hk.apply_a_dots_batched_kernel(w, a, b, h1, h2, pairs)
        again_n, again_sums = hk.apply_a_dots_batched_kernel(w, a, b, h1, h2,
                                                             pairs)
        assert _build.LAUNCHES["batched_stencil_dots"] == 2
        assert sums.shape == (n_pairs, B) and sums.dtype == torch.float32
        n_p, sums_p = hk.apply_a_dots_batched_plain(w, a, b, h1, h2, pairs)
        assert torch.equal(n, n_p)
        torch.testing.assert_close(sums, sums_p, rtol=1e-6, atol=0)
        assert torch.equal(again_n, n) and torch.equal(again_sums, sums)
        for lane in range(B):
            # the same table on one lane: its aliases stay aliases
            lane_pairs = _dots_pairs(n_pairs, [o[lane].contiguous()
                                               for o in ops])
            n_l, sums_l = hk.apply_a_dots_kernel(w[lane].contiguous(), a, b,
                                                 h1, h2, lane_pairs)
            assert torch.equal(n[lane], n_l)
            assert torch.equal(sums[:, lane], sums_l)


def test_batched_kernels_reject_what_they_do_not_take(cuda):
    g = (21, 33)
    w, x, y = (_rand((3,) + g, cuda, s) for s in range(3))
    a, b = _rand(g, cuda, 3), _rand(g, cuda, 4)
    for kernel, bad in (
        ("batched_stencil", lambda: hk.apply_a_batched_kernel(
            w, w, w, 0.1, 0.1)),
        ("batched_stencil", lambda: hk.apply_a_batched_kernel(
            w[:, :, :-1], a[:, :-1], b[:, :-1], 0.1, 0.1)),
        ("batched_stencil", lambda: hk.apply_a_batched_kernel(
            w.double(), a.double(), b.double(), 0.1, 0.1)),
        ("batched_stencil", lambda: hk.apply_a_batched_kernel(
            w[0], a, b, 0.1, 0.1)),
        ("batched_stencil_dots", lambda: hk.apply_a_dots_batched_kernel(
            w, a, b, 0.1, 0.1, ((x[0].contiguous(), y[0].contiguous()),))),
        ("batched_stencil_dots", lambda: hk.apply_a_dots_batched_kernel(
            w, a, b, 0.1, 0.1, ((x.transpose(1, 2), y),))),
        ("batched_stencil_dots", lambda: hk.apply_a_dots_batched_kernel(
            w, a, b, 0.1, 0.1, ((x, y),) * 9)),
    ):
        _build.reset_launches()
        with pytest.raises(ValueError):
            bad()
        assert _build.LAUNCHES[kernel] == 0


@pytest.mark.parametrize("engine_name", ["batched-pallas",
                                         "batched-pipelined-pallas"])
def test_batched_kernel_engines_on_the_card(cuda, engine_name):
    """40² f32 with three lanes: every lane within ±2 of the oracle
    counts, through the kernels, and lane independence: lanes 0 and 2 are
    the same bits whatever lane 1 holds, a NaN included."""
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        problem = Problem(M=40, N=40, norm=norm)
        solver, args, _ = engine.build_solver(problem, engine_name,
                                              torch.float32, cuda, lanes=3)
        _build.reset_launches()
        got = solver(*args)
        iters = got.iters.tolist()
        assert got.converged.all()
        assert all(abs(i - table[(40, 40)]) <= 2 for i in iters)
        bodies = 64 * -(-max(iters) // 64)
        if engine_name == "batched-pallas":
            assert dict(_build.LAUNCHES) == {"batched_stencil": bodies}
        else:
            assert _build.LAUNCHES["batched_stencil_dots"] == bodies
        runs = [got]
        for middle in (3.0, float("nan")):
            a, b, rhs = (t.clone() for t in args)
            rhs[1] *= middle
            runs.append(solver(a, b, rhs))
        assert runs[2].quarantined.tolist() == [False, True, False]
        for other in runs[1:]:
            for lane in (0, 2):
                assert torch.equal(other.w[lane], got.w[lane])
                assert int(other.iters[lane]) == iters[lane]


@pytest.mark.parametrize("mod,stencil", [(bp, "pallas"), (bpp, "pallas"),
                                         (bp, "xla"), (bpp, "xla")])
def test_batched_chunked_equals_straight_on_the_card(cuda, mod, stencil):
    problem = Problem(M=60, N=90)
    a, b, rhs = bp.batched_operands(problem, 3, torch.float32, cuda)
    rhs[1] *= 2.0
    extra = {"stencil": stencil} if mod is bpp else {}
    init = mod.init_state(problem, a, b, rhs, **extra)
    straight, _ = mod.advance(problem, a, b, rhs, init, stencil=stencil)
    state = init
    for limit in (32, 33, None):
        state, _ = mod.advance(problem, a, b, rhs, state, limit=limit,
                               stencil=stencil, chunk=7)
    for name, x, y in zip(type(init)._fields, straight, state):
        assert torch.equal(x, y), name


# -- the storage axis: K-g and K-h -------------------------------------------

# and K-g's march edges: one 128-row tile of 16-row warps and a 1-column
# strip past 32 (129x33), a ragged tile and strip (130x97), the smallest
# block (3x3)
MIXED_SHAPES = [(44, 132), (400, 600), (800, 1200), (2400, 3200),
                (128, 32), (129, 96), (2, 2)]
NARROW = {"bf16": torch.bfloat16, "f16": torch.float16}


def _narrow(g, dev, seed, st, lo=None):
    """A numpy-seeded array rounded once to ``st`` ("f32" keeps f32)."""
    x = _rand(g, dev, seed, lo=lo)
    return x if st == "f32" else x.to(NARROW[st])


MIXED_FORMS = [("bf16", "bf16"), ("f32", "bf16"), ("f16", "f16"),
               ("f32", "f16")]


@pytest.mark.parametrize("w_st,ab_st", MIXED_FORMS)
@pytest.mark.parametrize("M,N", MIXED_SHAPES)
def test_mixed_stencil_kernel_is_k_a_on_upcast_inputs(cuda, M, N, w_st,
                                                      ab_st):
    g = (M + 1, N + 1)
    w = _narrow(g, cuda, 0, w_st)
    a, b = (_narrow(g, cuda, s, ab_st, lo=0.5) for s in (1, 2))
    h1, h2 = 2.0 / M, 1.2 / N
    _build.reset_launches()
    got = hk.apply_a_mixed_kernel(w, a, b, h1, h2)
    block = hk.apply_a_mixed_block_kernel(w, a, b, h1, h2)
    assert _build.LAUNCHES["stencil_mixed"] == 2
    assert got.dtype == block.dtype == torch.float32
    assert torch.equal(got, hk.apply_a_mixed_plain(w, a, b, h1, h2))
    assert torch.equal(block, hk.apply_a_mixed_block_plain(w, a, b, h1, h2))
    up = [x.float().contiguous() for x in (w, a, b)]
    assert torch.equal(got, hk.apply_a_kernel(*up, h1, h2))


@pytest.mark.parametrize("pad", [1, 0])
@pytest.mark.parametrize("w_st,ab_st", MIXED_FORMS)
def test_mixed_stencil_issues_one_device_kernel(cuda, activities, w_st,
                                                ab_st, pad):
    assert activities[f"K-g {w_st} {ab_st} pad {pad}"] == 1


@pytest.mark.parametrize("st", ["bf16", "f16"])
@pytest.mark.parametrize("M,N", MIXED_SHAPES)
def test_mixed_stencil_dots_kernel_is_k_d_on_upcast_inputs(cuda, M, N, st):
    g = (M + 1, N + 1)
    m = _rand(g, cuda, 0)
    a, b = (_narrow(g, cuda, s, st, lo=0.5) for s in (1, 2))
    ops = [_narrow(g, cuda, 10 + i, st) for i in range(5)]
    h1, h2 = 2.0 / M, 1.2 / N
    pairs = pp._bundle(*ops)
    _build.reset_launches()
    n, sums = hk.apply_a_dots_mixed_kernel(m, a, b, h1, h2, pairs)
    assert _build.LAUNCHES["stencil_dots_mixed"] == 1
    want_n, want_sums = hk.apply_a_dots_mixed_plain(m, a, b, h1, h2, pairs)
    assert torch.equal(n, want_n)
    assert torch.equal(n, hk.apply_a_mixed_kernel(m, a, b, h1, h2))
    torch.testing.assert_close(sums, want_sums, rtol=1e-6, atol=0)
    up = [o.float().contiguous() for o in ops]
    n_d, sums_d = hk.apply_a_dots_kernel(m, a.float().contiguous(),
                                         b.float().contiguous(), h1, h2,
                                         pp._bundle(*up))
    assert torch.equal(n, n_d) and torch.equal(sums, sums_d)


def test_mixed_kernels_reject_what_they_do_not_take(cuda):
    g = (45, 133)
    w = _narrow(g, cuda, 0, "bf16")
    a, b = (_narrow(g, cuda, s, "bf16", lo=0.5) for s in (1, 2))
    for bad in ((w, a, b.float()), (w.half(), a, b),
                (w, a[:, :-1].contiguous(), b), (w.double(), a, b)):
        with pytest.raises(ValueError):
            hk.apply_a_mixed_kernel(*bad, 0.1, 0.1)
    with pytest.raises(ValueError, match="computes in float32"):
        hk.apply_a_mixed_kernel(w, a, b, 0.1, 0.1, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        hk.apply_a_dots_mixed_kernel(w, a, b, 0.1, 0.1, ((w, w),))
    m = w.float()
    with pytest.raises(ValueError, match="pair operand"):
        hk.apply_a_dots_mixed_kernel(m, a, b, 0.1, 0.1, ((m, m),))


def test_pallas_bf16_takes_xla_iterations_on_the_card(cuda):
    """K-g is bitwise the plain stencil on the upcast inputs, and the two
    engines share the rest of the body: the same iterations, flags and
    bits at 400x600."""
    problem = Problem(M=400, N=600)
    runs = {}
    for name in ("pallas", "xla"):
        solver, args, _ = engine.build_solver(problem, name, torch.float32,
                                              cuda, storage_dtype="bf16")
        _build.reset_launches()
        runs[name] = (solver(*args), dict(_build.LAUNCHES))
    (got, launches), (want, plain) = runs["pallas"], runs["xla"]
    assert plain == {}
    assert launches == {"stencil_mixed": 64 * -(-int(got.iters) // 64)}
    assert int(got.iters) == int(want.iters)
    assert bool(got.converged) == bool(want.converged) is True
    assert bool(got.breakdown) == bool(want.breakdown)
    assert torch.equal(got.w, want.w)


@pytest.mark.parametrize("engine_name", ["pipelined-pallas", "sstep-pallas"])
def test_narrow_recurrences_on_the_card(cuda, engine_name):
    """Capped bf16 runs: finite, stored in bf16, chunked == straight."""
    problem = Problem(M=400, N=600, max_iter=96)
    runs = []
    for chunk in (64, 96):
        solver, args, _ = engine.build_solver(problem, engine_name,
                                              torch.float32, cuda,
                                              chunk=chunk,
                                              storage_dtype="bf16")
        _build.reset_launches()
        runs.append((solver(*args), dict(_build.LAUNCHES)))
    (got, launches), (straight, _) = runs
    assert got.w.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.w).all())
    for x, y in zip(got, straight):
        assert torch.equal(x, y)
    # the bodies the host issued: chunks of 64 up to the cap of 96
    bodies = min(96, 64 * -(-int(got.iters) // 64))
    if engine_name == "pipelined-pallas":
        # w0 by K-a; K-h once a body; K-g four times every 8th body
        assert launches == {"stencil": 1, "stencil_dots_mixed": bodies,
                            "stencil_mixed": 4 * ((bodies - 1) // 8)}
    else:
        assert set(launches) == {"stencil_mixed"}


# -- the dtype axes: bf16 compute, narrow operand streams --------------------

# (engine, compute dtype, storage dtype, forced resident operands)
FORM_CASES = [
    ("resident", torch.bfloat16, None, None),
    ("xl", torch.bfloat16, None, None),
    ("xl", torch.float32, "bf16", None),
    ("xl", torch.float32, "f16", None),
    ("streamed", torch.bfloat16, None, ("ap", "dinv", "a", "b")),
    ("streamed", torch.bfloat16, None, ()),
    ("streamed", torch.float32, "bf16", ("dinv",)),
    ("streamed", torch.float32, "bf16", ()),
    ("streamed", torch.float32, "f16", ("ap", "a", "b")),
    ("streamed", torch.float32, "f16", ()),
]
FORM_SHAPES = [(60, 90), (257, 301)]
NARROW = {"bf16": torch.bfloat16, "f16": torch.float16}


def _form(name, problem, dev, dtype, storage, resident, seeded=False):
    """(kernel run, plain run) of one dtype form of a whole-solve engine;
    ``seeded`` streams numpy-seeded finite operands in place of the real
    ones (which overflow f16)."""
    cap = capacity(dev)
    if name == "resident":
        ops = rp.resident_operands(problem, dtype, dev)
        return (lambda: rp.resident(problem, *ops, cap=cap),
                lambda: rp.resident_plain(problem, *ops))
    if seeded:
        g = problem.node_shape
        st = NARROW[storage]
        ops = (_rand(g, dev, 0, lo=0.1).mul_(0.1).to(st),
               _rand(g, dev, 1, lo=1.0).to(st),
               _rand(g, dev, 2, lo=1.0).to(st), _rand(g, dev, 3))
    else:
        ops = sp.streamed_operands(problem, dtype, dev, storage)
    if name == "xl":
        return (lambda: xp.xl(problem, *ops, cap=cap),
                lambda: xp.xl_plain(problem, *ops))
    plan = sp.StreamPlan(problem, cap, dtype, resident=resident)
    return (lambda: sp.streamed(problem, *ops, plan=plan),
            lambda: sp.streamed_plain(problem, *ops, zstate=plan.zstate))


def _assert_form_close(got, want):
    """As _assert_whole_close, with NaN (an overflowed f16 stream) in the
    same places."""
    nan = torch.isnan(want.w)
    assert torch.equal(torch.isnan(got.w), nan)
    if bool(nan.any()):
        for f in ("iters", "converged", "breakdown"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        return
    _assert_whole_close(got, want)


@pytest.mark.parametrize("name,dtype,storage,resident", FORM_CASES)
@pytest.mark.parametrize("M,N", FORM_SHAPES)
def test_dtype_form_matches_plain_on_capped_runs(cuda, name, dtype, storage,
                                                 resident, M, N):
    form = ws.form_of(dtype, NARROW.get(storage))
    for max_iter in (1, 2, 7):
        problem = Problem(M=M, N=N, max_iter=max_iter)
        kernel, plain = _form(name, problem, cuda, dtype, storage, resident)
        _build.reset_launches()
        got, reads = kernel()
        assert reads == 1 and _build.LAUNCHES == {ws.counter(name, form): 1}
        want, _ = plain()
        # a bf16 resident solve may break down before the cap (its
        # cancelling stencil): the plain version then stops with it
        assert got.w.dtype == dtype and int(got.iters) <= max_iter
        _assert_form_close(got, want)


# the resident kernel's bf16 form, and each other form of the streamed
# kernel in every regime of WHOLE_CASES
WHOLE_FORM_CASES = [("resident", torch.bfloat16, None, None)] + [
    ("streamed", dtype, storage, resident)
    for dtype, storage in ((torch.bfloat16, None), (torch.float32, "bf16"),
                           (torch.float32, "f16"))
    for name, resident in WHOLE_CASES if name == "streamed"]


@pytest.mark.parametrize("name,dtype,storage,resident", WHOLE_FORM_CASES)
@pytest.mark.parametrize("M,N", WHOLE_SHAPES)
def test_whole_solve_forms_match_plain_on_capped_runs(cuda, name, dtype,
                                                      storage, resident, M,
                                                      N):
    test_dtype_form_matches_plain_on_capped_runs(cuda, name, dtype, storage,
                                                 resident, M, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_with_ap_in_memory_matches_plain(cuda, dtype):
    """A split whose warps march 4 units (66 strips of one step at
    131x2101) keeps ap in the device-memory scratch."""
    for max_iter in (1, 2, 7):
        problem = Problem(M=130, N=2100, max_iter=max_iter)
        assert not rp.layout(problem, capacity(cuda), dtype).ap_in_registers
        kernel, plain = _form("resident", problem, cuda, dtype, None, None)
        _build.reset_launches()
        got, reads = kernel()
        assert reads == 1 and _build.LAUNCHES == {
            ws.counter("resident", ws.form_of(dtype)): 1}
        want, _ = plain()
        assert int(got.iters) <= max_iter
        _assert_form_close(got, want)


@pytest.mark.parametrize("name,resident", [("resident", None),
                                           ("streamed", None),
                                           ("streamed", ("dinv",))])
def test_timing_instantiation_solves_as_the_kernel(cuda, name, resident):
    """The timing instantiation (``stamps=``) gives the kernel's bits and
    stamps every phase of every body in order; every block ends a phase
    after block 0 has ended the phase before it (a grid barrier lies
    between)."""
    problem = Problem(M=257, N=301, max_iter=7)
    cap = capacity(cuda)
    if name == "resident":
        ops = rp.resident_operands(problem, torch.float32, cuda)
        nb = rp.layout(problem, cap).nblocks
        run = lambda **kw: rp.resident(problem, *ops, cap=cap, **kw)[0]
    else:
        ops = sp.streamed_operands(problem, torch.float32, cuda)
        plan = sp.StreamPlan(problem, cap, resident=resident)
        nb = plan.nblocks
        run = lambda **kw: sp.streamed(problem, *ops, plan=plan, **kw)[0]
    want = run()
    stamps = ws.stamps_buffer(problem, nb, cuda)
    _build.reset_launches()
    got = run(stamps=stamps)
    assert _build.LAUNCHES == {f"{name}_stamps": 1}
    assert int(got.iters) == int(want.iters) == 7
    assert torch.equal(got.w, want.w)
    t = stamps.cpu()
    k = ws.WHOLE_STAMPS
    assert bool((t[:, :k] > 0).all())
    assert bool((t[:, :k].diff(dim=1) >= 0).all())
    # stencil ends (body 0's slots hold the SMs) after the previous body's
    # update end, update ends after the body's stencil end
    assert bool((t[1:, k:k + nb] >= t[:-1, 4:5]).all())
    assert bool((t[:, k + nb:] >= t[:, 2:3]).all())
    assert bool((t[0, k:k + nb] >= 1).all())


@pytest.mark.parametrize("name", ["xl", "streamed"])
@pytest.mark.parametrize("storage", ["bf16", "f16"])
def test_narrow_loads_on_seeded_operands_match_plain(cuda, name, storage):
    """Finite seeded operands inside f16's range: the load path of each
    narrow form bitwise its plain version on the upcast operands."""
    for max_iter in (1, 2, 7):
        problem = Problem(M=257, N=301, max_iter=max_iter)
        kernel, plain = _form(name, problem, cuda, torch.float32, storage,
                              ("dinv",) if name == "streamed" else None,
                              seeded=True)
        got, _ = kernel()
        want, _ = plain()
        assert bool(torch.isfinite(want.w).all())
        assert torch.equal(got.w, want.w)
        assert int(got.iters) == int(want.iters) == max_iter


@pytest.mark.parametrize("M,N", SHAPES)
def test_fused_bf16_kernels_match_plain(cuda, M, N):
    problem = Problem(M=M, N=N)
    g = problem.node_shape
    an, as_, bw, be, d, dinv = fp.fused_operands(problem, torch.bfloat16,
                                                 cuda)
    z, p, w, r = (_rand(g, cuda, s, torch.bfloat16) for s in range(4))
    partials = torch.empty(fp.scratch_len(*g), dtype=torch.float64,
                           device=cuda)
    _build.reset_launches()

    def carry(alpha=0.0):
        scal = torch.tensor([1.5, 0.7, float("inf"), 0.0, alpha],
                            dtype=torch.bfloat16, device=cuda)
        return scal, torch.zeros(fp.N_FLAGS, dtype=torch.int32, device=cuda)

    outs = []
    for k1 in (fp.k1, fp.k1_plain):
        scal, flags = carry()
        pn, ap = torch.empty_like(z), torch.empty_like(z)
        k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials,
           max_iter=NEVER, h1=problem.h1, h2=problem.h2)
        outs.append((pn, ap, scal, flags))
    (pn, ap, scal, flags), (pn_p, ap_p, scal_p, flags_p) = outs
    assert torch.equal(pn, pn_p) and torch.equal(ap, ap_p)
    _scalar_close(scal[fp.SCAL_DENOM].float(), scal_p[fp.SCAL_DENOM].float())
    assert torch.equal(flags[:4], flags_p[:4])
    outs = []
    for k2 in (fp.k2, fp.k2_plain):
        scal, flags = carry(alpha=0.3)
        ww, rr, zz = w.clone(), r.clone(), torch.empty_like(w)
        k2(ww, rr, pn_p, ap_p, dinv, zz, scal, flags, partials,
           max_iter=NEVER, h1=problem.h1, h2=problem.h2, delta=problem.delta,
           weighted=True)
        outs.append((ww, rr, zz, scal, flags))
    (ww, rr, zz, scal, flags), (ww_p, rr_p, zz_p, scal_p, flags_p) = outs
    for x, y in ((ww, ww_p), (rr, rr_p), (zz, zz_p)):
        assert torch.equal(x, y)
    for i in (fp.SCAL_ZR, fp.SCAL_BETA, fp.SCAL_DIFF):
        _scalar_close(scal[i].float(), scal_p[i].float())
    assert torch.equal(flags[:3], flags_p[:3])
    assert _build.LAUNCHES == {"fused_k1_bf16": 1, "fused_k2_bf16": 1}


def test_bf16_engines_on_the_card_take_their_forms(cuda):
    """auto at bf16 walks the ladder with its own forms, one launch a
    solve; fused at bf16 runs K-b / K-c bf16; each converges at 40²,
    δ = 1e-4, as on the CPU."""
    problem = Problem(M=40, N=40, delta=1e-4)
    for name, counters in (("auto", ("resident_bf16",)),
                           ("streamed", ("streamed_bf16",)),
                           ("xl", ("xl_bf16",)),
                           ("fused", ("fused_k1_bf16", "fused_k2_bf16"))):
        _build.reset_launches()
        got = engine.solve(problem, name, torch.bfloat16, device=cuda)
        assert set(_build.LAUNCHES) == set(counters), name
        assert bool(got.converged) and got.w.dtype == torch.bfloat16, name
        assert abs(int(got.iters) - 32) <= 3, name


def test_xl_forms_answer_their_own_occupancy(cuda):
    cap = capacity(cuda)
    for form in ws.FORMS:
        assert cap.max_co_resident(xp.LIBRARY, 0, form) >= cap.sm_count


# one rank's block of 2401x3201 on 2x2, and 13x17 over 2x4 (padding on both
# axes, blocks narrower than a 32-wide thread block)
SHARD_BLOCKS = [(1201, 1601), (7, 5)]


def _shard_inputs(bm, bn, dev, seed=0):
    """Seeded halo-extended windows and owned blocks of one rank, d zero on
    its first row and column (the ring), the carry at β = 0.7, zr = 1.5,
    denom = 2.5."""
    rng = np.random.default_rng(seed)

    def f32(shape, lo=None):
        x = rng.random(shape) + lo if lo is not None else rng.standard_normal(
            shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    ext, blk = (bm + 2, bn + 2), (bm, bn)
    d = f32(blk, lo=1.0)
    d[0, :] = 0.0
    d[:, 0] = 0.0
    scal = torch.zeros(fp.N_SCAL, device=dev)
    scal[fp.SCAL_BETA], scal[fp.SCAL_ZR], scal[fp.SCAL_DENOM] = 0.7, 1.5, 2.5
    return dict(z=f32(ext), p=f32(ext), a=f32(ext, lo=0.5), b=f32(ext, lo=0.5),
                d=d, dinv=torch.where(d != 0, 1.0 / d, torch.zeros_like(d)),
                w=f32(blk), r=f32(blk), scal=scal,
                flags=torch.zeros(fp.N_FLAGS, dtype=torch.int32, device=dev))


def _shard_run(inp, k1, k2, partials):
    bm, bn = inp["d"].shape
    pn, ap = (torch.full((bm, bn), 7.0, device=inp["d"].device)
              for _ in range(2))
    k1(inp["z"], inp["p"], inp["a"], inp["b"], inp["d"], pn, ap, inp["scal"],
       inp["flags"], partials[0], max_iter=NEVER, h1=0.05, h2=0.03)
    w, r, z = inp["w"].clone(), inp["r"].clone(), torch.full_like(pn, 7.0)
    k2(w, r, pn, ap, inp["dinv"], z, inp["scal"], inp["flags"], partials[1],
       max_iter=NEVER)
    return (pn, ap, w, r, z, partials[0].sum(), partials[1].sum(0))


@pytest.mark.parametrize("bm,bn", SHARD_BLOCKS)
def test_fused_sharded_kernels_match_plain(cuda, bm, bn):
    """Arrays bitwise; the rank's sums, in double, equal once rounded to
    f32 (their terms are added in another order)."""
    inp = _shard_inputs(bm, bn, cuda)
    _build.reset_launches()
    got = _shard_run(inp, fs.k1, fs.k2, fs.scratch(bm, bn, cuda))
    assert _build.LAUNCHES == {fs.K1: 1, fs.K2: 1}
    one = (torch.zeros(1, dtype=torch.float64, device=cuda),
           torch.zeros((1, 2), dtype=torch.float64, device=cuda))
    want = _shard_run(inp, fs.k1_plain, fs.k2_plain, one)
    for x, y in zip(got[:5], want[:5]):
        assert torch.equal(x, y)
    for x, y in zip(got[5:], want[5:]):
        assert torch.equal(x.float(), y.float())
    # the ring: ap is exactly 0 where d is 0
    assert torch.all(got[1][0, :] == 0) and torch.all(got[1][:, 0] == 0)


def test_fused_sharded_kernels_do_nothing_after_exit(cuda):
    inp = _shard_inputs(44, 70, cuda)
    inp["flags"][fp.FLAG_CONVERGED] = 1
    parts = fs.scratch(44, 70, cuda)
    parts[0].fill_(3.0)
    parts[1].fill_(3.0)
    pn, ap, w, r, z, s1, s2 = _shard_run(inp, fs.k1, fs.k2, parts)
    assert torch.all(pn == 7.0) and torch.all(ap == 7.0)
    assert torch.equal(w, inp["w"]) and torch.equal(r, inp["r"])
    assert torch.all(z == 7.0)
    assert torch.all(parts[0] == 3.0) and torch.all(parts[1] == 3.0)


def test_fused_sharded_kernels_reject_what_they_do_not_take(cuda):
    inp = _shard_inputs(8, 8, cuda)
    parts = fs.scratch(8, 8, cuda)
    with pytest.raises(ValueError, match="z_ext"):
        fs.k1(inp["z"][:-1], inp["p"], inp["a"], inp["b"], inp["d"],
              inp["w"], inp["r"], inp["scal"], inp["flags"], parts[0],
              max_iter=NEVER, h1=0.1, h2=0.1)
    with pytest.raises(ValueError, match="partials"):
        fs.k2(inp["w"], inp["r"], inp["w"], inp["r"], inp["dinv"],
              inp["w"].clone(), inp["scal"], inp["flags"], parts[0],
              max_iter=NEVER)


def test_sharded_fused_on_one_rank_over_nccl(cuda):
    """The 1x1 mesh on the card runs on NCCL: 546 +- 2 at 400x600, K1-shard
    and K2-shard once a body, 2 reductions and 1 halo exchange a body."""
    report = run_once(Problem(M=400, N=600), mode="sharded", engine="fused",
                      mesh_shape=(1, 1))
    assert report.backend == "nccl" and report.mesh_shape == (1, 1)
    assert report.converged and abs(report.iters - 546) <= 2
    assert report.l2_error < 1e-3
    assert report.rank_launches == [{fs.K1: report.bodies,
                                     fs.K2: report.bodies}]
    assert report.rank_collectives == [{"halo": report.bodies + 2,
                                        "reduce": 2 * report.bodies + 1}]


def test_sharded_on_two_ranks_sharing_the_card_over_gloo(cuda):
    """Two ranks on one card take gloo: the 50 of 40² for fused and pallas,
    each kernel once a body on both ranks."""
    for name, kernels in (("fused", (fs.K1, fs.K2)), ("pallas", ("stencil",))):
        report = run_once(Problem(M=40, N=40), mode="sharded", engine=name,
                          mesh_shape=(1, 2))
        assert report.backend == "gloo" and report.iters == 50, name
        assert report.converged, name
        for launches in report.rank_launches:
            assert launches == {k: report.bodies for k in kernels}, name


# -- the stage-4 kernels and the bf16 forms of K-a and K-d ------------------

STAGE4_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,N", SHAPES)
def test_stage4_kernels_match_plain(cuda, M, N, dtype):
    """dinv, dot, update_w_r and update_p: arrays bitwise their plain
    versions, dot and dw2 within rel 1e-6 (f32) / 1e-12 (f64), D with
    zeros, one launch each."""
    g = (M + 1, N + 1)
    w, r, p, ap, z, d = (_rand(g, cuda, s, dtype) for s in range(6))
    d = torch.where(d.abs() < 0.3, torch.zeros_like(d), d)
    alpha = torch.tensor(0.37, dtype=dtype, device=cuda)
    beta = torch.tensor(0.9, dtype=dtype, device=cuda)
    h1, h2 = 2.0 / M, 1.2 / N
    _build.reset_launches()
    got = s4.apply_dinv_pallas(r, d)
    assert torch.equal(got, s4.apply_dinv_plain(r, d))
    assert bool((got[d == 0] == 0).all())
    dot = s4.dot_pallas(w, r, h1, h2)
    assert dot.dim() == 0 and dot.device.type == "cuda"
    assert float(dot) == pytest.approx(float(s4.dot_plain(w, r, h1, h2)),
                                       rel=STAGE4_RTOL[dtype])
    w_new, r_new, dw2 = s4.update_w_r_pallas(alpha, w, r, p, ap)
    w_p, r_p, dw2_p = s4.update_w_r_plain(alpha, w, r, p, ap)
    assert torch.equal(w_new, w_p) and torch.equal(r_new, r_p)
    assert float(dw2) == pytest.approx(float(dw2_p), rel=STAGE4_RTOL[dtype])
    assert torch.equal(s4.update_p_pallas(beta, z, p),
                       s4.update_p_plain(beta, z, p))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"dinv": 1, "dot": 1, "update_w_r": 1,
                               "update_p": 1}


def test_stage4_kernels_refuse_bf16_and_cpu_scalars(cuda):
    x = torch.zeros(5, 7, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        s4.apply_dinv_pallas(x, x)
    f = torch.zeros(5, 7, device=cuda)
    with pytest.raises(ValueError):
        s4.update_p_pallas(torch.tensor(0.5), f, f)


# dot and update_p at the shapes their streaming design splits
# differently: (g1, g2, x's offset, y's offset) in elements past an
# aligned buffer. A lone offset puts x and y in different alignment
# classes (the kernels' scalar loop); a shared one gives a scalar head.
STREAM_CASES = [(1, 1, 0, 0), (3, 5, 0, 0), (401, 601, 0, 0),
                (2401, 3201, 0, 0), (401, 601, 1, 1), (401, 601, 1, 0)]


def _stream_operands(case, dev, dtype):
    """x, y (as views at their offsets) and beta of one STREAM_CASES row."""
    g1, g2, off_x, off_y = case
    x, y = (_rand((g1 * g2 + off,), dev, seed, dtype)[off:].view(g1, g2)
            for seed, off in ((11, off_x), (12, off_y)))
    return x, y, torch.tensor(0.9, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_dot_and_update_p_at_edge_shapes(cuda, case, dtype):
    """update_p bitwise its plain version; dot within rel 1e-6 (f32) /
    1e-12 (f64) of its plain version and the same bits on two launches;
    one launch counted a call."""
    x, y, beta = _stream_operands(case, cuda, dtype)
    h1, h2 = 2.0 / 400, 1.2 / 600
    _build.reset_launches()
    got = s4.dot_pallas(x, y, h1, h2)
    again = s4.dot_pallas(x, y, h1, h2)
    p_new = s4.update_p_pallas(beta, x, y)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"dot": 2, "update_p": 1}
    assert torch.equal(got, again)
    assert float(got) == pytest.approx(float(s4.dot_plain(x, y, h1, h2)),
                                       rel=STAGE4_RTOL[dtype])
    assert torch.equal(p_new, s4.update_p_plain(beta, x, y))


def _count_activities() -> dict:
    """The device activities one call issues, after a first call on the
    stream (``chip_smoke.device_activities``): dot and update_p on every
    STREAM_CASES row in f32 and f64, and each K-d-family entry at 400x600
    (``_dots_call``)."""
    from chip_smoke import device_activities

    dev = torch.device("cuda")
    counts = {}
    for dtype in (torch.float32, torch.float64):
        for case in STREAM_CASES:
            x, y, beta = _stream_operands(case, dev, dtype)
            counts[f"dot {case} {dtype}"] = device_activities(
                lambda: s4.dot_pallas(x, y, 0.1, 0.2))
            counts[f"update_p {case} {dtype}"] = device_activities(
                lambda: s4.update_p_pallas(beta, x, y))
    for form in DOTS_FORMS:
        call, _ = _dots_call(form, 400, 600, dev)
        counts[f"K-d {form}"] = device_activities(call)
    for w_st, ab_st in MIXED_FORMS:
        w = _narrow((401, 601), dev, 0, w_st)
        a, b = (_narrow((401, 601), dev, s, ab_st, lo=0.5) for s in (1, 2))
        for pad, fn in ((1, hk.apply_a_mixed_kernel),
                        (0, hk.apply_a_mixed_block_kernel)):
            counts[f"K-g {w_st} {ab_st} pad {pad}"] = device_activities(
                lambda: fn(w, a, b, 0.005, 0.002))
    for form in MARCH_FORMS:
        counts[f"K-a {form}"] = device_activities(_march_call(form, dev))
    return counts


@pytest.fixture(scope="module")
def activities():
    """``_count_activities`` in a fresh process: in a process that has
    captured and replayed CUDA graphs (the tests before these), the
    profiler recorded no device activity at all for some calls on the
    H100, as in chip_smoke.py's long run."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here.parent), str(here)] + [p for p in (env.get("PYTHONPATH"),)
                                         if p])
    code = ("import json, test_torch_gpu as t; "
            "print(json.dumps(t._count_activities()))")
    res = subprocess.run([sys.executable, "-c", code], cwd=here, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_dot_and_update_p_issue_one_device_kernel(cuda, activities, case,
                                                  dtype):
    """After a first call on the stream, a call is its kernel alone: no
    fill of the sums' ticket, no copy (torch.profiler, in a fresh
    process: ``activities``)."""
    assert activities[f"dot {case} {dtype}"] == 1
    assert activities[f"update_p {case} {dtype}"] == 1


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_dot_and_update_p_in_a_cuda_graph(cuda, case, dtype, warm):
    """A launch captured in a CUDA graph and replayed twice equals the
    eager launch, with and without a first call on the capture stream
    (without one, the graph zeroes its own ticket)."""
    from chip_smoke import graph_and_eager

    x, y, beta = _stream_operands(case, cuda, dtype)
    for fn in (lambda: s4.dot_pallas(x, y, 0.1, 0.2),
               lambda: s4.update_p_pallas(beta, x, y)):
        eager, captured = graph_and_eager(fn, warm)
        assert torch.equal(eager, captured)


@pytest.mark.parametrize("M,N", SHAPES)
def test_bf16_stencil_forms_match_plain(cuda, M, N):
    """K-a and K-d in bf16: arrays bitwise their plain versions (float
    arithmetic, rounded once where stored), K-d's sums bitwise once
    rounded, K-d's n bitwise K-a's."""
    g = (M + 1, N + 1)
    bf = torch.bfloat16
    w, a, b = (_rand(g, cuda, s, bf, lo=lo) for s, lo in
               ((0, None), (1, 0.5), (2, 0.5)))
    vecs = [_rand(g, cuda, 3 + s, bf) for s in range(5)]
    pairs = pp._bundle(*vecs)
    h1, h2 = 2.0 / M, 1.2 / N
    _build.reset_launches()
    full = hk.apply_a_kernel(w, a, b, h1, h2)
    block = hk.apply_a_block_kernel(w, a, b, h1, h2)
    n, sums = hk.apply_a_dots_kernel(w, a, b, h1, h2, pairs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"stencil_bf16": 2, "stencil_dots_bf16": 1}
    n_p, sums_p = hk.apply_a_dots_plain(w, a, b, h1, h2, pairs)
    for got, want in ((full, hk.apply_a_plain(w, a, b, h1, h2)),
                      (block, hk.apply_a_block_plain(w, a, b, h1, h2)),
                      (n, n_p), (sums, sums_p), (n, full)):
        assert got.dtype == bf and torch.equal(got.view(torch.int16),
                                               want.view(torch.int16))


def test_stage4_loop_at_400x600(cuda):
    """The reference's stage-4 iteration composed from K-a and the four
    kernels (``chip_smoke.stage4_solve``): 546 +- 2 iterations in f32,
    each kernel launched as the count predicts."""
    from chip_smoke import stage4_solve

    problem = Problem(M=400, N=600)
    a, b, rhs = assembly.assemble(problem, torch.float32, cuda)
    _build.reset_launches()
    w, iters, converged = stage4_solve(problem, a, b, rhs, hk.apply_a_kernel)
    torch.cuda.synchronize()
    assert converged and abs(iters - 546) <= 2
    assert _build.LAUNCHES == {"stencil": iters, "dinv": iters + 1,
                               "dot": 2 * iters + 1, "update_w_r": iters,
                               "update_p": iters - 1}


@pytest.mark.parametrize("name,counters", [
    ("pallas", ("stencil_bf16",)),
    ("pipelined-pallas", ("stencil_bf16", "stencil_dots_bf16")),
    ("sstep-pallas", ("stencil_bf16",)),
])
def test_bf16_kernel_loops_run_their_forms(cuda, name, counters):
    """The bf16 kernel loops at 40², δ = 1e-4 launch only the bf16 forms;
    pallas converges within 3 of 32 as on the CPU (and the JAX package)."""
    problem = Problem(M=40, N=40, delta=1e-4)
    _build.reset_launches()
    got = engine.solve(problem, name, torch.bfloat16, device=cuda)
    assert set(_build.LAUNCHES) == set(counters)
    assert got.w.dtype == torch.bfloat16
    if name == "pallas":
        assert bool(got.converged) and abs(int(got.iters) - 32) <= 3


# -- the plain-stencil march (K-a f32 and bf16, K-e) on the solver's zeros --

MARCH_SHAPES = [(44, 132), (130, 20), (400, 600), (2400, 3200)]
MARCH_KINDS = ["seeded", "w = +0", "w = -0", "zero exterior, signed zeros"]
MARCH_LANES = [(44, 132, 1), (130, 20, 3), (400, 600, 32)]


def _march_w(kind, shape, dev, seed, dtype=torch.float32):
    """w of ``kind``: seeded, or one of ``chip_smoke.signed_zero_inputs``
    (all +0.0; all -0.0; a seeded ellipse with a random mix of +0.0 and
    -0.0 outside it, as the solver's state is exactly zero there)."""
    from chip_smoke import signed_zero_inputs

    if kind == "seeded":
        return _rand(shape, dev, seed, dtype)
    like = torch.empty(shape, dtype=dtype, device=dev)
    return signed_zero_inputs(like, seed)[kind]


@pytest.mark.parametrize("kind", MARCH_KINDS)
@pytest.mark.parametrize("M,N", MARCH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_march_is_bitwise_its_plain_version(cuda, dtype, M, N, kind):
    """K-a f32 and bf16, pad 1 and pad 0, on the bits: a zero dividend
    (div_pos) gives the division's own signed zero."""
    g = (M + 1, N + 1)
    w = _march_w(kind, g, cuda, M + N, dtype)
    a, b = _rand(g, cuda, 1, dtype, lo=0.5), _rand(g, cuda, 2, dtype, lo=0.5)
    h1, h2 = 2.0 / M, 1.2 / N
    _build.reset_launches()
    full = hk.apply_a_kernel(w, a, b, h1, h2)
    block = hk.apply_a_block_kernel(w, a, b, h1, h2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {ws.counter(hk.KERNEL, ws.form_of(dtype)): 2}
    assert _same_bits(full, hk.apply_a_plain(w, a, b, h1, h2))
    assert _same_bits(block, hk.apply_a_block_plain(w, a, b, h1, h2))


@pytest.mark.parametrize("kind", MARCH_KINDS)
@pytest.mark.parametrize("M,N,B", MARCH_LANES)
def test_batched_march_is_k_a_on_every_lane_on_the_bits(cuda, M, N, B, kind):
    """K-e at B = 1, 3 and 32: each lane bitwise K-a on that lane and the
    whole bitwise its plain version, pad 1 and pad 0."""
    g = (M + 1, N + 1)
    w = _march_w(kind, (B,) + g, cuda, 5)
    a, b = _rand(g, cuda, 1, lo=0.5), _rand(g, cuda, 2, lo=0.5)
    h1, h2 = 2.0 / M, 1.2 / N
    for kernel, plain, single in (
            (hk.apply_a_batched_kernel, hk.apply_a_batched_plain,
             hk.apply_a_kernel),
            (hk.apply_a_batched_block_kernel, hk.apply_a_block_plain,
             hk.apply_a_block_kernel)):
        got = kernel(w, a, b, h1, h2)
        assert _same_bits(got, plain(w, a, b, h1, h2))
        for lane in range(B):
            assert _same_bits(got[lane], single(w[lane].contiguous(), a, b,
                                                h1, h2))


@pytest.mark.parametrize("engine_name,dtype", [("pallas", torch.float32),
                                               ("pallas", torch.bfloat16),
                                               ("batched-pallas",
                                                torch.float32)])
def test_stencil_march_on_the_loops_data(cuda, engine_name, dtype):
    """K-a / K-e on a capped solve's own w (zero outside the front the
    Krylov space has reached) and the assembled a and b, bitwise."""
    problem = Problem(M=400, N=600, max_iter=64)
    h1, h2 = problem.h1, problem.h2
    if engine_name == "batched-pallas":
        from poisson_ellipse_tpu_torch.batch.driver import solve_batched

        ops = bp.batched_operands(problem, 3, dtype, cuda)
        w = solve_batched(problem, 3, engine_name, operands=ops).result.w
        a, b = ops[:2]
        kernel, plain = hk.apply_a_batched_kernel, hk.apply_a_batched_plain
    else:
        a, b, _ = assembly.assemble(problem, dtype, cuda)
        w = engine.solve(problem, engine_name, dtype, device=cuda).w
        kernel, plain = hk.apply_a_kernel, hk.apply_a_plain
    assert (w == 0).any() and (w != 0).any()
    assert _same_bits(kernel(w, a, b, h1, h2), plain(w, a, b, h1, h2))


MARCH_FORMS = ["f32", "bf16", "lanes"]


def _march_call(form, dev):
    """A K-a f32 / bf16 or K-e (B = 3) call at 400x600 on zero-exterior w."""
    g = (401, 601)
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    w = _march_w("zero exterior, signed zeros",
                 ((3,) if form == "lanes" else ()) + g, dev, 9, dtype)
    a, b = _rand(g, dev, 1, dtype, lo=0.5), _rand(g, dev, 2, dtype, lo=0.5)
    fn = hk.apply_a_batched_kernel if form == "lanes" else hk.apply_a_kernel
    return lambda: fn(w, a, b, 0.005, 0.002)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("form", MARCH_FORMS)
def test_stencil_march_in_a_cuda_graph(cuda, form, warm):
    """A K-a / K-e launch captured in a CUDA graph and replayed twice
    equals the eager launch, to the bit."""
    from chip_smoke import graph_and_eager

    eager, captured = graph_and_eager(_march_call(form, cuda), warm)
    assert _same_bits(eager, captured)


@pytest.mark.parametrize("form", MARCH_FORMS)
def test_stencil_march_issues_one_device_kernel(cuda, activities, form):
    assert activities[f"K-a {form}"] == 1
