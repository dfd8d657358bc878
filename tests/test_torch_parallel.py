"""The port's mesh (``poisson_ellipse_tpu_torch.parallel``) against the JAX
package's, on the CPU.

The port's ranks are processes of a gloo group (``multihost.spawn``, a
``file://`` rendezvous in a temporary directory, one thread a rank); every
solve of one mesh shape runs in one spawn (a module-scoped fixture a
shape), which returns what this file compares. The JAX package runs its
mesh on the 8 virtual CPU devices of ``tests/conftest.py``, its Pallas
kernels in interpret mode, as ``tests/test_parallel.py`` runs them.

Tolerances, as the JAX tests hold their sharded solves to the single
device: f64 ``xla`` exactly 50 iterations at 40² and w within 1e-10 of the
JAX sharded w (both sum in double); ``pallas`` and ``fused`` at f32 take
JAX's iterations, w within 5e-6 (the port adds each reduction's terms in
double, rounded once; the JAX package sums in f32 in its own order). The
K1-shard and K2-shard plain versions against JAX's ``_k1_kernel`` and
``_k2_kernel`` on one shard: arrays within 1e-6 of their scale (XLA on the
CPU may contract a·b + c), sums within rel 1e-5 (JAX sums in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.parallel import fused_sharded as jfs
from poisson_ellipse_tpu.parallel import mesh as jmesh
from poisson_ellipse_tpu.parallel.compat import shard_map
from poisson_ellipse_tpu.parallel.halo import halo_extend as jax_halo
from poisson_ellipse_tpu.parallel.pcg_sharded import solve_sharded as jax_solve_sharded
from poisson_ellipse_tpu.solver.engine import ENGINE_CAPS as JAX_CAPS
from poisson_ellipse_tpu.solver.pcg import solve as jax_solve
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once, run_sharded_jobs
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs
from poisson_ellipse_tpu_torch.parallel import halo, mesh, multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps
from poisson_ellipse_tpu_torch.parallel import pipelined_sharded as pps
from poisson_ellipse_tpu_torch.parallel import sstep_sharded as sss
from poisson_ellipse_tpu_torch.solver import engine

W_ATOL_F64 = 1e-10
W_ATOL_F32 = 5e-6
KERNEL_TOL = 1e-6   # of the array's scale
SUM_RTOL = 1e-5

G40 = (40, 40)
UNEVEN = (13, 17)      # 14x18 nodes: padding on both axes over 2x4
ASSEMBLY = (24, 20)    # the JAX test_assembly_modes_agree grid
HALO_GLOBAL = np.arange(8 * 12, dtype=np.float64).reshape(8, 12)


def _jax_problem(M, N):
    return JaxProblem(M=M, N=N)


def _jax_mesh(px, py):
    return JaxMesh(np.asarray(jax.devices()[:px * py]).reshape(px, py),
                   (jmesh.AXIS_X, jmesh.AXIS_Y))


def _solve(grid, dtype, impl, **kw):
    return (ps.solve_report, (Problem(M=grid[0], N=grid[1]), dtype),
            dict(stencil_impl=impl, device="cpu", **kw))


def _spawn(world, jobs):
    return multihost.spawn(multihost.run_jobs, world, (jobs,), device="cpu",
                           timeout=600)


@pytest.fixture(scope="module")
def one_rank():
    return _spawn(1, [_solve(G40, torch.float64, "xla")])


@pytest.fixture(scope="module")
def two_ranks():
    return _spawn(2, [_solve(G40, torch.float64, "xla")])


@pytest.fixture(scope="module")
def four_ranks():
    """Every 2x2 result this file compares, from one spawn of 4 ranks."""
    names = ["xla64", "pallas", "fused", "fused_chunk1", "xla_chunk1",
             "host", "device", "halo", "stacked", "wide", "run_once"]
    jobs = [
        _solve(G40, torch.float64, "xla"),
        _solve(G40, torch.float32, "pallas"),
        _solve(G40, torch.float32, "fused"),
        _solve(G40, torch.float32, "fused", chunk=1),
        _solve(G40, torch.float64, "xla", chunk=1),
        _solve(ASSEMBLY, torch.float64, "xla", assembly_mode="host"),
        _solve(ASSEMBLY, torch.float64, "xla", assembly_mode="device"),
        (halo.exchange_report, (HALO_GLOBAL,), dict(device="cpu")),
        (halo.exchange_report, (HALO_GLOBAL, -2.0 * HALO_GLOBAL + 1.0),
         dict(device="cpu")),
        (halo.exchange_report, (HALO_GLOBAL,), dict(width=2, device="cpu")),
        (run_sharded_jobs, ([dict(problem=Problem(M=20, N=20), dtype="f64",
                                  engine="auto", repeat=1,
                                  mesh_shape=(2, 2))],),
         dict(device="cpu")),
    ]
    return dict(zip(names, _spawn(4, jobs)))


@pytest.fixture(scope="module")
def eight_ranks():
    """The one 2x4 case: 13x17 nodes, blocks padded on both axes."""
    return dict(zip(("xla64", "pallas", "fused"), _spawn(8, [
        _solve(UNEVEN, torch.float64, "xla"),
        _solve(UNEVEN, torch.float32, "pallas"),
        _solve(UNEVEN, torch.float32, "fused"),
    ])))


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded solves, by (grid, devices, dtype, impl)."""
    cache = {}

    def get(grid, n, dtype, impl="xla"):
        key = (grid, n, dtype, impl)
        if key not in cache:
            px, py = jmesh.choose_process_grid(n)
            cache[key] = jax_solve_sharded(_jax_problem(*grid), _jax_mesh(px, py),
                                     dtype, stencil_impl=impl)
        return cache[key]

    return get


# -- the rank grid ------------------------------------------------------------


def test_choose_process_grid_matches_jax():
    for size in range(1, 33):
        assert mesh.choose_process_grid(size) == jmesh.choose_process_grid(size)
    with pytest.raises(ValueError):
        mesh.choose_process_grid(0)


@pytest.mark.parametrize("nodes", [(41, 41), (42, 44), (14, 18), (401, 601)])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (2, 4), (3, 5)])
def test_padded_dims_match_jax(nodes, shape):
    assert (mesh.padded_dims_of(nodes, *shape)
            == jmesh.padded_dims_of(nodes, *shape))


def test_one_rank_mesh_without_a_group():
    m = mesh.make_mesh(device="cpu")
    assert (m.shape, m.rank, m.backend, m.ix, m.iy) == ((1, 1), 0, "none",
                                                        0, 0)
    assert mesh.padded_dims((41, 41), m) == (41, 41)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        mesh.make_mesh((2, 2), device="cpu")
    # a one-rank reduction rounds the one partial once
    total = m.reduce(torch.tensor([1.0 + 2**-40], dtype=torch.float64),
                     torch.float32)
    assert total.dtype == torch.float32 and float(total) == 1.0


def test_ranks_sit_row_major():
    m = mesh.Mesh(px=2, py=3, rank=4, device=torch.device("cpu"),
                  backend="gloo")
    assert (m.ix, m.iy) == (1, 1) and m.rank_of(1, 1) == 4
    assert m.world == 6


def test_process_helpers_without_a_group():
    assert multihost.process_info() == (0, 1)
    multihost.shutdown_multihost()  # not joined: a no-op
    assert multihost.global_mesh("cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.initialize_multihost()


# -- the halo exchange --------------------------------------------------------


def _jax_halo(global_array, width):
    m = _jax_mesh(2, 2)
    spec = P(jmesh.AXIS_X, jmesh.AXIS_Y)
    out = jax.jit(shard_map(lambda u: jax_halo(u, 2, 2, width=width),
                            mesh=m, in_specs=(spec,), out_specs=spec))(
        jnp.asarray(global_array))
    return np.asarray(out)


@pytest.mark.parametrize("case,width", [("halo", 1), ("wide", 2)])
def test_halo_reconstructs_neighbours_and_corners(four_ranks, case, width):
    """Each rank's extended block is the zero-padded global array's window
    around its block, and JAX's halo_extend on a 2x2 mesh agrees."""
    g = HALO_GLOBAL
    bm, bn = 4, 6
    padded = np.pad(g, width)
    jax_ext = _jax_halo(g, width)
    eb, en = bm + 2 * width, bn + 2 * width
    for r, ext in enumerate(four_ranks[case]):
        ix, iy = divmod(r, 2)
        want = padded[ix * bm:ix * bm + eb, iy * bn:iy * bn + en]
        np.testing.assert_array_equal(ext, want)
        np.testing.assert_array_equal(
            ext, jax_ext[ix * eb:(ix + 1) * eb, iy * en:(iy + 1) * en])
    # rank 3's corner came from rank 0 in the second round
    assert four_ranks["halo"][3][0, 0] == g[bm - 1, bn - 1]


def test_halo_stacked_equals_per_array(four_ranks):
    v = -2.0 * HALO_GLOBAL + 1.0
    padded_v = np.pad(v, 1)
    for r, (stacked, single) in enumerate(zip(four_ranks["stacked"],
                                              four_ranks["halo"])):
        ix, iy = divmod(r, 2)
        np.testing.assert_array_equal(stacked[0], single)
        np.testing.assert_array_equal(
            stacked[1], padded_v[ix * 4:ix * 4 + 6, iy * 6:iy * 6 + 8])


def test_halo_rejects_bad_width():
    m = mesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="width"):
        halo.halo_extend(torch.zeros(4, 4), m, width=0)
    with pytest.raises(ValueError, match="width"):
        halo.halo_extend(torch.zeros(4, 4), m, width=5)


def test_one_rank_halo_is_the_zero_ring():
    m = mesh.make_mesh(device="cpu")
    u = torch.arange(12.0).reshape(3, 4)
    ext = halo.halo_extend(u, m)
    assert torch.equal(ext, torch.nn.functional.pad(u, (1, 1, 1, 1)))


# -- the classical and fused loops against the JAX package ------------------


@pytest.mark.parametrize("ranks", ["one_rank", "two_ranks", "four_ranks"])
def test_sharded_xla_f64_matches_jax(request, jax_sharded, ranks):
    got = request.getfixturevalue(ranks)
    got = got["xla64"] if isinstance(got, dict) else got[0]
    n = {"one_rank": 1, "two_ranks": 2, "four_ranks": 4}[ranks]
    assert got["mesh"] == jmesh.choose_process_grid(n)
    assert got["iters"] == 50 and got["converged"]
    ref = jax_sharded(G40, n, jnp.float64)
    assert int(ref.iters) == 50
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=W_ATOL_F64)


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_sharded_f32_kernels_forms_match_jax(four_ranks, jax_sharded, impl):
    got = four_ranks[impl]
    ref = jax_sharded(G40, 4, jnp.float32, impl)
    assert got["iters"] == int(ref.iters) == 50 and got["converged"]
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=W_ATOL_F32)
    single = jax_solve(_jax_problem(*G40), jnp.float32)
    np.testing.assert_allclose(got["w"], np.asarray(single.w), rtol=0,
                               atol=W_ATOL_F32)


@pytest.mark.parametrize("impl,dtype,atol", [
    ("xla64", jnp.float64, W_ATOL_F64), ("pallas", jnp.float32, W_ATOL_F32),
    ("fused", jnp.float32, W_ATOL_F32)])
def test_uneven_blocks_on_2x4_match_jax(eight_ranks, jax_sharded, impl,
                                        dtype, atol):
    got = eight_ranks[impl]
    ref = jax_sharded(UNEVEN, 8, dtype, impl.removesuffix("64"))
    assert got["mesh"] == (2, 4) and got["block"] == (7, 5)
    assert got["w"].shape == np.asarray(ref.w).shape == (14, 18)
    assert got["iters"] == int(ref.iters) and got["converged"]
    np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                               atol=atol)


def test_host_and_device_assembly_agree(four_ranks):
    host, device = four_ranks["host"], four_ranks["device"]
    ref = jax_solve(_jax_problem(*ASSEMBLY), jnp.float64)
    assert host["iters"] == device["iters"] == int(ref.iters)
    for got in (host, device):
        np.testing.assert_allclose(got["w"], np.asarray(ref.w), rtol=0,
                                   atol=W_ATOL_F64)


@pytest.mark.parametrize("name", ["xla64", "pallas", "fused", "fused_chunk1",
                                  "xla_chunk1"])
def test_cadence_two_reductions_and_one_halo_a_body(four_ranks, name):
    """Every rank makes 1 halo exchange and 2 reductions a body (the
    coefficients' 2 exchanges and zr₀'s reduction once a solve): the
    ENGINE_CAPS rows, which are the JAX table's sharded_psum/sharded_halo."""
    got = four_ranks[name]
    impl = name.removesuffix("64").removesuffix("_chunk1")
    caps = engine.ENGINE_CAPS[impl]
    assert (caps["sharded_reductions"], caps["sharded_halo"]) == (
        JAX_CAPS[impl]["contracts"]["sharded_psum"],
        JAX_CAPS[impl]["contracts"]["sharded_halo"])
    bodies = got["bodies"]
    for counts in got["ranks"]:
        assert counts["collectives"] == {
            "halo": caps["sharded_halo"] * bodies + 2,
            "reduce": caps["sharded_reductions"] * bodies + 1}
    if name.endswith("chunk1"):
        # chunks of one body: the read after each body stops the loop at
        # the exit, so no body is issued past it
        assert bodies == got["iters"] and got["host_syncs"] == bodies + 1
    else:
        assert bodies == 64 * (got["host_syncs"] - 1)


def test_chunked_fused_equals_straight(four_ranks):
    a, b = four_ranks["fused"], four_ranks["fused_chunk1"]
    assert a["iters"] == b["iters"]
    np.testing.assert_array_equal(a["w"], b["w"])
    assert a["diff"] == b["diff"]


def test_sharded_plain_versions_count_no_launch(four_ranks):
    for name in ("pallas", "fused"):
        for counts in four_ranks[name]["ranks"]:
            assert counts["launches"] == {}


# -- K1-shard and K2-shard against JAX's kernels -----------------------------


def _round_up(n, m):
    return -(-n // m) * m


def _shard_inputs(jdtype):
    """One rank's (rank 3 of 2x2) inputs at 40², from the JAX package's
    fused-sharded operand set at ``jdtype`` through the interop (a bf16
    set bit for bit), and seeded z, p rounded once to it."""
    problem = Problem(M=40, N=40)
    jp = _jax_problem(40, 40)
    jm = _jax_mesh(2, 2)
    g1p, g2p = jfs.padded_dims_fused(jp.node_shape, jm)
    spec = P(jmesh.AXIS_X, jmesh.AXIS_Y)
    a, b, d, dinv, rhs = (np.asarray(x) for x in jfs._fused_sharded_args(
        jp, jm, jdtype, g1p, g2p, spec))
    rng = np.random.default_rng(7)
    interior = np.zeros(problem.node_shape, bool)
    interior[1:-1, 1:-1] = True
    z, p = (np.pad(np.where(interior, rng.standard_normal(interior.shape),
                            0.0).astype(np.float32),
                   ((0, g1p - 41), (0, g2p - 41))).astype(jdtype)
            for _ in range(2))
    ext = interop.sharded_operands_from_reference(
        problem, (z, p, a, b), (2, 2), 3, halo=1, device="cpu")
    blk = interop.sharded_operands_from_reference(
        problem, (d, dinv, rhs, z), (2, 2), 3, device="cpu")
    return problem, ext, blk


@pytest.fixture(scope="module")
def shard_inputs():
    return _shard_inputs(jnp.float32)


@pytest.fixture(scope="module")
def shard_inputs_bf16():
    return _shard_inputs(jnp.bfloat16)


def _jax_pad(x, rows, cols):
    return jnp.asarray(np.pad(x.numpy(), ((0, rows - x.shape[0]),
                                          (0, cols - x.shape[1]))))


def test_sharded_operands_from_reference_are_the_port_blocks(shard_inputs):
    problem, ext, blk = shard_inputs
    d_blk = blk[0]
    assert d_blk.shape == (21, 21) and ext[0].shape == (23, 23)
    a64, b64, _ = fs.assembly.assemble_numpy(problem)
    *_, d64, _ = fp.interior_normalized(problem, a64, b64)
    want = ps.rank_block(problem, mesh.Mesh(2, 2, 3, torch.device("cpu"),
                                            "gloo"), d64).astype(np.float32)
    np.testing.assert_array_equal(d_blk.numpy(), want)
    with pytest.raises(ValueError, match="outside"):
        interop.sharded_operands_from_reference(problem, (d64,), (2, 2), 4)


def test_k1_shard_plain_matches_jax_kernel(shard_inputs):
    problem, (z_ext, p_ext, a_ext, b_ext), (d, _dinv, _rhs, _z) = shard_inputs
    bm, bn = d.shape
    beta = 0.37
    scal = torch.zeros(fp.N_SCAL)
    scal[fp.SCAL_BETA] = beta
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    pn, ap = torch.empty(bm, bn), torch.empty(bm, bn)
    part = fs.scratch(bm, bn, "cpu")[0]
    fs.k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, part,
          max_iter=10, h1=problem.h1, h2=problem.h2)
    bma, bna = _round_up(bm, 8), _round_up(bn, 128)
    kern = jfs.build_shard_kernels(bma, bna, problem.h1, problem.h2,
                                   jnp.float32, True)
    jpn, jap, jden = kern.k1(
        jnp.float32(beta), _jax_pad(d, bma, bna),
        *(_jax_pad(x, bma + 8, bna + 128) for x in (z_ext, p_ext, a_ext,
                                                     b_ext)))
    for got, want in ((pn, jpn), (ap, jap)):
        want = np.asarray(want)[:bm, :bn]
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=KERNEL_TOL * scale)
    assert float(part.sum()) == pytest.approx(float(jden[0]), rel=SUM_RTOL)


def test_k2_shard_plain_matches_jax_kernel(shard_inputs):
    problem, _ext, (d, dinv, rhs, _z) = shard_inputs
    bm, bn = d.shape
    rng = np.random.default_rng(11)
    w, pn, ap = (torch.from_numpy(rng.standard_normal((bm, bn)).astype(
        np.float32)) for _ in range(3))
    zr, denom = 1.25, 3.5
    scal = torch.zeros(fp.N_SCAL)
    scal[fp.SCAL_ZR], scal[fp.SCAL_DENOM] = zr, denom
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    ww, rr, zz = w.clone(), rhs.clone(), torch.empty(bm, bn)
    part = fs.scratch(bm, bn, "cpu")[1]
    fs.k2(ww, rr, pn, ap, dinv, zz, scal, flags, part, max_iter=10)
    bma, bna = _round_up(bm, 8), _round_up(bn, 128)
    kern = jfs.build_shard_kernels(bma, bna, problem.h1, problem.h2,
                                   jnp.float32, True)
    jw, jr, jz, jsums = kern.k2(
        jnp.float32(zr), jnp.float32(denom),
        *(_jax_pad(x, bma, bna) for x in (w, rhs, pn, ap, dinv)))
    for got, want in ((ww, jw), (rr, jr), (zz, jz)):
        want = np.asarray(want)[:bm, :bn]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=KERNEL_TOL * np.abs(want).max())
    np.testing.assert_allclose(part.sum(0).numpy(), np.asarray(jsums),
                               rtol=SUM_RTOL)


def test_k1_k2_shard_do_nothing_after_exit(shard_inputs):
    problem, (z_ext, p_ext, a_ext, b_ext), (d, dinv, rhs, _z) = shard_inputs
    bm, bn = d.shape
    scal = torch.zeros(fp.N_SCAL)
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    flags[fp.FLAG_K] = 10  # at the cap
    pn, ap = torch.full((bm, bn), 7.0), torch.full((bm, bn), 7.0)
    p1, p2 = fs.scratch(bm, bn, "cpu")
    fs.k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, p1,
          max_iter=10, h1=problem.h1, h2=problem.h2)
    w, r, z = torch.ones(bm, bn), rhs.clone(), torch.full((bm, bn), 7.0)
    fs.k2(w, r, pn, ap, dinv, z, scal, flags, p2, max_iter=10)
    assert torch.all(pn == 7.0) and torch.all(ap == 7.0)
    assert torch.all(w == 1.0) and torch.equal(r, rhs)
    assert torch.all(z == 7.0)
    assert not p1.any() and not p2.any()


# -- K1-shard and K2-shard bf16 ------------------------------------------------
#
# The bf16 forms compute in float and round once where they store; the JAX
# kernels in interpret mode round every operation in bf16. β = 0.5 makes
# β·p exact, so pn = z + βp is one rounding in both and equal bit for bit;
# ap then differs only by the stencil's rounding points, within 2⁻⁵ of its
# term magnitude (the K-a bf16 tolerance, tests/test_torch_bf16_loops.py);
# w, r and z within 2⁻⁶ of their scale (JAX rounds α·pn and α·ap before
# adding: two roundings where the port has one); each sum within 2⁻⁶ of
# Σ|x·y| (JAX rounds each product and its accumulator to bf16).

BF16 = torch.bfloat16
BF16_TERM_TOL = 2.0**-5
BF16_ARRAY_TOL = 2.0**-6
BF16_SUM_TOL = 2.0**-6


def _bf16_port(x) -> torch.Tensor:
    return interop.tensor_from_numpy(np.asarray(x))


def _bf16_jax_pad(x, rows, cols):
    return jnp.asarray(np.pad(x.float().numpy(),
                              ((0, rows - x.shape[0]), (0, cols - x.shape[1]))),
                       jnp.bfloat16)


def _stencil_terms(w, a, b, h1, h2) -> torch.Tensor:
    """Σ|coefficient·difference|/h² at each owned node of a window."""
    w, a, b = (x.double() for x in (w, a, b))
    h1, h2 = (float(torch.tensor(h, dtype=BF16)) for h in (h1, h2))
    wc = w[1:-1, 1:-1]
    return (((a[2:, 1:-1] * (w[2:, 1:-1] - wc)).abs()
             + (a[1:-1, 1:-1] * (wc - w[:-2, 1:-1])).abs()) / h1**2
            + ((b[1:-1, 2:] * (w[1:-1, 2:] - wc)).abs()
               + (b[1:-1, 1:-1] * (wc - w[1:-1, :-2])).abs()) / h2**2)


def test_k1_shard_bf16_plain_matches_jax_kernel(shard_inputs_bf16):
    problem, (z_ext, p_ext, a_ext, b_ext), (d, *_rest) = shard_inputs_bf16
    assert z_ext.dtype == d.dtype == BF16
    bm, bn = d.shape
    beta = 0.5
    scal = torch.zeros(fp.N_SCAL, dtype=BF16)
    scal[fp.SCAL_BETA] = beta
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    pn, ap = (torch.empty(bm, bn, dtype=BF16) for _ in range(2))
    part = fs.scratch(bm, bn, "cpu")[0]
    fs.k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, part,
          max_iter=10, h1=problem.h1, h2=problem.h2)
    bma, bna = _round_up(bm, 8), _round_up(bn, 128)
    kern = jfs.build_shard_kernels(bma, bna, problem.h1, problem.h2,
                                   jnp.bfloat16, True)
    jpn, jap, jden = kern.k1(
        jnp.bfloat16(beta), _bf16_jax_pad(d, bma, bna),
        *(_bf16_jax_pad(x, bma + 8, bna + 128) for x in (z_ext, p_ext,
                                                          a_ext, b_ext)))
    jpn, jap = (_bf16_port(x)[:bm, :bn] for x in (jpn, jap))
    assert torch.equal(pn.view(torch.int16), jpn.view(torch.int16))
    pn_w = (z_ext.float() + beta * p_ext.float()).to(BF16)
    terms = _stencil_terms(pn_w, a_ext, b_ext, problem.h1, problem.h2)
    gap = (ap.double() - jap.double()).abs()
    assert bool((gap <= BF16_TERM_TOL * terms).all())
    assert not ap[d.float() == 0].float().any()
    # the form's definition: the tree in float on the rounded pn, once
    exact = float((ap.double() * pn.double()).sum())
    assert float(part.sum()) == exact
    mag = float((ap.double() * pn.double()).abs().sum())
    assert abs(float(jden[0]) - exact) <= BF16_SUM_TOL * mag


def test_k2_shard_bf16_plain_matches_jax_kernel(shard_inputs_bf16):
    problem, _ext, (d, dinv, rhs, _z) = shard_inputs_bf16
    bm, bn = d.shape
    rng = np.random.default_rng(11)
    w, pn, ap = (torch.from_numpy(rng.standard_normal((bm, bn))).to(BF16)
                 for _ in range(3))
    zr, denom = 1.25, 3.5
    scal = torch.zeros(fp.N_SCAL, dtype=BF16)
    scal[fp.SCAL_ZR], scal[fp.SCAL_DENOM] = zr, denom
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    ww, rr, zz = w.clone(), rhs.clone(), torch.empty(bm, bn, dtype=BF16)
    part = fs.scratch(bm, bn, "cpu")[1]
    fs.k2(ww, rr, pn, ap, dinv, zz, scal, flags, part, max_iter=10)
    assert ww.dtype == rr.dtype == zz.dtype == BF16
    bma, bna = _round_up(bm, 8), _round_up(bn, 128)
    kern = jfs.build_shard_kernels(bma, bna, problem.h1, problem.h2,
                                   jnp.bfloat16, True)
    jw, jr, jz, jsums = kern.k2(
        jnp.bfloat16(zr), jnp.bfloat16(denom),
        *(_bf16_jax_pad(x, bma, bna) for x in (w, rhs, pn, ap, dinv)))
    for got, want in ((ww, jw), (rr, jr), (zz, jz)):
        want = _bf16_port(want)[:bm, :bn].double()
        gap = (got.double() - want).abs().max()
        assert float(gap) <= BF16_ARRAY_TOL * float(want.abs().max())
    # the form's definition: α, w, r, z in float, each rounded once
    alpha = float(torch.tensor(zr / denom, dtype=torch.float32).to(BF16))
    w_new = (w.float() + alpha * pn.float()).to(BF16)
    r_new = (rhs.float() - alpha * ap.float()).to(BF16)
    z_new = (r_new.float() * dinv.float()).to(BF16)
    for got, want in ((ww, w_new), (rr, r_new), (zz, z_new)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    dw = w_new.float() - w.float()
    pairs = ((z_new.float() * r_new.float()).double(), (dw * dw).double())
    for got, want, terms in zip(part.sum(0), np.asarray(jsums, np.float64),
                                pairs):
        assert float(got) == float(terms.sum())
        assert abs(float(got) - want) <= BF16_SUM_TOL * float(
            terms.abs().sum())


def test_k1_k2_shard_bf16_do_nothing_after_exit(shard_inputs_bf16):
    problem, (z_ext, p_ext, a_ext, b_ext), (d, dinv, rhs, _z) = (
        shard_inputs_bf16)
    bm, bn = d.shape
    scal = torch.zeros(fp.N_SCAL, dtype=BF16)
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    flags[fp.FLAG_BREAKDOWN] = 1
    pn, ap = (torch.full((bm, bn), 7.0, dtype=BF16) for _ in range(2))
    p1, p2 = fs.scratch(bm, bn, "cpu")
    fs.k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, p1,
          max_iter=10, h1=problem.h1, h2=problem.h2)
    w, r = torch.ones(bm, bn, dtype=BF16), rhs.clone()
    z = torch.full((bm, bn), 7.0, dtype=BF16)
    fs.k2(w, r, pn, ap, dinv, z, scal, flags, p2, max_iter=10)
    assert torch.all(pn == 7.0) and torch.all(ap == 7.0)
    assert torch.all(w == 1.0) and torch.equal(r, rhs)
    assert torch.all(z == 7.0)
    assert not p1.any() and not p2.any()


# -- the harness --------------------------------------------------------------


def test_run_once_sharded_matches_single(four_ranks):
    """The in-group path (every rank calls run_once), as the JAX
    test_run_once_explicit_mesh_shape runs it."""
    (report,) = four_ranks["run_once"]
    single = run_once(Problem(M=20, N=20), dtype="f64", engine="xla",
                      device="cpu")
    assert report.mesh_shape == (2, 2) and report.backend == "gloo"
    assert report.engine == "xla" and report.converged
    assert report.iters == single.iters == 26
    assert report.l2_error == pytest.approx(single.l2_error, rel=1e-6)
    d = report.json_dict()
    assert d["mesh"] == [2, 2] and d["backend"] == "gloo"
    assert "Mesh: 2x2 ranks, backend gloo" in report.summary()
    assert [c["halo"] for c in report.rank_collectives] == [
        report.bodies + 2] * 4


def test_run_once_sharded_fused_spawns_its_ranks():
    """Without a group run_once starts the mesh's ranks itself: the fused
    per-rank path through the harness, JAX's 50 at 40²."""
    report = run_once(Problem(M=40, N=40), mode="sharded", dtype="f32",
                      engine="fused", mesh_shape=(1, 2), device="cpu")
    assert report.engine == "fused" and report.mesh_shape == (1, 2)
    assert report.iters == 50 and report.converged
    assert report.backend == "gloo"


def test_cli_sharded_runs_its_ranks(capsys):
    rc = cli_main(["40", "40", "--mode", "sharded", "--mesh", "1", "2",
                   "--device", "cpu", "--dtype", "f64", "--json"])
    assert rc == 0
    import json

    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["iters"] == 50 and rec["mesh"] == [1, 2]
    assert rec["engine"] == "xla" and rec["backend"] == "gloo"


@pytest.mark.parametrize("engine_name,error", [
    ("resident", ValueError), ("pipelined-pallas", ValueError)])
def test_run_once_sharded_refuses_what_it_does_not_run(engine_name, error):
    with pytest.raises(error):
        run_once(Problem(M=10, N=10), mode="sharded", engine=engine_name,
                 device="cpu")


@pytest.mark.parametrize("engine_name,iters", [
    ("batched-pallas", 17), ("pipelined", 17), ("sstep", 17)])
def test_run_once_sharded_runs_what_it_once_refused(engine_name, iters):
    """The lane-sharded, pipelined and s-step mesh engines, which this
    harness once refused, run on one rank: the reference's 17 at 10²
    (unweighted) in f64."""
    report = run_once(Problem(M=10, N=10, norm="unweighted"), mode="sharded",
                      engine=engine_name, dtype="f64", device="cpu")
    assert report.converged and report.iters == iters
    assert report.engine == engine_name and report.mesh_shape == (1, 1)


def test_run_once_sharded_refuses_storage_and_lanes():
    with pytest.raises(ValueError, match="storage-dtype"):
        run_once(Problem(M=10, N=10), mode="sharded", storage_dtype="bf16",
                 device="cpu")
    # lanes ride the lane-batched engines (parallel.batched_sharded)
    with pytest.raises(ValueError, match="--lanes needs --engine batched"):
        run_once(Problem(M=10, N=10), mode="sharded", engine="xla", lanes=2,
                 device="cpu")


def test_sharded_without_a_card_raises(monkeypatch):
    """A sharded run on the card with no card visible raises before it
    starts a rank: it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_once(Problem(M=10, N=10), mode="sharded", mesh_shape=(1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()


def test_a_failing_rank_raises_its_error():
    with pytest.raises(RuntimeError, match="not ported"):
        _spawn(2, [(ps._shard_init, (Problem(M=10, N=10), None, None, None,
                                     None), {"precond": "mg"})])


# -- refusals, as in the JAX package ----------------------------------------


def _mesh1():
    return mesh.make_mesh(device="cpu")


def test_fused_sharded_rejects_f64_and_defers_bf16():
    """f64 raises with the JAX text; bf16, once deferred, now solves."""
    with pytest.raises(ValueError, match="f32/bf16"):
        fs.solve_fused_sharded(Problem(M=10, N=10), _mesh1(), torch.float64)
    got = fs.solve_fused_sharded(Problem(M=10, N=10), _mesh1(),
                                 torch.bfloat16)
    assert got.w.dtype == torch.bfloat16 and bool(got.converged)
    assert int(got.iters) > 0 and not bool(got.breakdown)


def test_fused_sharded_rejects_device_assembly():
    with pytest.raises(ValueError, match="host"):
        ps.solve_sharded(Problem(M=10, N=10), _mesh1(), torch.float32,
                         assembly_mode="device", stencil_impl="fused")


def test_sharded_rejects_unknown_stencil_impl_and_assembly():
    with pytest.raises(ValueError, match="stencil_impl"):
        ps.solve_sharded(Problem(M=10, N=10), _mesh1(), torch.float32,
                         stencil_impl="cuda")
    with pytest.raises(ValueError, match="assembly_mode"):
        ps.solve_sharded(Problem(M=10, N=10), _mesh1(), torch.float32,
                         assembly_mode="disk")


@pytest.mark.parametrize("option", ["sstep_stepper", "sstep_abft",
                                    "pipelined_stepper", "stepper",
                                    "recover", "abft", "precond", "x0"])
def test_unported_mesh_options_name_their_item(option):
    """The resilience hooks (item 21b) are ported: each runs on a one-rank
    mesh to the straight solve's count, unflagged; precond= and x0_blk=
    still name item 21c."""
    m = _mesh1()
    p = Problem(M=10, N=10)
    f64 = torch.float64

    def chunked(init, advance, chunk=4):
        state, limit = init(), 0
        while not bool(state.converged) and limit < p.max_iterations:
            limit += chunk
            state = advance(state, limit)
        return state

    straight = ps.solve_sharded(p, m, f64)
    if option in ("precond", "x0"):
        kw = {"precond": object()} if option == "precond" else {
            "x0_blk": torch.zeros(1)}
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue A item 21c"):
            ps._shard_init(p, None, None, None, None, **kw)
        return
    if option == "sstep_stepper":
        state = chunked(*sss.build_sstep_sharded_stepper(p, m, f64))
    elif option == "sstep_abft":
        state = chunked(*sss.build_sstep_sharded_stepper(p, m, f64,
                                                         abft=True))
        assert not bool(state.sdc)
    elif option == "pipelined_stepper":
        state = chunked(*pps.build_pipelined_sharded_stepper(p, m, f64))
        assert abs(int(state.k) - int(straight.iters)) <= 2
        return
    elif option == "recover":
        init, advance = ps.build_sharded_stepper(p, m, f64)
        recover = ps.build_sharded_recover(p, m, f64)
        state = recover(advance(init(), 8))
        assert int(state.k) == 8 and not bool(state.converged)
        state = advance(state, p.max_iterations)
    else:
        state = chunked(*ps.build_sharded_stepper(p, m, f64,
                                                  abft=option == "abft"))
        if option == "abft":
            assert not bool(state.sdc)
    assert bool(state.converged)
    if option in ("stepper", "abft"):
        assert int(state.k) == int(straight.iters)
        assert torch.equal(state.w, straight.w)
    else:
        assert abs(int(state.k) - int(straight.iters)) <= 2


def test_one_rank_solve_in_process_matches_single():
    """The one-rank mesh with no group runs in this process: the sharded
    loop on one block is the single-device solve's count, w within 1e-10
    (f64; the reductions add in double)."""
    p = Problem(M=20, N=20)
    got = ps.solve_sharded(p, _mesh1(), torch.float64)
    ref = jax_solve(_jax_problem(20, 20), jnp.float64)
    assert int(got.iters) == int(ref.iters) == 26
    np.testing.assert_allclose(got.w[:21, :21].numpy(), np.asarray(ref.w),
                               rtol=0, atol=W_ATOL_F64)
    fused = fs.solve_fused_sharded(p, _mesh1())
    assert int(fused.iters) == 26 and bool(fused.converged)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_sharded_solver_stops_at_its_limit(impl):
    """solver(*args, limit=n), the harness's warm-up, stops at iteration n
    and leaves the next call's full solve unchanged."""
    p = Problem(M=20, N=20)
    solver, args = ps.build_sharded_solver(p, _mesh1(), torch.float32,
                                           stencil_impl=impl)
    capped = solver(*args, limit=5)
    assert int(capped.iters) == 5 and not bool(capped.converged)
    assert solver.bodies == 5 and solver.host_syncs == 2
    full = solver(*args)
    assert int(full.iters) == 26 and bool(full.converged)
    assert solver.bodies == 64

