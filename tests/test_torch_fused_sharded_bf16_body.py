"""Why the port's fused-sharded bf16 count parts from the JAX package's at
800×1200: one body of each from the same carry.

At 800×1200 (bf16, the problem's δ = 1e-6) the loop ends when w stops
moving in bf16, and where that happens is chaotic: on one rank the JAX
package's fused-sharded solve takes 5037 iterations, the port's 13196, the
port's sharded ``xla`` 7064 and ``pallas`` 6677, and JAX's own sharded
``xla`` runs past 13196 unconverged (ROADMAP Queue C, "Deliberate
differences"). This file pins the mechanism on the first body, run by both
packages from JAX's iteration-0 carry on a 1×1 mesh (JAX's K1 and K2 in
interpret mode, the port's K1-shard and K2-shard plain versions, which the
kernels match bitwise on the card):

- pn = z + βp (β = 0) is the same bits;
- ap, w, r and z differ only by the stated rounding points (the port
  computes in float and rounds once where a value is stored, and sums in
  double; JAX rounds every bf16 operation and accumulates its sums in bf16
  over row tiles): ap within one bf16 step of its scale (a node's ap is a
  difference of terms far larger than itself, so the gap is one of those
  terms' rounding, up to 52 steps of the node's own value), and w, r and z
  within α's relative gap (756 against 764) of their scale plus two steps,
  at under 1% of the nodes for ap, r and z;
- the scalars (zr, the denominator, α, β, the step norm) within 4 ulps;
- and this grid's first step amplifies them: α ≈ 758 (758 in f64), and
  β ≈ 330, so the few-ulp departures of body 1 grow from body 2 on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops.fused_pcg import rotated_next_state as jax_tail
from poisson_ellipse_tpu.parallel import fused_sharded as jfs
from poisson_ellipse_tpu.parallel.compat import shard_map
from poisson_ellipse_tpu.parallel.halo import halo_extend as jax_halo
from poisson_ellipse_tpu.parallel.halo import (
    halo_extend_stacked as jax_halo_stacked,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.stencil import spacing
from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs
from poisson_ellipse_tpu_torch.parallel.halo import (
    halo_extend,
    halo_extend_stacked,
)
from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh, rank_sums

GRID = (800, 1200)
SCALAR_ULPS = 4
DIFF_FRACTION = 0.01
ALPHA_F64 = 757.97   # zr₀ / (A·z₀, z₀) at 800×1200 in f64


def _jax_body():
    """JAX's first body at 800×1200 bf16 on a 1×1 mesh, from its
    iteration-0 carry: the arrays (cropped to the nodes) and scalars."""
    bf = jnp.bfloat16
    problem = JaxProblem(M=GRID[0], N=GRID[1])
    mesh = JaxMesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("x", "y"))
    g1p, g2p = jfs.padded_dims_fused(problem.node_shape, mesh)
    kern = jfs.build_shard_kernels(g1p, g2p, problem.h1, problem.h2, bf, True)
    h1, h2 = jnp.asarray(problem.h1, bf), jnp.asarray(problem.h2, bf)
    delta = jnp.asarray(problem.delta, bf)
    spec = P("x", "y")
    a, b, d, dinv, rhs = jfs._fused_sharded_args(problem, mesh, bf, g1p, g2p,
                                                 spec)

    def body(a_blk, b_blk, d_blk, dinv_blk, r, z, zr):
        a_ext = jfs._pad_ext(jax_halo(a_blk, 1, 1), kern.cols)
        b_ext = jfs._pad_ext(jax_halo(b_blk, 1, 1), kern.cols)
        p = jnp.zeros_like(r)
        zp = jax_halo_stacked(jnp.stack([z, p]), 1, 1)
        beta = jnp.asarray(0.0, bf)
        pn, ap, dpart = kern.k1(jfs._vary(beta), d_blk,
                                jfs._pad_ext(zp[0], kern.cols),
                                jfs._pad_ext(zp[1], kern.cols), a_ext, b_ext)
        denom = lax.psum(dpart[0], ("x", "y")) * h1 * h2
        w2, r2, z2, sums = kern.k2(jfs._vary(zr), jfs._vary(denom), p, r, pn,
                                   ap, dinv_blk)
        psums = lax.psum(sums, ("x", "y"))
        state = (jnp.asarray(0, jnp.int32), p, r, z, p, zr, beta,
                 jnp.asarray(jnp.inf, bf), jnp.asarray(False),
                 jnp.asarray(False))
        out = jax_tail(state, pn, w2, r2, z2, psums[0] * h1 * h2, psums[1],
                       denom < 1e-15, h1, h2, delta, True)
        return pn, ap, w2, r2, z2, denom, zr / denom, out[5], out[6], out[7]

    s = P()
    run = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 6 + (s,),
                            out_specs=(spec,) * 5 + (s,) * 5,
                            check_vma=False))
    z0 = rhs * dinv
    zr0 = jnp.sum(z0 * rhs) * h1 * h2
    out = run(a, b, d, dinv, rhs, z0, zr0)
    nodes = (GRID[0] + 1, GRID[1] + 1)
    arrays = {name: np.asarray(x.astype(jnp.float32))[:nodes[0], :nodes[1]]
              for name, x in zip(("pn", "ap", "w", "r", "z"), out[:5])}
    scalars = {name: float(x) for name, x in
               zip(("denom", "alpha", "zr", "beta", "diff"), out[5:])}
    start = (np.asarray(z0.astype(jnp.float32))[:nodes[0], :nodes[1]],
             float(zr0))
    return arrays, scalars, start


def _port_body():
    """The port's first body, K1-shard and K2-shard's plain versions in
    ``fused_sharded._run``'s order, on a one-rank mesh."""
    ct = torch.bfloat16
    problem = Problem(M=GRID[0], N=GRID[1])
    mesh = make_mesh(device="cpu")
    a, b, d, dinv, rhs = fs._fused_sharded_args(problem, mesh, ct)
    q = ws.rounder(ct)
    h1t, h2t, delta_t = (ws.held(spacing(x, rhs)) for x in
                         (problem.h1, problem.h2, problem.delta))
    a_ext, b_ext = halo_extend(a, mesh), halo_extend(b, mesh)
    w, r, p = torch.zeros_like(rhs), rhs.clone(), torch.zeros_like(rhs)
    z = q(ws.held(r) * ws.held(dinv)).to(ct)
    ap = torch.empty_like(rhs)
    scal = torch.zeros(fp.N_SCAL, dtype=ct)
    zr0 = mesh.reduce(rank_sums((ws.held(z), ws.held(r))), torch.float32)[0]
    scal[fp.SCAL_ZR] = q(q(zr0) * h1t * h2t)
    scal[fp.SCAL_DIFF] = float("inf")
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32)
    start = (z.float().numpy().copy(), float(scal[fp.SCAL_ZR]))
    part1, part2 = fs.scratch(*rhs.shape, "cpu", ct)
    cap = dict(max_iter=problem.max_iterations)
    zp = halo_extend_stacked(torch.stack([z, p]), mesh)
    fs.k1(zp[0], zp[1], a_ext, b_ext, d, p, ap, scal, flags, part1,
          h1=problem.h1, h2=problem.h2, **cap)
    denom = q(q(mesh.reduce(part1.sum()[None], torch.float32)[0]) * h1t * h2t)
    scal[fp.SCAL_DENOM] = denom
    flags[fp.FLAG_PENDING_BREAKDOWN] = ws.below_guard(denom, ct).int()
    alpha = ws.guarded_alpha(ws.held(scal[fp.SCAL_ZR]), denom, q, ct)
    fs.k2(w, r, p, ap, dinv, z, scal, flags, part2, **cap)
    sums = q(mesh.reduce(part2.sum(0), torch.float32))
    fp.rotated_next_state(scal, flags, q(sums[0] * h1t * h2t), sums[1], h1t,
                          h2t, delta_t, True, q)
    arrays = {name: x.float().numpy() for name, x in
              zip(("pn", "ap", "w", "r", "z"), (p, ap, w, r, z))}
    scalars = dict(denom=float(denom), alpha=float(alpha),
                   zr=float(scal[fp.SCAL_ZR]), beta=float(scal[fp.SCAL_BETA]),
                   diff=float(scal[fp.SCAL_DIFF]))
    return arrays, scalars, start


def _ulps(x: float, y: float) -> int:
    """The distance of two bf16 values in bf16 steps."""
    bits = torch.tensor([x, y], dtype=torch.bfloat16).view(torch.int16).int()
    key = torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return abs(int(key[0]) - int(key[1]))


def _ulp(x: float) -> float:
    """One bf16 step at |x| > 0."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.fixture(scope="module")
def bodies():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return _jax_body(), _port_body()
    finally:
        torch.set_num_threads(torch_threads)


def test_the_two_start_from_the_same_carry(bodies):
    """z₀ = r·(1/D) and zr₀ are the same bits in both packages."""
    (_, _, (jax_z0, jax_zr0)), (_, _, (z0, zr0)) = bodies
    np.testing.assert_array_equal(z0, jax_z0)
    assert zr0 == jax_zr0 > 0


def test_first_body_parts_only_by_the_rounding_points(bodies):
    (jarr, jsc, _), (parr, psc, _) = bodies
    np.testing.assert_array_equal(parr["pn"], jarr["pn"])
    alpha_gap = abs(psc["alpha"] / jsc["alpha"] - 1.0)
    for name in ("ap", "w", "r", "z"):
        gap = np.abs(parr[name].astype(np.float64) - jarr[name])
        scale = np.abs(jarr[name]).max()
        if name == "ap":
            bound = _ulp(scale)
        else:
            bound = alpha_gap * scale + 2 * _ulp(scale)
        assert gap.max() <= bound, name
        if name != "w":
            assert (gap > 0).mean() < DIFF_FRACTION, name
    for name in ("denom", "alpha", "zr", "beta", "diff"):
        assert _ulps(psc[name], jsc[name]) <= SCALAR_ULPS, name


def test_this_grids_first_step_amplifies(bodies):
    (_, jsc, _), (_, psc, _) = bodies
    for sc in (jsc, psc):
        assert abs(sc["alpha"] / ALPHA_F64 - 1.0) < 0.01
        assert sc["beta"] > 100.0
