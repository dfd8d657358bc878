"""bf16 compute on the mesh against the JAX package, on the CPU: the fused
two-kernel iteration (K1-shard and K2-shard's bf16 plain versions) and the
classical loop (``xla``, and ``pallas`` on K-a's bf16 plain version), on
one rank and on 2x2 gloo ranks, at 40², δ = 1e-4.

The JAX package runs its mesh on the 8 virtual CPU devices of
``tests/conftest.py``, its Pallas kernels in interpret mode. Its bf16
kernels round every operation in bf16, the port's bf16 forms compute in
float and round once where they store, and the port's reductions add in
double where JAX adds in bf16: so the counts are held, not the bits. What
holds: every solve converges without breakdown within ±3 iterations
(``ITERS_BAND``, the bf16 band of tests/test_torch_bf16_loops.py) of the
JAX package's solve of the same engine and mesh, which takes 32; its w
within ``W_TOL`` = 2⁻⁵ of the JAX w's scale (measured: 0.005 to 0.020,
a few bf16 ulps of the largest node); each rank
adds 1 halo exchange and 2 reductions a body, as at f32, and launches no
kernel (the plain versions on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.parallel import mesh as jmesh
from poisson_ellipse_tpu.parallel.pcg_sharded import solve_sharded as jax_solve_sharded
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.parallel import multihost
from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps

IMPLS = ("fused", "xla", "pallas")
ITERS_BAND = 3
W_TOL = 2.0**-5
DELTA = 1e-4


def _jobs():
    return [(ps.solve_report, (Problem(M=40, N=40, delta=DELTA),
                               torch.bfloat16),
             dict(stencil_impl=impl, device="cpu")) for impl in IMPLS]


@pytest.fixture(scope="module")
def port_bf16():
    """Every bf16 mesh solve of this file: one spawn of 1 rank, one of 4."""
    out = {}
    for shape in ((1, 1), (2, 2)):
        got = multihost.spawn(multihost.run_jobs, shape[0] * shape[1],
                              (_jobs(),), device="cpu", timeout=600)
        out.update({(shape, impl): r for impl, r in zip(IMPLS, got)})
    return out


@pytest.fixture(scope="module")
def jax_bf16():
    out = {}
    for px, py in ((1, 1), (2, 2)):
        jm = JaxMesh(np.asarray(jax.devices()[:px * py]).reshape(px, py),
                     (jmesh.AXIS_X, jmesh.AXIS_Y))
        for impl in IMPLS:
            out[((px, py), impl)] = jax_solve_sharded(
                JaxProblem(M=40, N=40, delta=DELTA), jm, jnp.bfloat16,
                stencil_impl=impl)
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("impl", IMPLS)
def test_mesh_bf16_counts_match_jax(port_bf16, jax_bf16, shape, impl):
    got, ref = port_bf16[(shape, impl)], jax_bf16[(shape, impl)]
    assert got["mesh"] == shape
    assert int(ref.iters) == 32 and bool(ref.converged)
    assert abs(got["iters"] - int(ref.iters)) <= ITERS_BAND
    assert got["converged"] and not got["breakdown"]
    want = np.asarray(ref.w, np.float32)
    gap = np.abs(got["w"] - want).max()
    assert gap <= W_TOL * np.abs(want).max(), gap


@pytest.mark.parametrize("impl", IMPLS)
def test_mesh_bf16_cadence_and_no_launch_on_the_cpu(port_bf16, impl):
    """1 halo exchange and 2 reductions a body on every rank, plus the
    solve's 2 coefficient halos and its first reduction; the plain
    versions count no launch."""
    got = port_bf16[((2, 2), impl)]
    bodies = got["bodies"]
    for counts in got["ranks"]:
        assert counts["collectives"] == {"halo": bodies + 2,
                                         "reduce": 2 * bodies + 1}
        assert counts["launches"] == {}


def test_fused_bf16_one_rank_and_2x2_agree(port_bf16):
    """The rank's sums are added in double and rounded once whatever the
    mesh, so 1x1 and 2x2 take the same count."""
    one, four = port_bf16[((1, 1), "fused")], port_bf16[((2, 2), "fused")]
    assert one["iters"] == four["iters"]
    gap = np.abs(one["w"] - four["w"]).max()
    assert gap <= W_TOL * np.abs(one["w"]).max()


def test_fused_bf16_ends_before_pallas_in_both_packages():
    """At a published grid, 400x600 on one rank with the problem's own δ,
    the fused mesh loop in bf16 converges, without breakdown, in fewer
    iterations than the classical ``pallas`` loop, in the JAX package as in
    the port (measured: JAX 226 against 290, the port 238 against 245), and
    no less accurately: its bf16 rounding points are K2's, which round each
    stored value once. So a fused bf16 mesh count under the pallas count at
    the same grid is the reference's behaviour, not a fault of the port's
    kernels, whose plain versions run here."""
    from poisson_ellipse_tpu_torch.parallel.fused_sharded import (
        solve_fused_sharded,
    )
    from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=400, N=600)
    jm = JaxMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 (jmesh.AXIS_X, jmesh.AXIS_Y))
    theirs = {impl: jax_solve_sharded(JaxProblem(M=400, N=600), jm,
                                      jnp.bfloat16, stencil_impl=impl)
              for impl in ("fused", "pallas")}
    mesh = make_mesh(device="cpu")
    ours = {"fused": solve_fused_sharded(problem, mesh, torch.bfloat16),
            "pallas": ps.solve_sharded(problem, mesh, torch.bfloat16,
                                       stencil_impl="pallas")}
    for got in (theirs, ours):
        fused, pallas = got["fused"], got["pallas"]
        assert bool(fused.converged) and not bool(fused.breakdown)
        assert bool(pallas.converged)
        assert int(fused.iters) < int(pallas.iters)
    l2 = {impl: float(l2_error_vs_analytic(problem, r.w.float()))
          for impl, r in ours.items()}
    assert l2["fused"] <= l2["pallas"]
