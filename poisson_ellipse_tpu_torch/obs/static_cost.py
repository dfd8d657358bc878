"""Static cost accounting: kernel launches and collectives a loop body.

The counterpart of ``poisson_ellipse_tpu.obs.static_cost``, redesigned for
PyTorch. The JAX module reads psum and ppermute counts from a while-loop
body's jaxpr; here there is no traced program to read, but every kernel
wrapper counts its launches (``ops._build.LAUNCHES``) and every collective
counts itself (``parallel.mesh.COLLECTIVES``: "halo", "reduce"). So
:func:`engine_report` builds the engine through the entry point a user
calls (``solver.engine.build_solver``; on the mesh the harness's
``_build_sharded`` in every rank of a spawned group) and runs it twice,
capped at ``BODIES[0]`` and ``BODIES[1]`` loop bodies: the difference of
the two runs' counts over the difference of their bodies is the count a
body, and what is left of the first run is the once-a-solve work (the init
reduction, w₀'s stencil, the coefficient halos, a whole-solve engine's one
launch). The caps are below every replacement cadence (8 iterations at the
narrow widths, 32 else), so the counts are those of the plain body; the
pipelined mesh adds 2 halos in each replacement body on top
(``chip_smoke.MESH_CADENCE``).

On the CPU the kernels' plain versions run and launch nothing: the
launch columns read 0 there, the collective columns are the mesh's own.
Beside the counts the report carries the roofline model's passes and
bytes an iteration (``harness.roofline``). There is no compiler cost
analysis in PyTorch: the JAX report's XLA columns
(``flops_per_iter_est``, ``hbm_bytes_per_iter_est``) are present and None.
"""

from __future__ import annotations

import dataclasses

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem

# the two capped runs, in loop bodies
BODIES = (1, 2)


def iters_per_loop_body(engine: str, sstep_s: int = 4) -> int:
    """Iterations a loop body advances: s on the s-step engines, else 1."""
    return sstep_s if engine in ("sstep", "sstep-pallas") else 1


def _capped(problem: Problem, bodies: int, per_body: int) -> Problem:
    return dataclasses.replace(problem, max_iter=bodies * per_body)


def _difference(small: dict, large: dict, n: int) -> tuple[dict, dict]:
    """(per body, once) from the counts of two runs ``n`` bodies apart."""
    keys = sorted(set(small) | set(large))
    per = {k: (large.get(k, 0) - small.get(k, 0)) / n for k in keys}
    once = {k: small.get(k, 0) - BODIES[0] * per[k] for k in keys}
    return ({k: v for k, v in per.items() if v},
            {k: v for k, v in once.items() if v})


def _single_counts(problem: Problem, engine: str, dtype, device,
                   storage_dtype, sstep_s: int, lanes: int) -> list:
    """[(launches, collectives, bodies)] of the two capped runs on one
    device."""
    from poisson_ellipse_tpu_torch.ops import _build
    from poisson_ellipse_tpu_torch.parallel.mesh import (
        COLLECTIVES,
        reset_collectives,
    )
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    per_body = iters_per_loop_body(engine, sstep_s)
    out = []
    for n in BODIES:
        solver, args, _ = build_solver(
            _capped(problem, n, per_body), engine, dtype, device,
            storage_dtype=storage_dtype, sstep_s=sstep_s, lanes=lanes)
        _build.reset_launches()
        reset_collectives()
        solver(*args)
        out.append((dict(_build.LAUNCHES), dict(COLLECTIVES), n))
    return out


def sharded_counts(problem: Problem, engine: str, dtype, sstep_s: int = 4,
                   storage_dtype=None, lanes: int = 1, device=None,
                   mesh_shape=None) -> list:
    """On every rank of a group, together: the rank-0 counts of the two
    capped runs of the sharded ``engine`` (each rank's are the same,
    ``parallel.pcg_sharded.measured_solve``), as
    [(launches, collectives, bodies)]."""
    from poisson_ellipse_tpu_torch.harness.run import (
        _build_sharded,
        resolve_mesh,
    )
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import measured_solve

    mesh = resolve_mesh(mesh_shape, device)
    per_body = iters_per_loop_body(engine, sstep_s)
    out = []
    for n in BODIES:
        solver, args = _build_sharded(_capped(problem, n, per_body), mesh,
                                      dtype, engine, sstep_s, lanes,
                                      storage_dtype)
        _result, per_rank = measured_solve(mesh, solver, args)
        if any(r != per_rank[0] for r in per_rank):
            raise RuntimeError(f"{engine}: the ranks' counts differ: "
                               f"{per_rank}")
        out.append((per_rank[0]["launches"], per_rank[0]["collectives"],
                    solver.bodies))
    return out


def engine_report(problem: Problem, engine: str = "xla",
                  dtype=torch.float32, mode: str = "single",
                  mesh_shape: tuple[int, int] | None = None,
                  storage_dtype=None, sstep_s: int = 4, lanes: int = 1,
                  device=None) -> dict:
    """One engine's cost record (module docstring).

    Keys: engine / mode / grid / dtype / storage / mesh; ``iters_per_body``;
    ``launches_per_body`` and ``launches_once`` ({kernel counter: n});
    ``collectives_per_body`` and ``collectives_once`` ({"halo", "reduce":
    n}); ``reduce_per_iter`` and ``halo_per_iter`` (per body over
    ``iters_per_body``); the roofline model's ``modeled_passes_per_iter``
    and ``modeled_hbm_bytes_per_iter`` (None for an engine without a
    model); and the JAX report's compiler columns, None."""
    from poisson_ellipse_tpu_torch.harness import roofline
    from poisson_ellipse_tpu_torch.ops.precision import (
        dtype_name,
        resolve_storage_dtype,
    )
    from poisson_ellipse_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if mode == "single":
        runs = _single_counts(problem, engine, dtype, dev, storage_dtype,
                              sstep_s, lanes)
        mesh = None
    elif mode == "sharded":
        from poisson_ellipse_tpu_torch.harness.run import check_sharded
        from poisson_ellipse_tpu_torch.parallel import multihost

        engine = check_sharded(engine, lanes, storage_dtype)
        mesh = tuple(mesh_shape) if mesh_shape is not None else (1, 1)
        runs = multihost.spawn(
            sharded_counts, mesh[0] * mesh[1],
            (problem, engine, dtype, sstep_s, storage_dtype, lanes,
             dev.type, mesh),
            device=dev.type)
    else:
        raise ValueError(f"unknown mode: {mode!r} (single or sharded)")
    (l1, c1, b1), (l2, c2, b2) = runs
    launches, launches_once = _difference(l1, l2, b2 - b1)
    colls, colls_once = _difference(c1, c2, b2 - b1)
    per_body = iters_per_loop_body(engine, sstep_s)
    st = resolve_storage_dtype(storage_dtype, dtype)
    try:
        passes = roofline.passes_per_iter(engine, problem, None, sstep_s,
                                          st, dtype)
        g1, g2 = problem.node_shape
        modeled = roofline.bytes_per_node(engine, problem, None, sstep_s,
                                          st, dtype) * g1 * g2
    except ValueError:  # an engine without a traffic model
        passes, modeled = None, None
    return {
        "engine": engine,
        "mode": mode,
        "grid": [problem.M, problem.N],
        "dtype": dtype_name(dtype),
        "storage_dtype": dtype_name(st) if st is not None else None,
        "mesh": list(mesh) if mesh is not None else None,
        "device": dev.type,
        "iters_per_body": per_body,
        "bodies": [b1, b2],
        "launches_per_body": launches,
        "launches_once": launches_once,
        "collectives_per_body": colls,
        "collectives_once": colls_once,
        "reduce_per_iter": colls.get("reduce", 0) / per_body,
        "halo_per_iter": colls.get("halo", 0) / per_body,
        "flops_per_iter_est": None,
        "hbm_bytes_per_iter_est": None,
        "modeled_passes_per_iter": passes,
        "modeled_hbm_bytes_per_iter": modeled,
    }


def render_report(rep: dict) -> str:
    """Human-readable form of one :func:`engine_report` record (the
    ``harness inspect`` output)."""
    where = (f"sharded {rep['mesh'][0]}x{rep['mesh'][1]}"
             if rep["mode"] == "sharded" else rep["mode"])
    storage = rep.get("storage_dtype")

    def counts(d):
        return ", ".join(f"{k} {v:g}" for k, v in sorted(d.items())) or "none"

    lines = [
        f"engine {rep['engine']} ({where}, {rep['device']}), grid "
        f"{rep['grid'][0]}x{rep['grid'][1]}, dtype {rep['dtype']}"
        + (f" (storage {storage})" if storage else "") + ":",
        f"  kernel launches a body ({rep['iters_per_body']} iteration"
        f"{'s' if rep['iters_per_body'] > 1 else ''}): "
        f"{counts(rep['launches_per_body'])}",
        f"  kernel launches once a solve: {counts(rep['launches_once'])}",
        f"  collectives a body: {counts(rep['collectives_per_body'])}",
        f"  collectives once a solve: {counts(rep['collectives_once'])}",
        f"  reductions/iter {rep['reduce_per_iter']:g}, halo exchanges/iter "
        f"{rep['halo_per_iter']:g}",
        "  est FLOPs/iter, est bytes/iter: n/a (no compiler cost analysis)",
    ]
    if rep["modeled_passes_per_iter"] is not None:
        lines.append(
            f"  modeled bytes/iter   {rep['modeled_hbm_bytes_per_iter']:.3e} "
            f"({rep['modeled_passes_per_iter']:g} array passes, "
            "harness.roofline)")
    if rep["device"] == "cpu":
        lines.append("  (on the CPU the kernels' plain versions run: no "
                     "launch is counted)")
    return "\n".join(lines)
