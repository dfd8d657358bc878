"""Fenced phase profiling: where one solve's seconds go.

The counterpart of ``poisson_ellipse_tpu.obs.profile``: for one engine on
one grid, the five phases a cold worker pays and the rate the solve
reached, beside the roofline model.

  t_build_s    host assembly (f64, rounded once) and the solver's
               construction, operands on the device
  t_compile_s  the first call: it builds the engine's kernel libraries at
               first use (``ops._build``, nvcc on a cold cache) and warms
               the loop; there is no ahead-of-time compile to split off
  t_h2d_s      the operands copied anew from host copies to the device
  t_solve_s    median of ``repeat`` calls on those operands
  t_d2h_s      the solution grid copied to the host

Every phase is a ``utils.timing.PhaseTimer`` phase: on a CUDA device CUDA
events recorded around it on the current stream and closed by
``torch.cuda.synchronize()``; on the CPU the host clock. Each is also a
``phase:<name>`` span on the ambient trace.

Rates, from the solve phase: ``hbm_gbps`` is the roofline model's bytes a
solve (``harness.roofline``) over t_solve, and ``hbm_peak_frac`` that
over the card's published peak (None on the CPU, where there is no device
memory to rate). PyTorch has no compiler cost analysis, so the JAX
record's XLA columns (``est_hbm_bytes_per_iter``, ``hbm_gbps_xla``,
``flops_per_s``, ``pct_of_model``) are present and None.
"""

from __future__ import annotations

import statistics

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.utils.timing import PhaseTimer

PROFILE_PHASES = ("build", "compile", "h2d", "solve", "d2h")


def profile_engine(problem: Problem, engine: str = "auto",
                   dtype=torch.float32, repeat: int = 3, device=None,
                   capacity=None) -> dict:
    """One engine's fenced phase and rate record (module docstring).
    Single-solve engines only: the lane-batched engines report throughput
    (``harness --lanes``)."""
    from poisson_ellipse_tpu_torch.harness import roofline
    from poisson_ellipse_tpu_torch.ops.precision import dtype_name
    from poisson_ellipse_tpu_torch.solver.engine import (
        BATCHED_ENGINES,
        build_solver,
    )
    from poisson_ellipse_tpu_torch.utils.device import (
        capacity as device_capacity,
        resolve_device,
    )

    if engine in BATCHED_ENGINES:
        raise ValueError(
            f"engine {engine!r} is lane-batched; the phase profile covers "
            "single-solve engines (throughput is the lanes protocol)"
        )
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    dev = resolve_device(device)
    if capacity is None and dev.type == "cuda":
        capacity = device_capacity(dev)
    timer = PhaseTimer(dev)
    with timer.phase("build"):
        solver, args, engine = build_solver(problem, engine, dtype, dev,
                                            capacity=capacity)
    with timer.phase("compile"):
        result = solver(*args)
    host_args = [a.cpu() for a in args]
    if dev.type == "cuda":
        host_args = [a.pin_memory() for a in host_args]
    with timer.phase("h2d"):
        args = [a.to(dev, non_blocking=True) for a in host_args]
    times = []
    for _ in range(repeat):
        step = PhaseTimer(dev)
        with step.phase("solve"):
            result = solver(*args)
        times.append(step.totals["solve"])
    t_solve = statistics.median(times)
    timer.add("solve", t_solve)
    with timer.phase("d2h"):
        result.w.cpu()
    iters = int(result.iters)
    try:
        roof = roofline.roofline(problem, engine, iters, t_solve, dtype,
                                 dev, capacity)
        g1, g2 = problem.node_shape
        modeled = roofline.bytes_per_node(engine, problem, capacity,
                                          dtype=dtype) * g1 * g2
    except ValueError:  # an engine without a traffic model
        roof = dict(passes_per_iter=None, hbm_gbps=None, hbm_peak_frac=None)
        modeled = None
    t = timer.totals
    return {
        "engine": engine,
        "grid": [problem.M, problem.N],
        "dtype": dtype_name(dtype),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "iters": iters,
        "converged": bool(result.converged),
        "host_syncs": solver.host_syncs,
        **{f"t_{name}_s": t[name] for name in PROFILE_PHASES},
        "solve_times_s": times,
        "us_per_iter": t_solve / iters * 1e6 if iters else None,
        "modeled_passes_per_iter": roof["passes_per_iter"],
        "modeled_hbm_bytes_per_iter": modeled,
        "est_hbm_bytes_per_iter": None,
        "hbm_gbps": roof["hbm_gbps"],
        "hbm_gbps_xla": None,
        "flops_per_s": None,
        "pct_of_model": None,
        "hbm_peak_frac": roof["hbm_peak_frac"],
    }


def render_profile(rows) -> str:
    """The phase table (``harness diagnose``); one row or a list."""
    if isinstance(rows, dict):
        rows = [rows]
    if not rows:
        return "profile: no engine produced a row"
    grid = rows[0]["grid"]
    lines = [
        f"phase profile {grid[0]}x{grid[1]} ({rows[0]['dtype']}, "
        f"{rows[0]['device']}; fenced, solve = median of "
        f"{len(rows[0]['solve_times_s'])}):",
        "  engine            build    compile      H2D    solve      D2H"
        "   us/iter   GB/s(model)",
    ]

    def col(v, fmt="{:8.4f}", na="     n/a"):
        return fmt.format(v) if v is not None else na

    for r in rows:
        lines.append(
            f"  {r['engine']:<16s}"
            f" {col(r['t_build_s'])} {col(r['t_compile_s'])}"
            f" {col(r['t_h2d_s'])} {col(r['t_solve_s'])}"
            f" {col(r['t_d2h_s'])}  {col(r['us_per_iter'], '{:8.1f}')}"
            f"     {col(r['hbm_gbps'], '{:9.2f}', '      n/a')}")
    for r in rows:
        if r.get("hbm_peak_frac") is not None:
            lines.append(f"  {r['engine']}: {r['hbm_peak_frac']:.1%} of the "
                         "card's memory peak (traffic model)")
    lines.append("  (no compiler cost analysis: the XLA columns are n/a)")
    return "\n".join(lines)
