"""One measured solve: the reference's ``main`` driver on one device.

Phases as the reference splits them (init + solver + finalize,
``poisson_mpi_cuda2.cu:992-1034``): init is the host assembly and the
upload; the first solve is a warm-up outside every timed phase (on the
card it also builds the kernels); T_solver is the median of ``repeat``
timed solves; finalize is the L2 error against the analytic solution.

``lanes > 1`` runs that many solves of the problem in one loop on a
lane-batched engine (``auto`` resolves to ``batched``, as in the JAX
harness). The report reduces the lanes as the JAX one does: iterations
and step norm of the worst lane, converged only if every lane converged,
breakdown if any lane broke down, the L2 error of lane 0, and
``solves_per_sec = lanes / T_solver``. A batched run reports no roofline.

``storage_dtype`` ("bf16", "f16" or "f32") runs the storage-vs-compute
split (``ops.precision``); the report carries it, and the roofline counts
the bytes at the storage width.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field

import torch

from poisson_ellipse_tpu_torch.harness.roofline import roofline
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.solver.engine import (
    BATCHED_ENGINES,
    build_solver,
)
from poisson_ellipse_tpu_torch.solver.pcg import unported
from poisson_ellipse_tpu_torch.utils.device import capacity, resolve_device
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic
from poisson_ellipse_tpu_torch.utils.timing import PhaseTimer

DTYPES = {"f32": torch.float32, "f64": torch.float64}


@dataclass
class RunReport:
    """The reference's rank-0 summary plus L2 error and the roofline."""

    problem: Problem
    mesh_shape: tuple[int, int]
    dtype: str
    engine: str
    iters: int
    converged: bool
    breakdown: bool
    diff: float
    l2_error: float
    t_init: float
    t_solver: float
    times: list[float] = field(default_factory=list)
    passes_per_iter: float = 0.0
    hbm_gbps: float | None = None
    hbm_peak_frac: float | None = None
    device: str = "cpu"
    host_syncs: int = 0
    # lane width of a batched run (1: the single-solve protocol), the
    # throughput it achieved (lanes / T_solver) and the lanes quarantined
    # after a non-finite carry
    lanes: int = 1
    solves_per_sec: float | None = None
    quarantined: int = 0
    # the storage width of the state and operands when one was asked for
    # ("bf16": ops.precision); None = storage == compute
    storage_dtype: str | None = None

    def summary(self) -> str:
        p = self.problem
        if self.converged:
            status = f"Converged after {self.iters} iterations (diff={self.diff:.3e})"
        elif self.breakdown:
            status = f"BREAKDOWN after {self.iters} iterations"
        else:
            status = (f"NOT converged after {self.iters} iterations "
                      f"(diff={self.diff:.3e})")
        lines = [
            f"Grid: {p.M} x {p.N}  (h1={p.h1:.6g}, h2={p.h2:.6g}, "
            f"eps={p.eps_value:.6g}, delta={p.delta:g}, norm={p.norm})",
            f"Device: {self.device}  dtype={self.dtype}"
            + (f" (storage {self.storage_dtype})" if self.storage_dtype
               else "")
            + f"  engine={self.engine}",
            status,
            f"T_init   {self.t_init:10.4f} s",
            f"T_solver {self.t_solver:10.4f} s"
            + (f"  (median of {len(self.times)})" if len(self.times) > 1
               else ""),
            f"Host syncs per solve: {self.host_syncs}",
            f"L2 error vs analytic: {self.l2_error:.6e}",
        ]
        if self.lanes > 1:
            lines.append(
                f"Lanes: {self.lanes}  throughput {self.solves_per_sec:.2f} "
                "solves/s"
                + (f"  ({self.quarantined} lane(s) quarantined)"
                   if self.quarantined else "")
            )
        if self.hbm_gbps is not None and self.iters:
            frac = (f"  ({self.hbm_peak_frac:.1%} of peak)"
                    if self.hbm_peak_frac is not None else "")
            lines.append(
                f"Roofline: {self.t_solver / self.iters * 1e6:.1f} us/iter, "
                f"{self.passes_per_iter:g} passes/iter -> "
                f"{self.hbm_gbps:.0f} GB/s{frac}"
            )
        return "\n".join(lines)

    def json_dict(self) -> dict:
        """The JAX package's ``RunReport.json_dict`` keys for a single-mode
        run, so reports from the two packages diff key for key."""
        p = self.problem
        return {
            "M": p.M,
            "N": p.N,
            "mesh": list(self.mesh_shape),
            "dtype": self.dtype,
            "engine": self.engine,
            "eps": p.eps_value,
            "delta": p.delta,
            "iters": self.iters,
            "converged": self.converged,
            "diff": self.diff,
            "l2_error": self.l2_error if math.isfinite(self.l2_error) else None,
            "t_init_s": self.t_init,
            "t_solver_s": self.t_solver,
            "passes_per_iter": self.passes_per_iter,
            "hbm_gbps": self.hbm_gbps,
            "hbm_peak_frac": self.hbm_peak_frac,
            **({"lanes": self.lanes, "solves_per_sec": self.solves_per_sec,
                "quarantined": self.quarantined} if self.lanes > 1 else {}),
            **({"storage_dtype": self.storage_dtype}
               if self.storage_dtype else {}),
        }


def run_once(problem: Problem, mode: str = "single", dtype: str = "f32",
             engine: str = "auto", repeat: int = 1,
             device=None, sstep_s: int = 4, lanes: int = 1,
             storage_dtype: str | None = None) -> RunReport:
    """Assemble, warm up, and time ``repeat`` solves on one device;
    ``sstep_s`` is the s-step engines' block size, ``lanes`` the number of
    solves a batched engine runs together, ``storage_dtype`` the narrow
    width the state and operands are stored at."""
    if mode not in ("single", "auto"):
        raise unported(f"mode={mode!r}", "Queue A item 12")
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r} (choose from {sorted(DTYPES)})")
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    if lanes > 1 and engine == "auto":
        engine = "batched"  # build_solver refuses lanes on any other engine
    dev = resolve_device(device)
    tdtype = DTYPES[dtype]
    cap = capacity(dev) if dev.type == "cuda" else None
    timer = PhaseTimer(dev)
    with timer.phase("init"):
        solver, args, engine = build_solver(problem, engine, tdtype, dev,
                                            capacity=cap, sstep_s=sstep_s,
                                            lanes=lanes,
                                            storage_dtype=storage_dtype)
    result = solver(*args)  # warm-up: builds the kernels on first use
    times = []
    for _ in range(repeat):
        step = PhaseTimer(dev)
        with step.phase("solver"):
            result = solver(*args)
        times.append(step.totals["solver"])
    timer.add("solver", statistics.median(times))
    t_solver = timer.totals["solver"]
    batched = engine in BATCHED_ENGINES
    if batched:
        # the worst lane's count and step norm, lane 0's solution
        iters = int(result.iters.max())
        converged = bool(result.converged.all())
        breakdown = bool(result.breakdown.any())
        diff = float(result.diff.max())
        w0 = result.w[0]
    else:
        iters = int(result.iters)
        converged = bool(result.converged)
        breakdown = bool(result.breakdown)
        diff = float(result.diff)
        w0 = result.w
    with timer.phase("finalize"):
        l2 = float(l2_error_vs_analytic(problem, w0))
    roof = (dict(passes_per_iter=0.0, hbm_gbps=None, hbm_peak_frac=None)
            if batched else
            roofline(problem, engine, iters, t_solver, tdtype, dev, cap,
                     sstep_s, storage_dtype))
    return RunReport(
        problem=problem,
        mesh_shape=(1, 1),
        dtype=dtype,
        engine=engine,
        iters=iters,
        converged=converged,
        breakdown=breakdown,
        diff=diff,
        l2_error=l2,
        t_init=timer.totals["init"],
        t_solver=t_solver,
        times=times,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        host_syncs=solver.host_syncs,
        lanes=lanes,
        solves_per_sec=(lanes / t_solver if batched and t_solver > 0
                        else None),
        quarantined=int(result.quarantined.sum()) if batched else 0,
        storage_dtype=storage_dtype,
        **roof,
    )
