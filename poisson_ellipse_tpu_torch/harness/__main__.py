"""Command line: ``python -m poisson_ellipse_tpu_torch.harness M N [...]``.

The argv contract of ``python -m poisson_ellipse_tpu.harness``'s default
command (``M N``, ``--grids``, ``--engine``, ``--dtype``, ``--norm``,
``--eps``, ``--delta``, ``--repeat``, ``--json``, ``--sstep-s``,
``--lanes``, ``--storage-dtype``, ``--mode``, ``--mesh``), plus
``--device``. It runs on the card unless ``--device cpu`` is given, and
fails without one.

``--mode sharded --mesh PX PY`` solves over a PX×PY mesh of ranks
(``parallel``). Under torchrun (its ``RANK``/``WORLD_SIZE`` environment)
this process is one rank and rank 0 prints; otherwise the command starts
the PX·PY rank processes itself (``parallel.multihost.spawn``), runs every
grid in them, and prints rank 0's reports.

Exit codes: 0 converged, 1 not converged within the iteration cap,
2 breakdown or bad input.
"""

from __future__ import annotations

import argparse
import json
import sys

from poisson_ellipse_tpu_torch.harness.run import (
    DTYPES,
    check_sharded,
    run_once,
    run_sharded_jobs,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.solver.engine import ENGINES
from poisson_ellipse_tpu_torch.utils.device import resolve_device


def _parse_grid(spec: str) -> tuple[int, int]:
    m, sep, n = spec.strip().lower().partition("x")
    if not sep:
        raise ValueError(f"grid {spec!r} is not MxN")
    return int(m), int(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness",
        description="Fictitious-domain Poisson PCG on one CUDA device",
    )
    ap.add_argument("M", type=int, nargs="?", help="grid cells in x")
    ap.add_argument("N", type=int, nargs="?", help="grid cells in y")
    ap.add_argument("--grids",
                    help="comma list of MxN grids, e.g. 400x600,800x1200")
    ap.add_argument("--engine", choices=ENGINES, default="auto",
                    help="auto: xla for f64; for f32 and bf16 the first of "
                    "resident, streamed, xl whose gate admits the grid on "
                    "the card (xl on the CPU). xla is the plain PyTorch loop, pallas the "
                    "same loop with the CUDA stencil, fused the two-kernel "
                    "iteration; resident, streamed and xl run the whole "
                    "solve in one kernel launch; pipelined and sstep are "
                    "the one-bundle and s-step recurrences, their -pallas "
                    "forms with the CUDA kernels; batched and "
                    "batched-pipelined (and their -pallas forms) run --lanes "
                    "solves in one loop")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                    help="the compute dtype; bf16 runs on xla, pallas, "
                    "fused, resident, streamed, xl, auto, the pipelined and "
                    "sstep engines and their -pallas forms")
    ap.add_argument("--norm", choices=("weighted", "unweighted"),
                    default="weighted")
    ap.add_argument("--eps", type=float, default=None)
    ap.add_argument("--delta", type=float, default=1e-6)
    ap.add_argument("--sstep-s", type=int, choices=(2, 4), default=4,
                    help="iterations per block of the sstep engines")
    ap.add_argument("--lanes", type=int, default=1,
                    help="run N independent solves in one loop on a batched "
                    "engine (auto resolves to batched when N > 1); reports "
                    "T_solver of the whole batch and solves/s")
    ap.add_argument("--storage-dtype", choices=("bf16", "f16", "f32"),
                    default=None, metavar="DT",
                    help="store the state and the rounded operands in DT "
                    "(bf16, f16 or f32) while every stencil and reduction "
                    "runs at --dtype; on xla, pallas, the pipelined and "
                    "sstep engines and batched. The raw narrow solve "
                    "converges to the storage floor. On streamed and xl "
                    "(f32 compute) only the operands dinv, a and b are "
                    "stored in DT")
    ap.add_argument("--mode", choices=("single", "sharded"),
                    default="single",
                    help="one device, or the mesh: --mesh PX PY ranks, each "
                    "solving its block (engines auto/xla, pallas, fused)")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("PX", "PY"),
                    help="mesh shape for --mode sharded (default: every "
                    "rank of torchrun's group, else 1 1)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed solves; T_solver is their median")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="one JSON line per run")
    args = ap.parse_args(argv)

    try:
        if args.M is not None:
            grids = [(args.M, args.N if args.N is not None else args.M)]
        elif args.grids:
            grids = [_parse_grid(s) for s in args.grids.split(",")]
        else:
            grids = [(40, 40)]
    except ValueError as e:
        print(f"error: invalid --grids: {e}", file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    def problem_of(M, N):
        return Problem(M=M, N=N, delta=args.delta, eps=args.eps,
                       norm=args.norm)

    if args.mode == "sharded":
        try:
            reports = _sharded(args, [problem_of(M, N) for M, N in grids])
        except (ValueError, NotImplementedError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if reports is None:
            return 0  # a rank other than 0 under torchrun
        return max(_show(report, args.json) for report in reports)
    rc = 0
    for M, N in grids:
        try:
            report = run_once(problem_of(M, N), dtype=args.dtype,
                              engine=args.engine, repeat=args.repeat,
                              device=args.device, sstep_s=args.sstep_s,
                              lanes=args.lanes,
                              storage_dtype=args.storage_dtype)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        rc = max(rc, _show(report, args.json))
    return rc


def _show(report, as_json: bool) -> int:
    """Print one report; its exit code."""
    if as_json:
        print(json.dumps(report.json_dict()))
    else:
        print(report.summary())
        print()
    if report.breakdown:
        return 2
    return 0 if report.converged else 1


def _sharded(args, problems):
    """The sharded runs of every grid: in this rank under torchrun (None on
    ranks other than 0), else in PX·PY rank processes started here."""
    from poisson_ellipse_tpu_torch.parallel import multihost

    check_sharded(args.engine, args.lanes, args.storage_dtype, args.dtype)
    jobs = [dict(problem=p, dtype=args.dtype, engine=args.engine,
                 repeat=args.repeat, mesh_shape=args.mesh,
                 sstep_s=args.sstep_s, lanes=args.lanes,
                 storage_dtype=args.storage_dtype) for p in problems]
    if multihost.torchrun_env():
        multihost.initialize_multihost(device=args.device)
        try:
            reports = run_sharded_jobs(jobs, args.device)
        finally:
            rank = multihost.process_info()[0]
            multihost.shutdown_multihost()
        return reports if rank == 0 else None
    px, py = args.mesh or (1, 1)
    for job in jobs:
        job["mesh_shape"] = (px, py)
    return multihost.spawn(run_sharded_jobs, px * py, (jobs, args.device),
                           device=args.device)


if __name__ == "__main__":
    sys.exit(main())
