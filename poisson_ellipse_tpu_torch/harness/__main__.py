"""Command line: ``python -m poisson_ellipse_tpu_torch.harness M N [...]``.

The argv contract of ``python -m poisson_ellipse_tpu.harness``'s default
command (``M N``, ``--grids``, ``--engine``, ``--dtype``, ``--norm``,
``--eps``, ``--delta``, ``--repeat``, ``--json``, ``--sstep-s``,
``--lanes``, ``--storage-dtype``), plus ``--device``. It
runs on the card unless ``--device cpu`` is given, and fails without one.

Exit codes: 0 converged, 1 not converged within the iteration cap,
2 breakdown or bad input.
"""

from __future__ import annotations

import argparse
import json
import sys

from poisson_ellipse_tpu_torch.harness.run import DTYPES, run_once
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
                    help="auto: xla for f64; for f32 the first of resident, "
                    "streamed, xl whose gate admits the grid on the card (xl "
                    "on the CPU). xla is the plain PyTorch loop, pallas the "
                    "same loop with the CUDA stencil, fused the two-kernel "
                    "iteration; resident, streamed and xl run the whole "
                    "solve in one kernel launch; pipelined and sstep are "
                    "the one-bundle and s-step recurrences, their -pallas "
                    "forms with the CUDA kernels; batched and "
                    "batched-pipelined (and their -pallas forms) run --lanes "
                    "solves in one loop")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
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
                    "converges to the storage floor")
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

    rc = 0
    for M, N in grids:
        try:
            problem = Problem(M=M, N=N, delta=args.delta, eps=args.eps,
                              norm=args.norm)
            report = run_once(problem, dtype=args.dtype, engine=args.engine,
                              repeat=args.repeat, device=args.device,
                              sstep_s=args.sstep_s, lanes=args.lanes,
                              storage_dtype=args.storage_dtype)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(report.json_dict()))
        else:
            print(report.summary())
            print()
        if report.breakdown:
            rc = max(rc, 2)
        elif not report.converged:
            rc = max(rc, 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
