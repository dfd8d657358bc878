"""Command line: ``python -m poisson_ellipse_tpu_torch.harness M N [...]``.

The argv contract of ``python -m poisson_ellipse_tpu.harness``'s default
command (``M N``, ``--grids``, ``--engine``, ``--dtype``, ``--norm``,
``--eps``, ``--delta``, ``--repeat``, ``--json``, ``--sstep-s``,
``--lanes``, ``--storage-dtype``, ``--mode``, ``--mesh``, ``--trace``,
``--metrics``, ``--metrics-interval``), plus ``--device``, and its
``diagnose`` and ``inspect`` subcommands. It runs on the card unless
``--device cpu`` is given, and fails without one.

``--trace FILE`` (or ``POISSON_TRACE=FILE`` in the environment) appends a
JSONL run trace (``obs.trace``, schema v3): the ``cli-args`` event, the
``phase:<name>`` spans of every timed phase, one ``run_report`` event a
run (the ``--json`` line's fields), the registry's counters, gauges and
histograms, and ``cli-exit``. ``--metrics FILE`` writes the run's
``runs``, ``runs_converged``, ``last_iters`` and ``solve_seconds`` as an
OpenMetrics snapshot (``obs.export``), every ``--metrics-interval``
seconds while running and once at the end. A path that cannot be written
exits 2 before any solve.

``diagnose <engine>`` runs one history solve (``obs.convergence``) beside
a plain one and reports whether the iterates are bitwise the same, the
spectrum (``obs.spectrum``: κ, CG rate, predicted iterations, plateaus)
and the phase profile (``obs.profile``), with ``--trace``, ``--metrics``
and ``--json``. ``inspect <engine>`` reports the kernel launches and
collectives a loop body and the roofline model (``obs.static_cost``),
``--mode sharded --mesh PX PY`` over that many rank processes.

``--mode sharded --mesh PX PY`` solves over a PX×PY mesh of ranks
(``parallel``). Under torchrun (its ``RANK``/``WORLD_SIZE`` environment)
this process is one rank and rank 0 prints; otherwise the command starts
the PX·PY rank processes itself (``parallel.multihost.spawn``), runs every
grid in them, and prints rank 0's reports.

``--guard`` runs the solve through ``resilience.guard`` (chunks with a
health word each, the recovery ladder, classified errors), ``--timeout S``
(which implies ``--guard``) cancels it at a chunk boundary past S seconds,
``--max-recoveries`` caps the ladder; with ``--lanes`` the guard is the
chunked lane driver. ``--checkpoint-dir D`` saves the carry every
``--chunk`` iterations (``xla`` or ``pallas``) and resumes from D. With
``--mode sharded`` both run on the mesh (the guard on ``xla``, ``pallas``,
``pipelined``, ``sstep``; checkpoints on ``xla``, ``pallas``, resumed on
any mesh shape), rank 0 printing. The
``inject`` subcommand runs one guarded solve with one deterministic fault
(``resilience.faultinject``) and reports the recovery.

Exit codes (the JAX package's contract, ``resilience.errors``): 0
converged; 1 not converged within the iteration cap; 2 breakdown,
recovery budget exhausted, or bad input (and a diagnose whose history
solve is not the plain one bit for bit); 3 device out of memory with no
engine left to degrade to; 4 ``--timeout`` exceeded (a partial report on
the trace); 6 silent corruption a rollback did not clear and 7 a mesh with
no survivor left (the mesh's resilience layer); 5, 8 and 9 the serving,
geometry and fleet errors of modules not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from poisson_ellipse_tpu_torch.harness.run import (
    DTYPES,
    check_sharded,
    run_once,
    run_sharded_jobs,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.resilience.errors import SolveError
from poisson_ellipse_tpu_torch.solver.engine import ENGINES
from poisson_ellipse_tpu_torch.utils.device import resolve_device


EXIT_CODES_HELP = (
    "exit codes (contract): 0 converged; 1 iteration cap reached without "
    "convergence; 2 diverged — breakdown or recovery budget exhausted "
    "(also invalid invocations, per argparse convention); 3 device "
    "out-of-memory with no engine left to degrade to; 4 --timeout "
    "exceeded (partial trace artifact emitted); 5-9 the serving, ABFT, "
    "mesh-loss, geometry and fleet errors (resilience.errors), raised by "
    "modules not ported yet."
)


def _parse_grid(spec: str) -> tuple[int, int]:
    m, sep, n = spec.strip().lower().partition("x")
    if not sep:
        raise ValueError(f"grid {spec!r} is not MxN")
    return int(m), int(n)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "diagnose":
        return _run_diagnose(argv[1:])
    if argv and argv[0] == "inspect":
        return _run_inspect(argv[1:])
    if argv and argv[0] == "inject":
        return _run_inject(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness",
        description="Fictitious-domain Poisson PCG on one CUDA device",
        epilog=EXIT_CODES_HELP,
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
                    "solving its block (engines auto/xla, pallas, fused, "
                    "pipelined, sstep/sstep-pallas, and the lane engines "
                    "with --lanes); with --guard/--timeout the guarded mesh "
                    "(xla, pallas, pipelined, sstep), with --checkpoint-dir "
                    "the checkpointed mesh (xla, pallas)")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("PX", "PY"),
                    help="mesh shape for --mode sharded (default: every "
                    "rank of torchrun's group, else 1 1)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed solves; T_solver is their median")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="FILE",
                    help="append a JSONL run trace (phase spans, run-report "
                    "events, counters; obs.trace schema v3) to FILE; "
                    "POISSON_TRACE=FILE in the environment does the same")
    ap.add_argument("--metrics", metavar="FILE",
                    help="export the run's counters, gauges and histograms "
                    "as an OpenMetrics snapshot to FILE (obs.export; written "
                    "every --metrics-interval seconds and once at exit)")
    ap.add_argument("--metrics-interval", type=float, default=30.0,
                    metavar="SECONDS",
                    help="periodic snapshot cadence for --metrics")
    ap.add_argument("--checkpoint-dir",
                    help="persist the PCG carry here every --chunk "
                    "iterations and resume from it after a kill (engines "
                    "xla and pallas)")
    ap.add_argument("--chunk", type=int, default=500,
                    help="iterations between checkpoints (with "
                    "--checkpoint-dir)")
    ap.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                    help="per-solve deadline, enforced at guard chunk "
                    "boundaries (graceful cancel: the in-flight chunk "
                    "completes, a partial schema-valid trace is emitted, "
                    "exit code 4); implies --guard")
    ap.add_argument("--guard", action="store_true",
                    help="run through resilience.guard: chunked execution "
                    "with a per-chunk device-side health word (breakdown/"
                    "NaN/stagnation), the recovery ladder (residual restart "
                    "-> f32->f64 escalation -> engine fallback), and "
                    "classified errors instead of NaN results")
    ap.add_argument("--max-recoveries", type=int, default=3,
                    help="recovery-action budget for guarded runs before "
                    "the solve is classified diverged (exit code 2)")
    ap.add_argument("--json", action="store_true", help="one JSON line per run")
    args = ap.parse_args(argv)

    if args.metrics and args.metrics_interval <= 0:
        print("error: --metrics-interval must be positive (a zero cadence "
              "would busy-spin the exporter thread)", file=sys.stderr)
        return 2
    err = _start_trace(args.trace)
    if err:
        return err
    obs_trace.event("cli-args", argv=list(argv))
    exporter = None
    if args.metrics:
        from poisson_ellipse_tpu_torch.obs.export import MetricsExporter

        exporter = MetricsExporter(args.metrics,
                                   interval_s=args.metrics_interval)
        # an unwritable path is bad input: exit 2 before any solve
        err = exporter.try_write()
        if err is not None:
            print(f"error: cannot write --metrics {args.metrics}: {err}",
                  file=sys.stderr)
            if args.trace:
                obs_trace.stop()
            return 2
        exporter.start()
    rc = None
    try:
        rc = _run_cli(args)
        return rc
    finally:
        # per-run aggregates: flushed before the reset, so a later main()
        # in this process does not report this run's counts as its own
        obs_metrics.REGISTRY.emit()
        if exporter is not None:
            exporter.stop(final_write=False)
            err = exporter.try_write()
            if err is not None:
                print(f"warning: metrics snapshot failed: {err}",
                      file=sys.stderr)
        obs_metrics.REGISTRY.reset()
        obs_trace.event("cli-exit", rc="error" if rc is None else rc)
        if args.trace:
            obs_trace.stop()


def _start_trace(path) -> int:
    """Start the tracer on ``path`` (none: the environment's, if any); 2
    with a message when the file cannot be opened, else 0."""
    if not path:
        return 0
    try:
        obs_trace.start(path)
    except OSError as e:
        print(f"error: cannot write --trace {path}: {e}", file=sys.stderr)
        return 2
    return 0


def _run_cli(args) -> int:
    """The default command's runs, after the trace and metrics set-up."""
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

    resilient = (args.guard or args.timeout is not None
                 or args.checkpoint_dir is not None)
    if args.mode == "sharded":
        try:
            reports = _sharded(args, [problem_of(M, N) for M, N in grids],
                               resilient)
        except (ValueError, NotImplementedError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if reports is None:
            return 0  # a rank other than 0 under torchrun
        rc = 0
        for (M, N), report in zip(grids, reports):
            if isinstance(report, SolveError):
                return _aborted(args, M, N, report)
            if isinstance(report, BaseException):
                print(f"error: {report}", file=sys.stderr)
                return 2
            rc = max(rc, _show(report, args.json))
        return rc
    rc = 0
    for M, N in grids:
        try:
            report = run_once(problem_of(M, N), mode=args.mode,
                              dtype=args.dtype, engine=args.engine,
                              repeat=args.repeat, device=args.device,
                              sstep_s=args.sstep_s, lanes=args.lanes,
                              storage_dtype=args.storage_dtype,
                              mesh_shape=(tuple(args.mesh) if args.mesh
                                          else None),
                              checkpoint_dir=_grid_dir(args, grids, M, N),
                              chunk=args.chunk, timeout=args.timeout,
                              guard=args.guard,
                              max_recoveries=args.max_recoveries)
        except SolveError as e:
            return _aborted(args, M, N, e)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        rc = max(rc, _show(report, args.json))
    return rc


def _grid_dir(args, grids, M: int, N: int):
    """The run's checkpoint directory: a checkpoint is fingerprinted by
    its grid, so a sweep keeps one directory a grid."""
    if args.checkpoint_dir is None or len(grids) == 1:
        return args.checkpoint_dir
    return os.path.join(args.checkpoint_dir, f"{M}x{N}")


def _aborted(args, M: int, N: int, e: SolveError) -> int:
    """The classified exit: the trace keeps every event written before the
    abort (recovery:* included) and this partial report."""
    record = {"M": M, "N": N, "dtype": args.dtype, "engine": args.engine,
              "aborted": e.classification, "iters": e.iters}
    obs_trace.event("run_report_partial", **record)
    if args.json:
        print(json.dumps(record))
    print(f"error: solve aborted — {e.classification}: {e}",
          file=sys.stderr)
    return e.exit_code


def _show(report, as_json: bool) -> int:
    """Print one report and put it on the trace and the metrics; its exit
    code."""
    obs_trace.event("run_report", **report.json_dict())
    obs_metrics.counter("runs").inc()
    if report.converged:
        obs_metrics.counter("runs_converged").inc()
    obs_metrics.gauge("last_iters").set(report.iters)
    obs_metrics.histogram("solve_seconds").observe(report.t_solver)
    if as_json:
        print(json.dumps(report.json_dict()))
    else:
        print(report.summary())
        print()
    if report.breakdown:
        return 2
    return 0 if report.converged else 1


def _sharded(args, problems, resilient: bool = False):
    """The sharded runs of every grid: in this rank under torchrun (None on
    ranks other than 0), else in PX·PY rank processes started here. A
    guarded or checkpointed run's classified error (or a refusal) comes
    back as the last entry (``run_sharded_jobs``)."""
    from poisson_ellipse_tpu_torch.parallel import multihost

    if not resilient:
        check_sharded(args.engine, args.lanes, args.storage_dtype)
    grids = [(p.M, p.N) for p in problems]
    jobs = [dict(problem=p, dtype=args.dtype, engine=args.engine,
                 repeat=args.repeat, mesh_shape=args.mesh,
                 sstep_s=args.sstep_s, lanes=args.lanes,
                 storage_dtype=args.storage_dtype) for p in problems]
    if resilient:
        for job, (M, N) in zip(jobs, grids):
            job.update(checkpoint_dir=_grid_dir(args, grids, M, N),
                       chunk=args.chunk, timeout=args.timeout,
                       guard=args.guard, max_recoveries=args.max_recoveries)
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


def _parse_grid_arg(spec) -> tuple[int, int]:
    """A subcommand's --grid (default 40x40)."""
    return (40, 40) if spec is None else _parse_grid(spec)


def _bitwise_equal(x, y) -> bool:
    """Whether two tensors hold the same bits (NaN and -0 as bits)."""
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import _bits

    return (x.shape == y.shape and x.dtype == y.dtype
            and bool(torch.equal(_bits(x), _bits(y))))


def _run_diagnose(argv: list) -> int:
    """The ``diagnose`` subcommand: one history solve beside a plain one
    (bitwise the same iterates, the same host reads), the spectrum read
    from its ring, the phase profile, and optionally an OpenMetrics
    snapshot and a trace."""
    from poisson_ellipse_tpu_torch.harness.run import DTYPES
    from poisson_ellipse_tpu_torch.solver.engine import (
        HISTORY_ENGINES,
        build_solver,
    )

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness diagnose",
        description="Solver diagnostics in one report: Lanczos spectral "
        "estimates (kappa, CG rate, predicted iterations, plateaus) from "
        "the on-device convergence ring, the fenced build/compile/H2D/"
        "solve/D2H phase profile beside the roofline model, and "
        "OpenMetrics export. The history solve is checked bitwise against "
        "a plain solve: diagnosing never changes the solver.",
    )
    ap.add_argument("engine", nargs="?", default="auto",
                    help="history-capable engine to diagnose "
                    f"({', '.join(HISTORY_ENGINES)}; auto resolves to xla)")
    ap.add_argument("--grid", help="MxN grid (default 40x40)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--delta", type=float, default=1e-6)
    ap.add_argument("--repeat", type=int, default=3,
                    help="solve-phase repetitions for the profile median")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the phase profile (spectrum and the bitwise "
                    "check only)")
    ap.add_argument("--metrics", metavar="FILE",
                    help="write the diagnostic numbers as an OpenMetrics "
                    "snapshot (obs.export; atomic write)")
    ap.add_argument("--trace", metavar="FILE", help="JSONL trace sink")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    err = _start_trace(args.trace)
    if err:
        return err
    try:
        from poisson_ellipse_tpu_torch.obs import profile as obs_profile
        from poisson_ellipse_tpu_torch.obs import spectrum as obs_spectrum
        from poisson_ellipse_tpu_torch.obs.export import MetricsExporter

        try:
            grid = _parse_grid_arg(args.grid)
            problem = Problem(M=grid[0], N=grid[1], delta=args.delta)
            dtype = DTYPES[args.dtype]
            dev = resolve_device(args.device)
            if args.repeat < 1:
                raise ValueError("repeat must be >= 1")
            if args.engine not in HISTORY_ENGINES:
                raise ValueError(
                    f"engine {args.engine!r} records no history; diagnose "
                    f"covers {', '.join(HISTORY_ENGINES)}")
            if args.metrics:
                # an unwritable path fails here, before the solves
                err = MetricsExporter(
                    args.metrics, registry=obs_metrics.MetricsRegistry()
                ).try_write()
                if err is not None:
                    raise ValueError(
                        f"cannot write --metrics {args.metrics}: {err}")
            solver, solver_args, engine = build_solver(problem, args.engine,
                                                       dtype, dev,
                                                       history=True)
            result, trace = solver(*solver_args)
            history_syncs = solver.host_syncs
            plain_solver, plain_args, _ = build_solver(problem, engine,
                                                       dtype, dev)
            plain = plain_solver(*plain_args)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        bit_identical = (int(plain.iters) == int(result.iters)
                         and _bitwise_equal(plain.diff, result.diff)
                         and _bitwise_equal(plain.w, result.w))
        spec = obs_spectrum.spectrum_report(trace, delta=problem.delta,
                                            actual_iters=int(result.iters))
        bounds = obs_spectrum.eigenvalue_bounds(trace)
        spec["eigenvalue_bounds"] = list(bounds) if bounds else None
        prof = None
        if not args.no_profile:
            prof = obs_profile.profile_engine(problem, engine, dtype,
                                              repeat=args.repeat, device=dev)
        record = {
            "engine": engine,
            "grid": list(grid),
            "dtype": args.dtype,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "iters": int(result.iters),
            "converged": bool(result.converged),
            "bit_identical": bit_identical,
            "host_syncs": {"history": history_syncs,
                           "plain": plain_solver.host_syncs},
            "spectrum": spec,
            "profile": prof,
        }
        if args.metrics:
            reg = obs_metrics.MetricsRegistry()
            reg.gauge("diagnose_iters").set(record["iters"])
            if spec.get("available"):
                reg.gauge("diagnose_kappa").set(spec["kappa"])
                reg.gauge("diagnose_cg_rate").set(spec["cg_rate"])
                if spec.get("predicted_iters") is not None:
                    reg.gauge("diagnose_predicted_iters").set(
                        spec["predicted_iters"])
            if prof is not None:
                reg.histogram("diagnose_solve_seconds").observe(
                    prof["t_solve_s"])
                reg.gauge("diagnose_compile_seconds").set(
                    prof["t_compile_s"])
                if prof.get("hbm_gbps") is not None:
                    reg.gauge("diagnose_hbm_gbps").set(prof["hbm_gbps"])
            record["metrics_path"] = MetricsExporter(
                args.metrics, registry=reg).write()
        obs_trace.event("diagnose_report", **record)
        if args.json:
            print(json.dumps(record))
        else:
            print(f"diagnose {engine} {grid[0]}x{grid[1]} ({args.dtype}, "
                  f"{record['device']}): {record['iters']} iterations, "
                  + ("converged" if record["converged"] else "NOT converged")
                  + "; history-enabled iterates "
                  + ("BIT-IDENTICAL to the plain solve" if bit_identical
                     else "DIFFER from the plain solve (contract violation)")
                  + f"; host reads {history_syncs} with the ring, "
                  f"{plain_solver.host_syncs} without")
            print(obs_spectrum.render_report(spec))
            if spec.get("eigenvalue_bounds"):
                lo, hi = spec["eigenvalue_bounds"]
                print(f"  chebyshev interval    [{lo:.6g}, {hi:.6g}]  "
                      "(widened Lanczos bounds)")
            if prof is not None:
                print(obs_profile.render_profile(prof))
            if args.metrics:
                print(f"metrics snapshot: {record['metrics_path']}")
        if not bit_identical:
            return 2
        return 0 if record["converged"] else 1
    finally:
        if args.trace:
            obs_trace.stop()


def _run_inspect(argv: list) -> int:
    """The ``inspect`` subcommand: kernel launches and collectives a loop
    body and the roofline model, for one engine (``obs.static_cost``)."""
    from poisson_ellipse_tpu_torch.harness.run import DTYPES
    from poisson_ellipse_tpu_torch.obs import static_cost

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness inspect",
        description="Cost accounting for one solver engine: kernel "
        "launches and collectives a loop body (counted over two short "
        "capped runs) beside the roofline traffic model.",
    )
    ap.add_argument("engine", help="engine to inspect (single-device: "
                    f"{', '.join(ENGINES[1:])}; --mode sharded: xla, "
                    "pallas, fused, pipelined, sstep and the batched "
                    "engines with --lanes)")
    ap.add_argument("--mode", choices=("single", "sharded"), default="single")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("PX", "PY"),
                    help="mesh shape for --mode sharded (default 1 1)")
    ap.add_argument("--grid", help="MxN grid (default 40x40)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--storage-dtype", choices=("bf16", "f16", "f32"),
                    default=None)
    ap.add_argument("--sstep-s", type=int, choices=(2, 4), default=4)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)
    try:
        grid = _parse_grid_arg(args.grid)
        report = static_cost.engine_report(
            Problem(M=grid[0], N=grid[1]), engine=args.engine,
            dtype=DTYPES[args.dtype], mode=args.mode,
            mesh_shape=tuple(args.mesh) if args.mesh else None,
            storage_dtype=args.storage_dtype, sstep_s=args.sstep_s,
            lanes=args.lanes, device=args.device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report))
    else:
        print(static_cost.render_report(report))
    obs_trace.event("inspect", **report)
    return 0


# the chunk-steppable engines ``inject`` guards (the JAX subcommand's, less
# the multigrid engines of ROADMAP Queue A item 11)
INJECT_ENGINES = ("xla", "pallas", "pipelined", "pipelined-pallas")


def _run_inject(argv: list) -> int:
    """The ``inject`` subcommand: one guarded solve with one deterministic
    fault, reporting the recovery ladder's actions (the JAX subcommand's
    arguments, JSON record and exit codes)."""
    from poisson_ellipse_tpu_torch.harness.run import DTYPES
    from poisson_ellipse_tpu_torch.resilience import faultinject
    from poisson_ellipse_tpu_torch.resilience.guard import guarded_solve

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness inject",
        description="Fault-injection harness: run a guarded solve with "
        "one deterministic fault (resilience.faultinject) and report the "
        "recovery ladder's actions. " + EXIT_CODES_HELP,
    )
    ap.add_argument(
        "fault",
        # device_loss/straggler are mesh-level dispatch faults: the mesh
        # guard's drills, not the single-solve guard's
        choices=sorted(
            set(faultinject.FAULT_KINDS) - {"device_loss", "straggler"}
        ),
        help="fault class to inject (see resilience.faultinject)",
    )
    ap.add_argument("M", type=int, nargs="?", default=40)
    ap.add_argument("N", type=int, nargs="?", default=None)
    ap.add_argument("--at", type=int, default=10, metavar="K",
                    help="iteration to inject at (guard chunks stop "
                    "exactly there)")
    ap.add_argument("--field", default=None,
                    help="carry field to corrupt (nan/halo faults; "
                    "default r)")
    ap.add_argument("--persistent", action="store_true",
                    help="re-fire the fault on every visit instead of "
                    "one-shot — forces the guard up the ladder and into the "
                    "classified error")
    ap.add_argument("--engine", default="xla", choices=INJECT_ENGINES,
                    help="chunk-steppable engine to guard (carry faults "
                    "need one)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-recoveries", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--delta", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="FILE", help="JSONL trace sink")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    err = _start_trace(args.trace)
    if err:
        return err
    # everything past the tracer's start sits under the finally that stops
    # it: a bad fault or problem spec exits 2 and releases the tracer
    try:
        try:
            dev = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        try:
            problem = Problem(M=args.M,
                              N=args.N if args.N is not None else args.M,
                              delta=args.delta)
            plan = faultinject.FaultPlan(faultinject.Fault(
                args.fault, at_iter=args.at, field=args.field,
                persistent=args.persistent,
            ))
            guarded = guarded_solve(
                problem, args.engine, DTYPES[args.dtype], chunk=args.chunk,
                max_recoveries=args.max_recoveries, timeout=args.timeout,
                faults=plan, device=dev,
            )
        except SolveError as e:
            record = {"fault": args.fault, "at": args.at,
                      "engine": args.engine,
                      "aborted": e.classification, "iters": e.iters}
            obs_trace.event("inject_report", **record)
            if args.json:
                print(json.dumps(record))
            else:
                print(f"fault {args.fault}@{args.at}: solve aborted — "
                      f"{e.classification} ({e}); exit {e.exit_code}",
                      file=sys.stderr)
            return e.exit_code
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return _report_inject(args, guarded)
    finally:
        # stop last: every inject_report above must land in the trace
        if args.trace:
            obs_trace.stop()


def _report_inject(args, guarded) -> int:
    result = guarded.result
    record = {
        "fault": args.fault, "at": args.at,
        "engine_requested": args.engine, "engine_final": guarded.engine,
        "dtype_final": guarded.dtype,
        "iters": int(result.iters), "converged": bool(result.converged),
        "recoveries": [e.kind for e in guarded.recoveries],
    }
    obs_trace.event("inject_report", **record)
    if args.json:
        print(json.dumps(record))
    else:
        kinds = ", ".join(e.kind for e in guarded.recoveries) or "none"
        print(
            f"fault {args.fault}@{args.at} on {args.engine}: "
            f"{'converged' if record['converged'] else 'NOT converged'} "
            f"after {record['iters']} iterations "
            f"(recoveries: {kinds}; finished on {guarded.engine}"
            + (f", {guarded.dtype}" if guarded.dtype else "")
            + ")"
        )
    return 0 if record["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
