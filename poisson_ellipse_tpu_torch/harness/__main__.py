"""Command line: ``python -m poisson_ellipse_tpu_torch.harness M N [...]``.

The argv contract of ``python -m poisson_ellipse_tpu.harness``'s default
command (``M N``, ``--grids``, ``--engine``, ``--dtype``, ``--norm``,
``--eps``, ``--delta``, ``--repeat``, ``--json``, ``--sstep-s``,
``--lanes``, ``--storage-dtype``, ``--mode``, ``--mesh``, ``--trace``,
``--metrics``, ``--metrics-interval``), plus ``--device``, and its
``diagnose``, ``inspect``, ``inject``, ``serve``, ``chaos`` and ``warmup``
subcommands. It runs on the card unless ``--device cpu`` is given, and
fails without one.

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
no survivor left (the mesh's resilience layer); 5 a request shed at admission (``serve``);
8 and 9 the geometry and fleet errors of modules not ported yet.

``serve`` drives a seeded Poisson arrival stream of mixed shapes through
the continuous-batching scheduler (``serve.scheduler``) and exits with the
worst per-request outcome; ``chaos`` runs the serving chaos drill
(``serve.chaos``: a NaN lane, a fake out-of-memory, a kill with journal
replay, ``--mesh`` a device loss) and exits 0 iff nothing was lost,
doubled or left unclassified, else 2; ``warmup`` fills the warm pool's
buckets (``runtime.compile_cache``: captured chunk graphs on the card)
and the kernel libraries' directory, and exits 0. Their options, JSON
records and exit codes are the JAX package's, with ``--device``.
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
    "exceeded (partial trace artifact emitted); 5 shed at admission "
    "(serve); 6 silent corruption, 7 no mesh survivor; 8-9 the geometry "
    "and fleet errors (resilience.errors), raised by modules not ported "
    "yet."
)


def _parse_grid(spec: str) -> tuple[int, int]:
    """One ``MxN`` grid (``M`` alone: M×M), as the JAX package's command
    line parses it; ValueError on a malformed or empty one."""
    m, _, n = spec.lower().partition("x")
    return (int(m), int(n or m))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "diagnose":
        return _run_diagnose(argv[1:])
    if argv and argv[0] == "inspect":
        return _run_inspect(argv[1:])
    if argv and argv[0] == "inject":
        return _run_inject(argv[1:])
    if argv and argv[0] == "warmup":
        return _run_warmup(argv[1:])
    if argv and argv[0] == "serve":
        return _run_serve(argv[1:])
    if argv and argv[0] == "chaos":
        return _run_chaos(argv[1:])
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



class _SigtermDrain:
    """SIGTERM → graceful drain for the ``serve`` subcommand.

    The handler only sets a flag; the serve loop checks it between
    arrivals and switches to drain mode (stop admitting, finish or
    journal in-flight, flush metrics/trace, exit 0) instead of dying
    mid-stream with the trace tail unflushed. Installed around the loop
    and restored on exit; a caller off the main thread gets no handler,
    never an error.
    """

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def _handle(self, signum, frame):
        self.requested = True

    def __enter__(self):
        import signal

        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
            self._installed = True
        except ValueError:  # not the main thread: no handler, no error
            pass
        return self

    def __exit__(self, *exc):
        import signal

        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
        return False


def _run_warmup(argv: list) -> int:
    """The ``warmup`` subcommand: fill the kernel libraries' directory and
    the warm pool's buckets (``runtime.compile_cache``) for the requested
    grids and lane counts, so a serving worker's first real request is a
    hit. Hit/miss counts land on the trace (``cache:hit`` /
    ``cache:miss``)."""
    from poisson_ellipse_tpu_torch.runtime import compile_cache

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness warmup",
        description="Warm the serving caches: point the kernel libraries' "
        "directory at the cache (building them there on the card) and "
        "build the warm pool's buckets for the batched engines, keyed "
        "(engine, grid-bucket, dtype, lane-bucket): static buffers and, on "
        "the card, a captured CUDA graph of one chunk. Arbitrary request "
        "sizes then hit a warm bucket by pad-and-mask embedding.",
    )
    ap.add_argument(
        "--grids", default="40x40",
        help="comma list of MxN grids to warm buckets for",
    )
    ap.add_argument(
        "--lanes", default="1,8",
        help="comma list of lane counts (each rounds up to its bucket)",
    )
    ap.add_argument(
        "--engine", default="batched",
        choices=("batched", "batched-pipelined", "both"),
    )
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument(
        "--cache-dir", default=None,
        help="kernel library directory (default: $POISSON_COMPILE_CACHE "
        "or the repository's build/kernels/)",
    )
    ap.add_argument(
        "--no-persistent", action="store_true",
        help="leave the kernel library directory alone (in-process pool "
        "only)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="FILE", help="JSONL trace sink")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    err = _start_trace(args.trace)
    if err:
        return err
    try:
        try:
            dev = resolve_device(args.device)
            grids = [_parse_grid(spec) for spec in args.grids.split(",")]
            lane_counts = [int(x) for x in args.lanes.split(",")]
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        cache_dir = (None if args.no_persistent else
                     compile_cache.enable_persistent_cache(args.cache_dir,
                                                           device=dev))
        engines = (
            ("batched", "batched-pipelined")
            if args.engine == "both"
            else (args.engine,)
        )
        pool = compile_cache.warm_pool()
        rows = []
        dtype = DTYPES[args.dtype]
        for engine in engines:
            for grid in grids:
                for lanes in lane_counts:
                    entry = pool.warmup(engine, grid, dtype, lanes,
                                        device=dev)
                    rows.append({
                        "engine": engine,
                        "grid": list(grid),
                        "bucket": list(entry.bucket),
                        "lanes": lanes,
                        "lane_bucket": entry.lanes,
                        "compile_s": round(entry.compile_s, 4),
                    })
        record = {
            "persistent_dir": cache_dir,
            "warmed": rows,
            "hits": pool.hits,
            "misses": pool.misses,
        }
        obs_trace.event("warmup_report", **record)
        if args.json:
            print(json.dumps(record))
        else:
            for row in rows:
                print(
                    f"warm {row['engine']:18s} {row['grid'][0]}x"
                    f"{row['grid'][1]} -> bucket {row['bucket'][0]}x"
                    f"{row['bucket'][1]} lanes {row['lanes']} -> "
                    f"{row['lane_bucket']}  build "
                    + (
                        f"{row['compile_s']:.3f}s"
                        if row["compile_s"] else "cached"
                    )
                )
            print(
                f"warm pool: {pool.misses} built, {pool.hits} already "
                "warm"
                + (f"; kernel libraries at {cache_dir}" if cache_dir else "")
            )
        return 0
    finally:
        if args.trace:
            obs_trace.stop()


def _run_serve(argv: list) -> int:
    """The ``serve`` subcommand: a synthetic arrival stream through the
    continuous-batching scheduler — the serving layer exercised from the
    command line, lifecycle events on the trace, latency quantiles in the
    report."""
    import random
    import time as _time

    from poisson_ellipse_tpu_torch.serve import EXIT_BY_OUTCOME, Scheduler
    from poisson_ellipse_tpu_torch.solver.pcg import unported

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness serve",
        description="Continuous-batching serve drill: drive a seeded "
        "Poisson arrival stream of mixed shapes through the scheduler "
        "(bounded admission, chunk-boundary lane retirement/refill, "
        "deadlines, retry ladder, optional crash-safe journal). "
        "exit code = the WORST per-request outcome of the stream "
        "(numerically highest of the per-request contract): 0 every "
        "request completed; 1 iteration cap; 2 failed/diverged (also "
        "invalid invocations, per argparse convention); 4 deadline "
        "missed; 5 shed at admission (backpressure — resubmit after "
        "retry_after_s).",
    )
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument(
        "--grids", default="10x10,12x12",
        help="comma list of MxN request shapes, mixed by the seeded RNG",
    )
    ap.add_argument(
        "--rate", type=float, default=200.0,
        help="Poisson arrival rate (requests/second of wall clock)",
    )
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument(
        "--deadline", type=float, default=None, metavar="SECONDS",
        help="per-request deadline (admission sheds infeasible asks; "
        "mid-solve expiry cancels at a chunk boundary, partial result)",
    )
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument(
        "--journal", metavar="FILE",
        help="crash-safe request journal; admitted-but-unfinished "
        "requests replay on the next start (see --replay)",
    )
    ap.add_argument(
        "--replay", action="store_true",
        help="replay the journal's unfinished requests before the new "
        "stream (requires --journal)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument(
        "--warm-start", action="store_true",
        help="per-bucket solve-cache pools (ROADMAP.md Queue A item 13; "
        "not ported: exits 2)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="FILE", help="JSONL trace sink")
    ap.add_argument(
        "--metrics", metavar="FILE",
        help="OpenMetrics snapshot of the serving counters/histograms",
    )
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    err = _start_trace(args.trace)
    if err:
        return err
    try:
        try:
            if args.warm_start:
                raise unported("--warm-start", "Queue A item 13")
            if args.replay and not args.journal:
                raise ValueError("--replay needs --journal")
            grids = [_parse_grid(spec) for spec in args.grids.split(",")]
            if args.requests < (0 if args.replay else 1):
                # --requests 0 is the pure-replay restart: drain the
                # journal's unfinished admissions, admit nothing new
                raise ValueError(
                    "--requests must be >= 1 (0 allowed with --replay)"
                )
            if args.rate <= 0:
                raise ValueError("--rate must be > 0 requests/second")
            sched = Scheduler(
                lanes=args.lanes, chunk=args.chunk,
                queue_capacity=args.queue_capacity,
                dtype=DTYPES[args.dtype],
                max_retries=args.retries, journal=args.journal,
                keep_solutions=False, device=args.device,
            )
        except (ValueError, RuntimeError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        replayed = sched.replay() if args.replay else 0
        rng = random.Random(args.seed)
        t0 = _time.monotonic()
        # results are harvested through collect() as the stream runs —
        # the eviction hand-off a long-lived server needs
        results: dict = {}
        drained_early = False
        with _SigtermDrain() as term:
            for _ in range(args.requests):
                if term.requested:
                    # SIGTERM: stop admitting, finish (or journal) the
                    # in-flight work, flush, exit 0
                    drained_early = True
                    sched.begin_drain()
                    obs_trace.event(
                        "serve:sigterm-drain", queued=len(sched.queue),
                    )
                    break
                M, N = rng.choice(grids)
                sched.submit(
                    Problem(M=M, N=N), deadline_s=args.deadline,
                )
                _time.sleep(min(rng.expovariate(args.rate), 0.05))
                sched.step()
                results.update(sched.collect())
            sched.drain()
            results.update(sched.collect())
        wall = _time.monotonic() - t0
        counts: dict[str, int] = {}
        for res in results.values():
            counts[res.outcome] = counts.get(res.outcome, 0) + 1
        completed = counts.get("completed", 0)
        lat = obs_metrics.REGISTRY.histogram("time_in_queue_seconds")
        record = {
            "requests": args.requests,
            "replayed": replayed,
            "outcomes": counts,
            "solves_per_sec": round(completed / wall, 2) if wall else None,
            "queue_p50_s": lat.quantile(0.5),
            "queue_p99_s": lat.quantile(0.99),
            "wall_s": round(wall, 4),
            "drained_on_sigterm": drained_early,
        }
        obs_trace.event("serve_report", **record)
        if args.metrics:
            from poisson_ellipse_tpu_torch.obs.export import MetricsExporter

            err = MetricsExporter(args.metrics).try_write()
            if err is not None:
                print(
                    f"warning: metrics snapshot failed: {err}",
                    file=sys.stderr,
                )
        if args.json:
            print(json.dumps(record))
        else:
            outcome_str = ", ".join(
                f"{k}={v}" for k, v in sorted(counts.items())
            )
            print(
                f"serve: {args.requests} requests (+{replayed} replayed) "
                f"in {wall:.2f}s — {outcome_str}; "
                f"{record['solves_per_sec']} solves/sec sustained"
            )
        # exit with the worst (numerically highest) per-request outcome;
        # a SIGTERM'd run that drained cleanly exits 0
        if drained_early:
            return 0
        return max((EXIT_BY_OUTCOME[o] for o in counts), default=0)
    finally:
        obs_metrics.REGISTRY.emit()
        obs_metrics.REGISTRY.reset()
        if args.trace:
            obs_trace.stop()


def _run_chaos(argv: list) -> int:
    """The ``chaos`` subcommand: the serving invariants under an injected
    lane NaN, a fake out-of-memory and a kill/restart — zero lost, zero
    double-completed, every outcome classified."""
    import tempfile

    from poisson_ellipse_tpu_torch.serve import run_chaos
    from poisson_ellipse_tpu_torch.solver.pcg import unported

    ap = argparse.ArgumentParser(
        prog="python -m poisson_ellipse_tpu_torch.harness chaos",
        description="Serving chaos drill (serve.chaos): a seeded Poisson "
        "stream of mixed shapes with an injected NaN-poisoned lane, a "
        "fake out-of-memory dispatch, and one mid-stream kill/restart "
        "with journal replay. Exit 0 iff zero requests were lost, none "
        "double-completed, and every terminal state is a classified "
        "outcome; exit 2 otherwise.",
    )
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grids", default="10x10,12x12,8x8")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument(
        "--no-kill", action="store_true",
        help="skip the kill/restart (fault injection only)",
    )
    ap.add_argument(
        "--mesh", action="store_true",
        help="add the device-kill drill: a simulated device loss takes "
        "out every live batch carry mid-stream and every in-flight "
        "request must re-enter through the journal/retry ladder — the "
        "zero-lost/zero-double invariants asserted across a DEVICE "
        "kill, not just a process kill",
    )
    ap.add_argument(
        "--journal", metavar="FILE",
        help="journal path (default: a temp file, removed after)",
    )
    ap.add_argument(
        "--deadline", type=float, default=None, metavar="SECONDS",
        help="per-request deadline for the stream",
    )
    ap.add_argument(
        "--warm-start", action="store_true",
        help="the drill with the per-bucket recycle pools (ROADMAP.md "
        "Queue A item 13; not ported: exits 2)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="FILE", help="JSONL trace sink")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    err = _start_trace(args.trace)
    if err:
        return err
    try:
        try:
            if args.warm_start:
                raise unported("--warm-start", "Queue A item 13")
            grids = tuple(
                _parse_grid(spec) for spec in args.grids.split(",")
            )
            resolve_device(args.device)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        tmp_dir = None
        journal = args.journal
        if journal is None and not args.no_kill:
            tmp_dir = tempfile.TemporaryDirectory()
            journal = os.path.join(tmp_dir.name, "chaos-journal.json")
        try:
            report = run_chaos(
                n_requests=args.requests, seed=args.seed, grids=grids,
                lanes=args.lanes, chunk=args.chunk,
                journal_path=journal,
                kill_after=None if not args.no_kill else 0,
                deadline_s=args.deadline,
                mesh_kill_request=(
                    max(args.requests // 3, 1) if args.mesh else None
                ),
                device=args.device,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        finally:
            if tmp_dir is not None:
                tmp_dir.cleanup()
        if args.json:
            print(json.dumps(report.json_dict()))
        else:
            verdict = "OK" if report.ok else "INVARIANT VIOLATION"
            mesh_note = (
                "; device-kill drill fired" if report.mesh_killed else ""
            )
            print(
                f"chaos: {report.n_requests} requests, seed {args.seed} — "
                f"{verdict}; outcomes {report.counts}; "
                f"replayed {report.replayed} after kill; "
                f"{report.faults_fired} faults fired{mesh_note}; "
                f"lost {len(report.lost)}, doubled "
                f"{len(report.double_completed)} ({report.wall_s:.2f}s)"
            )
        return 0 if report.ok else 2
    finally:
        obs_metrics.REGISTRY.emit()
        obs_metrics.REGISTRY.reset()
        if args.trace:
            obs_trace.stop()


if __name__ == "__main__":
    sys.exit(main())
