#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check every phase.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. device   — nvidia-smi's name and power limit, torch's device name and
              count; fails without a CUDA device or without the port's
              package beside this script.
2. build    — every kernel from poisson_ellipse_tpu_torch/csrc/, one nvcc
              per source in parallel; prints ptxas's registers, shared
              memory and spills.
3. kernels  — each kernel against its plain PyTorch version at the main
              path's 2401x3201 f32 shapes, inputs from
              numpy.random.default_rng(seed): arrays within rel 1e-6 /
              atol 1e-6 (bitwise expected: built with -fmad=false), sums
              within rel 1e-5 (their order differs); and a no-op check
              once the loop's flags say it has exited.
4. oracles  — xla in f64 on the card: exactly 17/31/61 (unweighted),
              15/26/50 (weighted) and 546; pallas and fused in f32: the
              exact small-grid counts and 546/989 within +-2.
5. main     — 2400x3200 through build_solver(engine="auto") (resolves to
              fused): 2449 +- 2 iterations, K1 and K2 launches >= iters,
              host reads once per chunk, l2 error; the same grid through
              the pallas engine for the stencil's launches; and
              max|w_fused - w_xla,f64| at 800x1200. Launch counts are set
              to 0 just before each run and read just after it.
6. timing   — each kernel and its plain version with CUDA events at
              2401x3201 next to its bound, and T_solver at 2400x3200 and
              800x1200.
7. profile  — one solve of each timed configuration under torch.profiler:
              device time by kernel and the device's idle share.

The last three lines are nvidia-smi's card name and power limit, the
kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "poisson_ellipse_tpu_torch"

# H100 SXM peak figures: HBM3 memory rate and the float32 rate outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

ARRAY_RTOL = 1e-6
ARRAY_ATOL = 1e-6
SUM_RTOL = 1e-5
ITERS_ABS = 2  # pyproject.toml [tool.bench_compare] iters-abs

UNWEIGHTED = {(10, 10): 17, (20, 20): 31, (40, 40): 61}
WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}
LARGE = {(400, 600): 546, (800, 1200): 989}
MAIN_GRID = (2400, 3200)
MAIN_ITERS = 2449


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x.double() - y.double()).abs().max())


def close_arrays(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = max_abs(got, want)
    bound = float((ARRAY_ATOL + ARRAY_RTOL * want.double().abs()).min())
    ok = bool(torch.all((got.double() - want.double()).abs()
                        <= ARRAY_ATOL + ARRAY_RTOL * want.double().abs()))
    bitwise = bool(torch.equal(got, want))
    say(f"  {name}: max_abs_err {err:.3e} bitwise={bitwise}")
    require(ok, f"{name} differs from its plain version beyond rel "
            f"{ARRAY_RTOL} / atol {ARRAY_ATOL} (tightest bound {bound:.3e})")
    return err


def close_sum(name: str, got: float, want: float) -> float:
    rel = abs(got - want) / max(abs(want), 1e-300)
    say(f"  {name}: kernel {got!r} plain {want!r} rel {rel:.3e}")
    require(math.isfinite(got) and rel <= SUM_RTOL,
            f"{name} differs beyond rel {SUM_RTOL}")
    return abs(got - want)


def time_ms(fn, n: int, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around n calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> tuple[str, str]:
    say("== phase 1: device")
    require(torch.cuda.is_available(), "no CUDA device is visible")
    require(PACKAGE.is_dir(), f"the port's package is not beside "
            f"{Path(__file__).name}")
    line = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"nvidia-smi: {line}")
    say(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{kind!r} count {torch.cuda.device_count()}")
    from poisson_ellipse_tpu_torch.utils.device import capacity

    say(f"capacity: {capacity(0)}")
    return line, kind


def phase_build():
    from poisson_ellipse_tpu_torch.ops import _build

    say("== phase 2: build")
    t0 = time.perf_counter()
    reports = _build.build()
    say(f"built {', '.join(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for ln in text.splitlines():
            if any(k in ln for k in ("Compiling entry", "registers", "spill",
                                     "smem")):
                say(f"  [{name}] {ln.strip()}")


def kernel_inputs(seed: int):
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.fused_pcg import fused_operands

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    g1, g2 = problem.node_shape
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def dev_f32(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return problem, dict(
        w=dev_f32(rng.standard_normal((g1, g2))),
        a=dev_f32(rng.random((g1, g2)) + 0.5),
        b=dev_f32(rng.random((g1, g2)) + 0.5),
        z=dev_f32(rng.standard_normal((g1, g2))),
        p=dev_f32(rng.standard_normal((g1, g2))),
        r=dev_f32(rng.standard_normal((g1, g2))),
        coeffs=fused_operands(problem, torch.float32, dev),
    )


def phase_kernels(problem, inp) -> dict:
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk

    say("== phase 3: kernels against their plain versions, "
        f"{problem.node_shape[0]}x{problem.node_shape[1]} f32")
    h1, h2 = problem.h1, problem.h2
    errs = {}

    say("K-a stencil (full grid, zero ring)")
    got = hk.apply_a_kernel(inp["w"], inp["a"], inp["b"], h1, h2)
    want = hk.apply_a_plain(inp["w"], inp["a"], inp["b"], h1, h2)
    err = close_arrays("Aw", got, want)
    got = hk.apply_a_block_kernel(inp["w"], inp["a"], inp["b"], h1, h2)
    want = hk.apply_a_block_plain(inp["w"], inp["a"], inp["b"], h1, h2)
    errs["stencil"] = max(err, close_arrays("Aw block", got, want))

    an, as_, bw, be, d, dinv = inp["coeffs"]
    g1, g2 = problem.node_shape
    never = 2**31 - 1

    def fresh_state(zr=1.5, beta=0.7, alpha=0.0):
        scal = torch.zeros(fp.N_SCAL, dtype=torch.float32, device="cuda")
        scal[fp.SCAL_ZR], scal[fp.SCAL_BETA] = zr, beta
        scal[fp.SCAL_DIFF], scal[fp.SCAL_ALPHA] = float("inf"), alpha
        flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32, device="cuda")
        return scal, flags

    partials = torch.empty(fp.scratch_len(g1, g2), device="cuda")

    say("K-b fused K1")
    outs = {}
    for which, fn in (("kernel", fp.k1), ("plain", fp.k1_plain)):
        scal, flags = fresh_state()
        pn, ap = torch.empty_like(inp["z"]), torch.empty_like(inp["z"])
        fn(inp["z"], inp["p"], an, as_, bw, be, d, pn, ap, scal, flags,
           partials, max_iter=never, h1=h1, h2=h2)
        outs[which] = (pn, ap, scal, flags)
    (pn, ap, scal_k, flags_k), (pn_p, ap_p, scal_p, flags_p) = (
        outs["kernel"], outs["plain"])
    err = max(close_arrays("pn", pn, pn_p), close_arrays("ap", ap, ap_p))
    close_sum("denom", float(scal_k[fp.SCAL_DENOM]),
              float(scal_p[fp.SCAL_DENOM]))
    close_sum("alpha", float(scal_k[fp.SCAL_ALPHA]),
              float(scal_p[fp.SCAL_ALPHA]))
    require(torch.equal(flags_k, flags_p), f"K1 flags {flags_k.tolist()} "
            f"vs plain {flags_p.tolist()}")
    errs["fused_k1"] = err

    say("K-c fused K2")
    outs = {}
    for which, fn in (("kernel", fp.k2), ("plain", fp.k2_plain)):
        scal, flags = fresh_state(alpha=0.3)
        w, r = inp["w"].clone(), inp["r"].clone()
        z = torch.empty_like(w)
        fn(w, r, pn_p, ap_p, dinv, z, scal, flags, partials, max_iter=never,
           h1=h1, h2=h2, delta=problem.delta, weighted=True)
        outs[which] = (w, r, z, scal, flags)
    (w, r, z, scal_k, flags_k), (w_p, r_p, z_p, scal_p, flags_p) = (
        outs["kernel"], outs["plain"])
    err = max(close_arrays("w", w, w_p), close_arrays("r", r, r_p),
              close_arrays("z", z, z_p))
    for name, i in (("zr", fp.SCAL_ZR), ("beta", fp.SCAL_BETA),
                    ("diff", fp.SCAL_DIFF)):
        close_sum(name, float(scal_k[i]), float(scal_p[i]))
    require(torch.equal(flags_k[:3], flags_p[:3]),
            f"K2 flags {flags_k.tolist()} vs plain {flags_p.tolist()}")
    errs["fused_k2"] = err

    say("K1/K2 after the loop has exited write nothing")
    scal, flags = fresh_state(alpha=0.3)
    flags[fp.FLAG_CONVERGED] = 1
    w, r, z = inp["w"].clone(), inp["r"].clone(), inp["z"].clone()
    pn, ap = inp["p"].clone(), inp["z"].clone()
    before = [t.clone() for t in (w, r, z, pn, ap, scal, flags)]
    fp.k1(z, inp["p"], an, as_, bw, be, d, pn, ap, scal, flags, partials,
          max_iter=never, h1=h1, h2=h2)
    fp.k2(w, r, pn, ap, dinv, z, scal, flags, partials, max_iter=never,
          h1=h1, h2=h2, delta=problem.delta, weighted=True)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in
                zip(before, (w, r, z, pn, ap, scal, flags))),
            "a kernel wrote after the loop had exited")
    say("  unchanged")
    return errs


def _solve(problem, engine, dtype):
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    solver, args, resolved = build_solver(problem, engine, dtype, "cuda")
    result = solver(*args)
    return result, resolved, solver.host_syncs


def phase_oracles() -> None:
    from poisson_ellipse_tpu_torch.models.problem import Problem

    say("== phase 4: oracle iteration counts on the card")
    cases = []
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        for (m, n), want in table.items():
            for engine, dtype in (("xla", torch.float64),
                                  ("pallas", torch.float32),
                                  ("fused", torch.float32)):
                cases.append((Problem(M=m, N=n, norm=norm), engine, dtype,
                              want, 0))
    cases.append((Problem(M=400, N=600), "xla", torch.float64, 546, 0))
    for (m, n), want in LARGE.items():
        for engine in ("pallas", "fused"):
            cases.append((Problem(M=m, N=n), engine, torch.float32, want,
                          ITERS_ABS))
    for problem, engine, dtype, want, tol in cases:
        result, _, _ = _solve(problem, engine, dtype)
        iters = int(result.iters)
        say(f"  {problem.M}x{problem.N} {problem.norm} {engine} "
            f"{str(dtype)[6:]}: {iters} iterations (oracle {want}"
            f"{f' +-{tol}' if tol else ''})")
        require(bool(result.converged), "did not converge")
        require(abs(iters - want) <= tol, "iteration count off the oracle")


def phase_main() -> dict:
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import _build
    from poisson_ellipse_tpu_torch.solver.engine import build_solver
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    say(f"== phase 5: main path, {problem.M}x{problem.N} f32, engine auto")
    solver, args, engine = build_solver(problem, "auto", torch.float32,
                                        "cuda")
    _build.reset_launches()
    result = solver(*args)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    iters = int(result.iters)
    l2 = float(l2_error_vs_analytic(problem, result.w))
    say(f"  engine {engine}: {iters} iterations, converged "
        f"{bool(result.converged)}, diff {float(result.diff):.3e}, "
        f"host reads {solver.host_syncs}, l2 error {l2:.6e}, "
        f"launches {launches}")
    require(engine == "fused", "auto did not resolve to fused")
    require(bool(result.converged) and abs(iters - MAIN_ITERS) <= ITERS_ABS,
            f"expected {MAIN_ITERS} +-{ITERS_ABS} iterations")
    require(tuple(result.w.shape) == problem.node_shape
            and bool(torch.isfinite(result.w).all()), "w not finite")
    require(math.isfinite(l2) and l2 < 1e-3, "l2 error out of range")
    for k in ("fused_k1", "fused_k2"):
        require(launches.get(k, 0) >= iters, f"{k} launched fewer times "
                "than iterations")
    require(solver.host_syncs <= iters // 64 + 2, "more host reads than "
            "one per chunk")

    say(f"  pallas engine, {problem.M}x{problem.N} f32")
    solver_p, args_p, _ = build_solver(problem, "pallas", torch.float32,
                                       "cuda")
    _build.reset_launches()
    result_p = solver_p(*args_p)
    torch.cuda.synchronize()
    launches_p = dict(_build.LAUNCHES)
    iters_p = int(result_p.iters)
    say(f"  pallas: {iters_p} iterations, host reads {solver_p.host_syncs}, "
        f"launches {launches_p}")
    require(bool(result_p.converged)
            and abs(iters_p - MAIN_ITERS) <= ITERS_ABS,
            f"pallas: expected {MAIN_ITERS} +-{ITERS_ABS} iterations")
    require(launches_p.get("stencil", 0) >= iters_p, "stencil launched "
            "fewer times than iterations")

    mid = Problem(M=800, N=1200)
    w32, _, _ = _solve(mid, "fused", torch.float32)
    w64, _, _ = _solve(mid, "xla", torch.float64)
    gap = max_abs(w32.w, w64.w)
    say(f"  max|w_fused,f32 - w_xla,f64| at 800x1200: {gap:.3e}")
    require(math.isfinite(gap) and gap < 1e-3, "fused f32 strays from f64")
    return dict(launches=launches, stencil=launches_p,
                problem=problem, solver=solver, args=args,
                solver_p=solver_p, args_p=args_p)


def phase_timing(problem, inp, card: str) -> list:
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk

    g1, g2 = problem.node_shape
    n = g1 * g2
    array = n * 4
    say(f"== phase 6: timing at {g1}x{g2} f32 on {card}")
    h1, h2 = problem.h1, problem.h2
    an, as_, bw, be, d, dinv = inp["coeffs"]
    never = 2**31 - 1
    partials = torch.empty(fp.scratch_len(g1, g2), device="cuda")
    scal = torch.zeros(fp.N_SCAL, device="cuda")
    scal[fp.SCAL_ZR], scal[fp.SCAL_BETA], scal[fp.SCAL_ALPHA] = 1.5, 0.7, 0.3
    flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32, device="cuda")
    pn, ap = torch.empty_like(inp["z"]), torch.empty_like(inp["z"])
    w, r, z = inp["w"].clone(), inp["r"].clone(), torch.empty_like(inp["w"])

    def stencil():
        hk.apply_a_kernel(inp["w"], inp["a"], inp["b"], h1, h2)

    def stencil_plain():
        hk.apply_a_plain(inp["w"], inp["a"], inp["b"], h1, h2)

    def k1(fn=fp.k1):
        fn(inp["z"], inp["p"], an, as_, bw, be, d, pn, ap, scal, flags,
           partials, max_iter=never, h1=h1, h2=h2)

    # delta = 0: the timed K2 launches never meet the stopping rule, so
    # each one does a whole iteration's work
    def k2(fn=fp.k2):
        fn(w, r, pn, ap, dinv, z, scal, flags, partials, max_iter=never,
           h1=h1, h2=h2, delta=0.0, weighted=True)

    rows = [
        ("stencil", "csrc/stencil.cu",
         "poisson_ellipse_tpu/ops/pallas_kernels.py:101", stencil,
         stencil_plain, 4 * array, 18 * n),
        ("fused_k1", "csrc/fused_pcg.cu",
         "poisson_ellipse_tpu/ops/fused_pcg.py:112", k1,
         lambda: k1(fp.k1_plain), 9 * array, 15 * n),
        ("fused_k2", "csrc/fused_pcg.cu",
         "poisson_ellipse_tpu/ops/fused_pcg.py:152", k2,
         lambda: k2(fp.k2_plain), 8 * array, 10 * n),
    ]
    timed = []
    for name, src, replaces, fn, plain, nbytes, flops in rows:
        ms = time_ms(fn, 200)
        plain_ms = time_ms(plain, 20)
        bound_ms, bound_by = bound(nbytes, flops)
        say(f"  {name}: {ms * 1e3:.1f} us/launch, plain {plain_ms * 1e3:.1f}"
            f" us, bound {bound_ms * 1e3:.1f} us ({bound_by}), "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        timed.append(dict(name=name, route="cuda",
                          source=f"poisson_ellipse_tpu_torch/{src}",
                          replaces=replaces, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None))
    return timed


def time_solver(solver, args, repeat: int = 3) -> float:
    times = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return sorted(times)[len(times) // 2]


def profile_solve(label: str, solver, args) -> None:
    """One solve under torch.profiler: device time by kernel name and the
    device's idle share of the solve's wall time (host clock around the
    solve and a synchronize). Prints "not measured" where the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    busy_us = sum(t for _, t in by_name.values())
    if not by_name:
        say(f"  profile {label}: device time not measured (no device events)")
        return
    say(f"  profile {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
        f"device busy {busy_us / 1e3:.2f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (count, us) in top:
        say(f"    {us / 1e3:9.2f} ms {count:7d} x {us / count:8.2f} us  "
            f"{name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card, kind = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    problem, inp = kernel_inputs(args.seed)
    errs = phase_kernels(problem, inp)
    phase_oracles()
    main_run = phase_main()
    timed = phase_timing(problem, inp, card)

    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    t_main = time_solver(main_run["solver"], main_run["args"])
    t_pallas = time_solver(main_run["solver_p"], main_run["args_p"], 1)
    solver_mid, args_mid, _ = build_solver(Problem(M=800, N=1200), "auto",
                                           torch.float32, "cuda")
    solver_mid(*args_mid)
    t_mid = time_solver(solver_mid, args_mid)
    say(f"  T_solver fused 2400x3200: {t_main:.4f} s; 800x1200: "
        f"{t_mid:.4f} s; pallas 2400x3200: {t_pallas:.4f} s ({card})")
    say(f"== phase 7: where the time goes (torch.profiler, {card})")
    profile_solve("fused 2400x3200", main_run["solver"], main_run["args"])
    profile_solve("fused 800x1200", solver_mid, args_mid)
    profile_solve("pallas 2400x3200", main_run["solver_p"],
                  main_run["args_p"])

    counts = {**main_run["launches"], **main_run["stencil"]}
    for row in timed:
        row["launches"] = counts.get(row["name"], 0)
        row["max_abs_err"] = errs[row["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": timed}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
