#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check every phase.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. device   — nvidia-smi's name and power limit, torch's device name and
              count, the card's capacity; fails without a CUDA device or
              without the port's package beside this script.
2. build    — every kernel from poisson_ellipse_tpu_torch/csrc/, one nvcc
              per source in parallel; prints ptxas's registers, shared
              memory and spills.
3. kernels  — each kernel against its plain PyTorch version on the card.
              K-a, K1, K2 and K-d at the 2401x3201 f32 shapes, inputs from
              numpy.random.default_rng(seed): arrays within rel 1e-6 /
              atol 1e-6 (bitwise expected: built with -fmad=false), sums
              within rel 1e-5 (their order differs); and a no-op check once
              the loop's flags say it has exited. The whole-solve kernels
              on capped solves, max_iter 1, 2 and 7: xl at 2401x3201,
              resident at the largest published grid its gate admits,
              streamed at 1101x1651 with dinv on chip (r-state) and with
              dinv streamed (z-state), each forced by its plan. Iterations
              and flags equal, w and the step norm within rel 1e-5 of
              their scale. K-d (the stencil fused with the pipelined
              loop's 8-pair dot bundle of 5 distinct vectors): n bitwise
              equal to K-a's and to the plain version's, sums within rel
              1e-6 (both sum in double and round once).
4. oracles  — xla in f64 on the card: exactly 17/31/61 (unweighted),
              15/26/50 (weighted) and 546; pallas, fused, resident,
              streamed and xl in f32: the exact small-grid counts, and
              546/989 within +-2 wherever the engine's gate admits the
              grid; the max_iter=5 cap reports 5, not converged.
              pipelined in f64 within +-2 of those small-grid counts,
              sstep (s = 2 and 4) in f64 exactly at them; pipelined-pallas
              and sstep-pallas (s = 4) in f32 at 546 +-2.
5. main     — 2400x3200 through build_solver(engine="auto"), which must
              resolve to xl by the card's gate: 2449 +- 2 iterations,
              l2 < 1e-3, one xl launch and one host read per solve, and two
              solves with the same bits and count. auto's engine at
              400x600, 800x1200, 1100x1650 and 1600x2400; auto at 800x1200
              (resident) and 1100x1650 (streamed) for their launches;
              fused and pallas at 2400x3200 explicitly, and
              max|w - w_xla,f64| at 800x1200 for fused and resident.
              This slice's path, 2400x3200 f32 through build_solver:
              pipelined-pallas (converged, no breakdown, l2 < 1e-3, one K-d
              launch per issued body, K-a for w0 and each residual
              replacement, one host read per 64-iteration chunk plus one);
              plain pipelined on the card within +-2 iterations of it;
              sstep-pallas with s = 4 (converged, l2 < 1e-3, within
              2*(2449//32 + 1) = 154 iterations of 2449, K-a 7 times a
              body). Launch counts are set to 0 just before each run and
              read just after it.
6. timing   — each per-iteration kernel and its plain version with CUDA
              events at 2401x3201 next to its bound; each whole-solve
              kernel's solve and its plain version's on auto's grid for it,
              per solve and per iteration, next to its bounds, the two
              whole solves held to each other as in phase 3 (their error
              joins the kernel's max_abs_err); T_solver per engine at
              400x600, 800x1200, 1100x1650 and 2400x3200; K-d against its
              82.6 us bound; T_solver of pipelined, pipelined-pallas, sstep
              and sstep-pallas (s = 4) at 400x600, 800x1200 and 2400x3200.
7. profile  — one solve of each whole-solve engine, of fused and pallas,
              and of pipelined-pallas and sstep-pallas at 2400x3200 under
              torch.profiler: device time by kernel and the device's idle
              share.

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
KD_SUM_RTOL = 1e-6  # K-d and its plain version both sum in double
ITERS_ABS = 2  # pyproject.toml [tool.bench_compare] iters-abs

UNWEIGHTED = {(10, 10): 17, (20, 20): 31, (40, 40): 61}
WEIGHTED = {(10, 10): 15, (20, 20): 26, (40, 40): 50}
LARGE = {(400, 600): 546, (800, 1200): 989}
MAIN_GRID = (2400, 3200)
MAIN_ITERS = 2449

WHOLE_SOLVE = ("resident", "streamed", "xl")
WHOLE_RTOL = 1e-5
CAPS = (1, 2, 7)
# published grids, largest first (README.md:1139-1144), and the grid
# between the resident and streamed gates
PUBLISHED = ((2400, 3200), (1600, 2400), (800, 1200), (400, 600))
STREAMED_GRID = (1100, 1650)
TIMED_GRIDS = ((400, 600), (800, 1200), (1100, 1650), (2400, 3200))
# operations per node per iteration, counted from each kernel's source,
# and the arrays one solve must read (operands, r0) and write (w)
WHOLE_FLOPS = {"resident": 24, "streamed": 25, "xl": 27}
WHOLE_ARRAYS = {"resident": 6, "streamed": 5, "xl": 5}
# the same for the per-iteration engines (K1 15 + K2 10; K-a 18 and the
# plain loop's 12 around it); the recurrence engines: the stencil (18),
# the bundle's 8 products and 8 sums (16), two D^-1 (2) and the seven
# updates (14) a pipelined iteration; per s-step iteration at s = 4 the
# 7 basis steps (20 each), the two Grams (2 * 81 * 2), V*D (9) and the
# three reconstructions (54), over 4
ITER_FLOPS = {**WHOLE_FLOPS, "fused": 25, "pallas": 30, "pipelined": 50,
              "pipelined-pallas": 50, "sstep": 132, "sstep-pallas": 132}
RECURRENCE = ("pipelined", "pipelined-pallas", "sstep", "sstep-pallas")
SSTEP_S = 4
# K-d: the stencil and the 8 pairs' products and sums, per node
KD_FLOPS = 18 + 16


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


def close_sum(name: str, got: float, want: float,
              rtol: float = SUM_RTOL) -> float:
    rel = abs(got - want) / max(abs(want), 1e-300)
    say(f"  {name}: kernel {got!r} plain {want!r} rel {rel:.3e}")
    require(math.isfinite(got) and rel <= rtol,
            f"{name} differs beyond rel {rtol}")
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
        u=dev_f32(rng.standard_normal((g1, g2))),
        s=dev_f32(rng.standard_normal((g1, g2))),
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

    say("K-d stencil + the pipelined loop's 8-pair dot bundle (full grid)")
    pairs = kd_bundle(inp)
    got_n, got_sums = hk.apply_a_dots_kernel(inp["w"], inp["a"], inp["b"],
                                             h1, h2, pairs)
    want_n, want_sums = hk.apply_a_dots_plain(inp["w"], inp["a"], inp["b"],
                                              h1, h2, pairs)
    ka = hk.apply_a_kernel(inp["w"], inp["a"], inp["b"], h1, h2)
    errs["stencil_dots"] = close_arrays("n", got_n, want_n)
    require(torch.equal(got_n, want_n) and torch.equal(got_n, ka),
            "K-d's n is not bitwise its plain version's and K-a's")
    for j in range(len(pairs)):
        close_sum(f"sum {j}", float(got_sums[j]), float(want_sums[j]),
                  KD_SUM_RTOL)
    again_n, again_sums = hk.apply_a_dots_kernel(inp["w"], inp["a"],
                                                 inp["b"], h1, h2, pairs)
    require(torch.equal(again_n, got_n) and torch.equal(again_sums, got_sums),
            "two K-d launches differ")
    say("  a second launch: the same bits")
    return errs


def kd_bundle(inp):
    """The pipelined loop's 8 pairs over (r, u, w, s, p): 5 distinct."""
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    return _bundle(inp["r"], inp["u"], inp["z"], inp["s"], inp["p"])


def _whole_runs(name, problem, cap, resident=None):
    """(kernel, plain) runs of one whole-solve engine on the card, over
    operands built once for ``problem``'s grid; each takes the Problem to
    solve (its max_iter may differ) and returns a PCGResult."""
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp

    dev = torch.device("cuda")
    if name == "resident":
        ops = rp.resident_operands(problem, torch.float32, dev)
        return (lambda pr: rp.resident(pr, *ops, cap=cap)[0],
                lambda pr: rp.resident_plain(pr, *ops)[0])
    ops = sp.streamed_operands(problem, torch.float32, dev)
    if name == "xl":
        return (lambda pr: xp.xl(pr, *ops, cap=cap)[0],
                lambda pr: xp.xl_plain(pr, *ops)[0])
    plan = sp.StreamPlan(problem, cap, resident=resident)
    return (lambda pr: sp.streamed(pr, *ops, plan=plan)[0],
            lambda pr: sp.streamed_plain(pr, *ops, zstate=plan.zstate)[0])


def close_solves(label: str, got, want) -> float:
    """A whole-solve kernel's capped solve against its plain version's:
    equal iterations and flags, w and the step norm within rel 1e-5 of
    their scale. Returns max|w_kernel - w_plain|."""
    for f in ("iters", "converged", "breakdown"):
        g, w = int(getattr(got, f)), int(getattr(want, f))
        require(g == w, f"{label}: {f} {g}, plain {w}")
    scale = float(want.w.abs().max())
    err = max_abs(got.w, want.w)
    d_k, d_p = float(got.diff), float(want.diff)
    say(f"  {label}: {int(got.iters)} iterations, max_abs_err {err:.3e} "
        f"(w scale {scale:.3e}) bitwise={torch.equal(got.w, want.w)}, "
        f"diff {d_k!r} plain {d_p!r}")
    require(err <= WHOLE_RTOL * scale,
            f"{label}: w differs beyond rel {WHOLE_RTOL} of its scale")
    require(d_k == d_p or abs(d_k - d_p) <= WHOLE_RTOL * abs(d_p),
            f"{label}: diff differs beyond rel {WHOLE_RTOL}")
    return err


def phase_whole_kernels(cap) -> dict:
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.resident_pcg import fits_resident

    say("== phase 3 (whole-solve kernels): capped solves against their "
        f"plain versions, max_iter in {CAPS}")
    admitted = [g for g in PUBLISHED
                if fits_resident(Problem(*g), torch.float32, cap)]
    require(bool(admitted), "the resident gate admits no published grid")
    cases = [
        ("xl", MAIN_GRID, None, "xl"),
        ("resident", admitted[0], None, "resident"),
        ("streamed", STREAMED_GRID, ("dinv",), "streamed r-state"),
        ("streamed", STREAMED_GRID, ("ap",), "streamed z-state"),
    ]
    errs = {}
    for name, (m, n), resident, label in cases:
        kernel, plain = _whole_runs(name, Problem(M=m, N=n), cap, resident)
        for max_iter in CAPS:
            capped = Problem(M=m, N=n, max_iter=max_iter)
            got, want = kernel(capped), plain(capped)
            torch.cuda.synchronize()
            require(int(got.iters) == max_iter,
                    f"{label}: {int(got.iters)} iterations at max_iter "
                    f"{max_iter}")
            err = close_solves(f"{label} {m}x{n} max_iter={max_iter}", got,
                               want)
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def _solve(problem, engine, dtype, sstep_s=SSTEP_S):
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    solver, args, resolved = build_solver(problem, engine, dtype, "cuda",
                                          sstep_s=sstep_s)
    result = solver(*args)
    return result, resolved, solver.host_syncs


def phase_oracles(cap) -> None:
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.resident_pcg import fits_resident
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import fits_streamed

    say("== phase 4: oracle iteration counts on the card")
    gates = {"resident": fits_resident, "streamed": fits_streamed}
    f32_engines = ("pallas", "fused") + WHOLE_SOLVE
    cases = []
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        for (m, n), want in table.items():
            for engine, dtype in (("xla", torch.float64),) + tuple(
                    (e, torch.float32) for e in f32_engines):
                cases.append((Problem(M=m, N=n, norm=norm), engine, dtype,
                              want, 0))
    cases.append((Problem(M=400, N=600), "xla", torch.float64, 546, 0))
    for (m, n), want in LARGE.items():
        for engine in f32_engines:
            gate = gates.get(engine)
            if gate is None or gate(Problem(M=m, N=n), torch.float32, cap):
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
    for norm, table in (("unweighted", UNWEIGHTED), ("weighted", WEIGHTED)):
        for (m, n), want in table.items():
            for engine, s, tol in (("pipelined", SSTEP_S, ITERS_ABS),
                                   ("sstep", 2, 0), ("sstep", 4, 0)):
                result, _, _ = _solve(Problem(M=m, N=n, norm=norm), engine,
                                      torch.float64, sstep_s=s)
                iters = int(result.iters)
                say(f"  {m}x{n} {norm} {engine}"
                    f"{f' s={s}' if engine == 'sstep' else ''} f64: "
                    f"{iters} iterations (oracle {want}"
                    f"{f' +-{tol}' if tol else ''})")
                require(bool(result.converged) and abs(iters - want) <= tol,
                        "iteration count off the oracle")
    for engine in ("pipelined-pallas", "sstep-pallas"):
        result, _, _ = _solve(Problem(M=400, N=600), engine, torch.float32,
                              sstep_s=SSTEP_S)
        iters = int(result.iters)
        say(f"  400x600 {engine} f32: {iters} iterations (oracle 546 "
            f"+-{ITERS_ABS})")
        require(bool(result.converged) and abs(iters - 546) <= ITERS_ABS,
                "iteration count off the oracle")
    for engine in WHOLE_SOLVE:
        result, _, _ = _solve(Problem(M=40, N=40, max_iter=5), engine,
                              torch.float32)
        say(f"  40x40 max_iter=5 {engine}: {int(result.iters)} iterations, "
            f"converged {bool(result.converged)}")
        require(int(result.iters) == 5 and not bool(result.converged)
                and not bool(result.breakdown), "the max_iter cap is off")


def _run_counted(solver, args):
    """One solve with the launch counts set to 0 just before it and read
    just after it."""
    from poisson_ellipse_tpu_torch.ops import _build

    _build.reset_launches()
    result = solver(*args)
    torch.cuda.synchronize()
    return result, dict(_build.LAUNCHES)


def phase_main(cap) -> dict:
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import StreamPlan
    from poisson_ellipse_tpu_torch.solver.engine import build_solver
    from poisson_ellipse_tpu_torch.solver.engine import select_engine
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    say(f"== phase 5: main path, {problem.M}x{problem.N} f32, engine auto")
    for m, n in ((400, 600), (800, 1200), STREAMED_GRID, (1600, 2400)):
        say(f"  auto at {m}x{n}: "
            f"{select_engine(Problem(M=m, N=n), torch.float32, cap)}")
    solver, args, engine = build_solver(problem, "auto", torch.float32,
                                        "cuda")
    result, launches = _run_counted(solver, args)
    iters = int(result.iters)
    l2 = float(l2_error_vs_analytic(problem, result.w))
    say(f"  engine {engine}: {iters} iterations, converged "
        f"{bool(result.converged)}, diff {float(result.diff):.3e}, "
        f"host reads {solver.host_syncs}, l2 error {l2:.6e}, "
        f"launches {launches}")
    require(engine == "xl", "auto did not resolve to xl")
    require(bool(result.converged) and abs(iters - MAIN_ITERS) <= ITERS_ABS,
            f"expected {MAIN_ITERS} +-{ITERS_ABS} iterations")
    require(tuple(result.w.shape) == problem.node_shape
            and bool(torch.isfinite(result.w).all()), "w not finite")
    require(math.isfinite(l2) and l2 < 1e-3, "l2 error out of range")
    require(launches == {"xl": 1}, "not one xl launch per solve")
    require(solver.host_syncs == 1, "not one host read per solve")
    again = solver(*args)
    same = torch.equal(again.w, result.w) and int(again.iters) == iters
    say(f"  a second solve: {int(again.iters)} iterations, bitwise "
        f"identical {same}")
    require(same, "two solves differ")
    counts = dict(launches)
    whole = {"xl": (solver, args, problem, iters)}

    for (m, n), want, oracle in (((800, 1200), "resident", LARGE[(800, 1200)]),
                                 (STREAMED_GRID, "streamed", None)):
        grid = Problem(M=m, N=n)
        s, a, e = build_solver(grid, "auto", torch.float32, "cuda")
        r, ln = _run_counted(s, a)
        it = int(r.iters)
        l2g = float(l2_error_vs_analytic(grid, r.w))
        say(f"  auto at {m}x{n} -> {e}: {it} iterations, host reads "
            f"{s.host_syncs}, l2 error {l2g:.6e}, launches {ln}"
            + (f", plan resident {StreamPlan(grid, cap).resident}"
               if e == "streamed" else ""))
        require(e == want, f"auto at {m}x{n} did not resolve to {want}")
        require(bool(r.converged) and ln == {want: 1} and s.host_syncs == 1,
                f"{want}: not one converged launch per solve")
        require(oracle is None or abs(it - oracle) <= ITERS_ABS,
                f"{want}: off the {oracle} oracle")
        require(math.isfinite(l2g) and l2g < 1e-3, "l2 error out of range")
        counts.update(ln)
        whole[want] = (s, a, grid, it)

    say(f"  fused engine, {problem.M}x{problem.N} f32")
    solver_f, args_f, _ = build_solver(problem, "fused", torch.float32,
                                       "cuda")
    result_f, launches_f = _run_counted(solver_f, args_f)
    iters_f = int(result_f.iters)
    say(f"  fused: {iters_f} iterations, host reads {solver_f.host_syncs}, "
        f"launches {launches_f}")
    require(bool(result_f.converged)
            and abs(iters_f - MAIN_ITERS) <= ITERS_ABS,
            f"fused: expected {MAIN_ITERS} +-{ITERS_ABS} iterations")
    for k in ("fused_k1", "fused_k2"):
        require(launches_f.get(k, 0) >= iters_f, f"{k} launched fewer times "
                "than iterations")
    require(solver_f.host_syncs <= iters_f // 64 + 2, "more host reads than "
            "one per chunk")
    counts.update(launches_f)

    say(f"  pallas engine, {problem.M}x{problem.N} f32")
    solver_p, args_p, _ = build_solver(problem, "pallas", torch.float32,
                                       "cuda")
    result_p, launches_p = _run_counted(solver_p, args_p)
    iters_p = int(result_p.iters)
    say(f"  pallas: {iters_p} iterations, host reads {solver_p.host_syncs}, "
        f"launches {launches_p}")
    require(bool(result_p.converged)
            and abs(iters_p - MAIN_ITERS) <= ITERS_ABS,
            f"pallas: expected {MAIN_ITERS} +-{ITERS_ABS} iterations")
    require(launches_p.get("stencil", 0) >= iters_p, "stencil launched "
            "fewer times than iterations")
    counts.update(launches_p)

    mid = Problem(M=800, N=1200)
    w64, _, _ = _solve(mid, "xla", torch.float64)
    for engine in ("fused", "resident"):
        w32, _, _ = _solve(mid, engine, torch.float32)
        gap = max_abs(w32.w, w64.w)
        say(f"  max|w_{engine},f32 - w_xla,f64| at 800x1200: {gap:.3e}")
        require(math.isfinite(gap) and gap < 1e-3,
                f"{engine} f32 strays from f64")
    return dict(counts=counts, whole=whole, problem=problem,
                solver_f=solver_f, args_f=args_f,
                solver_p=solver_p, args_p=args_p)


def expected_pipelined_launches(iters: int, chunk: int = 64) -> dict:
    """K-d and K-a launches of a pipelined-pallas solve that took
    ``iters`` iterations with the host reading once per ``chunk``: every
    issued body launches K-d once (bodies past the exit too), K-a runs for
    w0 and in each issued body whose iteration is a positive multiple of
    REPLACE_EVERY (four rebuild stencils)."""
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import REPLACE_EVERY

    bodies = chunk * -(-iters // chunk)
    rebuilds = (bodies - 1) // REPLACE_EVERY
    return {"stencil_dots": bodies, "stencil": 1 + 4 * rebuilds}


def phase_recurrence(cap) -> dict:
    """This slice's path at 2400x3200 f32: pipelined-pallas, then plain
    pipelined on the card, then sstep-pallas (s = 4)."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.sstep_pcg import replaces
    from poisson_ellipse_tpu_torch.solver.engine import build_solver
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    say(f"== phase 5 (this slice): pipelined and s-step at "
        f"{problem.M}x{problem.N} f32")
    runs, counts = {}, {}
    for engine in ("pipelined-pallas", "pipelined", "sstep-pallas"):
        solver, args, resolved = build_solver(problem, engine, torch.float32,
                                              "cuda", sstep_s=SSTEP_S)
        require(resolved == engine, f"{engine} resolved to {resolved}")
        t0 = time.perf_counter()
        result, launches = _run_counted(solver, args)
        wall = time.perf_counter() - t0
        iters = int(result.iters)
        l2 = float(l2_error_vs_analytic(problem, result.w))
        say(f"  {engine}: {iters} iterations, converged "
            f"{bool(result.converged)}, breakdown {bool(result.breakdown)}, "
            f"diff {float(result.diff):.3e}, l2 error {l2:.6e}, host reads "
            f"{solver.host_syncs}, launches {launches}, {wall:.3f} s")
        require(bool(result.converged) and not bool(result.breakdown),
                f"{engine} did not converge")
        require(tuple(result.w.shape) == problem.node_shape
                and bool(torch.isfinite(result.w).all()), "w not finite")
        require(math.isfinite(l2) and l2 < 1e-3, "l2 error out of range")
        require(solver.host_syncs == -(-iters // 64) + 1,
                "not one host read per 64-iteration chunk plus one")
        runs[engine] = (solver, args, iters)
        if engine == "pipelined-pallas":
            want = expected_pipelined_launches(iters)
            require(launches == want, f"pipelined-pallas launches {launches},"
                    f" expected {want}")
        elif engine == "pipelined":
            ref = runs["pipelined-pallas"][2]
            require(launches == {}, "plain pipelined launched a kernel")
            require(abs(iters - ref) <= ITERS_ABS, f"pipelined {iters} vs "
                    f"pipelined-pallas {ref}: more than +-{ITERS_ABS} apart")
        else:
            band = 2 * (MAIN_ITERS // 32 + 1)
            require(abs(iters - MAIN_ITERS) <= band,
                    f"sstep-pallas {iters} iterations: outside {MAIN_ITERS} "
                    f"+-{band}")
            bodies = [64 * c + SSTEP_S * j for c in range(-(-iters // 64))
                      for j in range(64 // SSTEP_S)]
            want = (2 * SSTEP_S - 1) * len(bodies) + sum(
                replaces(k, SSTEP_S) for k in bodies)
            require(launches == {"stencil": want},
                    f"sstep-pallas launches {launches}, expected "
                    f"{{'stencil': {want}}}")
        for k, v in launches.items():
            counts.setdefault(k, v)
    return dict(runs=runs, counts=counts, problem=problem)


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

    pairs = kd_bundle(inp)

    def stencil_dots(fn=hk.apply_a_dots_kernel):
        fn(inp["w"], inp["a"], inp["b"], h1, h2, pairs)

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
        # reads w, a, b and the bundle's 5 distinct vectors, writes n
        ("stencil_dots", "csrc/stencil_dots.cu",
         "poisson_ellipse_tpu/ops/pallas_kernels.py:196", stencil_dots,
         lambda: stencil_dots(hk.apply_a_dots_plain), 9 * array,
         KD_FLOPS * n),
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


def time_plain(name, args, problem, cap):
    """(seconds, result) of one solve by a whole-solve kernel's plain
    version on the card, on the operands its kernel is timed on (the
    streamed one in the regime of the kernel's plan)."""
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp

    plain = {"resident": lambda: rp.resident_plain(problem, *args),
             "streamed": lambda: sp.streamed_plain(
                 problem, *args, zstate=sp.StreamPlan(problem, cap).zstate),
             "xl": lambda: xp.xl_plain(problem, *args)}[name]
    out = []
    seconds = time_solver(lambda: out.append(plain()[0]), (), 1)
    return seconds, out[-1]


def phase_whole_timing(main_run, cap, card: str, errs: dict) -> list:
    """Each whole-solve kernel's solve on auto's grid for it, next to its
    plain version's and its bounds: per solve (each input read once, w
    written once; the operations the iterations take) and per iteration
    (the engine's pass model against its operations). The timed plain
    solve is also held against the kernel's whole solve (as in phase 3,
    at the main path's iteration count), and its error joins ``errs``."""
    from poisson_ellipse_tpu_torch.harness.roofline import passes_per_iter

    say(f"== phase 6 (whole-solve kernels): one launch per solve, on {card}")
    replaces = {
        "resident": "poisson_ellipse_tpu/ops/resident_pcg.py:234",
        "streamed": "poisson_ellipse_tpu/ops/streamed_pcg.py:632",
        "xl": "poisson_ellipse_tpu/ops/xl_pcg.py:451",
    }
    rows = []
    for name in WHOLE_SOLVE:
        solver, args, problem, iters = main_run["whole"][name]
        g1, g2 = problem.node_shape
        n = g1 * g2
        ms = time_solver(solver, args) * 1e3
        plain_s, want = time_plain(name, args, problem, cap)
        plain_ms = plain_s * 1e3
        err = close_solves(f"{name} {g1}x{g2} whole solve", solver(*args),
                           want)
        errs[name] = max(errs[name], err)
        bound_ms, bound_by = bound(WHOLE_ARRAYS[name] * n * 4,
                                   iters * WHOLE_FLOPS[name] * n)
        passes = passes_per_iter(name, problem, cap)
        iter_ms, iter_by = bound(passes * n * 4, WHOLE_FLOPS[name] * n)
        us_per_iter = ms * 1e3 / iters
        say(f"  {name} {g1}x{g2}: {ms:.3f} ms per solve, {iters} iterations, "
            f"{us_per_iter:.2f} us/iter; plain {plain_ms:.1f} ms; bound "
            f"{bound_ms:.3f} ms per solve ({bound_by}), "
            f"{iter_ms * 1e3:.2f} us/iter ({passes:g} passes, {iter_by})")
        rows.append(dict(name=name, route="cuda",
                         source=f"poisson_ellipse_tpu_torch/csrc/{name}_pcg.cu",
                         replaces=replaces[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, us_per_iter=us_per_iter,
                         bound_us_per_iter=iter_ms * 1e3, iters=iters,
                         grid=[g1, g2]))
    return rows


def phase_solver_times(cap, card: str) -> None:
    """T_solver per engine at the timed grids: each whole-solve engine
    wherever its gate admits the grid, fused and pallas everywhere."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops.resident_pcg import fits_resident
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import fits_streamed
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    from poisson_ellipse_tpu_torch.harness.roofline import passes_per_iter

    say(f"== phase 6 (T_solver per engine, median of 3, pallas 1; {card})")
    gates = {"resident": fits_resident, "streamed": fits_streamed}
    for m, n in TIMED_GRIDS:
        problem = Problem(M=m, N=n)
        nodes = (m + 1) * (n + 1)
        for engine in WHOLE_SOLVE + ("fused", "pallas"):
            gate = gates.get(engine)
            if gate is not None and not gate(problem, torch.float32, cap):
                continue
            solver, args, _ = build_solver(problem, engine, torch.float32,
                                           "cuda")
            iters = int(solver(*args).iters)
            t = time_solver(solver, args, 1 if engine == "pallas" else 3)
            passes = passes_per_iter(engine, problem, cap)
            iter_ms, iter_by = bound(passes * nodes * 4,
                                     ITER_FLOPS[engine] * nodes)
            say(f"  T_solver {m}x{n} {engine}: {t:.5f} s, {iters} iterations, "
                f"{t / iters * 1e6:.2f} us/iter, bound {iter_ms * 1e3:.2f} "
                f"us/iter ({passes:g} passes, {iter_by})")


def phase_recurrence_times(rec, card: str) -> None:
    """T_solver of the recurrence engines: one timed solve each at 400x600
    and 800x1200 (after a warm-up solve) and at 2400x3200 (on phase 5's
    solvers, already warm)."""
    from poisson_ellipse_tpu_torch.harness.roofline import passes_per_iter
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    say(f"== phase 6 (T_solver, recurrence engines, s = {SSTEP_S}; {card})")
    for m, n in ((400, 600), (800, 1200), MAIN_GRID):
        problem = Problem(M=m, N=n)
        nodes = (m + 1) * (n + 1)
        for engine in RECURRENCE:
            if (m, n) == MAIN_GRID and engine in rec["runs"]:
                solver, args, _ = rec["runs"][engine]
            else:
                solver, args, _ = build_solver(problem, engine, torch.float32,
                                               "cuda", sstep_s=SSTEP_S)
                if (m, n) != MAIN_GRID:
                    solver(*args)
            out = []
            t = time_solver(lambda: out.append(solver(*args)), (), 1)
            iters = int(out[-1].iters)
            passes = passes_per_iter(engine, problem, sstep_s=SSTEP_S)
            iter_ms, iter_by = bound(passes * nodes * 4,
                                     ITER_FLOPS[engine] * nodes)
            say(f"  T_solver {m}x{n} {engine}: {t:.5f} s, {iters} "
                f"iterations, {t / iters * 1e6:.2f} us/iter, bound "
                f"{iter_ms * 1e3:.2f} us/iter ({passes:g} passes, {iter_by})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card, kind = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    from poisson_ellipse_tpu_torch.utils.device import capacity

    cap = capacity(0)
    say(f"capacity: {cap}, cooperative launch "
        f"{cap.cooperative_launch('xl_pcg')}")
    problem, inp = kernel_inputs(args.seed)
    errs = phase_kernels(problem, inp)
    errs.update(phase_whole_kernels(cap))
    phase_oracles(cap)
    main_run = phase_main(cap)
    rec = phase_recurrence(cap)
    timed = phase_timing(problem, inp, card)
    timed += phase_whole_timing(main_run, cap, card, errs)
    # the kernels in the order they were ported, this slice's last
    timed.sort(key=lambda row: row["name"] == "stencil_dots")
    phase_solver_times(cap, card)
    phase_recurrence_times(rec, card)

    say(f"== phase 7: where the time goes (torch.profiler, {card})")
    for name in WHOLE_SOLVE:
        solver, solver_args, grid, _ = main_run["whole"][name]
        profile_solve(f"{name} {grid.M}x{grid.N}", solver, solver_args)
    profile_solve("fused 2400x3200", main_run["solver_f"], main_run["args_f"])
    profile_solve("pallas 2400x3200", main_run["solver_p"],
                  main_run["args_p"])
    for engine in ("pipelined-pallas", "sstep-pallas"):
        solver, solver_args, _ = rec["runs"][engine]
        profile_solve(f"{engine} 2400x3200", solver, solver_args)

    counts = {**rec["counts"], **main_run["counts"]}
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
