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
              atol 1e-6 (bitwise expected: built with -fmad=false); K-a
              and K-d's n also bitwise on w = +0, w = -0 and a seeded
              ellipse with a signed-zero exterior; sums
              within rel 1e-5 (their order differs); and a no-op check once
              the loop's flags say it has exited. The whole-solve kernels
              on capped solves, max_iter 1, 2 and 7: xl at 2401x3201,
              resident at the largest published grid its gate admits,
              streamed at 1101x1651 with dinv on chip (r-state) and with
              dinv streamed (z-state), each forced by its plan. Iterations
              and flags equal, w and the step norm within rel 1e-5 of
              their scale. resident and streamed in both regimes also at
              the march's edge grids (MARCH_EDGES: spans of one node and
              empty blocks at 11x11, one whole row a block at 132x201, 66
              strips of one step at 131x2101, where resident keeps ap in
              device memory), w bitwise. K-d (the stencil fused with the pipelined
              loop's 8-pair dot bundle of 5 distinct vectors): n bitwise
              equal to K-a's and to the plain version's, sums within rel
              1e-6 (both sum in double and round once), the bundle with
              each pair swapped (the generic instantiation) the same bits
              as the bundle (compiled in); one device activity a call for K-d f32 and
              bf16, K-h bf16 and f16 and K-f (torch.profiler, in a fresh
              process).
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
7. profile  — one solve of each whole-solve engine and of fused, and of
              pallas, pipelined-pallas and sstep-pallas capped at 256
              iterations, at 2400x3200 under torch.profiler: device time by
              kernel and the device's idle share.
8. batched  — the lane-batched path. K-e and K-f lane by lane against K-a
              and K-d on that lane (bitwise) and against their plain
              versions (arrays bitwise, K-f's sums within rel 1e-6; K-e
              also on +0, -0 and signed-zero-exterior lanes), at
              44x132 with B = 3, 400x600 with B = 32, 800x1200 with B = 8
              and 2400x3200 with B = 2; K-f's generic instantiation (each
              pair swapped) the same bits as the bundle's. The harness entry
              point (`--lanes 32 --engine batched-pallas` at 400x600,
              `--lanes 8` at 800x1200): every lane 546 / 989 +-2, lane 0's
              l2 < 1e-3, K-e launched 64*ceil(n/64) times a solve. batched,
              batched-pipelined and batched-pipelined-pallas at the same
              lanes (pipelined within +-2 of the classical lane), their
              launches as the body count predicts. One lane NaN-poisoned at
              iteration 10 through advance(limit=10): quarantined at 11, one
              lane-quarantine event, the healthy lanes bitwise a clean
              batch's. Then K-e and K-f timed against their bounds, solves/s
              of batched-pallas and batched at 400x600 and 800x1200 for
              lanes 1, 8 and 32, of batched-pipelined-pallas at 32 lanes,
              beside B sequential auto (resident) solves, and one
              torch.profiler breakdown of batched-pallas at 400x600, B = 32.
              Whether lane 0 is bitwise the single pallas / xla solve is
              printed, not required.
9. storage  — the storage axis (state and operands stored in bf16 or f16,
              f32 arithmetic). K-g (the mixed stencil) at 45x133, 801x1201
              and 2401x3201 with w bf16 or f32 and a, b bf16, and with w,
              a, b f16 (numpy-seeded inputs, inside f16's range): bitwise
              its plain version and K-a on the upcast inputs. K-h (the
              mixed stencil + the pipelined bundle of 5 distinct bf16
              operands): n bitwise its plain version's, K-g's and K-d's on
              the upcast inputs, sums within rel 1e-6 of the plain
              version's and bitwise K-d's, the generic instantiation (each
              pair swapped) the same bits. The main path: run_once(pallas,
              storage_dtype="bf16") at 2400x3200, uncapped: converged, the
              report's "storage_dtype" "bf16", K-g once per issued body,
              one host read per 64-iteration chunk plus one; xla bf16 on
              the card with pallas's iterations and flags (w's gap
              printed), the relative gap to the f32 solve printed, the
              count printed beside the JAX package's 3032 (CPU). The
              recurrences at 2400x3200, bf16, max_iter 1024:
              pipelined-pallas and sstep-pallas (s = 4) finite, chunk 64
              bitwise one straight run, launches as the body count
              predicts (K-a for w0, K-h once a body and K-g 4 times every
              8th body; K-g 7 times a block plus the replacements); the
              plain pipelined and sstep counts and x gaps printed. 400x600
              and 800x1200 pallas bf16 converged (counts printed beside the
              JAX package's 560 and 1053); f16 at 44x132 and 400x600:
              pallas with xla's iterations and flags. K-g and K-h timed
              against their bounds, plain versions and K-a / K-d at f32;
              T_solver of pallas bf16 beside f32 at 400x600, 800x1200 and
              2400x3200; the capped recurrences' time per iteration in bf16
              beside f32; one torch.profiler breakdown of pallas bf16 at
              2400x3200, capped at 256 iterations.

10. dtypes  — bf16 compute and the narrow operand streams. Every new
              form against its plain version on capped solves (max_iter 1,
              2, 7; iterations and flags equal, w and the step norm bitwise
              or within rel 1e-5 of their scale, NaN in the same places):
              xl bf16 at 2401x3201, streamed bf16 at the first published
              grid between the bf16 gates (1601x2401), resident bf16 at the
              largest published grid its bf16 gate admits (801x1201); xl and
              streamed (both regimes) with f32 compute and bf16 or f16
              operand streams at 2401x3201 / 1101x1651, on the real operands
              and on numpy-seeded finite ones (the real f16 operands
              overflow); K-b / K-c bf16 on seeded inputs at 2401x3201. The
              main path: build_solver(engine="auto", bf16) capped at 8192 at
              400x600, 800x1200, 1100x1650, 1600x2400 and 2400x3200: the
              engine select_engine names, one launch and one host read, w
              finite, counts and l2 printed beside the bf16 xla loop's on
              the card (held below 3e-2 at 400x600, the JAX package's
              1.55e-2 there); fused bf16 at 400x600 and 2400x3200; xl and
              streamed with bf16 operand streams at 2400x3200 / 1100x1650,
              converged, l2 < 1e-3, counts beside f32's; f16 streams at
              400x600 (NaN, as in the JAX package). Timing, capped at 256
              iterations, in turns: xl at 2400x3200 and streamed at
              1100x1650 in f32, bf16, f32 + bf16 and f32 + f16 streams,
              resident at 800x1200 in f32 and bf16, against their pass
              bounds; K-b / K-c bf16 against f32 per launch.

11. mesh     — the sharded path (--mode sharded), its ranks processes of a
              torch.distributed group. K1-shard and K2-shard against their
              plain versions on numpy-seeded inputs at one rank's block of
              2401x3201 on 2x2 (1201x1601 and its halo) and at the uneven
              7x5 block of 13x17 on 2x4: arrays bitwise, the rank's sums
              (per-block partials added in double) equal once rounded to
              f32, their double gap printed; both do nothing once the flags
              say the loop has exited. The harness entry point (run_once,
              as the command line runs it in every rank; each run's counts
              set to 0 just before its timed solve and read just after):
              fused on a 1x1 mesh over NCCL at 2400x3200 (2449 +- 2, l2 <
              1e-3); on 2x2, four ranks sharing the card over gloo, fused
              and xla at 400x600 and 800x1200 (546 / 989 +- 2), fused at
              2400x3200 (2449 +- 2), pallas at 400x600 (546 +- 2); the
              command line with --mesh 1 2 --dtype f64 at 40x40 (exactly
              50). On every rank: K1-shard and K2-shard (K-a for pallas)
              once per issued body, 1 halo exchange and 2 reductions per
              body, the report's mesh and backend. Then K1-shard and
              K2-shard timed with CUDA events at the 1201x1601 block
              against their bounds and plain versions, and T_solver of each
              sharded run.

12. stage 4 — the last four TPU kernels and bf16 on the kernel loops.
              The stage-4 kernels (csrc/stage4.cu: dinv, dot, update_w_r,
              update_p) against their plain versions at 2401x3201 in f32
              and f64 on numpy-seeded inputs, D a tenth zeros: arrays
              bitwise, dot and dw2 within rel 1e-6 (f32) / 1e-12 (f64), two
              launches the same bits; dot and update_p also at 1x1, 3x5,
              401x601 and on views one element past an aligned buffer
              (in one alignment class and in two), one device kernel a
              call (torch.profiler, in a fresh process), and a launch
              captured in a CUDA graph
              (with and without a first call on the capture stream) equal
              to the eager one. K-a's and K-d's bf16 forms against
              their plain versions at 2401x3201 on the bf16 operands: arrays
              and sums bitwise (K-a also on +0, -0 and a signed-zero
              exterior). The reference's stage-4 iteration composed
              from K-a and the four (a host read an iteration, not an
              engine) at 400x600: f32 546 +- 2, l2 < 1e-3, each kernel's
              launches as the count predicts (read just after the run); f64
              (the plain stencil: K-a has no f64 form) exactly the f64 xla
              count. bf16 pallas at 400x600 through build_solver: converged,
              l2 < 3e-2, K-a bf16 once a body, its count beside bf16 xla's
              on the card; pallas, pipelined-pallas and sstep-pallas at
              2400x3200 in bf16 and f32, capped at 256: bf16 launches as
              the body count predicts (K-d bf16 once a body, K-a bf16 for
              w0, the rebuilds every 8 and the basis), us an iteration
              beside f32's. Then the six kernels timed beside their
              bounds and plain versions; each stage-4 kernel, and
              torch.dot and torch.add(alpha=) beside dot and update_p,
              three ways on 3 rotated input sets: device time (calls
              captured in a CUDA graph, replays timed with CUDA events),
              call time (CUDA events around eager calls) and host time
              (the host clock around those calls, before the sync).

`--only stage4` runs phases 1-2 and then phase 12's stage-4 checks, loop
and timing alone; `--only stage4-timing` the timing alone (it also runs
from the root of an older tree, to compare two trees' kernels in one
call). `--only stencil-dots-timing` runs phases 1-2 and then rule 2's
queue by device time: K-d f32 and bf16 and K-h bf16 and f16 on the
pipelined bundle at 2401x3201, K-f at 401x601 with B = 32, K-g, K-a, K1
and K2 at 2401x3201, K-d f32 at 401x601, each three ways as phase 12 times the stage-4 kernels,
with its device activities a call, its share of its bound and its loss on
its path; the SASS instruction counts of the K-d and K-a libraries
(`--sass-dir` writes the listings); and pipelined-pallas at 400x600 and
2400x3200 f32 and with bf16 storage capped at 1024, us an iteration and
launches a body. It too runs on an older tree's kernels. `--only
xl-timing` runs phases 1-2 and then: xl at 2400x3200 in its four forms,
capped at 256 bodies in turns, and T_solver of xl beside fused; xl's body
split by phase on the device clock (the kernel's timing instantiation:
stencil phase, first barrier with its sums, update phase, second barrier
with its sum, and the spread of the blocks' stencil-phase ends by the
blocks their SM holds) with xl's SASS; one grid barrier alone, with
grid_reduce, grid_reduce2 and grid_reduce_wide, at xl's, resident's and
streamed's grids; K-g's four type pairs at 2401x3201, pad 1 and pad 0,
bitwise their plain versions and timed three ways, with the stencil
library's SASS; K-a, K-g and K-d a launch inside pallas (f32, bf16
storage) and pipelined-pallas capped at 256 beside their graph replay, on
the loop's own data and on w = 0, the SM clock under each, and pallas with
bf16 storage us an iteration. What an older tree lacks (the timing
instantiation, the barrier kernel) prints as not measured. `--only
stencil-timing` runs phases 1-2 and then the plain-stencil family by
input data: K-a f32 and bf16 at 2401x3201, pad 1 and pad 0, and K-e at
401x601, B = 32 and 801x1201, B = 8, each on seeded values, on the loop's
own data and on w = 0, bitwise its plain version and timed three ways;
each a launch inside its loops (K-a in pallas and sstep-pallas, K-a bf16
in pallas bf16, K-e in batched-pallas, capped at 256); K-g's four forms;
K-d on seeded values, on m = 0 and inside pipelined-pallas; K1-shard on
a rank's 1201x1601 block, seeded and with the loop's zero exterior, and
K2-shard by device time; the stencil, K-d and K1-shard libraries' SASS.
It too runs on an older tree's kernels. `--only whole-timing` runs phases
1-2 and then resident and streamed by phase (WHOLE_SPLITS: resident f32
at 401x601 and 801x1201 and bf16 at 1101x1651; streamed f32 at 801x1201
with every operand on chip and at 1101x1651 planned (z-state) and with
dinv forced on chip (r-state), bf16 at 1601x2401, f32_bf16 and f32_f16
at 1101x1651): us an iteration capped at 256, T_solver (f32 uncapped,
the other forms capped at 8192), a solve of one iteration, the body split
on the device clock by the kernels' timing instantiation (pn pass,
stencil phase, first sum with its barrier, update phase, second sums with
their barrier, the spread of the blocks' phase ends), xl at the same grid
and form, and the two libraries' SASS. It too runs on an older tree's
kernels (the split prints as not measured where the tree lacks it). Each
prints the kernels' record and no result line.

The last three lines are nvidia-smi's card name and power limit, the
kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import statistics
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
# the march's edge grids (csrc/grid_sync.cuh march_split), held bitwise in
# phase 3: 121 nodes over 132 blocks, one whole row a block, and 66 strips
# of one step (resident's ap in device memory)
MARCH_EDGES = ((10, 10), (131, 200), (130, 2100))
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


_START = time.perf_counter()


def mark(done: str) -> None:
    """The script's elapsed time after a phase."""
    say(f"[{done} done at {time.perf_counter() - _START:.1f} s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x.double() - y.double()).abs().max())


_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.dtype == y.dtype and torch.equal(x.view(_INT_VIEW[x.dtype]),
                                              y.view(_INT_VIEW[y.dtype]))


def signed_zero_inputs(like: torch.Tensor, seed: int) -> dict:
    """Iterates shaped and typed as ``like`` on which a stencil's dividends
    are zero: all +0.0, all -0.0, and a numpy-seeded field inside the
    ellipse x^2 + 4y^2 < 1 of the node grid on [-1, 1] x [-0.6, 0.6] with a
    random mix of +0.0 and -0.0 outside it (the solver's state outside the
    ellipse is exactly zero)."""
    shape = tuple(like.shape)
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, shape[-2])[:, None]
    y = np.linspace(-0.6, 0.6, shape[-1])[None, :]
    inside = np.broadcast_to(x * x + 4 * y * y < 1, shape)
    mixed = np.where(inside, rng.standard_normal(shape),
                     np.where(rng.random(shape) < 0.5, -0.0, 0.0))
    return {"w = +0": torch.zeros_like(like),
            "w = -0": torch.full_like(like, -0.0),
            "zero exterior, signed zeros": torch.from_numpy(mixed).to(
                like.device, like.dtype)}


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


def call_times(calls, n: int, warmup: int = 3) -> tuple[float, float]:
    """(call ms, host ms) per call: ``time_ms``'s CUDA events around n
    calls that rotate over ``calls`` (one closure per input set), and
    the host clock around the same n calls, read before the sync. The
    call time is the device's pace of a loop of calls: the host's when
    its work outlasts the kernel's."""
    for fn in calls[:warmup]:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(n):
        calls[i % len(calls)]()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, host * 1e3 / n


def device_ms(calls, n: int = 96, replays: int = 5) -> float:
    """Device milliseconds per call: n calls rotating over ``calls``
    captured in one CUDA graph on a stream of its own (warmed up there
    first), and ``replays`` replays timed with CUDA events after one
    untimed replay. A replay runs no host code, so this is the kernels'
    time alone; the rotation (input sets larger than L2 together) makes
    each launch read HBM."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in calls:
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * replays)
    del graph
    return ms


def device_activities(fn, attempts: int = 3) -> int:
    """Device activities (kernels, fills, copies) one call of ``fn``
    issues, counted by torch.profiler after a warm-up call. A profile
    that records no device activity at all (a call always issues one; a
    test run of many profiles met one such empty profile) is taken again,
    up to ``attempts`` profiles; -1 if every one was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return -1


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
    for kind, w0 in signed_zero_inputs(inp["w"], seed=1).items():
        for label, kernel, plain in (
                ("full grid", hk.apply_a_kernel, hk.apply_a_plain),
                ("block", hk.apply_a_block_kernel, hk.apply_a_block_plain)):
            require(same_bits(kernel(w0, inp["a"], inp["b"], h1, h2),
                              plain(w0, inp["a"], inp["b"], h1, h2)),
                    f"K-a {label} on {kind}: not bitwise its plain version")
        say(f"  K-a on {kind}: bitwise its plain version (full grid and "
            "block)")

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
    gen_n, gen_sums = hk.apply_a_dots_kernel(inp["w"], inp["a"], inp["b"],
                                             h1, h2, swapped(pairs))
    require(same_bits(gen_n, got_n) and same_bits(gen_sums, got_sums),
            "K-d's generic instantiation differs from the bundle's")
    say("  the generic instantiation (each pair swapped): the same bits")
    for kind, m0 in signed_zero_inputs(inp["w"], seed=4).items():
        n0, _ = hk.apply_a_dots_kernel(m0, inp["a"], inp["b"], h1, h2, pairs)
        require(same_bits(n0, hk.apply_a_dots_plain(m0, inp["a"], inp["b"],
                                                     h1, h2, pairs)[0])
                and same_bits(n0, hk.apply_a_kernel(m0, inp["a"], inp["b"],
                                                    h1, h2)),
                f"K-d's n on {kind}: not bitwise its plain version's and "
                "K-a's")
    say("  n on +0, -0 and a signed-zero exterior: bitwise its plain "
        "version's and K-a's")
    for label, acts in child_activities("count_kd_activities").items():
        say(f"  {label}: {acts} device activities a call (a fresh process)")
        require(acts == 1, f"{label}: {acts} device activities a call, not "
                "one kernel")
    return errs


def kd_bundle(inp):
    """The pipelined loop's 8 pairs over (r, u, w, s, p): 5 distinct."""
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    return _bundle(inp["r"], inp["u"], inp["z"], inp["s"], inp["p"])


def swapped(pairs):
    """``pairs`` with each pair's two operands swapped: the same products
    (f32 multiplication commutes) in the same order under another table,
    which the K-d family runs through its generic instantiation; the
    bundle's own table runs compiled in."""
    return tuple((y, x) for x, y in pairs)


def _whole_runs(name, problem, cap, resident=None, dtype=torch.float32,
                storage=None, operands=None):
    """(kernel, plain) runs of one whole-solve engine on the card, in its
    form at ``dtype`` with operands streamed at ``storage``, over operands
    built once for ``problem``'s grid (or ``operands``); each takes the
    Problem to solve (its max_iter may differ) and returns a PCGResult."""
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp

    dev = torch.device("cuda")
    if name == "resident":
        ops = rp.resident_operands(problem, dtype, dev)
        return (lambda pr: rp.resident(pr, *ops, cap=cap)[0],
                lambda pr: rp.resident_plain(pr, *ops)[0])
    ops = operands or sp.streamed_operands(problem, dtype, dev, storage)
    if name == "xl":
        return (lambda pr: xp.xl(pr, *ops, cap=cap)[0],
                lambda pr: xp.xl_plain(pr, *ops)[0])
    plan = sp.StreamPlan(problem, cap, dtype, resident=resident)
    return (lambda pr: sp.streamed(pr, *ops, plan=plan)[0],
            lambda pr: sp.streamed_plain(pr, *ops, zstate=plan.zstate)[0])


def close_solves(label: str, got, want) -> float:
    """A whole-solve kernel's capped solve against its plain version's:
    equal iterations and flags, w and the step norm within rel 1e-5 of
    their scale; a solve that overflowed (f16 operand streams) NaN in the
    same places and the same elsewhere. Returns max|w_kernel - w_plain|
    over the finite nodes."""
    for f in ("iters", "converged", "breakdown"):
        g, w = int(getattr(got, f)), int(getattr(want, f))
        require(g == w, f"{label}: {f} {g}, plain {w}")
    nan = torch.isnan(want.w)
    require(torch.equal(torch.isnan(got.w), nan),
            f"{label}: NaN in other places than the plain version's")
    w_k, w_p = (x.w.double().masked_fill(nan, 0.0) for x in (got, want))
    scale = float(w_p.abs().max())
    err = float((w_k - w_p).abs().max())
    d_k, d_p = float(got.diff), float(want.diff)
    say(f"  {label}: {int(got.iters)} iterations, max_abs_err {err:.3e} "
        f"(w scale {scale:.3e}"
        + (f", {int(nan.sum())} NaN nodes in both" if bool(nan.any()) else "")
        + f") bitwise={torch.equal(w_k, w_p)}, diff {d_k!r} plain {d_p!r}")
    require(err <= WHOLE_RTOL * scale,
            f"{label}: w differs beyond rel {WHOLE_RTOL} of its scale")
    require(d_k == d_p or abs(d_k - d_p) <= WHOLE_RTOL * abs(d_p)
            or (math.isnan(d_k) and math.isnan(d_p)),
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
    # the march's edges, held bitwise: spans of one node and empty blocks,
    # one whole row a block, and a split whose warps outgrow the registers
    # (resident's ap in device memory)
    for m, n in MARCH_EDGES:
        cases += [("resident", (m, n), None, "resident"),
                  ("streamed", (m, n), None, "streamed r-state"),
                  ("streamed", (m, n), ("ap",), "streamed z-state")]
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
            if (m, n) in MARCH_EDGES:
                require(same_bits(got.w, want.w),
                        f"{label} {m}x{n} max_iter={max_iter}: w is not "
                        "its plain version's bitwise")
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
                solver_f=solver_f, args_f=args_f)


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


def profile_solve(label: str, solver, args) -> dict:
    """One solve under torch.profiler: device time by kernel name and the
    device's idle share of the solve's wall time (host clock around the
    solve and a synchronize). Prints "not measured" where the profiler
    records no device activity. Returns {kernel name: [launches, us]}."""
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
        return by_name
    say(f"  profile {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
        f"device busy {busy_us / 1e3:.2f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (count, us) in top:
        say(f"    {us / 1e3:9.2f} ms {count:7d} x {us / count:8.2f} us  "
            f"{name[:90]}")
    return by_name


# iterations of the profiled solves of the per-iteration kernel engines:
# the per-body breakdown, without a whole solve's events (sorting those
# took minutes)
PROFILE_CAP = 256


def profile_capped(engine: str, **options) -> dict:
    """``profile_solve`` of ``engine`` at 2400x3200, capped at PROFILE_CAP
    iterations, after one warm-up solve; returns its table."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=PROFILE_CAP)
    solver, args, _ = build_solver(problem, engine, torch.float32, "cuda",
                                   **options)
    solver(*args)
    extra = "".join(f" {k}={v}" for k, v in options.items())
    return profile_solve(f"{engine}{extra} 2400x3200, capped at "
                         f"{PROFILE_CAP}", solver, args)


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


def timed_recurrence(problem, engine: str, warm=None, storage=None,
                     repeat: int = 1):
    """(result, seconds, launches) of a recurrence engine at ``problem`` in
    f32: its solver built and warmed by one counted solve (``launches``,
    set to 0 just before it), or ``warm``'s (solver, args), already warm
    (``launches`` None); then the median of ``repeat`` timed solves, the
    last of whose results is returned."""
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    launches = None
    if warm is None:
        solver, args, _ = build_solver(problem, engine, torch.float32, "cuda",
                                       sstep_s=SSTEP_S, storage_dtype=storage)
        _, launches = _run_counted(solver, args)
    else:
        solver, args = warm
    out = []
    t = time_solver(lambda: out.append(solver(*args)), (), repeat)
    return out[-1], t, launches


def phase_recurrence_times(rec, card: str) -> None:
    """T_solver of the recurrence engines: one timed solve each at 400x600
    and 800x1200 (after a warm-up solve) and at 2400x3200 (on phase 5's
    solvers, already warm)."""
    from poisson_ellipse_tpu_torch.harness.roofline import passes_per_iter
    from poisson_ellipse_tpu_torch.models.problem import Problem

    say(f"== phase 6 (T_solver, recurrence engines, s = {SSTEP_S}; {card})")
    for m, n in ((400, 600), (800, 1200), MAIN_GRID):
        problem = Problem(M=m, N=n)
        nodes = (m + 1) * (n + 1)
        for engine in RECURRENCE:
            warm = (rec["runs"][engine][:2]
                    if (m, n) == MAIN_GRID and engine in rec["runs"] else None)
            result, t, _ = timed_recurrence(problem, engine, warm)
            iters = int(result.iters)
            passes = passes_per_iter(engine, problem, sstep_s=SSTEP_S)
            iter_ms, iter_by = bound(passes * nodes * 4,
                                     ITER_FLOPS[engine] * nodes)
            say(f"  T_solver {m}x{n} {engine}: {t:.5f} s, {iters} "
                f"iterations, {t / iters * 1e6:.2f} us/iter, bound "
                f"{iter_ms * 1e3:.2f} us/iter ({passes:g} passes, {iter_by})")


# -- phase 8: the lane-batched path ------------------------------------------

# every shape the batched path gives K-e and K-f, and a small one
BATCHED_KERNEL_CASES = (((44, 132), 3), ((400, 600), 32), ((800, 1200), 8),
                        (MAIN_GRID, 2))
BATCHED_ORACLE = (((400, 600), 32, 546), ((800, 1200), 8, 989))
THROUGHPUT_GRIDS = ((400, 600), (800, 1200))
THROUGHPUT_LANES = (1, 8, 32)
POISON_LANE, POISON_AT = 5, 10


def batched_inputs(grid, lanes: int, seed: int):
    """A lane stack w, lane-shared a, b in [0.5, 1.5) and the pipelined
    bundle's five distinct (B, g1, g2) operands on the card, from numpy's
    seed; with ``lanes`` 0, one (g1, g2) grid each."""
    g = (grid[0] + 1, grid[1] + 1)
    lead = (lanes,) if lanes else ()
    rng = np.random.default_rng(seed)

    def dev_f32(x):
        return torch.from_numpy(x.astype(np.float32)).to("cuda")

    return dict(
        w=dev_f32(rng.standard_normal(lead + g)),
        a=dev_f32(rng.random(g) + 0.5),
        b=dev_f32(rng.random(g) + 0.5),
        ops=[dev_f32(rng.standard_normal(lead + g)) for _ in range(5)],
    )


def phase_batched_kernels(seed: int) -> dict:
    """K-e and K-f lane by lane: bitwise K-a / K-d on that lane and their
    plain versions' arrays; K-f's sums within KD_SUM_RTOL of the plain
    version's (both sum the f32 products in double, rounded once)."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say("== phase 8: the batched kernels lane by lane against K-a and K-d")
    errs = {"batched_stencil": 0.0, "batched_stencil_dots": 0.0}
    for (m, n), lanes in BATCHED_KERNEL_CASES:
        inp = batched_inputs((m, n), lanes, seed)
        w, a, b = inp["w"], inp["a"], inp["b"]
        h1, h2 = 2.0 / m, 1.2 / n
        label = f"{m + 1}x{n + 1} B={lanes}"
        for form, kernel, plain, single in (
                ("full", hk.apply_a_batched_kernel, hk.apply_a_batched_plain,
                 hk.apply_a_kernel),
                ("block", hk.apply_a_batched_block_kernel,
                 hk.apply_a_block_plain, hk.apply_a_block_kernel)):
            got = kernel(w, a, b, h1, h2)
            errs["batched_stencil"] = max(errs["batched_stencil"],
                                          close_arrays(f"K-e {form} {label}",
                                                       got,
                                                       plain(w, a, b, h1, h2)))
            lanes_ok = all(torch.equal(got[l], single(w[l].contiguous(), a, b,
                                                      h1, h2))
                           for l in range(lanes))
            say(f"  K-e {form} {label}: every lane bitwise K-a's {lanes_ok}")
            require(lanes_ok and torch.equal(got, plain(w, a, b, h1, h2)),
                    f"K-e {form} {label} is not bitwise K-a and its plain "
                    "version on every lane")
            for kind, w0 in signed_zero_inputs(w, seed=2).items():
                got = kernel(w0, a, b, h1, h2)
                require(same_bits(got, plain(w0, a, b, h1, h2))
                        and all(same_bits(got[l], single(w0[l].contiguous(),
                                                         a, b, h1, h2))
                                for l in range(lanes)),
                        f"K-e {form} {label} on {kind}: not bitwise its "
                        "plain version and K-a on every lane")
            say(f"  K-e {form} {label} on +0, -0 and a signed-zero "
                "exterior: bitwise its plain version and K-a on every lane")
        pairs = _bundle(*inp["ops"])
        got_n, got_sums = hk.apply_a_dots_batched_kernel(w, a, b, h1, h2,
                                                         pairs)
        want_n, want_sums = hk.apply_a_dots_batched_plain(w, a, b, h1, h2,
                                                          pairs)
        err = close_arrays(f"K-f n {label}", got_n, want_n)
        require(torch.equal(got_n, want_n), f"K-f n {label} is not bitwise "
                "its plain version's")
        rel = float(((got_sums.double() - want_sums.double()).abs()
                     / want_sums.double().abs().clamp_min(1e-300)).max())
        say(f"  K-f sums {label}: max rel {rel:.3e} against the plain "
            f"version, bitwise {torch.equal(got_sums, want_sums)}")
        require(bool(torch.isfinite(got_sums).all()) and rel <= KD_SUM_RTOL,
                f"K-f sums {label} differ beyond rel {KD_SUM_RTOL}")
        gen_n, gen_sums = hk.apply_a_dots_batched_kernel(w, a, b, h1, h2,
                                                         swapped(pairs))
        require(same_bits(gen_n, got_n) and same_bits(gen_sums, got_sums),
                f"K-f {label}: the generic instantiation differs from the "
                "bundle's")
        errs["batched_stencil_dots"] = max(
            errs["batched_stencil_dots"], err,
            float((got_sums.double() - want_sums.double()).abs().max()))
        for l in range(lanes):
            lane_ops = [o[l].contiguous() for o in inp["ops"]]
            n_l, sums_l = hk.apply_a_dots_kernel(w[l].contiguous(), a, b, h1,
                                                 h2, _bundle(*lane_ops))
            require(torch.equal(got_n[l], n_l)
                    and torch.equal(got_sums[:, l], sums_l),
                    f"K-f lane {l} {label} is not bitwise K-d on that lane")
        say(f"  K-f {label}: n and sums[:, l] bitwise K-d's on every lane")
    return errs


def expected_batched_launches(engine: str, iters: int, chunk: int = 64):
    """The kernel launches of one solve of a batched engine whose slowest
    lane took ``iters`` iterations, the host reading once per ``chunk``:
    every issued body launches the engine's per-body kernel (bodies past
    the exit too); the pipelined form launches K-e for w0 and four times in
    each body whose iteration is a positive multiple of REPLACE_EVERY."""
    if not engine.endswith("pallas"):
        return {}
    if engine == "batched-pallas":
        return {"batched_stencil": chunk * -(-iters // chunk)}
    want = expected_pipelined_launches(iters, chunk)
    return {"batched_stencil_dots": want["stencil_dots"],
            "batched_stencil": want["stencil"]}


def _check_lanes(label, result, problem, want, tol, lanes):
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    iters = result.iters.tolist()
    l2 = float(l2_error_vs_analytic(problem, result.w[0]))
    say(f"  {label}: lanes {lanes}, iterations {sorted(set(iters))} "
        f"(oracle {want} +-{tol}), converged {bool(result.converged.all())}, "
        f"quarantined {int(result.quarantined.sum())}, lane 0 l2 {l2:.6e}")
    require(tuple(result.w.shape) == (lanes,) + problem.node_shape
            and bool(torch.isfinite(result.w).all()), f"{label}: w not finite")
    require(bool(result.converged.all()) and not bool(result.breakdown.any())
            and not bool(result.quarantined.any()),
            f"{label}: not every lane converged")
    require(all(abs(i - want) <= tol for i in iters),
            f"{label}: a lane is off {want} +-{tol}")
    require(math.isfinite(l2) and l2 < 1e-3, f"{label}: lane 0 l2 error")
    return iters


def phase_batched(seed: int) -> dict:
    """This slice's path: the harness entry point with --lanes, each
    batched engine's per-lane counts and launches, the NaN-lane drill."""
    import contextlib
    import io

    from poisson_ellipse_tpu_torch.batch import batched_pcg as bp
    from poisson_ellipse_tpu_torch.batch import driver
    from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import _build
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    say("== phase 8: the batched path on the card")
    counts, runs = {}, {}
    for (m, n), lanes, want in BATCHED_ORACLE:
        problem = Problem(M=m, N=n)
        # the entry point a user calls: a warm-up solve and one timed one
        out = io.StringIO()
        _build.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = cli_main([str(m), str(n), "--lanes", str(lanes), "--engine",
                           "batched-pallas", "--json"])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        rep = json.loads(out.getvalue())
        say(f"  harness {m} {n} --lanes {lanes} --engine batched-pallas: rc "
            f"{rc}, iters {rep['iters']}, converged {rep['converged']}, "
            f"solves/s {rep['solves_per_sec']:.2f}, l2 {rep['l2_error']}, "
            f"launches {launches}")
        want_launches = expected_batched_launches("batched-pallas",
                                                  rep["iters"])
        require(rc == 0 and rep["converged"] and rep["lanes"] == lanes
                and rep["iters"] == want
                and rep["l2_error"] is not None and rep["l2_error"] < 1e-3,
                f"harness --lanes {lanes} at {m}x{n} failed")
        require(launches == {k: 2 * v for k, v in want_launches.items()},
                f"harness launches {launches}, expected twice "
                f"{want_launches}")
        for engine in ("batched-pallas", "batched", "batched-pipelined-pallas",
                       "batched-pipelined"):
            solver, args, resolved = build_solver(problem, engine,
                                                  torch.float32, "cuda",
                                                  lanes=lanes)
            require(resolved == engine, f"{engine} resolved to {resolved}")
            result, launches = _run_counted(solver, args)
            ref = runs.get(("batched", m, n))
            classical = ref is None or "pipelined" not in engine
            # the classical engines land on the oracle exactly, the
            # pipelined ones within ITERS_ABS
            iters = _check_lanes(f"{engine} {m}x{n}", result, problem, want,
                                 ITERS_ABS if "pipelined" in engine else 0,
                                 lanes)
            if not classical:
                gap = max(abs(i - j) for i, j in zip(iters, ref[2]))
                require(gap <= ITERS_ABS, f"{engine}: a lane more than "
                        f"+-{ITERS_ABS} from the classical lane")
            want_launches = expected_batched_launches(engine, max(iters))
            say(f"    launches {launches} (predicted {want_launches}), "
                f"host reads {solver.host_syncs}")
            require(launches == want_launches, f"{engine} launches")
            require(solver.host_syncs == -(-max(iters) // 64) + 1,
                    "not one host read per 64-iteration chunk plus one")
            if engine == "batched-pallas" and (m, n) == (400, 600):
                counts.update(launches)
            if engine == "batched-pipelined-pallas" and (m, n) == (400, 600):
                counts["batched_stencil_dots"] = launches.get(
                    "batched_stencil_dots", 0)
            runs[(engine, m, n)] = (solver, args, iters, result)

    # on the CPU a lane of a batch is the single solve to the bit; on the
    # card the per-lane and whole-grid sums may add in other orders:
    # reported, not required (the contract is lane independence)
    problem = Problem(M=400, N=600)
    for batched_engine, single_engine in (("batched-pallas", "pallas"),
                                          ("batched", "xla")):
        single, _, _ = _solve(problem, single_engine, torch.float32)
        lane = runs[(batched_engine, 400, 600)][3]
        say(f"  {batched_engine} lane 0 against one {single_engine} solve at "
            f"400x600: iterations {int(lane.iters[0])} / "
            f"{int(single.iters)}, w bitwise "
            f"{torch.equal(lane.w[0], single.w)}, max|dw| "
            f"{max_abs(lane.w[0], single.w):.3e}")

    say(f"  NaN in lane {POISON_LANE}'s r at iteration {POISON_AT}, "
        "batched-pallas 400x600, B = 32")
    problem = Problem(M=400, N=600)
    solver, args, iters, clean = runs[("batched-pallas", 400, 600)]
    a, b, rhs = args
    state, _ = bp.advance(problem, a, b, rhs, bp.init_state(problem, a, b,
                                                            rhs),
                          limit=POISON_AT, stencil="pallas")
    r = state.r.clone()
    r[POISON_LANE] = float("nan")
    got = driver.solve_batched(problem, 32, "batched-pallas",
                               operands=args, state=state._replace(r=r))
    res = got.result
    quar = res.quarantined.nonzero().flatten().tolist()
    events = [(e.kind, e.at_iter, e.detail) for e in got.recoveries]
    healthy = [l for l in range(32) if l != POISON_LANE]
    same = all(torch.equal(res.w[l], clean.w[l])
               and int(res.iters[l]) == iters[l] for l in healthy)
    say(f"    quarantined {quar} at {res.iters[POISON_LANE].item()}, events "
        f"{events}, healthy lanes bitwise the clean batch's {same}")
    require(quar == [POISON_LANE] and int(res.iters[POISON_LANE])
            == POISON_AT + 1, "the poisoned lane was not quarantined at 11")
    require(events == [("lane-quarantine", POISON_AT + 1,
                        f"lane {POISON_LANE}")], "not one quarantine event")
    require(same, "a healthy lane moved")
    return dict(counts=counts, runs=runs)


def phase_batched_timing(seed: int, card: str) -> list:
    """K-e and K-f per launch at 401x601, B = 32 and 801x1201, B = 8,
    against their bounds: K-e reads a and b once and each lane's w and
    out once, (2 + 2B) passes; K-f also each lane's five bundle operands,
    (2 + 7B) passes."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say(f"== phase 8 (timing): K-e and K-f on {card}")
    rows = []
    for (m, n), lanes in (((400, 600), 32), ((800, 1200), 8)):
        inp = batched_inputs((m, n), lanes, seed)
        w, a, b = inp["w"], inp["a"], inp["b"]
        h1, h2 = 2.0 / m, 1.2 / n
        pairs = _bundle(*inp["ops"])
        nodes = (m + 1) * (n + 1)
        array = nodes * 4
        cases = (
            ("batched_stencil", "csrc/stencil.cu",
             "poisson_ellipse_tpu/ops/pallas_kernels.py:409",
             lambda fn=hk.apply_a_batched_kernel: fn(w, a, b, h1, h2),
             lambda: hk.apply_a_batched_plain(w, a, b, h1, h2),
             (2 + 2 * lanes) * array, 18 * nodes * lanes),
            ("batched_stencil_dots", "csrc/stencil_dots.cu",
             "poisson_ellipse_tpu/ops/pallas_kernels.py:529",
             lambda: hk.apply_a_dots_batched_kernel(w, a, b, h1, h2, pairs),
             lambda: hk.apply_a_dots_batched_plain(w, a, b, h1, h2, pairs),
             (2 + 7 * lanes) * array, KD_FLOPS * nodes * lanes),
        )
        for name, src, replaces, fn, plain, nbytes, flops in cases:
            ms = time_ms(fn, 100)
            plain_ms = time_ms(plain, 10)
            bound_ms, bound_by = bound(nbytes, flops)
            say(f"  {name} {m + 1}x{n + 1} B={lanes}: {ms * 1e3:.1f} us/launch,"
                f" plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} "
                f"us ({bound_by}), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
            if (m, n) == (400, 600):
                rows.append(dict(name=name, route="cuda",
                                 source=f"poisson_ellipse_tpu_torch/{src}",
                                 replaces=replaces, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None, grid=[m + 1, n + 1],
                                 lanes=lanes))
    return rows


def phase_throughput(batched, card: str) -> None:
    """solves/s = B / T_solver (CUDA events around one batched solve,
    median of 3, of 1 where one solve takes over a second) for each
    batched engine, grid and lane count, beside B sequential auto solves
    (resident at both grids)."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    say(f"== phase 8 (throughput, solves/s; {card})")
    for m, n in THROUGHPUT_GRIDS:
        problem = Problem(M=m, N=n)
        seq, seq_args, resolved = build_solver(problem, "auto",
                                               torch.float32, "cuda")
        seq(*seq_args)
        for lanes in THROUGHPUT_LANES:
            t = time_solver(lambda: [seq(*seq_args) for _ in range(lanes)],
                            (), 3)
            say(f"  {m}x{n} B={lanes} sequential auto ({resolved}): "
                f"T {t:.5f} s, {lanes / t:.2f} solves/s")
            engines = ["batched-pallas", "batched"]
            if lanes == 32:
                engines.append("batched-pipelined-pallas")
            for engine in engines:
                key = (engine, m, n)
                run = batched["runs"].get(key)
                if run is not None and len(run[1][2]) == lanes:
                    solver, args = run[0], run[1]
                else:
                    solver, args, _ = build_solver(problem, engine,
                                                   torch.float32, "cuda",
                                                   lanes=lanes)
                    solver(*args)
                out = []
                t1 = time_solver(lambda: out.append(solver(*args)), (), 1)
                if t1 < 1.0:
                    t1 = time_solver(lambda: out.append(solver(*args)), (), 3)
                iters = int(out[-1].iters.max())
                say(f"  {m}x{n} B={lanes} {engine}: T_solver {t1:.5f} s, "
                    f"{lanes / t1:.2f} solves/s, {iters} iterations "
                    f"(slowest lane), {t1 / iters * 1e6:.1f} us/iter")


# -- phase 9: the storage axis -----------------------------------------------

# every grid the storage path gives K-g and K-h, and a small ragged one
STORAGE_KERNEL_GRIDS = ((44, 132), (800, 1200), MAIN_GRID)
STORAGE_KERNEL_CASES = (("bf16", "bf16"), ("f32", "bf16"), ("f16", "f16"))
NARROW = {"bf16": torch.bfloat16, "f16": torch.float16}
# the JAX package's counts on the CPU (raw bf16 classical loop): printed
# beside the card's, not held (a narrow solve's count moves with the order
# of its sums)
JAX_BF16_ITERS = {(400, 600): 560, (800, 1200): 1053, MAIN_GRID: 3032}
# f16 on the JAX package's CPU run: 298 iterations, converged; breakdown
# at iteration 2 (D overflows f16)
JAX_F16 = {(44, 132): "298, converged", (400, 600): "2, breakdown"}
STORAGE_CAP = 1024
# a narrow solve sits at its storage floor: l2 is held to this sanity
# bound only (the JAX package: 9.1e-3 at 400x600, 4.1e-2 at 2400x3200)
STORAGE_L2 = 0.1


def storage_inputs(grid, seed: int):
    """w, m, a, b and the bundle's five operands at f32 on the card, from
    numpy's seed; inside f16's range."""
    g = (grid[0] + 1, grid[1] + 1)
    rng = np.random.default_rng(seed)

    def dev_f32(x):
        return torch.from_numpy(x.astype(np.float32)).to("cuda")

    return dict(
        w=dev_f32(rng.standard_normal(g)),
        a=dev_f32(rng.random(g) + 0.5),
        b=dev_f32(rng.random(g) + 0.5),
        ops=[dev_f32(rng.standard_normal(g)) for _ in range(5)],
    )


def _as(x, st: str):
    return x if st == "f32" else x.to(NARROW[st])


def phase_storage_kernels(seed: int) -> dict:
    """K-g and K-h bitwise against their plain versions and against K-a /
    K-d on the upcast inputs."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say("== phase 9: K-g and K-h against their plain versions and K-a / K-d")
    errs = {"stencil_mixed": 0.0, "stencil_dots_mixed": 0.0}
    for m, n in STORAGE_KERNEL_GRIDS:
        inp = storage_inputs((m, n), seed)
        h1, h2 = 2.0 / m, 1.2 / n
        label = f"{m + 1}x{n + 1}"
        for w_st, ab_st in STORAGE_KERNEL_CASES:
            w = _as(inp["w"], w_st)
            a, b = _as(inp["a"], ab_st), _as(inp["b"], ab_st)
            up = [x.float().contiguous() for x in (w, a, b)]
            for form, kernel, plain, f32 in (
                    ("full", hk.apply_a_mixed_kernel, hk.apply_a_mixed_plain,
                     hk.apply_a_kernel),
                    ("block", hk.apply_a_mixed_block_kernel,
                     hk.apply_a_mixed_block_plain, hk.apply_a_block_kernel)):
                got = kernel(w, a, b, h1, h2)
                err = close_arrays(f"K-g {form} {label} w {w_st} a,b {ab_st}",
                                   got, plain(w, a, b, h1, h2))
                require(torch.equal(got, plain(w, a, b, h1, h2))
                        and torch.equal(got, f32(*up, h1, h2)),
                        f"K-g {form} {label} is not bitwise its plain version "
                        "and K-a on the upcast inputs")
                errs["stencil_mixed"] = max(errs["stencil_mixed"], err)
        a, b = _as(inp["a"], "bf16"), _as(inp["b"], "bf16")
        m_f32 = inp["w"]
        ops = [_as(o, "bf16") for o in inp["ops"]]
        pairs = _bundle(*ops)
        got_n, got_sums = hk.apply_a_dots_mixed_kernel(m_f32, a, b, h1, h2,
                                                       pairs)
        want_n, want_sums = hk.apply_a_dots_mixed_plain(m_f32, a, b, h1, h2,
                                                        pairs)
        d_n, d_sums = hk.apply_a_dots_kernel(
            m_f32, a.float(), b.float(), h1, h2,
            _bundle(*(o.float() for o in ops)))
        err = close_arrays(f"K-h n {label}", got_n, want_n)
        require(torch.equal(got_n, want_n) and torch.equal(got_n, d_n)
                and torch.equal(got_n, hk.apply_a_mixed_kernel(m_f32, a, b,
                                                               h1, h2)),
                f"K-h n {label} is not bitwise its plain version's, K-d's and "
                "K-g's")
        for j in range(len(pairs)):
            close_sum(f"K-h sum {j} {label}", float(got_sums[j]),
                      float(want_sums[j]), KD_SUM_RTOL)
        require(torch.equal(got_sums, d_sums), f"K-h sums {label} are not "
                "bitwise K-d's on the upcast inputs")
        gen_n, gen_sums = hk.apply_a_dots_mixed_kernel(m_f32, a, b, h1, h2,
                                                       swapped(pairs))
        require(same_bits(gen_n, got_n) and same_bits(gen_sums, got_sums),
                f"K-h {label}: the generic instantiation differs from the "
                "bundle's")
        say(f"  K-h {label}: sums bitwise K-d's on the upcast operands; the "
            "generic instantiation the same bits")
        errs["stencil_dots_mixed"] = max(
            errs["stencil_dots_mixed"], err,
            float((got_sums.double() - want_sums.double()).abs().max()))
    return errs


def _storage_solve(problem, engine, storage, chunk=64):
    """(solver, args, result, launches) of one counted solve."""
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    solver, args, resolved = build_solver(problem, engine, torch.float32,
                                          "cuda", chunk=chunk,
                                          sstep_s=SSTEP_S,
                                          storage_dtype=storage)
    require(resolved == engine, f"{engine} resolved to {resolved}")
    result, launches = _run_counted(solver, args)
    return solver, args, result, launches


def phase_storage_main() -> dict:
    """The slice's main path: run_once(pallas, bf16) at 2400x3200."""
    from poisson_ellipse_tpu_torch.harness.run import run_once
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import _build

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    say(f"== phase 9: main path, run_once(pallas, storage bf16) at "
        f"{problem.M}x{problem.N} f32")
    _build.reset_launches()
    rep = run_once(problem, engine="pallas", storage_dtype="bf16",
                   device="cuda")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    d = rep.json_dict()
    bodies = 64 * -(-rep.iters // 64)
    say(f"  run_once: {rep.iters} iterations (JAX package, CPU: "
        f"{JAX_BF16_ITERS[MAIN_GRID]}), converged {rep.converged}, breakdown "
        f"{rep.breakdown}, l2 {rep.l2_error:.6e}, T_solver {rep.t_solver:.5f}"
        f" s, {rep.t_solver / rep.iters * 1e6:.2f} us/iter, host reads "
        f"{rep.host_syncs}, launches (warm-up + timed solve) {launches}, "
        f"storage_dtype {d.get('storage_dtype')!r}")
    require(d.get("storage_dtype") == "bf16", "the report does not carry "
            "storage_dtype bf16")
    require(rep.converged and not rep.breakdown, "pallas bf16 did not "
            "converge")
    require(math.isfinite(rep.l2_error) and rep.l2_error < STORAGE_L2,
            "pallas bf16 l2 error out of range")
    require(launches == {"stencil_mixed": 2 * bodies}, "K-g not launched "
            "once per issued body")
    require(rep.host_syncs == -(-rep.iters // 64) + 1,
            "not one host read per 64-iteration chunk plus one")

    runs = {}
    for engine, storage in (("pallas", "bf16"), ("xla", "bf16"),
                            ("pallas", None)):
        runs[(engine, storage)] = _storage_solve(problem, engine, storage)
    _, _, res_p, launches_p = runs[("pallas", "bf16")]
    _, _, res_x, launches_x = runs[("xla", "bf16")]
    _, _, res_f, _ = runs[("pallas", None)]
    gap = max_abs(res_p.w, res_x.w)
    say(f"  pallas bf16 {int(res_p.iters)} / xla bf16 {int(res_x.iters)} "
        f"iterations, flags {bool(res_p.converged)}/{bool(res_p.breakdown)} "
        f"and {bool(res_x.converged)}/{bool(res_x.breakdown)}, "
        f"max|w_pallas - w_xla| {gap:.3e}, bitwise "
        f"{torch.equal(res_p.w, res_x.w)}; launches {launches_p} / "
        f"{launches_x}")
    for f in ("iters", "converged", "breakdown"):
        require(int(getattr(res_p, f)) == int(getattr(res_x, f)),
                f"pallas and xla bf16 differ in {f}")
    require(launches_x == {}, "xla bf16 launched a kernel")
    w16, w32 = res_p.w.double(), res_f.w.double()
    rel = float(torch.linalg.vector_norm(w16 - w32)
                / torch.linalg.vector_norm(w32))
    say(f"  ||w_bf16 - w_f32|| / ||w_f32|| = {rel:.4e} (f32: "
        f"{int(res_f.iters)} iterations)")
    return dict(counts={"stencil_mixed": launches_p["stencil_mixed"]},
                runs=runs, report=rep)


def expected_narrow_launches(engine: str, iters: int, limit: int,
                             chunk: int = 64) -> dict:
    """The launches of a bf16 run of pipelined-pallas or sstep-pallas
    capped at ``limit`` with the host reading once per ``chunk``: bodies
    are issued in chunks up to the limit; the replacement comes every
    ``replace_every("bf16")`` = 8 iterations."""
    from poisson_ellipse_tpu_torch.ops.precision import replace_every
    from poisson_ellipse_tpu_torch.ops.sstep_pcg import replaces

    cadence = replace_every("bf16")
    issued = min(limit, chunk * -(-iters // chunk))
    if engine == "pipelined-pallas":
        return {"stencil": 1, "stencil_dots_mixed": issued,
                "stencil_mixed": 4 * ((issued - 1) // cadence)}
    starts = range(0, issued, SSTEP_S)
    return {"stencil_mixed": (2 * SSTEP_S - 1) * len(starts)
            + sum(replaces(k, SSTEP_S, cadence) for k in starts)}


def phase_storage_recurrences(card: str) -> dict:
    """pipelined-pallas and sstep-pallas at 2400x3200 in bf16, capped at
    STORAGE_CAP: finite, chunk 64 bitwise one straight run, launches; the
    plain forms' counts and gaps printed; time per iteration beside f32."""
    from poisson_ellipse_tpu_torch.models.problem import Problem

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=STORAGE_CAP)
    say(f"== phase 9: the recurrences at {problem.M}x{problem.N}, bf16, "
        f"max_iter {STORAGE_CAP} ({card})")
    counts, results = {}, {}
    for engine in ("pipelined-pallas", "sstep-pallas"):
        solver, args, got, launches = _storage_solve(problem, engine, "bf16")
        _, _, straight, _ = _storage_solve(problem, engine, "bf16",
                                           chunk=STORAGE_CAP)
        iters = int(got.iters)
        want = expected_narrow_launches(engine, iters, STORAGE_CAP)
        same = all(torch.equal(x, y) for x, y in zip(got, straight))
        say(f"  {engine}: {iters} iterations, converged "
            f"{bool(got.converged)}, breakdown {bool(got.breakdown)}, w "
            f"finite {bool(torch.isfinite(got.w).all())}, chunk 64 bitwise "
            f"straight {same}, launches {launches} (predicted {want})")
        require(bool(torch.isfinite(got.w).all()), f"{engine}: carry not "
                "finite")
        require(same, f"{engine}: chunked and straight runs differ")
        require(launches == want, f"{engine}: launches {launches}")
        results[engine] = (got, time_solver(solver, args, 1))
        if engine == "pipelined-pallas":
            counts["stencil_dots_mixed"] = launches["stencil_dots_mixed"]
    for plain, kernel in (("pipelined", "pipelined-pallas"),
                          ("sstep", "sstep-pallas")):
        _, _, got, launches = _storage_solve(problem, plain, "bf16")
        ref = results[kernel][0]
        rel = float((got.w.double() - ref.w.double()).abs().max()
                    / ref.w.double().abs().max())
        say(f"  {plain} bf16: {int(got.iters)} iterations, converged "
            f"{bool(got.converged)}, breakdown {bool(got.breakdown)}, "
            f"max|x - x_{kernel}| / max|x_{kernel}| {rel:.3e}, launches "
            f"{launches}")
        require(launches == {}, f"{plain} launched a kernel")
    return dict(counts=counts, results=results, problem=problem)


def phase_storage_checks() -> None:
    """The published grids under bf16, and f16 on pallas against xla."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    say("== phase 9: published grids in bf16, f16 against xla")
    for (m, n), jax_iters in JAX_BF16_ITERS.items():
        if (m, n) == MAIN_GRID:
            continue
        problem = Problem(M=m, N=n)
        _, _, res, launches = _storage_solve(problem, "pallas", "bf16")
        l2 = float(l2_error_vs_analytic(problem, res.w))
        say(f"  {m}x{n} pallas bf16: {int(res.iters)} iterations (JAX "
            f"package, CPU: {jax_iters}), converged {bool(res.converged)}, "
            f"l2 {l2:.6e}, launches {launches}")
        require(bool(res.converged) and not bool(res.breakdown),
                f"{m}x{n} pallas bf16 did not converge")
        require(math.isfinite(l2) and l2 < STORAGE_L2, "l2 out of range")
    for (m, n), jax_says in JAX_F16.items():
        problem = Problem(M=m, N=n)
        _, _, res_p, _ = _storage_solve(problem, "pallas", "f16")
        _, _, res_x, _ = _storage_solve(problem, "xla", "f16")
        say(f"  {m}x{n} f16: pallas {int(res_p.iters)} it "
            f"{bool(res_p.converged)}/{bool(res_p.breakdown)}, xla "
            f"{int(res_x.iters)} it {bool(res_x.converged)}/"
            f"{bool(res_x.breakdown)} (converged/breakdown; JAX package, "
            f"CPU: {jax_says}); w bitwise {torch.equal(res_p.w, res_x.w)}")
        for f in ("iters", "converged", "breakdown"):
            require(int(getattr(res_p, f)) == int(getattr(res_x, f)),
                    f"{m}x{n} f16: pallas and xla differ in {f}")


def phase_storage_timing(seed: int, main, rec, card: str) -> list:
    """K-g and K-h against their bounds, plain versions and K-a / K-d at
    f32 on the same 2401x3201 inputs; T_solver of pallas in bf16 beside
    f32; the capped recurrences' time per iteration."""
    from poisson_ellipse_tpu_torch.harness.run import run_once
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say(f"== phase 9 (timing): K-g and K-h at 2401x3201 on {card}")
    inp = storage_inputs(MAIN_GRID, seed)
    nodes = (MAIN_GRID[0] + 1) * (MAIN_GRID[1] + 1)
    h1, h2 = 2.0 / MAIN_GRID[0], 1.2 / MAIN_GRID[1]
    a, b = _as(inp["a"], "bf16"), _as(inp["b"], "bf16")
    w16, w32 = _as(inp["w"], "bf16"), inp["w"]
    ops16 = [_as(o, "bf16") for o in inp["ops"]]
    pairs16, pairs32 = _bundle(*ops16), _bundle(*(o.float() for o in ops16))
    a32, b32 = a.float(), b.float()
    cases = (
        # name, label, kernel, plain, bytes, flops
        ("stencil_mixed", "K-g w bf16",
         lambda: hk.apply_a_mixed_kernel(w16, a, b, h1, h2),
         lambda: hk.apply_a_mixed_plain(w16, a, b, h1, h2),
         10 * nodes, 18 * nodes),
        (None, "K-g w f32",
         lambda: hk.apply_a_mixed_kernel(w32, a, b, h1, h2),
         lambda: hk.apply_a_mixed_plain(w32, a, b, h1, h2),
         12 * nodes, 18 * nodes),
        (None, "K-a f32 (same values)",
         lambda: hk.apply_a_kernel(w32, a32, b32, h1, h2),
         lambda: hk.apply_a_plain(w32, a32, b32, h1, h2),
         16 * nodes, 18 * nodes),
        ("stencil_dots_mixed", "K-h bundle bf16",
         lambda: hk.apply_a_dots_mixed_kernel(w32, a, b, h1, h2, pairs16),
         lambda: hk.apply_a_dots_mixed_plain(w32, a, b, h1, h2, pairs16),
         22 * nodes, KD_FLOPS * nodes),
        (None, "K-d f32 (same values)",
         lambda: hk.apply_a_dots_kernel(w32, a32, b32, h1, h2, pairs32),
         lambda: hk.apply_a_dots_plain(w32, a32, b32, h1, h2, pairs32),
         36 * nodes, KD_FLOPS * nodes),
    )
    rows = []
    sources = {"stencil_mixed": ("csrc/stencil.cu", 784),
               "stencil_dots_mixed": ("csrc/stencil_dots.cu", 910)}
    for name, label, fn, plain, nbytes, flops in cases:
        ms = time_ms(fn, 200)
        plain_ms = time_ms(plain, 20)
        bound_ms, bound_by = bound(nbytes, flops)
        say(f"  {label}: {ms * 1e3:.1f} us/launch, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({bound_by}, {nbytes / nodes:g} B a node), "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        if name is not None:
            src, line = sources[name]
            rows.append(dict(
                name=name, route="cuda",
                source=f"poisson_ellipse_tpu_torch/{src}",
                replaces=f"poisson_ellipse_tpu/ops/pallas_kernels.py:{line}",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None))

    say(f"== phase 9 (timing): T_solver of pallas, bf16 beside f32 ({card})")
    rep16 = main["report"]
    for m, n in ((400, 600), (800, 1200), MAIN_GRID):
        problem = Problem(M=m, N=n)
        reps = {"f32": run_once(problem, engine="pallas", device="cuda")}
        reps["bf16"] = (rep16 if (m, n) == MAIN_GRID else
                        run_once(problem, engine="pallas", device="cuda",
                                 storage_dtype="bf16"))
        for st, rep in reps.items():
            say(f"  T_solver {m}x{n} pallas {st}: {rep.t_solver:.5f} s, "
                f"{rep.iters} iterations, {rep.t_solver / rep.iters * 1e6:.2f}"
                f" us/iter, {rep.passes_per_iter:g} passes/iter, "
                f"{rep.hbm_gbps} GB/s modelled")
    for engine, (got, t16) in rec["results"].items():
        say(f"  {engine} {MAIN_GRID[0]}x{MAIN_GRID[1]} capped at "
            f"{STORAGE_CAP}: bf16 {t16:.5f} s for {int(got.iters)} "
            f"iterations, {t16 / int(got.iters) * 1e6:.2f} us/iter")
    return rows


def phase_storage_f32_recurrence_times(rec, card: str) -> None:
    """The capped recurrences at f32, timed as the bf16 ones were."""
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    problem = rec["problem"]
    for engine in rec["results"]:
        solver, args, _ = build_solver(problem, engine, torch.float32,
                                       "cuda", sstep_s=SSTEP_S)
        out = []
        t = time_solver(lambda: out.append(solver(*args)), (), 1)
        iters = int(out[-1].iters)
        say(f"  {engine} capped at {STORAGE_CAP}: f32 {t:.5f} s for {iters}"
            f" iterations, {t / iters * 1e6:.2f} us/iter ({card})")


# -- phase 10: the dtype axes ------------------------------------------------

BF16 = torch.bfloat16
# every bf16-compute solve and every f16-stream solve is capped here: a
# stalled bf16 loop would run into the script's time limit at the default
# cap of (M-1)(N-1)
DTYPE_CAP = 8192
# published grids (README.md:1139-1144) and the grid between the f32 gates:
# auto bf16 takes resident, streamed (1600x2400) and xl on them
BF16_AUTO_GRIDS = ((400, 600), (800, 1200), STREAMED_GRID, (1600, 2400),
                   MAIN_GRID)
# the JAX package's CPU run: xla bf16 at 400x600, l2 1.55e-2 (290
# iterations, "converged" at bf16's floor); resident bf16 there: 33
# iterations, l2 0.0719 (the cancelling stencil; ROADMAP Queue C)
BF16_XLA_L2 = 3e-2
JAX_BF16_400 = {"xla": "290, l2 1.55e-2", "resident": "33, l2 0.0719"}
# capped solves timed per iteration (the forms stop at different counts
# uncapped, if at all)
TIME_CAP = 256
FORM_ROWS = {
    # counter: (engine, compute dtype, storage dtype)
    "resident_bf16": ("resident", BF16, None),
    "streamed_bf16": ("streamed", BF16, None),
    "streamed_f32_bf16": ("streamed", torch.float32, "bf16"),
    "streamed_f32_f16": ("streamed", torch.float32, "f16"),
    "xl_bf16": ("xl", BF16, None),
    "xl_f32_bf16": ("xl", torch.float32, "bf16"),
    "xl_f32_f16": ("xl", torch.float32, "f16"),
}
WHOLE_REPLACES = {
    "resident": "poisson_ellipse_tpu/ops/resident_pcg.py:234",
    "streamed": "poisson_ellipse_tpu/ops/streamed_pcg.py:632",
    "xl": "poisson_ellipse_tpu/ops/xl_pcg.py:451",
}


def seeded_operands(grid, storage, seed: int):
    """Finite (dinv, an, bw, r0) for a narrow-stream form: the real f16
    operands overflow (1/eps > 65504), so the f16 load path is also held on
    numpy-seeded values inside f16's range."""
    g = (grid[0] + 1, grid[1] + 1)
    rng = np.random.default_rng(seed)

    def dev(lo, hi, dtype):
        x = rng.uniform(lo, hi, g).astype(np.float32)
        return torch.from_numpy(x).to("cuda").to(dtype)

    st = NARROW[storage]
    return (dev(0.1, 0.2, st), dev(1.0, 2.0, st), dev(1.0, 2.0, st),
            dev(-1.0, 1.0, torch.float32))


def phase_dtype_kernels(cap, seed: int, inp) -> dict:
    """Every new form against its plain version on the card: capped solves
    at max_iter 1, 2 and 7 for the whole-solve forms, one launch each on
    seeded inputs for K-b / K-c bf16 at 2401x3201."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.ops.resident_pcg import fits_resident
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import fits_streamed

    say("== phase 10: the dtype forms against their plain versions, "
        f"max_iter in {CAPS}")
    admitted = [g for g in PUBLISHED if fits_resident(Problem(*g), BF16, cap)]
    require(bool(admitted), "the bf16 resident gate admits no published grid")
    between = [g for g in PUBLISHED
               if fits_streamed(Problem(*g), BF16, cap)
               and not fits_resident(Problem(*g), BF16, cap)]
    require(bool(between), "no published grid between the bf16 gates")
    cases = [
        ("xl_bf16", "xl", MAIN_GRID, BF16, None, None, None),
        ("streamed_bf16", "streamed", between[0], BF16, None, None, None),
        ("resident_bf16", "resident", admitted[0], BF16, None, None, None),
    ]
    for st in ("bf16", "f16"):
        for seeded in (False, True):
            ops = (lambda g, st=st: seeded_operands(g, st, seed)) \
                if seeded else (lambda g: None)
            cases += [
                (f"xl_f32_{st}", "xl", MAIN_GRID, torch.float32, st, None,
                 ops(MAIN_GRID)),
                (f"streamed_f32_{st}", "streamed", STREAMED_GRID,
                 torch.float32, st, None, ops(STREAMED_GRID)),
                (f"streamed_f32_{st}", "streamed", STREAMED_GRID,
                 torch.float32, st, ("dinv",), ops(STREAMED_GRID)),
            ]
    errs = {}
    for counter, name, (m, n), dtype, st, resident, operands in cases:
        kernel, plain = _whole_runs(name, Problem(M=m, N=n), cap, resident,
                                    dtype, st, operands)
        label = (f"{counter} {m}x{n}"
                 + (f" resident {list(resident)}" if resident else "")
                 + (" seeded operands" if operands else ""))
        for max_iter in CAPS:
            capped = Problem(M=m, N=n, max_iter=max_iter)
            got, want = kernel(capped), plain(capped)
            torch.cuda.synchronize()
            err = close_solves(f"{label} max_iter={max_iter}", got, want)
            errs[counter] = max(errs.get(counter, 0.0), err)

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    g1, g2 = problem.node_shape
    h1, h2 = problem.h1, problem.h2
    an, as_, bw, be, d, dinv = fp.fused_operands(problem, BF16, "cuda")
    z, p, w0, r0 = (inp[k].to(BF16) for k in ("z", "p", "w", "r"))
    partials = torch.empty(fp.scratch_len(g1, g2), dtype=torch.float64,
                           device="cuda")

    def fresh(alpha=0.0):
        scal = torch.tensor([1.5, 0.7, float("inf"), 0.0, alpha], dtype=BF16,
                            device="cuda")
        return scal, torch.zeros(fp.N_FLAGS, dtype=torch.int32,
                                 device="cuda")

    say(f"K-b / K-c bf16 at {g1}x{g2} against their plain versions")
    outs = []
    for fn in (fp.k1, fp.k1_plain):
        scal, flags = fresh()
        pn, ap = torch.empty_like(z), torch.empty_like(z)
        fn(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials,
           max_iter=2**31 - 1, h1=h1, h2=h2)
        outs.append((pn, ap, scal, flags))
    (pn, ap, scal_k, flags_k), (pn_p, ap_p, scal_p, flags_p) = outs
    errs["fused_k1_bf16"] = max(close_arrays("K-b bf16 pn", pn, pn_p),
                                close_arrays("K-b bf16 ap", ap, ap_p))
    for nm, i in (("denom", fp.SCAL_DENOM), ("alpha", fp.SCAL_ALPHA)):
        close_sum(f"K-b bf16 {nm}", float(scal_k[i]), float(scal_p[i]))
    require(torch.equal(flags_k, flags_p), "K-b bf16 flags differ")
    outs = []
    for fn in (fp.k2, fp.k2_plain):
        scal, flags = fresh(alpha=0.3)
        w, r, zz = w0.clone(), r0.clone(), torch.empty_like(w0)
        fn(w, r, pn_p, ap_p, dinv, zz, scal, flags, partials,
           max_iter=2**31 - 1, h1=h1, h2=h2, delta=problem.delta,
           weighted=True)
        outs.append((w, r, zz, scal, flags))
    (w, r, zz, scal_k, flags_k), (w_p, r_p, zz_p, scal_p, flags_p) = outs
    errs["fused_k2_bf16"] = max(close_arrays("K-c bf16 w", w, w_p),
                                close_arrays("K-c bf16 r", r, r_p),
                                close_arrays("K-c bf16 z", zz, zz_p))
    for nm, i in (("zr", fp.SCAL_ZR), ("beta", fp.SCAL_BETA),
                  ("diff", fp.SCAL_DIFF)):
        close_sum(f"K-c bf16 {nm}", float(scal_k[i]), float(scal_p[i]))
    require(torch.equal(flags_k[:3], flags_p[:3]), "K-c bf16 flags differ")
    return errs


def _add(counts: dict, launches: dict) -> None:
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v


def phase_dtype_main(cap) -> dict:
    """The slice's path: auto at bf16 through build_solver on the published
    grids, fused at bf16, and xl and streamed with f32 compute and bf16
    (then f16) operand streams; launches counted over these runs only."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import (
        build_solver,
        select_engine,
    )
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    say(f"== phase 10: main path, auto at bf16 (capped at {DTYPE_CAP}), and "
        "the narrow operand streams")
    counts = {}
    for m, n in BF16_AUTO_GRIDS:
        problem = Problem(M=m, N=n, max_iter=DTYPE_CAP)
        solver, args, engine = build_solver(problem, "auto", BF16, "cuda")
        want = select_engine(problem, BF16, cap)
        result, launches = _run_counted(solver, args)
        _add(counts, launches)
        iters = int(result.iters)
        l2 = float(l2_error_vs_analytic(problem, result.w))
        l2_zero = float(l2_error_vs_analytic(problem,
                                             torch.zeros_like(result.w)))
        s_x, a_x, _ = build_solver(problem, "xla", BF16, "cuda")
        ref, launches_x = _run_counted(s_x, a_x)
        l2_x = float(l2_error_vs_analytic(problem, ref.w))
        say(f"  auto bf16 {m}x{n} -> {engine} (select_engine {want}): "
            f"{iters} iterations, converged {bool(result.converged)}, "
            f"breakdown {bool(result.breakdown)}, hit the cap "
            f"{iters >= DTYPE_CAP}, l2 {l2:.6e} (w = 0 scores {l2_zero:.6e}),"
            f" launches {launches}, host reads {solver.host_syncs}; xla bf16 "
            f"on this card {int(ref.iters)} iterations, converged "
            f"{bool(ref.converged)}, l2 {l2_x:.6e}"
            + (f" (JAX package, CPU: xla {JAX_BF16_400['xla']}, resident "
               f"{JAX_BF16_400['resident']})" if (m, n) == (400, 600)
               else ""))
        require(engine == want, f"auto bf16 {m}x{n} resolved to {engine}, "
                f"select_engine says {want}")
        require(launches == {f"{engine}_bf16": 1} and solver.host_syncs == 1,
                f"auto bf16 {m}x{n}: not one launch and one host read")
        require(bool(torch.isfinite(result.w).all()), "w not finite")
        require(launches_x == {}, "xla bf16 launched a kernel")
        if (m, n) == (400, 600):
            require(bool(ref.converged) and l2_x < BF16_XLA_L2,
                    f"xla bf16 at 400x600: l2 {l2_x:.3e} not below "
                    f"{BF16_XLA_L2}")
    for m, n in ((400, 600), MAIN_GRID):
        problem = Problem(M=m, N=n, max_iter=DTYPE_CAP)
        solver, args, _ = build_solver(problem, "fused", BF16, "cuda")
        result, launches = _run_counted(solver, args)
        _add(counts, launches)
        iters = int(result.iters)
        say(f"  fused bf16 {m}x{n}: {iters} iterations, converged "
            f"{bool(result.converged)}, breakdown {bool(result.breakdown)}, "
            f"l2 {float(l2_error_vs_analytic(problem, result.w)):.6e}, "
            f"launches {launches}")
        for k in ("fused_k1_bf16", "fused_k2_bf16"):
            require(launches.get(k, 0) >= max(iters, 1),
                    f"{k} launched fewer times than iterations")
        require(bool(torch.isfinite(result.w).all()), "w not finite")

    for engine, (m, n) in (("xl", MAIN_GRID), ("streamed", STREAMED_GRID)):
        problem = Problem(M=m, N=n)
        s_f, a_f, _ = build_solver(problem, engine, torch.float32, "cuda")
        f32_iters = int(s_f(*a_f).iters)
        solver, args, _ = build_solver(problem, engine, torch.float32, "cuda",
                                       storage_dtype="bf16")
        result, launches = _run_counted(solver, args)
        _add(counts, launches)
        iters = int(result.iters)
        l2 = float(l2_error_vs_analytic(problem, result.w))
        say(f"  {engine} f32, bf16 operand streams, {m}x{n}: {iters} "
            f"iterations (f32 streams: {f32_iters}), converged "
            f"{bool(result.converged)}, l2 {l2:.6e}, launches {launches}, "
            f"host reads {solver.host_syncs}")
        require(bool(result.converged) and l2 < 1e-3,
                f"{engine} with bf16 streams: not converged below l2 1e-3")
        require(launches == {f"{engine}_f32_bf16": 1}
                and solver.host_syncs == 1, "not one launch and one read")
    for engine in ("xl", "streamed"):
        problem = Problem(M=400, N=600, max_iter=DTYPE_CAP)
        solver, args, _ = build_solver(problem, engine, torch.float32, "cuda",
                                       storage_dtype="f16")
        result, launches = _run_counted(solver, args)
        _add(counts, launches)
        say(f"  {engine} f32, f16 operand streams, 400x600 (capped at "
            f"{DTYPE_CAP}): {int(result.iters)} iterations, converged "
            f"{bool(result.converged)}, breakdown {bool(result.breakdown)}, "
            f"w NaN {bool(torch.isnan(result.w).any())}, launches {launches} "
            "(JAX package, CPU: NaN, not converged, at 40x40 and 44x132)")
        require(launches == {f"{engine}_f32_f16": 1}, "not one launch")
    return dict(counts=counts)


def _timed_form(engine, problem, dtype, storage):
    """(solver, args, iterations) of one capped solve of a form."""
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    solver, args, _ = build_solver(problem, engine, dtype, "cuda",
                                   storage_dtype=storage)
    return solver, args, int(solver(*args).iters)


def phase_dtype_timing(cap, card: str) -> list:
    """Per iteration, capped at TIME_CAP: xl at 2400x3200 and streamed at
    1100x1650 in f32, f32 with bf16 streams and bf16 compute, resident at
    800x1200 in f32 and bf16, in turns in one run; each new form's plain
    version on the same solve; K-b / K-c bf16 against f32 per launch."""
    from poisson_ellipse_tpu_torch.harness.roofline import bytes_per_node
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp

    say(f"== phase 10 (timing): the dtype forms, capped at {TIME_CAP} "
        f"iterations, on {card}")
    grids = {"xl": MAIN_GRID, "streamed": STREAMED_GRID,
             "resident": (800, 1200)}
    forms = {"xl": (("f32", torch.float32, None), ("bf16", BF16, None),
                    ("f32_bf16", torch.float32, "bf16"),
                    ("f32_f16", torch.float32, "f16")),
             "streamed": (("f32", torch.float32, None), ("bf16", BF16, None),
                          ("f32_bf16", torch.float32, "bf16"),
                          ("f32_f16", torch.float32, "f16")),
             "resident": (("f32", torch.float32, None), ("bf16", BF16, None))}
    plains = {"resident": rp.resident_plain, "xl": xp.xl_plain}
    rows = []
    for engine, (m, n) in grids.items():
        # delta = 0: no form stops on the step norm before the cap (a bf16
        # form may still break down earlier; its count is printed)
        problem = Problem(M=m, N=n, max_iter=TIME_CAP, delta=0.0)
        nodes = (m + 1) * (n + 1)
        built = {f: _timed_form(engine, problem, dt, st)
                 for f, dt, st in forms[engine]}
        times = {f: [] for f in built}
        # in turns: f32, the others, the others again, f32
        order = list(built) + list(built)[::-1]
        for f in order:
            solver, args, _ = built[f]
            times[f].append(time_solver(solver, args, 1))
        for f, dt, st in forms[engine]:
            solver, args, iters = built[f]
            ms = statistics.median(times[f]) * 1e3
            per_node = bytes_per_node(engine, problem, cap,
                                      storage_dtype=st, dtype=dt)
            iter_ms, iter_by = bound(per_node * nodes,
                                     WHOLE_FLOPS[engine] * nodes)
            say(f"  {engine} {m}x{n} {f}: {ms:.3f} ms for {iters} "
                f"iterations, {ms * 1e3 / iters:.2f} us/iter; bound "
                f"{iter_ms * 1e3:.2f} us/iter ({per_node:g} B a node, "
                f"{iter_by})")
            if f == "f32":
                continue
            if engine == "streamed":
                plan = sp.StreamPlan(problem, cap, dt)
                plain = lambda: sp.streamed_plain(problem, *args,
                                                  zstate=plan.zstate)
            else:
                plain = lambda fn=plains[engine]: fn(problem, *args)
            plain_ms = time_solver(lambda: plain(), (), 1) * 1e3
            item = dt.itemsize
            load = NARROW[st].itemsize if st else item
            arrays = (5 * item if engine == "resident"
                      else 3 * load + item)  # the operands and r0, read
            solve_ms, solve_by = bound((arrays + item) * nodes,
                                       iters * WHOLE_FLOPS[engine] * nodes)
            rows.append(dict(
                name=f"{engine}_{f}", route="cuda",
                source=f"poisson_ellipse_tpu_torch/csrc/{engine}_pcg.cu",
                replaces=WHOLE_REPLACES[engine], ms=ms, plain_ms=plain_ms,
                bound_ms=solve_ms, bound_by=solve_by, library_ms=None,
                us_per_iter=ms * 1e3 / iters,
                bound_us_per_iter=iter_ms * 1e3, iters=iters,
                grid=[m + 1, n + 1]))
            say(f"    plain {plain_ms:.1f} ms; bound {solve_ms:.3f} ms a "
                f"solve ({solve_by})")

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    g1, g2 = problem.node_shape
    nodes = g1 * g2
    h1, h2 = problem.h1, problem.h2
    rng = np.random.default_rng(3)
    for dt, tag in ((torch.float32, "f32"), (BF16, "bf16")):
        an, as_, bw, be, d, dinv = fp.fused_operands(problem, dt, "cuda")
        z, p, w, r = (torch.from_numpy(rng.standard_normal((g1, g2)))
                      .to("cuda").to(dt) for _ in range(4))
        partials = torch.empty(fp.scratch_len(g1, g2),
                               dtype=fp.partials_dtype(dt), device="cuda")
        scal = torch.tensor([1.5, 0.7, float("inf"), 0.0, 0.3], dtype=dt,
                            device="cuda")
        flags = torch.zeros(fp.N_FLAGS, dtype=torch.int32, device="cuda")
        pn, ap, zz = (torch.empty_like(z) for _ in range(3))
        never = 2**31 - 1

        def k1(fn=fp.k1):
            fn(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials,
               max_iter=never, h1=h1, h2=h2)

        def k2(fn=fp.k2):
            fn(w, r, pn, ap, dinv, zz, scal, flags, partials, max_iter=never,
               h1=h1, h2=h2, delta=0.0, weighted=True)

        item = dt.itemsize
        for name, fn, plain, passes, flops, line in (
                ("fused_k1", k1, lambda: k1(fp.k1_plain), 9, 15, 112),
                ("fused_k2", k2, lambda: k2(fp.k2_plain), 8, 10, 152)):
            ms = time_ms(fn, 200)
            plain_ms = time_ms(plain, 20)
            bound_ms, bound_by = bound(passes * nodes * item, flops * nodes)
            say(f"  {name} {tag} {g1}x{g2}: {ms * 1e3:.1f} us/launch, plain "
                f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
                f"({bound_by})")
            if tag == "bf16":
                rows.append(dict(
                    name=f"{name}_bf16", route="cuda",
                    source="poisson_ellipse_tpu_torch/csrc/fused_pcg.cu",
                    replaces=f"poisson_ellipse_tpu/ops/fused_pcg.py:{line}",
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None))
    return rows


# -- phase 11: the mesh -------------------------------------------------------

# one rank's block of 2401x3201 on 2x2, and 13x17 (14x18 nodes) on 2x4
SHARD_BLOCKS = ((1201, 1601), (7, 5))
SHARD_GRID = (2400, 3200)
# operations per node: pn at the 5 points (10), the stencil tree (18), the
# product and its sum (2); K2's updates, products and sums
K1_SHARD_FLOPS = 30
K2_SHARD_FLOPS = 10
# run_once jobs on 2x2: (engine, dtype, grid, oracle iterations)
MESH_RUNS = (("fused", "f32", (400, 600), 546), ("xla", "f32", (400, 600), 546),
             ("pallas", "f32", (400, 600), 546),
             ("fused", "f32", (800, 1200), 989),
             ("xla", "f32", (800, 1200), 989),
             ("fused", "f32", SHARD_GRID, MAIN_ITERS))
MESH_KERNELS = {"fused": ("fused_sharded_k1", "fused_sharded_k2"),
                "pallas": ("stencil",), "xla": ()}


def shard_inputs(bm: int, bn: int, seed: int):
    """One rank's halo-extended windows and owned blocks, numpy-seeded; d
    is zero on the block's first row and column (the ring)."""
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp

    rng = np.random.default_rng(seed)

    def f32(shape, lo=None):
        x = (rng.random(shape) + lo if lo is not None
             else rng.standard_normal(shape))
        return torch.from_numpy(x.astype(np.float32)).to("cuda")

    ext, blk = (bm + 2, bn + 2), (bm, bn)
    d = f32(blk, lo=1.0)
    d[0, :] = 0.0
    d[:, 0] = 0.0
    scal = torch.zeros(fp.N_SCAL, device="cuda")
    scal[fp.SCAL_BETA], scal[fp.SCAL_ZR], scal[fp.SCAL_DENOM] = 0.7, 1.5, 2.5
    return dict(z=f32(ext), p=f32(ext), a=f32(ext, lo=0.5),
                b=f32(ext, lo=0.5), d=d,
                dinv=torch.where(d != 0, 1.0 / d, torch.zeros_like(d)),
                w=f32(blk), r=f32(blk), scal=scal,
                flags=torch.zeros(fp.N_FLAGS, dtype=torch.int32,
                                  device="cuda"))


def _shard_pair(inp, k1, k2, parts, h1, h2, max_iter=2**31 - 1):
    """K1 then K2 (or their plain versions) on ``inp``: (pn, ap, w, r, z,
    K1's rank sum, K2's two rank sums), sums in double."""
    bm, bn = inp["d"].shape
    pn = torch.full((bm, bn), 7.0, device="cuda")
    ap = torch.full((bm, bn), 7.0, device="cuda")
    k1(inp["z"], inp["p"], inp["a"], inp["b"], inp["d"], pn, ap, inp["scal"],
       inp["flags"], parts[0], max_iter=max_iter, h1=h1, h2=h2)
    w, r = inp["w"].clone(), inp["r"].clone()
    z = torch.full((bm, bn), 7.0, device="cuda")
    k2(w, r, pn, ap, inp["dinv"], z, inp["scal"], inp["flags"], parts[1],
       max_iter=max_iter)
    torch.cuda.synchronize()
    return pn, ap, w, r, z, parts[0].sum(), parts[1].sum(0)


def phase_shard_kernels(seed: int) -> dict:
    """K1-shard and K2-shard bitwise their plain versions, rank sums equal
    once rounded to f32, and no writes after the exit."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs

    say("== phase 11: K1-shard and K2-shard against their plain versions")
    problem = Problem(M=SHARD_GRID[0], N=SHARD_GRID[1])
    h1, h2 = problem.h1, problem.h2
    errs = {fs.K1: 0.0, fs.K2: 0.0}
    for bm, bn in SHARD_BLOCKS:
        inp = shard_inputs(bm, bn, seed)
        got = _shard_pair(inp, fs.k1, fs.k2, fs.scratch(bm, bn, "cuda"), h1,
                          h2)
        one = (torch.zeros(1, dtype=torch.float64, device="cuda"),
               torch.zeros((1, 2), dtype=torch.float64, device="cuda"))
        want = _shard_pair(inp, fs.k1_plain, fs.k2_plain, one, h1, h2)
        for name, kernel, i in (("pn", fs.K1, 0), ("ap", fs.K1, 1),
                                ("w", fs.K2, 2), ("r", fs.K2, 3),
                                ("z", fs.K2, 4)):
            err = max_abs(got[i], want[i])
            errs[kernel] = max(errs[kernel], err)
            say(f"  {kernel} {bm}x{bn} {name}: max_abs_err {err:.3e} "
                f"bitwise={torch.equal(got[i], want[i])}")
            require(torch.equal(got[i], want[i]),
                    f"{kernel} {name} at {bm}x{bn} is not bitwise its plain "
                    "version's")
        for kernel, g, wv in ((fs.K1, got[5][None], want[5][None]),
                              (fs.K2, got[6], want[6])):
            gap = float((g - wv).abs().max())
            say(f"  {kernel} {bm}x{bn} rank sums: kernel {g.tolist()} plain "
                f"{wv.tolist()}, double gap {gap:.3e}")
            require(torch.equal(g.float(), wv.float()),
                    f"{kernel} rank sums at {bm}x{bn} differ once rounded "
                    "to f32")
        require(bool(torch.all(got[1][0, :] == 0) & torch.all(got[1][:, 0]
                                                              == 0)),
                "K1-shard wrote a nonzero ap where d is 0")
    # after the exit neither kernel writes
    inp = shard_inputs(*SHARD_BLOCKS[0], seed)
    inp["flags"][fp.FLAG_CONVERGED] = 1
    parts = fs.scratch(*SHARD_BLOCKS[0], "cuda")
    parts[0].fill_(3.0)
    parts[1].fill_(3.0)
    pn, ap, w, r, z, _, _ = _shard_pair(inp, fs.k1, fs.k2, parts, h1, h2)
    require(bool(torch.all(pn == 7.0) & torch.all(ap == 7.0)
                 & torch.all(z == 7.0)) and torch.equal(w, inp["w"])
            and torch.equal(r, inp["r"]) and bool(torch.all(parts[0] == 3.0))
            and bool(torch.all(parts[1] == 3.0)),
            "K1-shard or K2-shard wrote after the loop's exit")
    say("  no writes after the exit: ok")
    return errs


def _check_mesh_report(label: str, report, want_iters: int, engine: str,
                       exact: bool = False) -> None:
    say(f"  {label}: {report.iters} iterations, converged {report.converged},"
        f" l2 {report.l2_error:.3e}, mesh {report.mesh_shape}, backend "
        f"{report.backend}, T_solver {report.t_solver:.5f} s, {report.bodies}"
        f" bodies, {report.host_syncs} host reads; rank launches "
        f"{report.rank_launches}; rank collectives "
        f"{report.rank_collectives}")
    ok_iters = (report.iters == want_iters if exact
                else abs(report.iters - want_iters) <= ITERS_ABS)
    require(report.converged and ok_iters,
            f"{label}: {report.iters} iterations, want {want_iters}"
            + ("" if exact else f" +- {ITERS_ABS}"))
    require(report.l2_error < 1e-3, f"{label}: l2 {report.l2_error}")
    bodies = report.bodies
    for rank, (launches, colls) in enumerate(zip(report.rank_launches,
                                                 report.rank_collectives)):
        want = {k: bodies for k in MESH_KERNELS[engine]}
        require(launches == want, f"{label}: rank {rank} launched "
                f"{launches}, want {want} (once per issued body)")
        require(colls == {"halo": bodies + 2, "reduce": 2 * bodies + 1},
                f"{label}: rank {rank} made {colls}, want 1 halo exchange "
                "and 2 reductions a body (and the 2 coefficient halos and "
                "zr0's reduction once)")
    require(len(report.rank_launches) == report.mesh_shape[0]
            * report.mesh_shape[1], f"{label}: not every rank reported")
    d = report.json_dict()
    require(d["mesh"] == list(report.mesh_shape) and "backend" in d,
            f"{label}: the report does not name the mesh and the backend")


def phase_mesh(card: str) -> dict:
    """The sharded path through the harness entry point: 1x1 over NCCL,
    2x2 ranks sharing the card over gloo, and the command line on 1x2."""
    from poisson_ellipse_tpu_torch.harness.run import run_once
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.parallel import multihost

    say(f"== phase 11: the mesh through the harness ({card})")
    t0 = time.perf_counter()
    one = run_once(Problem(M=SHARD_GRID[0], N=SHARD_GRID[1]), mode="sharded",
                   engine="fused", mesh_shape=(1, 1))
    require(one.backend == "nccl", f"the 1x1 mesh took {one.backend}, not "
            "NCCL")
    _check_mesh_report("fused 1x1 2400x3200", one, MAIN_ITERS, "fused")
    # one spawn of the four ranks for every 2x2 run and the profile
    jobs = [(run_once, (Problem(M=g[0], N=g[1]),),
             dict(mode="sharded", dtype=dt, engine=e, mesh_shape=(2, 2),
                  device="cuda"))
            for e, dt, g, _ in MESH_RUNS]
    jobs.append((profile_rank, (Problem(M=400, N=600), "fused"), {}))
    *reports, profiled = multihost.spawn(multihost.run_jobs, 4, (jobs,))
    counts = {}
    for (e, dt, g, want), report in zip(MESH_RUNS, reports):
        require(report.backend == "gloo", f"2x2 on one card took "
                f"{report.backend}, not gloo")
        _check_mesh_report(f"{e} 2x2 {g[0]}x{g[1]}", report, want, e)
        if (e, g) == ("fused", SHARD_GRID):
            counts = report.rank_launches[0]
    out = subprocess.run(
        [sys.executable, "-m", "poisson_ellipse_tpu_torch.harness", "40",
         "40", "--mode", "sharded", "--mesh", "1", "2", "--dtype", "f64",
         "--json"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    require(out.returncode == 0, f"the command line on 1x2 exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    say(f"  command line f64 xla 1x2 40x40: {rec}")
    require(rec["iters"] == 50 and rec["converged"] and rec["mesh"] == [1, 2]
            and rec["backend"] == "gloo" and rec["engine"] == "xla",
            "the command line on 1x2 did not give exactly 50 over gloo")
    say(f"  T_solver on {card}: fused 1x1 NCCL 2400x3200 "
        f"{one.t_solver:.5f} s; 2x2 gloo: " + ", ".join(
            f"{e} {g[0]}x{g[1]} {r.t_solver:.5f} s"
            for (e, _, g, _), r in zip(MESH_RUNS, reports)))
    say(f"  phase 11 runs took {time.perf_counter() - t0:.1f} s")
    show_mesh_profile(profiled, card)
    return {"counts": counts, "one": one, "reports": reports}


def profile_rank(problem, engine: str) -> dict:
    """One sharded solve under torch.profiler on this rank (every rank runs
    it together; ``multihost.run_jobs``): wall time, device busy time,
    device time by kernel and host time by operation."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
        build_sharded_solver,
    )

    mesh = make_mesh(device="cuda")
    solver, args = build_sharded_solver(problem, mesh, torch.float32,
                                        stencil_impl=engine)
    solver(*args, limit=64)  # warm-up, as run_once's
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = device.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    host = sorted(((e.key, e.count, e.self_cpu_time_total)
                   for e in prof.key_averages()), key=lambda x: -x[2])[:8]
    return dict(wall_us=wall_us, bodies=solver.bodies,
                busy_us=sum(t for _, t in device.values()),
                device=sorted(device.items(), key=lambda kv: -kv[1][1])[:6],
                host=host)


def show_mesh_profile(prof: dict, card: str) -> None:
    """Where the time of one 2x2 fused run goes: rank 0 under the
    profiler, four ranks sharing the card over gloo."""
    say(f"== phase 11 (profile): fused 2x2 400x600, rank 0 ({card})")
    wall, busy = prof["wall_us"], prof["busy_us"]
    if not prof["device"]:
        say("  device time not measured (no device events)")
        return
    say(f"  wall {wall / 1e3:.2f} ms (profiler on), {prof['bodies']} bodies,"
        f" {wall / prof['bodies']:.1f} us a body; device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}")
    for name, (n, us) in prof["device"]:
        say(f"    device {us / 1e3:9.2f} ms {n:7d} x {us / n:8.2f} us  "
            f"{name[:80]}")
    for name, n, us in prof["host"]:
        say(f"    host   {us / 1e3:9.2f} ms {n:7d} x {us / max(n, 1):8.2f} us"
            f"  {name[:80]}")


def phase_shard_timing(seed: int, card: str) -> list:
    """K1-shard and K2-shard with CUDA events at the 1201x1601 block, beside
    their plain versions and bounds."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs

    bm, bn = SHARD_BLOCKS[0]
    say(f"== phase 11 (timing): K1-shard and K2-shard at {bm}x{bn} on {card}")
    problem = Problem(M=SHARD_GRID[0], N=SHARD_GRID[1])
    inp = shard_inputs(bm, bn, seed)
    parts = fs.scratch(bm, bn, "cuda")
    one = (torch.zeros(1, dtype=torch.float64, device="cuda"),
           torch.zeros((1, 2), dtype=torch.float64, device="cuda"))
    pn, ap = torch.empty((bm, bn), device="cuda"), torch.empty((bm, bn),
                                                                device="cuda")
    w, r, z = inp["w"].clone(), inp["r"].clone(), torch.empty_like(pn)
    never = 2**31 - 1

    def k1(fn=fs.k1, p=parts[0]):
        fn(inp["z"], inp["p"], inp["a"], inp["b"], inp["d"], pn, ap,
           inp["scal"], inp["flags"], p, max_iter=never, h1=problem.h1,
           h2=problem.h2)

    def k2(fn=fs.k2, p=parts[1]):
        fn(w, r, pn, ap, inp["dinv"], z, inp["scal"], inp["flags"], p,
           max_iter=never)

    n, n_ext = bm * bn, (bm + 2) * (bn + 2)
    n1, n2 = fs.partial_counts(bm, bn)
    rows = []
    for name, fn, plain, nbytes, flops, line in (
            (fs.K1, k1, lambda: k1(fs.k1_plain, one[0]),
             4 * (4 * n_ext + 3 * n) + 8 * n1, K1_SHARD_FLOPS * n, 179),
            (fs.K2, k2, lambda: k2(fs.k2_plain, one[1]),
             4 * 8 * n + 16 * n2, K2_SHARD_FLOPS * n, 207)):
        ms = time_ms(fn, 200)
        plain_ms = time_ms(plain, 20)
        bound_ms, bound_by = bound(nbytes, flops)
        say(f"  {name} {bm}x{bn}: {ms * 1e3:.1f} us/launch, plain "
            f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({bound_by}), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        rows.append(dict(
            name=name, route="cuda",
            source="poisson_ellipse_tpu_torch/csrc/fused_sharded.cu",
            replaces=f"poisson_ellipse_tpu/parallel/fused_sharded.py:{line}",
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    return rows


# -- phase 12: the stage-4 kernels and the bf16 kernel loops ----------------

# the reference's stage-4 loop at 400x600: f32 held to the oracle +-2, f64
# to the port's f64 xla count on the card, exactly
STAGE4_GRID = (400, 600)
STAGE4_SUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# dot and update_p beyond 2401x3201: (g1, g2, x's offset, y's offset) in
# elements past an aligned buffer; one offset alone puts the operands in
# different alignment classes (the kernels' scalar loop)
STAGE4_SHAPES = ((1, 1, 0, 0), (3, 5, 0, 0), (401, 601, 0, 0),
                 (401, 601, 1, 1), (401, 601, 1, 0), (2401, 3201, 1, 1))
# input sets the stage-4 timing rotates over: a kernel's operands in all
# sets (>= 184 MB at 2401x3201 f32) outsize the 50 MB L2
STAGE4_SETS = 3
# the one PyTorch call of each stage-4 kernel's function, where there is
# one (timed beside the kernel, called nowhere in the port)
LIBRARY_CALLS = {"dot": "torch.dot", "update_p": "torch.add(alpha=beta)"}
# per node: dinv 1 division; dot a product and a sum; update_w_r two
# products, three sums, the increment's square and its sum; update_p 2
STAGE4_KERNELS = (
    # name, pallas_call line, passes, operations a node
    ("dinv", 570, 3, 1),
    ("dot", 610, 2, 2),
    ("update_w_r", 662, 6, 7),
    ("update_p", 699, 3, 2),
)
# bf16 compute on the single-device kernel loops: pallas uncapped at
# 400x600 (the JAX package's CPU run: 290 iterations, converged, diff
# 3.67e-7), the three kernel loops capped for their time per iteration
BF16_LOOP_CAP = 256
JAX_BF16_PALLAS_400x600 = 290
BF16_LOOPS = ("pallas", "pipelined-pallas", "sstep-pallas")


def stage4_inputs(dtype, seed: int) -> dict:
    """numpy-seeded operands of the stage-4 kernels at the 2401x3201 node
    grid, on the card; D has a tenth of its nodes at 0 (dinv's guard)."""
    rng = np.random.default_rng(seed)
    g = (MAIN_GRID[0] + 1, MAIN_GRID[1] + 1)
    out = {k: torch.from_numpy(rng.standard_normal(g)).to("cuda", dtype)
           for k in ("w", "r", "p", "ap", "z", "x", "y")}
    d = rng.random(g) + 0.5
    d[rng.random(g) < 0.1] = 0.0
    out["d"] = torch.from_numpy(d).to("cuda", dtype)
    out["alpha"] = torch.tensor(0.37, dtype=dtype, device="cuda")
    out["beta"] = torch.tensor(0.9, dtype=dtype, device="cuda")
    return out


def stage4_solve(problem, a, b, rhs, stencil):
    """The reference's stage-4 iteration (its solver loop,
    poisson_mpi_cuda2.cu:992-1034, with the semantics of solver.pcg)
    composed from ``stencil`` and the four stage-4 dispatchers, not an
    engine: (w, iterations, converged). The stopping test reads the device
    once an iteration, as the reference's host loop does."""
    from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4
    from poisson_ellipse_tpu_torch.ops.stencil import diag_d, spacing
    from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD

    h1, h2 = problem.h1, problem.h2
    hw = spacing(h1, rhs) * spacing(h2, rhs)
    d = diag_d(a, b, spacing(h1, rhs), spacing(h2, rhs))
    w, r = torch.zeros_like(rhs), rhs.clone()
    z = s4.apply_dinv_pallas(r, d)
    p = z
    zr = s4.dot_pallas(z, r, h1, h2)
    for k in range(1, problem.max_iterations + 1):
        ap = stencil(p, a, b, h1, h2)
        denom = s4.dot_pallas(ap, p, h1, h2)
        alpha = zr / denom
        w_new, r_new, dw2 = s4.update_w_r_pallas(alpha, w, r, p, ap)
        z = s4.apply_dinv_pallas(r_new, d)
        zr_new = s4.dot_pallas(z, r_new, h1, h2)
        diff = (torch.sqrt(dw2 * hw) if problem.norm == "weighted"
                else torch.sqrt(dw2))
        broke, done = (bool(v) for v in torch.stack(
            [denom < DENOM_GUARD, diff < problem.delta]).tolist())
        if broke:
            return w, k - 1, False
        w, r = w_new, r_new
        if done:
            return w, k, True
        p = s4.update_p_pallas(zr_new / zr, z, p)
        zr = zr_new
    return w, problem.max_iterations, False


def phase_stage4_kernels(seed: int) -> dict:
    """Each stage-4 kernel against its plain version at 2401x3201, f32 and
    f64: arrays bitwise, dot and dw2 within rel 1e-6 / 1e-12, two
    launches the same bits. dot and update_p also at the small and
    unaligned STAGE4_SHAPES, one device kernel a call, and a launch
    captured in a CUDA graph equal to an eager one."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4

    say("== phase 12: the stage-4 kernels against their plain versions, "
        "2401x3201, f32 and f64")
    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    h1, h2 = problem.h1, problem.h2
    errs = {name: 0.0 for name, *_ in STAGE4_KERNELS}
    for dtype in (torch.float32, torch.float64):
        inp = stage4_inputs(dtype, seed)
        tag = s4.DTYPES[dtype]
        rtol = STAGE4_SUM_RTOL[dtype]

        def bitwise(kernel, label, got, want):
            same = torch.equal(got, want)
            err = max_abs(got, want)
            say(f"  {label} {tag}: max_abs_err {err:.3e} bitwise={same}")
            require(same, f"{label} {tag} differs from its plain version")
            errs[kernel] = max(errs[kernel], err)

        def close(kernel, label, got, want):
            g, w = float(got), float(want)
            rel = abs(g - w) / max(abs(w), 1e-300)
            say(f"  {label} {tag}: kernel {g!r} plain {w!r} rel {rel:.3e}")
            require(math.isfinite(g) and rel <= rtol,
                    f"{label} {tag} differs beyond rel {rtol}")
            errs[kernel] = max(errs[kernel], abs(g - w))

        z = s4.apply_dinv_pallas(inp["r"], inp["d"])
        bitwise("dinv", "dinv", z, s4.apply_dinv_plain(inp["r"], inp["d"]))
        require(bool((z[inp["d"] == 0] == 0).all()),
                "dinv is not 0 where D is 0")
        got = s4.dot_pallas(inp["x"], inp["y"], h1, h2)
        again = s4.dot_pallas(inp["x"], inp["y"], h1, h2)
        close("dot", "dot", got, s4.dot_plain(inp["x"], inp["y"], h1, h2))
        require(torch.equal(got, again), f"dot {tag}: two launches differ")
        args = (inp["alpha"], inp["w"], inp["r"], inp["p"], inp["ap"])
        got = s4.update_w_r_pallas(*args)
        want = s4.update_w_r_plain(*args)
        bitwise("update_w_r", "update_w_r w", got[0], want[0])
        bitwise("update_w_r", "update_w_r r", got[1], want[1])
        close("update_w_r", "update_w_r dw2", got[2], want[2])
        require(torch.equal(got[2], s4.update_w_r_pallas(*args)[2]),
                f"update_w_r {tag}: two launches differ in dw2")
        args = (inp["beta"], inp["z"], inp["p"])
        bitwise("update_p", "update_p", s4.update_p_pallas(*args),
                s4.update_p_plain(*args))

        rng = np.random.default_rng(seed + 1)
        for g1, g2, off_x, off_y in STAGE4_SHAPES:
            label = f"{g1}x{g2} offsets ({off_x}, {off_y})"
            x, y = (offset_view(rng, (g1, g2), dtype, off)
                    for off in (off_x, off_y))
            got = s4.dot_pallas(x, y, h1, h2)
            close("dot", f"dot {label}", got, s4.dot_plain(x, y, h1, h2))
            require(torch.equal(got, s4.dot_pallas(x, y, h1, h2)),
                    f"dot {tag} {label}: two launches differ")
            bitwise("update_p", f"update_p {label}",
                    s4.update_p_pallas(inp["beta"], x, y),
                    s4.update_p_plain(inp["beta"], x, y))

        x, y = inp["x"], inp["y"]
        calls = {"dot": lambda: s4.dot_pallas(x, y, h1, h2),
                 "update_p": lambda: s4.update_p_pallas(inp["beta"], x, y)}
        for name, fn in calls.items():
            for warm in (True, False):
                eager, captured = graph_and_eager(fn, warm)
                require(torch.equal(eager, captured),
                        f"{name} {tag}: the launch captured in a CUDA graph "
                        f"(warm-up on its stream: {warm}) differs from the "
                        "eager one")
            say(f"  {name} {tag}: graph replay == eager launch (with and "
                "without a warm-up on the capture stream)")
    for label, acts in child_activities("count_stage4_activities").items():
        say(f"  {label}: {acts} device activities a call (a fresh process)")
        require(acts == 1, f"{label}: {acts} device activities a call, not "
                "one kernel")
    torch.cuda.synchronize()
    return errs


def child_activities(counter: str) -> dict:
    """{label: n}: the device activities a call issues, counted by this
    script's ``counter`` (``count_stage4_activities``,
    ``count_kd_activities``) in a child process. In the process that has
    run the earlier phases (the mesh's, a dozen profiles) the profiler
    recorded no device activity at all on the H100."""
    code = ("import json, chip_smoke; "
            f"print(json.dumps(chip_smoke.{counter}()))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    require(res.returncode == 0, f"{counter} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def count_kd_activities() -> dict:
    """``device_activities`` of one call of each K-d-family entry on the
    pipelined bundle, after a first call on the stream: K-d f32 and bf16
    and K-h bf16 and f16 at 2401x3201, K-f at 401x601 with B = 32."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    g = (MAIN_GRID[0] + 1, MAIN_GRID[1] + 1)
    h1, h2 = 2.0 / MAIN_GRID[0], 1.2 / MAIN_GRID[1]
    counts = {}

    def ones(shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device="cuda")

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        w, a, b = (ones(g, dtype) for _ in range(3))
        pairs = _bundle(*(ones(g, dtype) for _ in range(5)))
        counts[f"K-d {tag}"] = device_activities(
            lambda: hk.apply_a_dots_kernel(w, a, b, h1, h2, pairs))
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        m = ones(g)
        a, b = ones(g, dtype), ones(g, dtype)
        pairs = _bundle(*(ones(g, dtype) for _ in range(5)))
        counts[f"K-h {tag}"] = device_activities(
            lambda: hk.apply_a_dots_mixed_kernel(m, a, b, h1, h2, pairs))
    (m_, n_), lanes = QUEUE_BATCH
    gb = (lanes, m_ + 1, n_ + 1)
    w, a, b = ones(gb), ones(gb[1:]), ones(gb[1:])
    pairs = _bundle(*(ones(gb) for _ in range(5)))
    counts[f"K-f B={lanes}"] = device_activities(
        lambda: hk.apply_a_dots_batched_kernel(w, a, b, 2.0 / m_, 1.2 / n_,
                                               pairs))
    return counts


def count_stage4_activities() -> dict:
    """``device_activities`` of one call of dot and of update_p at
    2401x3201, f32 and f64, after a first call on the stream."""
    from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4

    g = (MAIN_GRID[0] + 1, MAIN_GRID[1] + 1)
    counts = {}
    for dtype in (torch.float32, torch.float64):
        x, y = (torch.ones(g, dtype=dtype, device="cuda") for _ in range(2))
        beta = torch.tensor(0.9, dtype=dtype, device="cuda")
        tag = s4.DTYPES[dtype]
        counts[f"dot {tag}"] = device_activities(
            lambda: s4.dot_pallas(x, y, 0.1, 0.2))
        counts[f"update_p {tag}"] = device_activities(
            lambda: s4.update_p_pallas(beta, x, y))
    return counts


def offset_view(rng, shape, dtype, offset: int) -> torch.Tensor:
    """numpy-seeded values of ``shape`` on the card, as a contiguous view
    that starts ``offset`` elements into its buffer (unaligned for 1)."""
    n = shape[0] * shape[1]
    flat = torch.from_numpy(rng.standard_normal(n + offset)).to("cuda",
                                                                dtype)
    return flat[offset:].view(shape)


def graph_and_eager(fn, warm: bool):
    """(eager result, result of the same call captured in a CUDA graph on a
    new stream and replayed twice); ``warm`` runs the call on that stream
    before the capture."""
    eager = fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    if warm:
        with torch.cuda.stream(stream):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured.clone()


def phase_stage4_loop() -> dict:
    """The stage-4 iteration composed from K-a and the four kernels at
    400x600: f32 within +-2 of 546, f64 (the plain stencil: K-a has no f64
    form) exactly the port's f64 xla count on the card. Launch counts of
    the f32 run, set to 0 just before it and read just after."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import _build, assembly
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.solver.engine import build_solver
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=STAGE4_GRID[0], N=STAGE4_GRID[1])
    say(f"== phase 12: the stage-4 loop at {problem.M}x{problem.N} from K-a "
        "and the four stage-4 kernels")
    oracle = LARGE[STAGE4_GRID]
    a, b, rhs = assembly.assemble(problem, torch.float32, "cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    w, iters, converged = stage4_solve(problem, a, b, rhs, hk.apply_a_kernel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    l2 = float(l2_error_vs_analytic(problem, w))
    want = {"stencil": iters, "dinv": iters + 1, "dot": 2 * iters + 1,
            "update_w_r": iters, "update_p": iters - 1}
    say(f"  f32: {iters} iterations, converged {converged}, l2 {l2:.6e}, "
        f"{wall:.3f} s (a host read an iteration), launches {launches}")
    require(converged and abs(iters - oracle) <= ITERS_ABS,
            f"stage-4 loop f32: {iters} iterations, outside {oracle} "
            f"+-{ITERS_ABS}")
    require(math.isfinite(l2) and l2 < 1e-3, "stage-4 loop f32: l2 error")
    require(launches == want, f"stage-4 loop launches {launches}, expected "
            f"{want}")

    a, b, rhs = assembly.assemble(problem, torch.float64, "cuda")
    w64, iters64, conv64 = stage4_solve(problem, a, b, rhs, hk.apply_a_plain)
    solver, args, _ = build_solver(problem, "xla", torch.float64, "cuda")
    ref = solver(*args)
    gap = max_abs(w64, ref.w)
    say(f"  f64: {iters64} iterations, converged {conv64}; xla f64 "
        f"{int(ref.iters)}; max|w - w_xla| {gap:.3e}")
    require(conv64 and iters64 == int(ref.iters) == oracle,
            f"stage-4 loop f64: {iters64} iterations, xla f64 "
            f"{int(ref.iters)}, oracle {oracle}")
    counts = {k: v for k, v in launches.items() if k != "stencil"}
    return dict(counts=counts)


def phase_bf16_kernels(seed: int) -> dict:
    """K-a's and K-d's bf16 forms against their plain versions at
    2401x3201 on the bf16 operands and seeded iterates: arrays bitwise,
    sums bitwise (both rounded once from double)."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import assembly
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say("== phase 12: K-a and K-d bf16 forms against their plain versions, "
        "2401x3201")
    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    h1, h2 = problem.h1, problem.h2
    a, b, _ = assembly.assemble(problem, torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed)
    vecs = [torch.from_numpy(rng.standard_normal(a.shape)).to(
        "cuda", torch.bfloat16) for _ in range(6)]
    w, pairs = vecs[0], _bundle(*vecs[1:])
    errs = {}

    def bits(name, got, want):
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        err = max_abs(got, want)
        say(f"  {name}: max_abs_err {err:.3e} bitwise={same}")
        require(got.dtype == torch.bfloat16 and same,
                f"{name} differs from its plain version")
        return err

    errs["stencil_bf16"] = max(
        bits("K-a bf16 (full grid)", hk.apply_a_kernel(w, a, b, h1, h2),
             hk.apply_a_plain(w, a, b, h1, h2)),
        bits("K-a bf16 (block)", hk.apply_a_block_kernel(w, a, b, h1, h2),
             hk.apply_a_block_plain(w, a, b, h1, h2)))
    for kind, w0 in signed_zero_inputs(w, seed=3).items():
        bits(f"K-a bf16 (full grid) on {kind}",
             hk.apply_a_kernel(w0, a, b, h1, h2),
             hk.apply_a_plain(w0, a, b, h1, h2))
        bits(f"K-a bf16 (block) on {kind}",
             hk.apply_a_block_kernel(w0, a, b, h1, h2),
             hk.apply_a_block_plain(w0, a, b, h1, h2))
    n, sums = hk.apply_a_dots_kernel(w, a, b, h1, h2, pairs)
    n_p, sums_p = hk.apply_a_dots_plain(w, a, b, h1, h2, pairs)
    errs["stencil_dots_bf16"] = max(bits("K-d bf16 n", n, n_p),
                                    bits("K-d bf16 sums", sums, sums_p))
    gen_n, gen_sums = hk.apply_a_dots_kernel(w, a, b, h1, h2, swapped(pairs))
    require(same_bits(gen_n, n) and same_bits(gen_sums, sums),
            "K-d bf16: the generic instantiation differs from the bundle's")
    require(torch.equal(n, hk.apply_a_kernel(w, a, b, h1, h2)),
            "K-d bf16's n is not K-a bf16's")
    torch.cuda.synchronize()
    return errs


def expected_bf16_launches(engine: str, iters: int, limit: int,
                           chunk: int = 64) -> dict:
    """The launches of a bf16 kernel loop that took ``iters`` iterations
    under the cap ``limit``, the host reading once per ``chunk``: every
    issued body launches K-a bf16 once (pallas) or K-d bf16 once with K-a
    bf16 for w0 and four times a rebuild, every 8 iterations
    (pipelined-pallas), or K-a bf16 2s-1 times a block plus once a
    replacement (sstep-pallas)."""
    from poisson_ellipse_tpu_torch.ops.precision import replace_every
    from poisson_ellipse_tpu_torch.ops.sstep_pcg import replaces

    cadence = replace_every(None, torch.bfloat16)
    issued = min(limit, chunk * -(-iters // chunk))
    if engine == "pallas":
        return {"stencil_bf16": issued}
    if engine == "pipelined-pallas":
        return {"stencil_bf16": 1 + 4 * ((issued - 1) // cadence),
                "stencil_dots_bf16": issued}
    starts = range(0, issued, SSTEP_S)
    return {"stencil_bf16": (2 * SSTEP_S - 1) * len(starts)
            + sum(replaces(k, SSTEP_S, cadence) for k in starts)}


def phase_bf16_loops(card: str) -> dict:
    """bf16 pallas at 400x600 through build_solver, beside xla bf16 on the
    card; the three kernel loops at 2400x3200 capped at BF16_LOOP_CAP:
    launches a body and the time an iteration beside f32's."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.solver.engine import build_solver
    from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

    problem = Problem(M=400, N=600)
    say(f"== phase 12: bf16 pallas at {problem.M}x{problem.N} ({card})")
    solver, args, resolved = build_solver(problem, "pallas", torch.bfloat16,
                                          "cuda")
    result, launches = _run_counted(solver, args)
    iters = int(result.iters)
    l2 = float(l2_error_vs_analytic(problem, result.w))
    xla_solver, xla_args, _ = build_solver(problem, "xla", torch.bfloat16,
                                           "cuda")
    ref = xla_solver(*xla_args)
    say(f"  pallas bf16: {iters} iterations, converged "
        f"{bool(result.converged)}, breakdown {bool(result.breakdown)}, l2 "
        f"{l2:.6e}, launches {launches}; xla bf16 on the card "
        f"{int(ref.iters)} iterations, converged {bool(ref.converged)}, l2 "
        f"{float(l2_error_vs_analytic(problem, ref.w)):.6e} (JAX package, "
        f"CPU: {JAX_BF16_PALLAS_400x600} for both)")
    require(resolved == "pallas" and result.w.dtype == torch.bfloat16,
            "pallas bf16 did not run in bf16")
    require(bool(result.converged) and not bool(result.breakdown),
            "pallas bf16 did not converge at 400x600")
    require(math.isfinite(l2) and l2 < BF16_XLA_L2, f"pallas bf16 l2 {l2}")
    want = expected_bf16_launches("pallas", iters, problem.max_iterations)
    require(launches == want, f"pallas bf16 launches {launches}, expected "
            f"{want}")
    counts = dict(launches)

    big = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=BF16_LOOP_CAP)
    say(f"== phase 12: the bf16 kernel loops at {big.M}x{big.N}, capped at "
        f"{BF16_LOOP_CAP} ({card})")
    for engine in BF16_LOOPS:
        times = {}
        for dtype in (torch.bfloat16, torch.float32):
            solver, args, _ = build_solver(big, engine, dtype, "cuda",
                                           sstep_s=SSTEP_S)
            got, launches = _run_counted(solver, args)
            t = time_solver(solver, args, 1)
            iters = int(got.iters)
            times[dtype] = t / iters
            if dtype != torch.bfloat16:
                continue
            want = expected_bf16_launches(engine, iters, BF16_LOOP_CAP)
            say(f"  {engine} bf16: {iters} iterations, converged "
                f"{bool(got.converged)}, breakdown {bool(got.breakdown)}, w "
                f"finite {bool(torch.isfinite(got.w).all())}, launches "
                f"{launches} (predicted {want})")
            require(got.w.dtype == torch.bfloat16, f"{engine}: w not bf16")
            require(launches == want, f"{engine} bf16 launches {launches}")
            if engine == "pipelined-pallas":
                counts.update((k, v) for k, v in launches.items()
                              if k == "stencil_dots_bf16")
        say(f"  {engine}: bf16 {times[torch.bfloat16] * 1e6:.2f} us/iter, "
            f"f32 {times[torch.float32] * 1e6:.2f} us/iter")
    return dict(counts=counts)


def phase_stage4_timing(seed: int, card: str) -> list:
    """The four stage-4 kernels at 2401x3201 f32 (f64 printed) and the two
    bf16 forms beside their bounds and plain versions. Each stage-4 kernel,
    and for dot and update_p the one PyTorch call of the same function,
    three ways on STAGE4_SETS rotated input sets: device time (graph
    replay, ``device_ms``), call time and host time (``call_times``)."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import assembly
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say(f"== phase 12 (timing): the stage-4 kernels and the bf16 forms at "
        f"2401x3201 on {card}")
    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    h1, h2 = problem.h1, problem.h2
    nodes = (MAIN_GRID[0] + 1) * (MAIN_GRID[1] + 1)
    rows = []
    for dtype in (torch.float32, torch.float64):
        base = stage4_inputs(dtype, seed)
        sets = [base] + [{k: v.clone() for k, v in base.items()}
                         for _ in range(STAGE4_SETS - 1)]
        size = torch.empty((), dtype=dtype).element_size()
        beta = float(base["beta"])
        calls = {
            "dinv": (lambda i: s4.apply_dinv_pallas(i["r"], i["d"]),
                     lambda i: s4.apply_dinv_plain(i["r"], i["d"]), None),
            "dot": (lambda i: s4.dot_pallas(i["x"], i["y"], h1, h2),
                    lambda i: s4.dot_plain(i["x"], i["y"], h1, h2),
                    lambda i: torch.dot(i["x"].view(-1), i["y"].view(-1))),
            "update_w_r": (
                lambda i: s4.update_w_r_pallas(i["alpha"], i["w"], i["r"],
                                               i["p"], i["ap"]),
                lambda i: s4.update_w_r_plain(i["alpha"], i["w"], i["r"],
                                              i["p"], i["ap"]),
                None),
            "update_p": (
                lambda i: s4.update_p_pallas(i["beta"], i["z"], i["p"]),
                lambda i: s4.update_p_plain(i["beta"], i["z"], i["p"]),
                lambda i: torch.add(i["z"], i["p"], alpha=beta)),
        }
        tag = s4.DTYPES[dtype]

        def three(label, fn):
            rotated = [(lambda s=s: fn(s)) for s in sets]
            dev = device_ms(rotated)
            call, host = call_times(rotated, 200)
            acts = device_activities(rotated[0])
            say(f"  {label} {tag}: device {dev * 1e3:.2f} us, call "
                f"{call * 1e3:.2f} us, host {host * 1e3:.2f} us, "
                f"{acts if acts > 0 else 'not measured (no profile)'} "
                "device activities a call")
            return dev, call, host

        for name, line, passes, ops in STAGE4_KERNELS:
            fn, plain, library = calls[name]
            ms, call_ms, host_ms = three(name, fn)
            plain_ms = time_ms(lambda: plain(base), 20)
            library_ms = library_call_ms = None
            if library is not None:
                library_ms, library_call_ms, _ = three(
                    f"{name} library ({LIBRARY_CALLS[name]})", library)
            bound_ms, bound_by = bound(passes * size * nodes, ops * nodes)
            lib_txt = ("" if library_ms is None
                       else f", library {library_ms * 1e3:.2f} us "
                            f"({ms / library_ms:.2f}x)")
            say(f"  {name} {tag}: {ms * 1e3:.2f} us/launch (device), plain "
                f"{plain_ms * 1e3:.1f} us{lib_txt}, bound "
                f"{bound_ms * 1e3:.1f} us ({bound_by}, "
                f"{bound_ms / ms:.0%} of it), "
                f"{passes * size * nodes / (ms * 1e-3) / 1e9:.0f} GB/s")
            if dtype == torch.float32:
                rows.append(dict(
                    name=name, route="cuda",
                    source="poisson_ellipse_tpu_torch/csrc/stage4.cu",
                    replaces=f"poisson_ellipse_tpu/ops/pallas_kernels.py:"
                             f"{line}",
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                    call_ms=call_ms, host_ms=host_ms,
                    library_call_ms=library_call_ms))
        del base, sets

    a, b, _ = assembly.assemble(problem, torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed)
    vecs = [torch.from_numpy(rng.standard_normal(a.shape)).to(
        "cuda", torch.bfloat16) for _ in range(6)]
    w, pairs = vecs[0], _bundle(*vecs[1:])
    forms = (
        # name, source, pallas_call line, kernel, plain, bytes, flops
        ("stencil_bf16", "csrc/stencil.cu", 169,
         lambda: hk.apply_a_kernel(w, a, b, h1, h2),
         lambda: hk.apply_a_plain(w, a, b, h1, h2), 4 * 2 * nodes,
         18 * nodes),
        ("stencil_dots_bf16", "csrc/stencil_dots.cu", 299,
         lambda: hk.apply_a_dots_kernel(w, a, b, h1, h2, pairs),
         lambda: hk.apply_a_dots_plain(w, a, b, h1, h2, pairs),
         9 * 2 * nodes, KD_FLOPS * nodes),
    )
    for name, src, line, fn, plain, nbytes, flops in forms:
        ms = time_ms(fn, 200)
        plain_ms = time_ms(plain, 20)
        bound_ms, bound_by = bound(nbytes, flops)
        say(f"  {name}: {ms * 1e3:.1f} us/launch, plain {plain_ms * 1e3:.1f}"
            f" us, bound {bound_ms * 1e3:.1f} us ({bound_by}), "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        rows.append(dict(
            name=name, route="cuda",
            source=f"poisson_ellipse_tpu_torch/{src}",
            replaces=f"poisson_ellipse_tpu/ops/pallas_kernels.py:{line}",
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    return rows


# -- rule 2's queue by device time ------------------------------------------

# the input sets each timed kernel rotates over: K-d's in all sets (740 MB
# at 2401x3201 f32) outsize the 50 MB L2
QUEUE_SETS = 3
# each kernel's launches on its path, from the whole script's kernels line
# (K-d: pipelined-pallas at 2400x3200 f32; K-h: its bf16-storage form
# capped at 1024; K-g: pallas with bf16 storage at 2400x3200; K-f:
# batched-pipelined-pallas at 400x600, B = 32; K-a: pallas at 2400x3200;
# K1 and K2: fused at 2400x3200)
QUEUE_LAUNCHES = {"stencil_dots": 2496, "stencil_dots_mixed": 1024,
                  "stencil_mixed": 3328, "fused_k1": 2496,
                  "batched_stencil_dots": 576, "stencil": 2496,
                  "fused_k2": 2496}
QUEUE_BATCH = ((400, 600), 32)
# K-d's launches in pipelined-pallas at 400x600 f32 (the grid of QUEUE_BATCH)
QUEUE_SMALL_KD = 576
# the SASS opcodes counted in each kernel function
SASS_OPS = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "SHFL", "F2F",
            "DADD", "DFMA", "MUFU", "FCHK", "FMUL", "FADD", "FFMA", "SEL",
            "FSEL", "ISETP", "IMAD", "IADD3", "LEA", "BRA", "CALL")


def sass_report(library: str, out_dir=None) -> dict:
    """{kernel function: (instructions, {opcode: count}, [loop lengths],
    median instructions between two global stores)} from ``cuobjdump
    -sass`` of a built library (the toolkit's, beside nvcc): the static
    instruction count of each kernel and of each loop in it (a branch to
    an earlier address; its length counts the instructions from the target
    to the branch). With ``out_dir`` the listing is written there as
    ``<library>.sass``."""
    import re

    from poisson_ellipse_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass",
                          str(_build.library_path(library))],
                         capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / f"{library}.sass").write_text(res.stdout)
    functions: dict = {}
    name = None
    for ln in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            functions[name] = ([], {}, [])
            continue
        if name is None:
            continue
        body, labels, pending = functions[name]
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending.clear()
            body.append((addr, m.group(2).split()))
    report = {}
    for name, (body, labels, _) in functions.items():
        ops = collections.Counter()
        loops, stores = [], []
        for i, (addr, words) in enumerate(body):
            words = words[1:] if words[0].startswith("@") else words
            op = words[0].split(".")[0]
            ops[op] += 1
            if op == "STG":
                stores.append(i)
            if op != "BRA":
                continue
            target = " ".join(words[1:])
            m = re.search(r"(\.L_x_\d+)", target)
            dest = (labels.get(m.group(1)) if m else
                    int(target.split("0x")[1].split()[0], 16)
                    if "0x" in target else None)
            if dest is not None and dest <= addr:
                start = next(j for j, (a, _) in enumerate(body) if a >= dest)
                loops.append(i - start + 1)
        gaps = [b - a for a, b in zip(stores, stores[1:])]
        report[name] = (len(body), {k: ops[k] for k in SASS_OPS if ops[k]},
                        loops, statistics.median(gaps) if gaps else None)
    return report


def show_sass(library: str, match: str, out_dir=None) -> None:
    """``sass_report``'s lines for the functions whose name holds
    ``match``: the instruction count, each loop's length (a loop of one
    node a trip is the count a node), the median distance between two
    global stores (in a march unrolled over rows, one out store a row:
    the count a node) and the opcode counts."""
    for name, (count, ops, loops, gap) in sass_report(library,
                                                      out_dir).items():
        if match in name:
            say(f"  SASS {name}: {count} instructions, loops {loops}, "
                f"median store gap {gap}, {ops}")


def timed_row(rows: list, name, label, calls, plain, nbytes, flops, src,
              line, launches=None, per=None) -> dict:
    """One kernel timed three ways (``device_ms``, ``call_times``,
    ``device_activities``) on its rotated input sets ``calls``, beside its
    plain version, its bound, its share of it and its loss on its path,
    launches x (device time - bound) (``launches`` default: its
    QUEUE_LAUNCHES entry); the row is appended to ``rows`` and returned.
    ``per``: the nodes a B-a-node figure divides by."""
    dev = device_ms(calls)
    call, host = call_times(calls, 200)
    acts = device_activities(calls[0])
    plain_ms = time_ms(plain, 10)
    bound_ms, bound_by = bound(nbytes, flops)
    if launches is None:
        launches = QUEUE_LAUNCHES.get(name, 0)
    say(f"  {label}: device {dev * 1e3:.2f} us, call {call * 1e3:.2f} "
        f"us, host {host * 1e3:.2f} us, "
        f"{acts if acts > 0 else 'not measured (no profile)'} device "
        f"activities a call; plain {plain_ms * 1e3:.1f} us; bound "
        f"{bound_ms * 1e3:.1f} us ({bound_by}"
        + (f", {nbytes / per:g} B a node" if per else "")
        + f"), {bound_ms / dev:.0%} of it; loss {launches} x "
        f"{(dev - bound_ms) * 1e3:.1f} us = "
        f"{launches * (dev - bound_ms):.1f} ms")
    row = dict(name=name, label=label, route="cuda",
               source=f"poisson_ellipse_tpu_torch/{src}",
               replaces=f"poisson_ellipse_tpu/{line}", ms=dev, call_ms=call,
               host_ms=host, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, activities=acts)
    rows.append(row)
    return row


def phase_queue_timing(seed: int, card: str, sass_dir=None) -> list:
    """Rule 2's queue timed three ways (``device_ms``, ``call_times``,
    ``device_activities``) on QUEUE_SETS rotated input sets, at the shapes
    the main paths give them: K-d f32 and bf16 and K-h bf16 and f16 with
    the pipelined bundle on the full 2401x3201 grid, as the engine calls
    them; K-f at 401x601, B = 32; K-g (w, a, b bf16), K-a, K1 and K2 at
    2401x3201; K-d f32 at 401x601, where pipelined-pallas at 400x600 calls
    it. Each beside its bound, its share of it and its loss on its path,
    launches x (device time - bound). Then the SASS of the K-d family, and
    pipelined-pallas at 400x600 and 2400x3200 f32 (uncapped) and with
    bf16 storage capped at STORAGE_CAP: us an iteration and launches a
    body."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.fused_pcg import fused_operands
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle

    say(f"== rule 2's queue by device time on {card}")
    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    h1, h2 = problem.h1, problem.h2
    g1, g2 = problem.node_shape
    nodes = g1 * g2
    base = batched_inputs(MAIN_GRID, 0, seed)
    bf, f16 = torch.bfloat16, torch.float16
    rows = []

    def sets(make):
        """QUEUE_SETS copies of the arrays ``make`` builds from ``base``."""
        return [make({k: ([o.clone() for o in v] if k == "ops"
                          else v.clone()) for k, v in base.items()})
                for _ in range(QUEUE_SETS)]

    def timed(name, label, calls, plain, nbytes, flops, src, line,
              launches=None, per=nodes):
        timed_row(rows, name, label, calls, plain, nbytes, flops, src, line,
                  launches, per)

    def kd(i, dtype=torch.float32):
        w, a, b = (i[k].to(dtype) for k in "wab")
        return w, a, b, _bundle(*(o.to(dtype) for o in i["ops"]))

    kd32 = sets(kd)
    timed("stencil_dots", "K-d f32",
          [lambda s=s: hk.apply_a_dots_kernel(*s[:3], h1, h2, s[3])
           for s in kd32],
          lambda s=kd32[0]: hk.apply_a_dots_plain(*s[:3], h1, h2, s[3]),
          36 * nodes, KD_FLOPS * nodes, "csrc/stencil_dots.cu",
          "ops/pallas_kernels.py:299")
    del kd32
    kd16 = sets(lambda i: kd(i, bf))
    timed("stencil_dots_bf16", "K-d bf16",
          [lambda s=s: hk.apply_a_dots_kernel(*s[:3], h1, h2, s[3])
           for s in kd16],
          lambda s=kd16[0]: hk.apply_a_dots_plain(*s[:3], h1, h2, s[3]),
          18 * nodes, KD_FLOPS * nodes, "csrc/stencil_dots.cu",
          "ops/pallas_kernels.py:299")
    del kd16
    for st, dtype in (("bf16", bf), ("f16", f16)):
        kh = sets(lambda i: (i["w"], i["a"].to(dtype), i["b"].to(dtype),
                             _bundle(*(o.to(dtype) for o in i["ops"]))))
        timed("stencil_dots_mixed" if st == "bf16" else None, f"K-h {st}",
              [lambda s=s: hk.apply_a_dots_mixed_kernel(*s[:3], h1, h2, s[3])
               for s in kh],
              lambda s=kh[0]: hk.apply_a_dots_mixed_plain(*s[:3], h1, h2,
                                                          s[3]),
              22 * nodes, KD_FLOPS * nodes, "csrc/stencil_dots.cu",
              "ops/pallas_kernels.py:910")
        del kh
    kg = sets(lambda i: tuple(i[k].to(bf) for k in "wab"))
    timed("stencil_mixed", "K-g w, a, b bf16",
          [lambda s=s: hk.apply_a_mixed_kernel(*s, h1, h2) for s in kg],
          lambda s=kg[0]: hk.apply_a_mixed_plain(*s, h1, h2), 10 * nodes,
          18 * nodes, "csrc/stencil.cu", "ops/pallas_kernels.py:784")
    del kg
    ka = sets(lambda i: (i["w"], i["a"], i["b"]))
    timed("stencil", "K-a f32",
          [lambda s=s: hk.apply_a_kernel(*s, h1, h2) for s in ka],
          lambda s=ka[0]: hk.apply_a_plain(*s, h1, h2), 16 * nodes,
          18 * nodes, "csrc/stencil.cu", "ops/pallas_kernels.py:169")
    del ka

    never = 2**31 - 1
    coeffs = fused_operands(problem, torch.float32, torch.device("cuda"))

    def fused_set(i):
        scal = torch.zeros(fp.N_SCAL, device="cuda")
        scal[fp.SCAL_ZR], scal[fp.SCAL_BETA] = 1.5, 0.7
        scal[fp.SCAL_ALPHA] = 0.3
        return dict(z=i["ops"][0], p=i["ops"][1], w=i["w"], r=i["ops"][2],
                    pn=torch.empty_like(i["w"]), ap=torch.empty_like(i["w"]),
                    zo=torch.empty_like(i["w"]), scal=scal,
                    flags=torch.zeros(fp.N_FLAGS, dtype=torch.int32,
                                      device="cuda"),
                    coeffs=[c.clone() for c in coeffs],
                    partials=torch.empty(fp.scratch_len(g1, g2),
                                         device="cuda"))

    def k1(s, fn=fp.k1):
        an, as_, bw, be, d, _ = s["coeffs"]
        fn(s["z"], s["p"], an, as_, bw, be, d, s["pn"], s["ap"], s["scal"],
           s["flags"], s["partials"], max_iter=never, h1=h1, h2=h2)

    # delta = 0: no timed K2 launch meets the stopping rule
    def k2(s, fn=fp.k2):
        fn(s["w"], s["r"], s["pn"], s["ap"], s["coeffs"][5], s["zo"],
           s["scal"], s["flags"], s["partials"], max_iter=never, h1=h1,
           h2=h2, delta=0.0, weighted=True)

    fs = sets(fused_set)
    timed("fused_k1", "K1 (fused)", [lambda s=s: k1(s) for s in fs],
          lambda: k1(fs[0], fp.k1_plain), 36 * nodes, 15 * nodes,
          "csrc/fused_pcg.cu", "ops/fused_pcg.py:229")
    timed("fused_k2", "K2 (fused)", [lambda s=s: k2(s) for s in fs],
          lambda: k2(fs[0], fp.k2_plain), 32 * nodes, 10 * nodes,
          "csrc/fused_pcg.cu", "ops/fused_pcg.py:244")
    del fs, coeffs, base

    (m, n), lanes = QUEUE_BATCH
    bh1, bh2 = 2.0 / m, 1.2 / n
    bnodes = (m + 1) * (n + 1)
    bbase = batched_inputs((m, n), lanes, seed)
    kf = [(bbase["w"].clone(), bbase["a"], bbase["b"],
           _bundle(*(o.clone() for o in bbase["ops"])))
          for _ in range(QUEUE_SETS)]
    timed("batched_stencil_dots", f"K-f {m + 1}x{n + 1} B={lanes}",
          [lambda s=s: hk.apply_a_dots_batched_kernel(*s[:3], bh1, bh2, s[3])
           for s in kf],
          lambda s=kf[0]: hk.apply_a_dots_batched_plain(*s[:3], bh1, bh2,
                                                       s[3]),
          (2 + 7 * lanes) * bnodes * 4, KD_FLOPS * bnodes * lanes,
          "csrc/stencil_dots.cu", "ops/pallas_kernels.py:529", per=bnodes)
    del kf, bbase
    # K-d f32 where pipelined-pallas at 400x600 calls it (QUEUE_SMALL_KD
    # launches a solve)
    sbase = batched_inputs((m, n), 0, seed)
    kds = [(sbase["w"].clone(), sbase["a"], sbase["b"],
            _bundle(*(o.clone() for o in sbase["ops"])))
           for _ in range(QUEUE_SETS)]
    timed(None, f"K-d f32 {m + 1}x{n + 1}",
          [lambda s=s: hk.apply_a_dots_kernel(*s[:3], bh1, bh2, s[3])
           for s in kds],
          lambda s=kds[0]: hk.apply_a_dots_plain(*s[:3], bh1, bh2, s[3]),
          36 * bnodes, KD_FLOPS * bnodes, "csrc/stencil_dots.cu",
          "ops/pallas_kernels.py:299", launches=QUEUE_SMALL_KD, per=bnodes)
    del kds, sbase
    torch.cuda.synchronize()

    say("  the K-d family's SASS (cuobjdump -sass)")
    show_sass("stencil_dots", "stencil_dots", sass_dir)
    show_sass("stencil", "_kernel", sass_dir)
    phase_pipelined_times(card)
    return rows


def phase_pipelined_times(card: str) -> None:
    """The loops that launch K-d and K-h, timed (not held): pipelined-pallas
    at 400x600 and 2400x3200 f32, uncapped, at their oracle counts; with
    bf16 storage at 2400x3200 capped at STORAGE_CAP. us an iteration (the
    median of three solves timed after the counted one) and launches a
    body."""
    from poisson_ellipse_tpu_torch.models.problem import Problem

    say(f"== the loops that launch K-d and K-h ({card})")
    for (m, n), storage, cap in (((400, 600), None, None),
                                 (MAIN_GRID, None, None),
                                 (MAIN_GRID, "bf16", STORAGE_CAP)):
        result, t, launches = timed_recurrence(
            Problem(M=m, N=n, max_iter=cap), "pipelined-pallas",
            storage=storage, repeat=3)
        iters = int(result.iters)
        kernel = "stencil_dots_mixed" if storage else "stencil_dots"
        issued = 64 * -(-iters // 64)
        issued = min(cap, issued) if cap else issued
        say(f"  pipelined-pallas {m}x{n} f32"
            f"{' storage ' + storage + f' capped at {cap}' if storage else ''}"
            f": {iters} iterations, converged {bool(result.converged)}, "
            f"{t:.5f} s, {t / iters * 1e6:.2f} us/iter, launches {launches}, "
            f"{launches.get(kernel, 0) / issued:g} {kernel} a body")
        if storage is None:
            want = MAIN_ITERS if (m, n) == MAIN_GRID else LARGE[(m, n)]
            require(bool(result.converged) and abs(iters - want) <= ITERS_ABS,
                    f"pipelined-pallas {m}x{n}: {iters} iterations, outside "
                    f"{want} +-{ITERS_ABS}")


# -- xl's body by phase, the grid barrier, K-g's forms, in-loop time --------

# bodies of the timed xl solves (delta = 0: none stops before the cap)
XL_TIME_CAP = 256
# the grids of the barrier timing: (label, engine, grid)
BARRIER_GRIDS = (("xl 2401x3201", "xl", MAIN_GRID),
                 ("resident 801x1201", "resident", (800, 1200)),
                 ("streamed 1101x1651", "streamed", STREAMED_GRID))
# the barrier kernel's bodies: two runs, the difference over their gap
BARRIER_BODIES = (100, 1100)
BARRIER_MODES = ("grid_barrier", "grid_reduce_warp, 1 sum",
                 "grid_reduce_warp, 2 sums", "grid_reduce_wide, 1 sum",
                 "grid_reduce_wide, 2 sums")
# what modes 1 and 2 were before grid_reduce_warp (an older tree's bench)
BARRIER_MODES_BEFORE = ("grid_barrier", "grid_reduce", "grid_reduce2",
                        "grid_reduce_wide, 1 sum", "grid_reduce_wide, 2 sums")
# K-g's (w, a and b) type pairs, and the one on pallas's bf16 path
KG_FORMS = (("bf16", "bf16"), ("f32", "bf16"), ("f16", "f16"), ("f32", "f16"))
KG_MAIN = ("bf16", "bf16", 1)


class ClockSampler:
    """nvidia-smi's SM clock and power draw, sampled every 50 ms while the
    block runs (the process is stopped on exit)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.5)  # nvidia-smi's own start
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        samples = []
        for ln in out.splitlines():
            try:
                mhz, watts = (float(x) for x in ln.split(","))
            except ValueError:
                continue
            samples.append((mhz, watts))
        self.text = ("not measured (no nvidia-smi sample)" if not samples
                     else f"SM clock {statistics.median(m for m, _ in samples)}"
                     f" MHz (min {min(m for m, _ in samples)}), power "
                     f"{statistics.median(w for _, w in samples):.1f} W, "
                     f"{len(samples)} samples")
        return False


def sustained(fn, seconds: float = 1.5) -> None:
    """``fn`` again and again for ``seconds`` of host time, then a sync."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
    torch.cuda.synchronize()


def xl_phase_split(cap) -> None:
    """xl f32 at 2400x3200 capped at XL_TIME_CAP bodies, through the
    timing instantiation (``xl(stamps=)``): each body's stencil phase, first
    barrier with its two sums, update phase and second barrier with its
    sum on the device clock (block 0's stamps), and the spread of the
    blocks' stencil-phase ends; medians over the bodies but the first and
    the last. Beside it the uninstrumented solve's time a body."""
    import inspect

    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import streamed_operands

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=XL_TIME_CAP,
                      delta=0.0)
    ops = streamed_operands(problem, torch.float32, "cuda")
    nb = xp.XLPlan(problem).nblocks(cap, "f32")
    bodies = XL_TIME_CAP + 1
    plain = time_solver(lambda: xp.xl(problem, *ops, cap=cap), (), 3)
    say(f"  xl f32 {problem.M}x{problem.N}: {nb} blocks, "
        f"{plain * 1e6 / bodies:.2f} us a body uninstrumented "
        f"({bodies} bodies, median of 3)")
    if "stamps" not in inspect.signature(xp.xl).parameters:
        say("  the body by phase: not measured (this tree's kernel has no "
            "timing instantiation)")
        return
    stamps = xp.stamps_buffer(problem, nb, "cuda")
    xp.xl(problem, *ops, cap=cap, stamps=stamps)
    t = stamps.cpu().numpy().astype(np.float64)
    require(bool((t[:, :5] > 0).all()), "xl stamps: a body left no stamp")
    body = t[1:-1]
    nxt = t[2:]
    ends = body[:, 5:5 + nb]
    parts = {
        "stencil phase": body[:, 1] - body[:, 0],
        "barrier 1 + 2 sums": body[:, 2] - body[:, 1],
        "update phase": body[:, 3] - body[:, 2],
        "barrier 2 + sum": body[:, 4] - body[:, 3],
        "scalar tail": nxt[:, 0] - body[:, 4],
        "body": nxt[:, 0] - body[:, 0],
    }
    for label, ns in parts.items():
        say(f"  xl body {label}: median {np.median(ns) / 1e3:.2f} us, mean "
            f"{ns.mean() / 1e3:.2f} us")
    spread = ends.max(axis=1) - ends.min(axis=1)
    fast = ends.min(axis=1) - body[:, 0]
    slow = ends.max(axis=1) - body[:, 0]
    steps = np.diff(np.unique(body[:, :5]))
    say(f"  xl stencil-phase ends over {nb} blocks: fastest block "
        f"{np.median(fast) / 1e3:.2f} us, slowest {np.median(slow) / 1e3:.2f}"
        f" us after block 0's start, spread median "
        f"{np.median(spread) / 1e3:.2f} us (mean {spread.mean() / 1e3:.2f}); "
        f"clock step {steps[steps > 0].min() if steps.size else 0:.0f} ns")
    # each block's median end, by the blocks its SM holds (body 0's block
    # slots hold the SM plus one where the kernel records it)
    per_block = np.median(ends - body[:, :1], axis=0) / 1e3
    sm = t[0, 5:5 + nb]
    if 1 <= sm.min() and sm.max() <= 1024:
        counts = collections.Counter(sm.astype(int).tolist())
        load = np.array([counts[int(x)] for x in sm])
        for k in sorted(set(load.tolist())):
            sel = per_block[load == k]
            say(f"    blocks on SMs holding {k}: {sel.size}, stencil-phase "
                f"end median {np.median(sel):.2f} us, max {sel.max():.2f}")
    q = np.percentile(per_block, [0, 10, 50, 90, 100])
    say(f"    blocks' median ends, percentiles 0/10/50/90/100: "
        + ", ".join(f"{x:.2f}" for x in q) + " us; slowest blocks "
        + ", ".join(str(b) for b in np.argsort(per_block)[-5:][::-1]))


def barrier_latency(cap) -> None:
    """One grid barrier (``grid_sync.cuh``) alone, with one grid sum and
    with two, at xl's grid at 2401x3201 and resident's at 801x1201: a
    cooperative kernel of BARRIER_BODIES bodies each, us a body from the
    difference of the two runs."""
    import ctypes

    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import _build
    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp

    try:
        lib = _build.load("xl_pcg", {
            "pe_xl_pcg_barrier_bench": (ctypes.c_int, [ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 3),
            "pe_xl_pcg_error_string": (ctypes.c_char_p, [ctypes.c_int])})
    except AttributeError:
        say("  the grid barrier: not measured (this tree has no barrier "
            "kernel)")
        return
    for label, engine, (m, n) in BARRIER_GRIDS:
        problem = Problem(M=m, N=n)
        if engine == "xl":
            nb = xp.XLPlan(problem).nblocks(cap, "f32")
            threads = getattr(xp, "THREADS", 256)
        elif engine == "resident":
            lay = rp.layout(problem, cap)
            nb = lay.nblocks
            threads = (lay.threads if getattr(lay, "split", None)
                       else getattr(rp, "THREADS", 512))
        else:
            plan = sp.StreamPlan(problem, cap)
            nb = plan.nblocks
            threads = (plan.launch_shape().threads
                       if hasattr(plan, "launch_shape") else 1024)
        partials = torch.zeros(4 * nb, dtype=torch.float64, device="cuda")
        out = torch.zeros(1, device="cuda")
        stream = _build.stream_handle(out.device)
        header = (PACKAGE / "csrc" / "grid_sync.cuh").read_text()
        names = (BARRIER_MODES if "grid_reduce_warp" in header
                 else BARRIER_MODES_BEFORE)
        for mode, name in enumerate(names):
            def run(bodies):
                rc = lib.pe_xl_pcg_barrier_bench(
                    mode, nb, threads, bodies, partials.data_ptr(),
                    out.data_ptr(), stream)
                _build.check(lib.pe_xl_pcg_error_string, "barrier", rc)
            t0, t1 = (time_ms(lambda b=b: run(b), 5) for b in BARRIER_BODIES)
            per = (t1 - t0) * 1e3 / (BARRIER_BODIES[1] - BARRIER_BODIES[0])
            say(f"  {label}, {nb} blocks of {threads}: {name} {per:.3f} us a"
                f" body ({t0:.3f} / {t1:.3f} ms for {BARRIER_BODIES} bodies)")


def kg_rows(seed: int) -> list:
    """K-g's four (w, a and b) type pairs at 2401x3201, pad 1 and pad 0,
    each timed as ``timed_row`` times rule 2's queue; K-a f32 on the same
    values beside them; the SASS of the stencil library."""
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk

    say("  K-g at 2401x3201 (device / call / host time, activities a call)")
    g1, g2 = MAIN_GRID[0] + 1, MAIN_GRID[1] + 1
    h1, h2 = 2.0 / MAIN_GRID[0], 1.2 / MAIN_GRID[1]
    nodes = g1 * g2
    rng = np.random.default_rng(seed)
    base = [tuple(torch.from_numpy(x.astype(np.float32)).to("cuda")
                  for x in (rng.standard_normal((g1, g2)),
                            rng.random((g1, g2)) + 0.5,
                            rng.random((g1, g2)) + 0.5))
            for _ in range(QUEUE_SETS)]
    width = {"f32": 4, "bf16": 2, "f16": 2}
    rows = []
    for w_st, ab_st in KG_FORMS:
        sets = [(w if w_st == "f32" else w.to(NARROW[w_st]),
                 a.to(NARROW[ab_st]), b.to(NARROW[ab_st]))
                for w, a, b in base]
        for pad in (1, 0):
            full = pad == 1
            kernel = hk.apply_a_mixed_kernel if full else \
                hk.apply_a_mixed_block_kernel
            plain = hk.apply_a_mixed_plain if full else \
                hk.apply_a_mixed_block_plain
            out_nodes = nodes if full else (g1 - 2) * (g2 - 2)
            main = (w_st, ab_st, pad) == KG_MAIN
            require(same_bits(kernel(*sets[0], h1, h2),
                              plain(*sets[0], h1, h2)),
                    f"K-g w {w_st} a/b {ab_st} pad {pad} is not bitwise its "
                    "plain version")
            timed_row(
                rows, "stencil_mixed" if main else None,
                f"K-g w {w_st}, a/b {ab_st}, pad {pad}",
                [lambda s=s, k=kernel: k(*s, h1, h2) for s in sets],
                lambda s=sets[0], k=plain: k(*s, h1, h2),
                (width[w_st] + 2 * width[ab_st]) * nodes + 4 * out_nodes,
                18 * out_nodes, "csrc/stencil.cu",
                "ops/pallas_kernels.py:784",
                launches=QUEUE_LAUNCHES["stencil_mixed"] if main else 0,
                per=nodes)
        del sets
    timed_row(rows, None, "K-a f32 (same values)",
              [lambda s=s: hk.apply_a_kernel(*s, h1, h2) for s in base],
              lambda s=base[0]: hk.apply_a_plain(*s, h1, h2), 16 * nodes,
              18 * nodes, "csrc/stencil.cu", "ops/pallas_kernels.py:169",
              launches=QUEUE_LAUNCHES["stencil"], per=nodes)
    say("  the stencil library's SASS (cuobjdump -sass)")
    show_sass("stencil", "_kernel")
    return rows


def _per_launch(table: dict, match):
    """(name, launches, us a launch) of the kernel in a profile ``table``
    whose name ``match`` accepts, the one with the most launches."""
    hits = [(n, c, us / c) for n, (c, us) in table.items() if match(n)]
    return max(hits, key=lambda h: h[1]) if hits else None


def _profiled_us(calls, n: int, match) -> str:
    """``n`` eager rounds of ``calls`` (each a list of closures run in turn)
    under torch.profiler: us a launch of the kernel ``match`` accepts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls[0]:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            for fn in calls[i % len(calls)]:
                fn()
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = table.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    hit = _per_launch(table, match)
    return "not measured (no device events)" if hit is None else \
        f"{hit[2]:.2f} us a launch ({hit[1]} launches)"


def in_loop_times(seed: int) -> None:
    """K-a, K-g (bf16) and K-d a launch inside their loops at 2400x3200
    (torch.profiler over a solve capped at PROFILE_CAP, as phase 7 and
    phase 9 profile them) beside their graph-replay time; then causes
    tested on K-a: the profiler on K-a alone, K-a after a PyTorch kernel
    that writes 31 MB (dirty lines in L2), after one that reads 92 MB of
    other data (clean), on an input that kernel has just written (as in
    the loop), and the SM clock under each; pallas with bf16 storage, us
    an iteration capped at PROFILE_CAP."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    g1, g2 = MAIN_GRID[0] + 1, MAIN_GRID[1] + 1
    h1, h2 = 2.0 / MAIN_GRID[0], 1.2 / MAIN_GRID[1]
    rng = np.random.default_rng(seed)

    def f32(lo=None):
        x = rng.random((g1, g2)) + lo if lo is not None else \
            rng.standard_normal((g1, g2))
        return torch.from_numpy(x.astype(np.float32)).to("cuda")

    sets = [(f32(), f32(0.5), f32(0.5)) for _ in range(QUEUE_SETS)]
    ops = [f32() for _ in range(5)]
    pairs = _bundle(*ops)
    ka_calls = [lambda s=s: hk.apply_a_kernel(*s, h1, h2) for s in sets]
    kg_sets = [tuple(x.to(torch.bfloat16) for x in s) for s in sets]
    replay = {
        "K-a f32": device_ms(ka_calls),
        "K-g bf16": device_ms([lambda s=s: hk.apply_a_mixed_kernel(*s, h1, h2)
                               for s in kg_sets]),
        "K-d f32": device_ms([lambda s=s: hk.apply_a_dots_kernel(
            *s, h1, h2, pairs) for s in sets]),
    }
    # the port's kernels live in anonymous namespaces, PyTorch's in
    # at::native; the one launched most in a loop is its stencil
    ours = lambda n: n.startswith("void (anonymous namespace)::")  # noqa
    loops = (("K-a f32", "pallas", {}, ours),
             ("K-g bf16", "pallas", {"storage_dtype": "bf16"}, ours),
             ("K-d f32", "pipelined-pallas", {}, lambda n: "stencil_dots" in n))
    for label, engine, options, match in loops:
        table = profile_capped(engine, **options)
        hit = _per_launch(table, match)
        inside = "not measured" if hit is None else \
            f"{hit[2]:.2f} us a launch ({hit[1]} launches, {hit[0][:60]})"
        say(f"  in-loop {label} in {engine}{' bf16 storage' if options else ''}"
            f": {inside}; graph replay {replay[label] * 1e3:.2f} us")

    say("  the loop's data: K-a and K-g by graph replay on the assembled "
        "a and b and the w of a solve capped at "
        f"{PROFILE_CAP} (pallas), beside seeded values")
    from poisson_ellipse_tpu_torch.ops import assembly
    from poisson_ellipse_tpu_torch.solver import engine

    capped = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=PROFILE_CAP)
    a_r, b_r, _ = assembly.assemble(capped, torch.float32, "cuda")
    w_r = engine.solve(capped, "pallas", torch.float32, device="cuda").w
    tiny = torch.finfo(torch.float32).tiny
    flux = a_r[1:] * (w_r[1:] - w_r[:-1])
    for label, x in (("w", w_r), ("a*(w_s - w)", flux),
                     ("a*(w_s - w)/h1", flux / h1)):
        sub = int(((x != 0) & (x.abs() < tiny)).sum())
        say(f"    {label}: {sub} subnormal of {x.numel()} "
            f"({sub / x.numel():.3%}), {int((x == 0).sum())} zero")
    real = [(w_r.clone(), a_r, b_r) for _ in range(QUEUE_SETS)]
    zero = torch.zeros_like(w_r)
    zero16 = zero.to(torch.bfloat16)
    mixed = [tuple(x.to(torch.bfloat16) for x in r) for r in real]
    for label, calls in (
            ("K-a f32, the loop's w, a, b", [
                lambda s=s: hk.apply_a_kernel(*s, h1, h2) for s in real]),
            ("K-a f32, seeded w, the loop's a, b", [
                lambda s=s: hk.apply_a_kernel(s[0], a_r, b_r, h1, h2)
                for s in sets]),
            ("K-a f32, w = 0, seeded a, b (every dividend 0)", [
                lambda s=s: hk.apply_a_kernel(zero, s[1], s[2], h1, h2)
                for s in sets]),
            ("K-g bf16, w = 0, seeded a, b", [
                lambda s=s: hk.apply_a_mixed_kernel(zero16, s[1], s[2], h1,
                                                    h2)
                for s in kg_sets]),
            ("K-g bf16, the loop's w, a, b", [
                lambda s=s: hk.apply_a_mixed_kernel(*s, h1, h2)
                for s in mixed])):
        say(f"    {label}: {device_ms(calls) * 1e3:.2f} us by graph replay")

    x0 = sets[0][0]
    o = torch.empty_like(x0)
    for label, fn in (("torch.mul(x, 1.0): seeded in, seeded out",
                       lambda: torch.mul(x0, 1.0, out=o)),
                      ("torch.mul(x, 0.0): seeded in, zeros out",
                       lambda: torch.mul(x0, 0.0, out=o)),
                      ("torch.mul(0, 1.0): zeros in, zeros out",
                       lambda: torch.mul(zero, 1.0, out=o))):
        say(f"    {label}: {device_ms([fn]) * 1e3:.2f} us by graph replay")

    say("  causes, tested on K-a f32 at 2401x3201 (torch.profiler, eager)")
    ka = ours
    x, y, o = f32(), f32(), torch.empty(g1, g2, device="cuda")
    big = torch.ones(3 * g1 * g2, device="cuda")
    z = f32()
    w_in = torch.empty(g1, g2, device="cuda")
    a0, b0 = sets[0][1], sets[0][2]
    cases = (
        ("alone, 3 rotated sets", [[f] for f in ka_calls]),
        ("after torch.add writing 31 MB", [
            [lambda: torch.add(x, y, out=o), f] for f in ka_calls]),
        ("after torch.sum reading 92 MB", [
            [lambda: big.sum(), f] for f in ka_calls]),
        ("on an input torch.add has just written (the loop's order)", [[
            lambda: torch.add(z, x, alpha=0.7, out=w_in),
            lambda: hk.apply_a_kernel(w_in, a0, b0, h1, h2)]]),
    )
    for label, calls in cases:
        with ClockSampler() as clocks:
            us = _profiled_us(calls, 60, ka)
            sustained(lambda: [fn() for fn in calls[0]])
        say(f"    K-a {label}: {us}; {clocks.text}")
    with ClockSampler() as clocks:
        sustained(lambda: device_ms(ka_calls, n=48, replays=3), 2.0)
    say(f"    K-a by graph replay: {replay['K-a f32'] * 1e3:.2f} us; "
        f"{clocks.text}")
    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=PROFILE_CAP)
    solver, args, _ = build_solver(problem, "pallas", torch.float32, "cuda")
    solver(*args)
    with ClockSampler() as clocks:
        sustained(lambda: solver(*args), 2.0)
    say(f"    the pallas f32 loop capped at {PROFILE_CAP}: {clocks.text}")
    solver, args, _ = build_solver(problem, "pallas", torch.float32, "cuda",
                                   storage_dtype="bf16")
    iters = int(solver(*args).iters)
    t = time_solver(solver, args, 3)
    say(f"  pallas bf16 storage {MAIN_GRID[0]}x{MAIN_GRID[1]} capped at "
        f"{PROFILE_CAP}: {iters} iterations, {t * 1e6 / iters:.2f} us an "
        "iteration (median of 3)")


def xl_form_times(cap) -> list:
    """xl at 2400x3200 in its four forms, capped at XL_TIME_CAP (delta =
    0), in turns (f32, the others, the others again, f32): us an
    iteration; then T_solver of the uncapped f32 xl and fused solves in
    turns (xl, fused, fused, xl), medians of 3 each."""
    from poisson_ellipse_tpu_torch.harness.roofline import passes_per_iter
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import whole_solve as ws
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    problem = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=XL_TIME_CAP,
                      delta=0.0)
    nodes = (MAIN_GRID[0] + 1) * (MAIN_GRID[1] + 1)
    forms = (("f32", torch.float32, None), ("bf16", BF16, None),
             ("f32_bf16", torch.float32, "bf16"),
             ("f32_f16", torch.float32, "f16"))
    built = {f: _timed_form("xl", problem, dt, st) for f, dt, st in forms}
    times = {f: [] for f in built}
    for f in list(built) + list(built)[::-1]:
        solver, args, _ = built[f]
        times[f].append(time_solver(solver, args, 1))
    rows = []
    for f, dt, st in forms:
        iters = built[f][2]
        ms = statistics.median(times[f]) * 1e3
        say(f"  xl {f} {MAIN_GRID[0]}x{MAIN_GRID[1]} capped at {XL_TIME_CAP}:"
            f" {iters} iterations, {ms * 1e3 / iters:.2f} us/iter "
            f"({', '.join(f'{t * 1e6 / iters:.2f}' for t in times[f])})")
        item = dt.itemsize
        per_node = (passes_per_iter("xl", problem) * item
                    if st is None and dt == torch.float32 else None)
        rows.append(dict(name=ws.counter("xl", f), label=f"xl {f}",
                         route="cuda",
                         source="poisson_ellipse_tpu_torch/csrc/xl_pcg.cu",
                         replaces=WHOLE_REPLACES["xl"], ms=ms,
                         us_per_iter=ms * 1e3 / iters, iters=iters,
                         plain_ms=None, bound_ms=None, bound_by=None,
                         library_ms=None,
                         bound_us_per_iter=(per_node * nodes / PEAK_BYTES_PER_S
                                            * 1e6 if per_node else None)))
    full = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    runs = {e: build_solver(full, e, torch.float32, "cuda")[:2]
            for e in ("xl", "fused")}
    iters = {e: int(s(*a).iters) for e, (s, a) in runs.items()}
    t_solver = {e: [] for e in runs}
    for e in ("xl", "fused", "fused", "xl"):
        t_solver[e].append(time_solver(*runs[e], 3))
    for e, ts in t_solver.items():
        say(f"  T_solver {MAIN_GRID[0]}x{MAIN_GRID[1]} {e}: "
            f"{', '.join(f'{t:.5f}' for t in ts)} s, {iters[e]} iterations,"
            f" {min(ts) * 1e6 / iters[e]:.2f} us/iter at the faster")
    return rows


def phase_xl_timing(seed: int, card: str) -> list:
    """``--only xl-timing``: xl's four forms a body and T_solver beside
    fused; xl's body by phase and its block imbalance; one grid barrier's
    latency; K-g's four forms, both pads, three ways with the stencil
    library's SASS; K-a, K-g and K-d in their loops beside their graph
    replay. Runs on an older tree's kernels too (what that tree lacks is
    printed as not measured)."""
    from poisson_ellipse_tpu_torch.utils.device import capacity

    cap = capacity(0)
    say(f"== xl, the grid barrier, K-g and in-loop times on {card}")
    rows = xl_form_times(cap)
    xl_phase_split(cap)
    show_sass("xl_pcg", "xl_kernelIffLb0E")
    barrier_latency(cap)
    rows += kg_rows(seed)
    in_loop_times(seed)
    return rows


# -- the whole-solve kernels by phase: resident and streamed beside xl ------

WHOLE_TIME_CAP = 256
# (label, engine, grid, compute dtype, storage dtype, forced resident
# operands): auto's grids for resident and streamed in every form, and
# streamed with every operand on chip and in both regimes
WHOLE_SPLITS = (
    ("resident f32", "resident", (400, 600), torch.float32, None, None),
    ("resident f32", "resident", (800, 1200), torch.float32, None, None),
    ("resident bf16", "resident", STREAMED_GRID, BF16, None, None),
    ("streamed f32, every operand on chip", "streamed", (800, 1200),
     torch.float32, None, ("ap", "dinv", "a", "b")),
    ("streamed f32, planned (z-state)", "streamed", STREAMED_GRID,
     torch.float32, None, None),
    ("streamed f32, dinv forced on chip (r-state)", "streamed",
     STREAMED_GRID, torch.float32, None, ("dinv",)),
    ("streamed bf16, planned", "streamed", (1600, 2400), BF16, None, None),
    ("streamed f32_bf16, planned", "streamed", STREAMED_GRID, torch.float32,
     "bf16", None),
    ("streamed f32_f16, planned", "streamed", STREAMED_GRID, torch.float32,
     "f16", None),
)
WHOLE_STAMP_PARTS = (("pn pass", 0, 1), ("stencil phase", 1, 2),
                     ("sum 1 with its barrier", 2, 3),
                     ("update phase", 3, 4),
                     ("sums 2 with their barrier", 4, 5))


def whole_split(label: str, stamps: torch.Tensor, nb: int,
                bodies: int) -> None:
    """The body by phase from a timing launch's stamps (grid_sync.cuh
    whole_stamp) of ``bodies`` bodies: block 0's phases, medians and means
    over the bodies but the first and the last, and the spread of the
    blocks' stencil- and update-phase ends."""
    t = stamps[:bodies].cpu().numpy().astype(np.float64)
    require(bodies >= 4 and bool((t[:, :6] > 0).all()),
            f"{label}: a body left no stamp")
    body, nxt = t[1:-1], t[2:]
    parts = [(name, body[:, b] - body[:, a]) for name, a, b in
             WHOLE_STAMP_PARTS]
    parts.append(("scalar tail", nxt[:, 0] - body[:, 5]))
    parts.append(("body", nxt[:, 0] - body[:, 0]))
    say(f"    {label} by phase (median / mean us over {len(body)} bodies): "
        + "; ".join(f"{name} {np.median(ns) / 1e3:.2f} / "
                    f"{ns.mean() / 1e3:.2f}" for name, ns in parts))
    for name, col in (("stencil", 6), ("update", 6 + nb)):
        ends = body[:, col:col + nb] - body[:, :1]
        spread = ends.max(axis=1) - ends.min(axis=1)
        q = np.percentile(np.median(ends, axis=0) / 1e3, [0, 50, 100])
        say(f"      {name}-phase ends over {nb} blocks: spread median "
            f"{np.median(spread) / 1e3:.2f} us (mean "
            f"{spread.mean() / 1e3:.2f}); blocks' median ends 0/50/100%: "
            + ", ".join(f"{x:.2f}" for x in q) + " us after block 0's start")


def _whole_case(engine, problem, dtype, storage, resident, cap):
    """(run(problem, stamps=None), blocks, what the launch shape is) of one
    case of WHOLE_SPLITS on operands built once."""
    import inspect

    from poisson_ellipse_tpu_torch.ops import resident_pcg as rp
    from poisson_ellipse_tpu_torch.ops import streamed_pcg as sp

    dev = torch.device("cuda")
    if engine == "resident":
        ops = rp.resident_operands(problem, dtype, dev)
        lay = rp.layout(problem, cap, dtype)
        split = getattr(lay, "split", None)
        what = (f"span {lay.span}, {lay.smem_bytes} B, "
                + (f"{split}, ap in "
                   f"{'registers' if lay.ap_in_registers else 'memory'}"
                   if split else f"{rp.THREADS} threads"))
        stamped = "stamps" in inspect.signature(rp.resident).parameters

        def run(pr, stamps=None):
            extra = {"stamps": stamps} if stamps is not None else {}
            return rp.resident(pr, *ops, cap=cap, **extra)[0]
        return run, lay.nblocks, what, stamped
    ops = sp.streamed_operands(problem, dtype, dev, storage)
    plan = sp.StreamPlan(problem, cap, dtype, resident=resident)
    on_chip = [k for k, v in plan.resident.items() if v]
    shape = getattr(plan, "launch_shape", None)
    what = (f"span {plan.span}, on chip {on_chip or 'nothing'}, "
            f"{'z' if plan.zstate else 'r'}-state, {plan.smem_bytes} B"
            + (f", {shape()}" if shape else ""))
    stamped = "stamps" in inspect.signature(sp.streamed).parameters

    def run(pr, stamps=None):
        extra = {"stamps": stamps} if stamps is not None else {}
        return sp.streamed(pr, *ops, plan=plan, **extra)[0]
    return run, plan.nblocks, what, stamped


def _xl_at(problem, dtype, storage, cap):
    """xl's run at ``problem``'s grid in a form: the yardstick a kernel that
    keeps its state on chip has to beat."""
    from poisson_ellipse_tpu_torch.ops import xl_pcg as xp
    from poisson_ellipse_tpu_torch.ops.streamed_pcg import streamed_operands

    ops = streamed_operands(problem, dtype, "cuda", storage)
    return lambda pr: xp.xl(pr, *ops, cap=cap)[0]


def _us_and_t_solver(label, run, problem, uncapped, repeat=3):
    """us an iteration of ``run`` capped at WHOLE_TIME_CAP (delta = 0) and
    its T_solver on ``uncapped``, medians of ``repeat``; returns both."""
    from poisson_ellipse_tpu_torch.models.problem import Problem

    capped = Problem(M=problem.M, N=problem.N, max_iter=WHOLE_TIME_CAP,
                     delta=0.0)
    iters = int(run(capped).iters)
    ts = [time_solver(lambda: run(capped), (), 1) for _ in range(repeat)]
    us = statistics.median(ts) * 1e6 / iters
    # a solve of one iteration: the launch, the operand loads and the
    # status read, what a solve costs beside its iterations
    one = Problem(M=problem.M, N=problem.N, max_iter=1, delta=0.0)
    t1 = statistics.median(time_solver(lambda: run(one), (), 1)
                           for _ in range(repeat))
    full = run(uncapped)
    n_full = int(full.iters)
    tf = [time_solver(lambda: run(uncapped), (), 1) for _ in range(repeat)]
    say(f"  {label}: {us:.2f} us/iter capped at {iters} ("
        + ", ".join(f"{x * 1e6 / iters:.2f}" for x in ts)
        + f"); T_solver {statistics.median(tf) * 1e3:.3f} ms ("
        + ", ".join(f"{x * 1e3:.3f}" for x in tf)
        + f") for {n_full} iterations, converged {bool(full.converged)}; "
        f"one iteration {t1 * 1e3:.3f} ms"
        + (f" (capped at {uncapped.max_iterations})"
           if uncapped.max_iter is not None else ""))
    return us, statistics.median(tf)


def phase_whole_timing_split(cap, card: str) -> list:
    """``--only whole-timing``: each case of WHOLE_SPLITS capped at
    WHOLE_TIME_CAP us an iteration and T_solver (f32 uncapped, the other
    forms capped at DTYPE_CAP: they need not converge), its body by phase
    through the timing instantiation, xl at the same grid and form beside
    it, and the resident and streamed libraries' SASS. Runs on an older
    tree's kernels too (what that tree lacks is printed as not
    measured)."""
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import whole_solve as ws

    say(f"== the whole-solve kernels by phase, beside xl, on {card}")
    rows = []
    for label, engine, (m, n), dtype, storage, resident in WHOLE_SPLITS:
        problem = Problem(M=m, N=n)
        uncapped = (problem if dtype == torch.float32 and storage is None
                    else Problem(M=m, N=n, max_iter=DTYPE_CAP))
        run, nb, what, stamped = _whole_case(engine, problem, dtype, storage,
                                             resident, cap)
        full = f"{label} {m + 1}x{n + 1}"
        say(f"  {full}: {nb} blocks, {what}")
        us, t = _us_and_t_solver(full, run, problem, uncapped)
        if stamped:
            capped = Problem(M=m, N=n, max_iter=WHOLE_TIME_CAP, delta=0.0)
            stamps = ws.stamps_buffer(capped, nb, "cuda")
            bodies = int(run(capped, stamps).iters)
            whole_split(full, stamps, nb, bodies)
        else:
            say(f"    {full} by phase: not measured (this tree's kernel has "
                "no timing instantiation)")
        xl_run = _xl_at(problem, dtype, storage, cap)
        xl_us, xl_t = _us_and_t_solver(f"xl {label.split(',')[0].split()[1]}"
                                       f" {m + 1}x{n + 1}", xl_run, problem,
                                       uncapped)
        form = ws.form_of(dtype, NARROW[storage] if storage else None)
        rows.append(dict(name=ws.counter(engine, form), label=full,
                         route="cuda",
                         source=f"poisson_ellipse_tpu_torch/csrc/{engine}"
                                "_pcg.cu",
                         replaces=WHOLE_REPLACES[engine], us_per_iter=us,
                         t_solver_ms=t * 1e3, xl_us_per_iter=xl_us,
                         xl_t_solver_ms=xl_t * 1e3, ms=None, plain_ms=None,
                         bound_ms=None, bound_by=None, library_ms=None))
    # xl at its own grid: the kernels share grid_sync.cuh's sums
    main = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1])
    _us_and_t_solver(f"xl f32 {MAIN_GRID[0] + 1}x{MAIN_GRID[1] + 1}",
                     _xl_at(main, torch.float32, None, cap), main, main)
    for library, match in (("resident_pcg", "resident_kernel"),
                           ("streamed_pcg", "streamed_kernel")):
        show_sass(library, match)
    return rows


# -- the plain-stencil family by data: K-a, K-e, beside K-g, K-d, K1-shard ---

# K-e's grids and lanes: batched-pallas's two throughput shapes
KE_CASES = (((400, 600), 32), ((800, 1200), 8))
# K-e's launches in batched-pallas at 400x600, B = 32 (546 iterations)
KE_LAUNCHES = 576


def _data_rows(rows, name, label, data, kernel, plain, h1, h2, nbytes,
               flops, src, line, launches, per) -> None:
    """``timed_row`` for each input kind of ``data`` ({kind: QUEUE_SETS
    input tuples}), each kind first held bitwise to ``plain``; the row
    named ``name`` (with ``launches``) is the seeded one."""
    for kind, sets in data.items():
        require(same_bits(kernel(*sets[0], h1, h2), plain(*sets[0], h1, h2)),
                f"{label}, {kind}: not bitwise its plain version")
        main = kind == "seeded"
        timed_row(rows, name if main else None, f"{label}, {kind}",
                  [lambda s=s: kernel(*s, h1, h2) for s in sets],
                  lambda s=sets[0]: plain(*s, h1, h2), nbytes, flops, src,
                  line, launches=launches if main else 0, per=per)


def _in_loop(label: str, solver, args, match) -> None:
    """One warm-up and one profiled run of ``solver``: us a launch of the
    kernel ``match`` accepts."""
    solver(*args)
    hit = _per_launch(profile_solve(label, solver, args), match)
    say(f"  in-loop {label}: " + ("not measured" if hit is None else
        f"{hit[2]:.2f} us a launch ({hit[1]} launches, {hit[0][:60]})"))


def phase_stencil_timing(seed: int, card: str) -> list:
    """``--only stencil-timing``: the plain-stencil family by input data.
    K-a f32 and bf16 at 2401x3201, pad 1 and pad 0, and K-e at 401x601, B =
    32 and 801x1201, B = 8, each on seeded values, on the loop's own data
    (a capped pallas / batched-pallas solve's w with the assembled a and b)
    and on w = 0, bitwise its plain version and timed three ways
    (``timed_row``); each a launch inside its loops capped at PROFILE_CAP
    (K-a in pallas and sstep-pallas, K-a bf16 in pallas bf16, K-e in
    batched-pallas). Then K-g's forms (``kg_rows``, with the stencil
    library's SASS), K-d on seeded values and on m = 0 and a launch inside
    pipelined-pallas, K1-shard on a rank's 1201x1601 block, seeded and
    with the loop's zero exterior, and K2-shard, all by device time. Runs
    on an older tree's kernels too."""
    from poisson_ellipse_tpu_torch.batch.batched_pcg import batched_operands
    from poisson_ellipse_tpu_torch.batch.driver import solve_batched
    from poisson_ellipse_tpu_torch.models.problem import Problem
    from poisson_ellipse_tpu_torch.ops import assembly
    from poisson_ellipse_tpu_torch.ops import hopper_kernels as hk
    from poisson_ellipse_tpu_torch.ops.pipelined_pcg import _bundle
    from poisson_ellipse_tpu_torch.parallel import fused_sharded as fs
    from poisson_ellipse_tpu_torch.solver.engine import build_solver

    say(f"== the plain-stencil family by data on {card}")
    ours = lambda n: n.startswith("void (anonymous namespace)::")  # noqa
    rng = np.random.default_rng(seed)

    def seeded(shape, lo=None, n=QUEUE_SETS):
        return [torch.from_numpy(
            (rng.random(shape) + lo if lo is not None
             else rng.standard_normal(shape)).astype(np.float32)).to("cuda")
            for _ in range(n)]

    rows = []
    capped = Problem(M=MAIN_GRID[0], N=MAIN_GRID[1], max_iter=PROFILE_CAP)
    h1, h2 = capped.h1, capped.h2
    g = capped.node_shape
    nodes = g[0] * g[1]
    inner = (g[0] - 2) * (g[1] - 2)
    sets32 = list(zip(seeded(g), seeded(g, 0.5), seeded(g, 0.5)))
    loop_w = {}
    for dtype, form in ((torch.float32, "f32"), (BF16, "bf16")):
        a_r, b_r, _ = assembly.assemble(capped, dtype, "cuda")
        solver, args, _ = build_solver(capped, "pallas", dtype, "cuda")
        w_r = solver(*args).w
        loop_w[form] = w_r
        say(f"  the pallas {form} loop's w after {PROFILE_CAP} iterations: "
            f"{int((w_r == 0).sum())} of {w_r.numel()} nodes exactly 0")
        data = {
            "seeded": [tuple(x.to(dtype) for x in s) for s in sets32],
            "the loop's w, a, b": [(w_r.clone(), a_r.clone(), b_r.clone())
                                   for _ in range(QUEUE_SETS)],
            "w = 0": [(torch.zeros_like(w_r), a.to(dtype), b.to(dtype))
                      for _, a, b in sets32],
        }
        item = dtype.itemsize
        for pad in (1, 0):
            out = nodes if pad else inner
            _data_rows(rows, hk.KERNEL if form == "f32" else
                       f"{hk.KERNEL}_{form}", f"K-a {form} pad {pad}", data,
                       hk.apply_a_kernel if pad else hk.apply_a_block_kernel,
                       hk.apply_a_plain if pad else hk.apply_a_block_plain,
                       h1, h2, 3 * item * nodes + item * out, 18 * out,
                       "csrc/stencil.cu", "ops/pallas_kernels.py:169",
                       QUEUE_LAUNCHES["stencil"] if pad and form == "f32"
                       else 0, nodes)
        del data
        for engine in ("pallas", "sstep-pallas") if form == "f32" else \
                ("pallas",):
            _in_loop(f"K-a {form} in {engine} capped at {PROFILE_CAP}",
                     *build_solver(capped, engine, dtype, "cuda")[:2], ours)

    for (m, n), lanes in KE_CASES:
        prob = Problem(M=m, N=n, max_iter=PROFILE_CAP)
        bg = prob.node_shape
        bnodes = bg[0] * bg[1]
        a_b, b_b, rhs = batched_operands(prob, lanes, device="cuda")

        def batched(prob=prob, lanes=lanes, ops=(a_b, b_b, rhs)):
            return solve_batched(prob, lanes, "batched-pallas",
                                 operands=ops).result

        w_l = batched().w
        say(f"  batched-pallas {m}x{n} B={lanes} after {PROFILE_CAP} "
            f"bodies: {int((w_l == 0).sum())} of {w_l.numel()} nodes "
            "exactly 0")
        a_s, b_s = seeded(bg, 0.5), seeded(bg, 0.5)
        data = {
            "seeded": list(zip(seeded((lanes,) + bg), a_s, b_s)),
            "the loop's lanes": [(w_l.clone(), a_b.clone(), b_b.clone())
                                 for _ in range(QUEUE_SETS)],
            "w = 0": [(torch.zeros_like(w_l), a, b)
                      for a, b in zip(a_s, b_s)],
        }
        main = (m, n) == QUEUE_BATCH[0]
        _data_rows(rows, hk.BATCHED_KERNEL if main else None,
                   f"K-e {bg[0]}x{bg[1]} B={lanes}", data,
                   hk.apply_a_batched_kernel, hk.apply_a_batched_plain,
                   prob.h1, prob.h2, (2 + 2 * lanes) * bnodes * 4,
                   18 * bnodes * lanes, "csrc/stencil.cu",
                   "ops/pallas_kernels.py:409", KE_LAUNCHES if main else 0,
                   bnodes * lanes)
        del data
        if main:
            _in_loop(f"K-e in batched-pallas {m}x{n} B={lanes} capped at "
                     f"{PROFILE_CAP}", batched, (), ours)

    rows += kg_rows(seed)

    pairs = _bundle(*seeded(g, n=5))
    zeros = [torch.zeros(g, device="cuda") for _ in range(QUEUE_SETS)]
    _data_rows(rows, None, "K-d f32", {
        "seeded": [(*s, pairs) for s in sets32],
        "m = 0": [(z, *s[1:], pairs) for z, s in zip(zeros, sets32)]},
        lambda w, a, b, p, h1, h2: hk.apply_a_dots_kernel(w, a, b, h1, h2,
                                                          p)[0],
        lambda w, a, b, p, h1, h2: hk.apply_a_dots_plain(w, a, b, h1, h2,
                                                         p)[0],
        h1, h2, 36 * nodes, KD_FLOPS * nodes, "csrc/stencil_dots.cu",
        "ops/pallas_kernels.py:299", 0, nodes)
    _in_loop(f"K-d f32 in pipelined-pallas capped at {PROFILE_CAP}",
             *build_solver(capped, "pipelined-pallas", torch.float32,
                           "cuda")[:2], lambda n: "stencil_dots" in n)
    del pairs, zeros, sets32

    bm, bn = SHARD_BLOCKS[0]
    inp = shard_inputs(bm, bn, seed)
    a_r, b_r, _ = assembly.assemble(capped, torch.float32, "cuda")
    window = (slice(0, bm + 2), slice(0, bn + 2))
    zero_ext = dict(inp, z=loop_w["f32"][window].contiguous(),
                    p=loop_w["f32"][window].contiguous(),
                    a=a_r[window].contiguous(), b=b_r[window].contiguous())
    say(f"  K1-shard's zero exterior: the pallas f32 loop's w on the "
        f"top-left {bm + 2}x{bn + 2} window as z and p, "
        f"{int((zero_ext['z'] == 0).sum())} of {zero_ext['z'].numel()} "
        "exactly 0")
    n_own, n_ext = bm * bn, (bm + 2) * (bn + 2)
    n1, n2 = fs.partial_counts(bm, bn)
    never = 2**31 - 1

    def shard_set(src):
        return dict(src, pn=torch.empty((bm, bn), device="cuda"),
                    ap=torch.empty((bm, bn), device="cuda"),
                    w=src["w"].clone(), r=src["r"].clone(),
                    zo=torch.empty((bm, bn), device="cuda"),
                    parts=fs.scratch(bm, bn, "cuda"))

    def k1(s, fn=fs.k1):
        fn(s["z"], s["p"], s["a"], s["b"], s["d"], s["pn"], s["ap"],
           s["scal"], s["flags"], s["parts"][0], max_iter=never, h1=h1,
           h2=h2)

    def k2(s, fn=fs.k2):
        fn(s["w"], s["r"], s["pn"], s["ap"], s["dinv"], s["zo"], s["scal"],
           s["flags"], s["parts"][1], max_iter=never)

    for kind, src in (("seeded", inp), ("the loop's zero exterior",
                                        zero_ext)):
        sets = [shard_set(src) for _ in range(QUEUE_SETS)]
        for s in sets:
            k1(s)
        plain_set = shard_set(src)
        plain_set["parts"] = (torch.zeros(1, dtype=torch.float64,
                                          device="cuda"),
                              torch.zeros((1, 2), dtype=torch.float64,
                                          device="cuda"))
        timed_row(rows, None, f"K1-shard {bm}x{bn}, {kind}",
                  [lambda s=s: k1(s) for s in sets],
                  lambda: k1(plain_set, fs.k1_plain),
                  4 * (4 * n_ext + 3 * n_own) + 8 * n1,
                  K1_SHARD_FLOPS * n_own, "csrc/fused_sharded.cu",
                  "parallel/fused_sharded.py:179", launches=0, per=n_own)
        if kind == "seeded":
            timed_row(rows, None, f"K2-shard {bm}x{bn}",
                      [lambda s=s: k2(s) for s in sets],
                      lambda: k2(plain_set, fs.k2_plain),
                      4 * 8 * n_own + 16 * n2, K2_SHARD_FLOPS * n_own,
                      "csrc/fused_sharded.cu",
                      "parallel/fused_sharded.py:207", launches=0,
                      per=n_own)
        del sets
    say("  the K-d and K1-shard libraries' SASS (cuobjdump -sass)")
    show_sass("stencil_dots", "stencil_dots")
    show_sass("fused_sharded", "k1")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--only", choices=("stage4", "stage4-timing", "stencil-dots-timing",
                           "xl-timing", "stencil-timing", "whole-timing"),
        help="run phases 1-2 and then only phase 12's stage-4 kernel checks, "
             "loop and timing (stage4), its timing alone (stage4-timing), "
             "rule 2's queue by device time, the K-d family's SASS and the "
             "loops that launch K-d and K-h (stencil-dots-timing), or xl's "
             "forms and body by phase, the grid barrier, K-g's forms and "
             "the in-loop times (xl-timing), or K-a and K-e by input data "
             "and in their loops beside K-g, K-d and K1-shard "
             "(stencil-timing), or resident and streamed by phase beside "
             "xl (whole-timing); the timings also run on an older tree's "
             "kernels; prints the kernels' record and no result line")
    ap.add_argument("--sass-dir", help="with --only stencil-dots-timing, "
                    "write the SASS listings of the K-d and K-a libraries "
                    "to this directory")
    args = ap.parse_args(argv)

    card, kind = phase_device()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.only == "stencil-dots-timing":
        timed = phase_queue_timing(args.seed, card, args.sass_dir)
    elif args.only == "xl-timing":
        timed = phase_xl_timing(args.seed, card)
    elif args.only == "stencil-timing":
        timed = phase_stencil_timing(args.seed, card)
    elif args.only == "whole-timing":
        from poisson_ellipse_tpu_torch.utils.device import capacity

        timed = phase_whole_timing_split(capacity(0), card)
    elif args.only:
        if args.only == "stage4":
            phase_stage4_kernels(args.seed)
            phase_stage4_loop()
        timed = phase_stage4_timing(args.seed, card)
    if args.only:
        print(card, flush=True)
        print(json.dumps({"kernels": timed}), flush=True)
        return 0
    from poisson_ellipse_tpu_torch.utils.device import capacity

    cap = capacity(0)
    say(f"capacity: {cap}, cooperative launch "
        f"{cap.cooperative_launch('xl_pcg')}")
    problem, inp = kernel_inputs(args.seed)
    errs = phase_kernels(problem, inp)
    errs.update(phase_whole_kernels(cap))
    mark("phases 1-3")
    phase_oracles(cap)
    mark("phase 4")
    main_run = phase_main(cap)
    rec = phase_recurrence(cap)
    mark("phase 5")
    timed = phase_timing(problem, inp, card)
    timed += phase_whole_timing(main_run, cap, card, errs)
    # the kernels in the order they were ported: K-d after the first six
    timed.sort(key=lambda row: row["name"] == "stencil_dots")
    phase_solver_times(cap, card)
    phase_recurrence_times(rec, card)

    mark("phase 6")
    say(f"== phase 7: where the time goes (torch.profiler, {card})")
    for name in WHOLE_SOLVE:
        solver, solver_args, grid, _ = main_run["whole"][name]
        profile_solve(f"{name} {grid.M}x{grid.N}", solver, solver_args)
    profile_solve("fused 2400x3200", main_run["solver_f"], main_run["args_f"])
    for engine in ("pallas", "pipelined-pallas", "sstep-pallas"):
        profile_capped(engine)

    mark("phase 7")
    errs.update(phase_batched_kernels(args.seed))
    batched = phase_batched(args.seed)
    timed += phase_batched_timing(args.seed, card)
    phase_throughput(batched, card)
    solver, solver_args = batched["runs"][("batched-pallas", 400, 600)][:2]
    profile_solve("batched-pallas 400x600 B=32", solver, solver_args)

    mark("phase 8")
    errs.update(phase_storage_kernels(args.seed))
    storage_main = phase_storage_main()
    storage_rec = phase_storage_recurrences(card)
    phase_storage_checks()
    timed += phase_storage_timing(args.seed, storage_main, storage_rec, card)
    phase_storage_f32_recurrence_times(storage_rec, card)
    profile_capped("pallas", storage_dtype="bf16")

    mark("phase 9")
    errs.update(phase_dtype_kernels(cap, args.seed, inp))
    dtype_main = phase_dtype_main(cap)
    timed += phase_dtype_timing(cap, card)

    mark("phase 10")
    errs.update(phase_shard_kernels(args.seed))
    mesh = phase_mesh(card)
    timed += phase_shard_timing(args.seed, card)
    mark("phase 11")
    errs.update(phase_stage4_kernels(args.seed))
    errs.update(phase_bf16_kernels(args.seed))
    stage4 = phase_stage4_loop()
    bf16_loops = phase_bf16_loops(card)
    timed += phase_stage4_timing(args.seed, card)
    mark("phase 12")

    counts = {**rec["counts"], **main_run["counts"], **batched["counts"],
              **storage_main["counts"], **storage_rec["counts"],
              **dtype_main["counts"], **mesh["counts"], **stage4["counts"],
              **bf16_loops["counts"]}
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
