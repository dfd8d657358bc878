"""Bytes-per-iteration roofline model: achieved memory bandwidth per engine.

One "pass" is one full node-array read or write against device memory.

  xla / pallas — stencil (read p, a, b; write ap)                 4
                 w/r update (read w, r, p, ap; write w, r)         6
                 z = r*dinv (r fused; read dinv; write z)          2
                 p = z + beta*p (z fused; read p; write p)         1
                 => 13
  fused        — K1 reads z, p and five coefficient arrays and
                 writes pn, ap (9); K2 reads w, r, pn, ap, dinv and
                 writes w, r, z (8) => 17
  resident     — every array stays in shared memory => 0
  streamed     — the state stays in shared memory; each streamed
                 operand of its plan costs 1 (dinv, a, b) or 2 (ap)
                 (``StreamPlan.streamed_passes_per_iter``)
  xl           — 12 plus the march's halo rereads, a row above and
                 below a 120-row unit, a column beside a 32-column strip
                 (``xl_pcg.PASSES_PER_ITER``) => 12.20

The recurrence engines are counted statement by statement as the port
runs them (each statement reads each operand once and writes its result
once; D⁻¹v reads v and D: 3; a stencil reads v, a, b: 4):

  pipelined-pallas — m = D⁻¹w                                       3
                     K-d (m, a, b, the bundle's r, u, w, s, p; n)    9
                     z⁺, s⁺, p⁺, x⁺, r⁺, w⁺ (two reads, one write)   18
                     u⁺ = u − α·D⁻¹s⁺ (D⁻¹s⁺ 3, the update 3)         6
                     seven masked stores (read new, old; write)     21
                     the replacement every 32: r = rhs − Ax (7),
                     u = D⁻¹r (3), s = Ap (4), w = Au (4),
                     z = A·D⁻¹s (7) => 25/32                         0.78
                     => 57.78
  pipelined        — the same with the plain stencil (4) and the
                     bundle as eight sums of two reads each (16) in
                     place of K-d => 68.78
  sstep, sstep-pallas — per block of s iterations, K = 2s+1 basis
                     vectors (an f64 array counts 2):
                     z = D⁻¹r                                         3
                     2s−1 basis steps Â·v/ρ (stencil 4, D⁻¹ 3,
                     scale 2)                                   9(2s−1)
                     stack V (K reads, K writes)                     2K
                     V to f64 (K reads, 2K writes)                   3K
                     V·D in f64 (2K + 1 reads, 2K writes)          4K+1
                     Gm and Ge (each reads two f64 operands)         8K
                     x, z, p from V (K reads each; x + ·, D·z)     3K+9
                     three masked stores                              9
                     => (22 + 9(2s−1) + 20K)/s, plus the
                     replacement r = rhs − Ax (7) once every 32
                     => 66.47 (s = 4), 74.72 (s = 2)

A pass moves one array at the compute width: 4 bytes at f32, 2 at bf16
compute. With a storage dtype (``ops.precision``) a pass moves one array
at the storage width (2 bytes for bf16 and f16), and the recurrences'
replacement terms are amortised over ``replace_every(storage_dtype)`` (8)
in place of 32: ``pipelined-pallas`` 25/8 and the s-step 7/8. The plain
PyTorch loops also upcast in passes of their own that the model does not
count. ``streamed`` and ``xl`` store only their operands narrow: their
operand passes (dinv, a, b; ``xl_pcg.OPERAND_PASSES``, 3.04 of xl's
12.20) move at the storage width, the rest at the compute width
(``bytes_per_node``).

The model counts unpadded node arrays and assumes each array streams
once per use; the plain PyTorch loop (``xla``) moves more than that,
since each of its operations is its own pass. The whole-solve engines'
halo rows and per-block partials (a few rows per block per iteration,
mostly from L2) are not counted.
"""

from __future__ import annotations

from typing import Optional

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.precision import (
    replace_every,
    storage_itemsize,
)

# Published peak device-memory bandwidth by CUDA device name (bytes/s).
_MEMORY_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H200": 4.8e12,
}


def memory_peak_bytes_per_s(device=None) -> Optional[float]:
    """Peak memory bandwidth of a CUDA device, or None if its name is not
    in the table (and for the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return _MEMORY_PEAK.get(torch.cuda.get_device_name(dev))


# the recurrence engines' terms, as the module docstring counts them (the
# replacement's 25 passes go on top, amortised over the cadence)
_PIPELINED_UPDATE = 3.0 + 18.0 + 6.0 + 21.0
_PIPELINED_STENCIL_DOTS = {"pipelined-pallas": 9.0, "pipelined": 4.0 + 16.0}


def _sstep_passes(s: int, cadence: int) -> float:
    K = 2 * s + 1
    return (22.0 + 9.0 * (2 * s - 1) + 20.0 * K) / s + 7.0 / cadence


def passes_per_iter(engine: str, problem: Problem | None = None,
                    capacity=None, sstep_s: int = 4,
                    storage_dtype=None, dtype=torch.float32) -> float:
    """Modelled array passes per PCG iteration for one engine; the
    streamed engine's depends on its plan for ``problem`` on
    ``capacity`` (None: the CPU's all-resident plan), the s-step
    engines' on their block size ``sstep_s``, the recurrences' on the
    replacement cadence of ``storage_dtype`` against ``dtype``."""
    if engine in ("xla", "pallas"):
        return 13.0
    cadence = replace_every(storage_dtype, dtype)
    if engine in _PIPELINED_STENCIL_DOTS:
        return (_PIPELINED_UPDATE + 25.0 / cadence
                + _PIPELINED_STENCIL_DOTS[engine])
    if engine in ("sstep", "sstep-pallas"):
        return _sstep_passes(sstep_s, cadence)
    if engine == "fused":
        return 17.0
    if engine == "resident":
        return 0.0
    if engine == "streamed":
        from poisson_ellipse_tpu_torch.ops.streamed_pcg import StreamPlan

        if problem is None:
            raise ValueError("the streamed engine's traffic follows its "
                             "plan: pass the problem")
        return StreamPlan(problem, capacity,
                          dtype).streamed_passes_per_iter()
    if engine == "xl":
        from poisson_ellipse_tpu_torch.ops.xl_pcg import PASSES_PER_ITER

        return PASSES_PER_ITER
    raise ValueError(f"no traffic model for engine {engine!r}")


def operand_passes(engine: str, problem: Problem | None = None,
                   capacity=None, dtype=torch.float32) -> float:
    """The passes of ``passes_per_iter`` that read the operands dinv, a
    and b: what a storage dtype narrows on ``streamed`` and ``xl``."""
    if engine == "xl":
        from poisson_ellipse_tpu_torch.ops.xl_pcg import OPERAND_PASSES

        return OPERAND_PASSES
    if engine == "streamed":
        from poisson_ellipse_tpu_torch.ops.streamed_pcg import StreamPlan

        plan = StreamPlan(problem, capacity, dtype)
        return float(sum(not plan.resident[k] for k in ("dinv", "a", "b")))
    raise ValueError(f"engine {engine!r} stores its state narrow, not only "
                     "its operands")


def bytes_per_node(engine: str, problem: Problem | None = None,
                   capacity=None, sstep_s: int = 4, storage_dtype=None,
                   dtype=torch.float32) -> float:
    """Bytes an iteration moves per node: the passes at the storage width
    (the compute width without one); on ``streamed`` and ``xl`` only
    their operand passes at the storage width."""
    passes = passes_per_iter(engine, problem, capacity, sstep_s,
                             storage_dtype, dtype)
    item = storage_itemsize(dtype, storage_dtype)
    if engine not in ("streamed", "xl"):
        return passes * item
    narrow = operand_passes(engine, problem, capacity, dtype)
    return (passes - narrow) * dtype.itemsize + narrow * item


def roofline(problem: Problem, engine: str, iters: int, t_solver: float,
             dtype=torch.float32, device="cuda", capacity=None,
             sstep_s: int = 4, storage_dtype=None) -> dict:
    """{"passes_per_iter", "hbm_gbps", "hbm_peak_frac"} for a measured
    solve, the bytes counted by ``bytes_per_node``. The rate is a device-memory
    rate, so it is None for a run on the CPU; the fraction is None where
    the peak is unknown."""
    g1, g2 = problem.node_shape
    passes = passes_per_iter(engine, problem, capacity, sstep_s,
                             storage_dtype, dtype)
    out = {"passes_per_iter": passes, "hbm_gbps": None, "hbm_peak_frac": None}
    if torch.device(device).type != "cuda" or t_solver <= 0:
        return out
    rate = (bytes_per_node(engine, problem, capacity, sstep_s, storage_dtype,
                           dtype) * g1 * g2 * max(iters, 1) / t_solver)
    peak = memory_peak_bytes_per_s(device)
    out["hbm_gbps"] = round(rate / 1e9, 2)
    if peak:
        out["hbm_peak_frac"] = round(rate / peak, 4)
    return out
