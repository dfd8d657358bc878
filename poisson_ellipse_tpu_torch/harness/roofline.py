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
  xl           — 12 plus the 32x32 tile's halo rereads
                 (``xl_pcg.PASSES_PER_ITER``) => 12.32

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


# the recurrence engines' terms, as the module docstring counts them
_PIPELINED_UPDATE = 3.0 + 18.0 + 6.0 + 21.0 + 25.0 / 32
_PIPELINED_STENCIL_DOTS = {"pipelined-pallas": 9.0, "pipelined": 4.0 + 16.0}


def _sstep_passes(s: int) -> float:
    K = 2 * s + 1
    return (22.0 + 9.0 * (2 * s - 1) + 20.0 * K) / s + 7.0 / 32


def passes_per_iter(engine: str, problem: Problem | None = None,
                    capacity=None, sstep_s: int = 4) -> float:
    """Modelled array passes per PCG iteration for one engine; the
    streamed engine's depends on its plan for ``problem`` on
    ``capacity`` (None: the CPU's all-resident plan), the s-step
    engines' on their block size ``sstep_s``."""
    if engine in ("xla", "pallas"):
        return 13.0
    if engine in _PIPELINED_STENCIL_DOTS:
        return _PIPELINED_UPDATE + _PIPELINED_STENCIL_DOTS[engine]
    if engine in ("sstep", "sstep-pallas"):
        return _sstep_passes(sstep_s)
    if engine == "fused":
        return 17.0
    if engine == "resident":
        return 0.0
    if engine == "streamed":
        from poisson_ellipse_tpu_torch.ops.streamed_pcg import StreamPlan

        if problem is None:
            raise ValueError("the streamed engine's traffic follows its "
                             "plan: pass the problem")
        return StreamPlan(problem, capacity).streamed_passes_per_iter()
    if engine == "xl":
        from poisson_ellipse_tpu_torch.ops.xl_pcg import PASSES_PER_ITER

        return PASSES_PER_ITER
    raise ValueError(f"no traffic model for engine {engine!r}")


def roofline(problem: Problem, engine: str, iters: int, t_solver: float,
             dtype=torch.float32, device="cuda", capacity=None,
             sstep_s: int = 4) -> dict:
    """{"passes_per_iter", "hbm_gbps", "hbm_peak_frac"} for a measured
    solve. The rate is a device-memory rate, so it is None for a run on
    the CPU; the fraction is None where the peak is unknown."""
    g1, g2 = problem.node_shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    passes = passes_per_iter(engine, problem, capacity, sstep_s)
    out = {"passes_per_iter": passes, "hbm_gbps": None, "hbm_peak_frac": None}
    if torch.device(device).type != "cuda" or t_solver <= 0:
        return out
    rate = passes * g1 * g2 * itemsize * max(iters, 1) / t_solver
    peak = memory_peak_bytes_per_s(device)
    out["hbm_gbps"] = round(rate / 1e9, 2)
    if peak:
        out["hbm_peak_frac"] = round(rate / peak, 4)
    return out
