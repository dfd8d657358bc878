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

The model counts unpadded node arrays and assumes each array streams
once per use; the plain PyTorch loop (``xla``) moves more than that,
since each of its operations is its own pass.
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


def passes_per_iter(engine: str) -> float:
    """Modelled array passes per PCG iteration for one engine."""
    if engine in ("xla", "pallas"):
        return 13.0
    if engine == "fused":
        return 17.0
    raise ValueError(f"no traffic model for engine {engine!r}")


def roofline(problem: Problem, engine: str, iters: int, t_solver: float,
             dtype=torch.float32, device="cuda") -> dict:
    """{"passes_per_iter", "hbm_gbps", "hbm_peak_frac"} for a measured
    solve. The rate is a device-memory rate, so it is None for a run on
    the CPU; the fraction is None where the peak is unknown."""
    g1, g2 = problem.node_shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    passes = passes_per_iter(engine)
    out = {"passes_per_iter": passes, "hbm_gbps": None, "hbm_peak_frac": None}
    if torch.device(device).type != "cuda" or t_solver <= 0:
        return out
    rate = passes * g1 * g2 * itemsize * max(iters, 1) / t_solver
    peak = memory_peak_bytes_per_s(device)
    out["hbm_gbps"] = round(rate / 1e9, 2)
    if peak:
        out["hbm_peak_frac"] = round(rate / peak, 4)
    return out
