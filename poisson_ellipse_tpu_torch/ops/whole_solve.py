"""What the whole-solve engines (``resident``, ``streamed``, ``xl``) share.

Each runs the whole PCG solve in one cooperative launch of a persistent
CUDA kernel (``csrc/resident_pcg.cu``, ``streamed_pcg.cu``, ``xl_pcg.cu``,
over the grid barrier and deterministic sums of ``csrc/grid_sync.cuh``).
The kernel leaves a status word (iterations, converged, breakdown, done)
and the last step norm in device memory; the host reads the status word
once per solve, after the launch, and raises if the kernel did not mark
it done (``launch_result``).

Beside each kernel is its plain PyTorch version (``resident_plain``,
``streamed_plain``, ``xl_plain``): a Python loop over iterations with the
JAX kernel's per-element expressions in the same order. The CPU runs it,
and ``chip_smoke.py`` holds each kernel against it on the card. No wrapper
falls back to it: a build or launch failure raises.

The kernels accumulate every sum in double from its float terms and round
it once to float; the plain versions do the same (``total``). So the two
agree bitwise in practice, though their sums run in different orders: a
float sum's order alone moves α and β in their last bits, and the
resident form's cancelling stencil grows that to 6e-5 of w's scale within
7 iterations at 401×601.

The helpers here are the plain versions' shared pieces: the sum, the
interior mask, the neighbour shifts, the stencil form and the scalar tail.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD, PCGResult

# the kernels' status word (csrc/grid_sync.cuh enum Status)
STATUS_ITERS, STATUS_CONVERGED, STATUS_BREAKDOWN, STATUS_DONE = range(4)
N_STATUS = 4

# bytes of shared memory each block keeps for its sums
# (csrc/grid_sync.cuh kReduceBytes: 40 doubles)
REDUCE_BYTES = 320

# per-block partial sums a kernel keeps, in double: three sums per iteration
N_PARTIALS = 3

# ctypes argument types of the launchers
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype, as a 0-dim tensor on its device."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def total(x: torch.Tensor) -> torch.Tensor:
    """Σx accumulated in double and rounded once to x's dtype, as the
    kernels sum (``csrc/grid_sync.cuh``)."""
    return torch.sum(x, dtype=torch.float64).to(x.dtype)


def h1h2(problem: Problem, like: torch.Tensor) -> torch.Tensor:
    """h1·h2 formed in double and rounded once, as the TPU kernels take it."""
    return scalar(float(problem.h1) * float(problem.h2), like)


def interior(problem: Problem, like: torch.Tensor) -> torch.Tensor:
    """The interior mask 1..M-1 × 1..N-1 of the node grid."""
    g1, g2 = like.shape
    gi = torch.arange(g1, device=like.device)[:, None]
    gj = torch.arange(g2, device=like.device)[None, :]
    return ((gi >= 1) & (gi <= problem.M - 1)
            & (gj >= 1) & (gj <= problem.N - 1))


def neighbours(p: torch.Tensor):
    """(p↑, p↓, p←, p→): p at row i-1, row i+1, column j-1, column j+1,
    zero outside the grid."""
    ext = F.pad(p, (1, 1, 1, 1))
    return ext[:-2, 1:-1], ext[2:, 1:-1], ext[1:-1, :-2], ext[1:-1, 2:]


def next_row(x: torch.Tensor) -> torch.Tensor:
    """x at row i+1, zero past the last row."""
    return F.pad(x[1:], (0, 0, 0, 1))


def next_col(x: torch.Tensor) -> torch.Tensor:
    """x at column j+1, zero past the last column."""
    return F.pad(x[:, 1:], (0, 1))


def stencil_unmasked(pn, an, bw, inside):
    """A·pn in the streamed and xl kernels' form (streamed_pcg.py:330-369
    of the JAX package): the unmasked an = a/h1², bw = b/h2², the output
    masked to the interior."""
    pu, pd, pl, pr = neighbours(pn)
    ax = an * (pn - pu) + next_row(an) * (pn - pd)
    ay = bw * (pn - pl) + next_col(bw) * (pn - pr)
    return torch.where(inside, ax + ay, torch.zeros_like(pn))


def guarded_alpha(zr, denom):
    """α = zr/denom, 0 when the denominator guard trips."""
    guard = denom < DENOM_GUARD
    alpha = zr / torch.where(guard, torch.ones_like(denom), denom)
    return torch.where(guard, torch.zeros_like(alpha), alpha)


def guarded_reciprocal(dinv):
    """1/dinv on the interior, 0 where dinv is 0."""
    nonzero = dinv != 0.0
    return torch.where(nonzero,
                       1.0 / torch.where(nonzero, dinv, torch.ones_like(dinv)),
                       torch.zeros_like(dinv))


class Carry:
    """The plain loops' scalar carry (0-dim tensors)."""

    def __init__(self, zr: torch.Tensor):
        self.zr = zr
        self.beta = torch.zeros_like(zr)
        self.diff = torch.full_like(zr, float("inf"))
        self.converged = torch.zeros((), dtype=torch.bool, device=zr.device)
        self.breakdown = torch.zeros_like(self.converged)

    def active(self) -> bool:
        return not bool(self.converged) and not bool(self.breakdown)

    def advance(self, breakdown, dw2, zr_raw, hh, delta, weighted: bool):
        """The scalar tail of the resident and streamed iterations
        (resident_pcg.py:179-184 of the JAX package): convergence on the
        realised step norm; on breakdown zr, β and diff are held, as the
        reference exits before touching them."""
        zr_new = zr_raw * hh
        ndiff = torch.sqrt(dw2 * hh) if weighted else torch.sqrt(dw2)
        converged = ~breakdown & (ndiff < delta)
        self.diff = torch.where(breakdown, self.diff, ndiff)
        self.beta = torch.where(breakdown, self.beta, zr_new / self.zr)
        self.zr = torch.where(breakdown, self.zr, zr_new)
        self.converged = converged
        self.breakdown = breakdown


def plain_result(w, iters: int, carry: Carry) -> PCGResult:
    return PCGResult(
        w=w,
        iters=torch.tensor(iters, dtype=torch.int32, device=w.device),
        diff=carry.diff,
        converged=carry.converged,
        breakdown=carry.breakdown,
    )


def check_operands(kernel: str, problem: Problem, arrays: dict) -> None:
    """Raise for what the kernels do not take: every array float32, 2-D of
    the node grid's shape, contiguous, on one CUDA device."""
    shape = problem.node_shape
    first = next(iter(arrays.values()))
    if shape[0] * shape[1] >= 2**31:
        raise ValueError(f"{kernel}: grid {shape} exceeds 32-bit indexing")
    for name, t in arrays.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != first.device):
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); expected "
                f"contiguous float32 {shape} on {first.device}"
            )


def scratch(like: torch.Tensor, nblocks: int):
    """(status, diff, partials) for one launch of ``nblocks`` blocks."""
    status = torch.zeros(N_STATUS, dtype=torch.int32, device=like.device)
    diff = torch.empty(1, dtype=like.dtype, device=like.device)
    partials = torch.empty(N_PARTIALS * nblocks, dtype=torch.float64,
                           device=like.device)
    return status, diff, partials


def launch(library: str, kernel: str, symbol: str, signature: list,
           *args) -> None:
    """Call a whole-solve library's launcher, raise on its CUDA error code
    (a refused cooperative launch among them) and count the launch."""
    lib = _build.load(library, {
        symbol: (INT, signature),
        f"pe_{library}_error_string": (ctypes.c_char_p, [INT]),
    })
    rc = getattr(lib, symbol)(*args)
    _build.check(getattr(lib, f"pe_{library}_error_string"), kernel, rc)
    _build.count_launch(kernel)


def launch_result(kernel: str, w, status, diff) -> tuple[PCGResult, int]:
    """The launch's result and its one host read: the status word, which
    must carry the kernel's done mark."""
    host = status.tolist()
    if host[STATUS_DONE] != 1:
        raise RuntimeError(f"{kernel}: the kernel did not run to its end "
                           f"(status {host})")
    return PCGResult(
        w=w,
        iters=status[STATUS_ITERS],
        diff=diff[0],
        converged=status[STATUS_CONVERGED].to(torch.bool),
        breakdown=status[STATUS_BREAKDOWN].to(torch.bool),
    ), 1
