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
it once to float (then to bf16 in a bf16 form); the plain versions do the
same (``total``). So the two
agree bitwise in practice, though their sums run in different orders: a
float sum's order alone moves α and β in their last bits, and the
resident form's cancelling stencil grows that to 6e-5 of w's scale within
7 iterations at 401×601.

The dtype axes (``FORMS``): each kernel is a template on its compute
type, float or bf16, and the streamed and xl kernels also on the load type
of their operands (dinv, an, bw), f32 compute with bf16 or f16 operand
streams. A narrow stream is upcast exactly after its load, so that form is
the f32 kernel on the upcast operands. A bf16-compute form stores bf16:
every array element, every grid sum and every scalar of the carry is a
bf16 value, computed in float from stored values and rounded once where it
is stored; the plain versions do the same on f32 tensors (``rounder``).
That tracks the JAX kernels' bf16 counts; rounding each operation
instead, as PyTorch's bf16 ops do, loses the cancelling stencil
d·p − Σ(neighbours) of the resident and fused kernels: at 40×40, δ = 1e-4,
fused then takes 45 iterations against the JAX package's 33 (32 this way).

The helpers here are the plain versions' shared pieces: the sum, the
interior mask, the neighbour shifts, the stencil form and the scalar tail;
and the forms' names, checks and launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.solver.pcg import DENOM_GUARD, PCGResult

# the kernels' status word (csrc/grid_sync.cuh enum Status)
STATUS_ITERS, STATUS_CONVERGED, STATUS_BREAKDOWN, STATUS_DONE = range(4)
N_STATUS = 4

# bytes of shared memory each block keeps for its sums
# (csrc/grid_sync.cuh kReduceBytes: 66 doubles, two sums at once)
REDUCE_BYTES = 528

# per-block partial sums a kernel keeps, in double: three sums per iteration
N_PARTIALS = 3

# ctypes argument types of the launchers
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# The march of the resident and streamed kernels (csrc/grid_sync.cuh
# march_split, march_unit): a block reads its span of ``length`` nodes as
# span-local rows of g2 nodes; a lane owns a column m < g2 and marches its
# steps t (node m + t*g2), a warp a strip of 32 columns; a unit is a strip
# and a segment of the steps, warp w marching units w, w + warps, ...


@dataclasses.dataclass(frozen=True)
class MarchSplit:
    """The kernels' work split of a span (``march_split``)."""

    strips: int    # 32-column strips over the first min(span, g2) columns
    segs: int      # segments each strip's steps are cut into
    rows: int      # steps of the span's longest lane
    warps: int     # warps a block
    per_warp: int  # units a warp marches, at most

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def units(self) -> int:
        return self.strips * self.segs


def march_split(span: int, g2: int, steps: int,
                max_warps: int) -> MarchSplit:
    """The split of a ``span``-node span of a grid g2 nodes wide, a unit at
    most ``steps`` steps (the kernel's unrolled loop), over at most
    ``max_warps`` warps: the arithmetic of ``pe::march_split``."""
    width = min(span, g2)
    strips = -(-width // 32)
    rows = -(-span // g2)
    segs = -(-rows // steps)
    units = strips * segs
    warps = min(units, max_warps)
    per_warp = -(-units // warps)
    return MarchSplit(strips, segs, rows, -(-units // per_warp), per_warp)


def march_nodes(split: MarchSplit, length: int, g2: int):
    """Every step of the march over a block's ``length`` nodes, as the
    kernel takes them (``pe::march_unit``): yields (warp, j, lane, step,
    span-local node) for unit j of each warp."""
    lq, lr = divmod(length, g2)
    for warp in range(split.warps):
        for j in range(split.per_warp):
            u = warp + j * split.warps
            if u >= split.units:
                continue
            seg, strip = divmod(u, split.strips)
            t0 = seg * split.rows // split.segs
            t1 = (seg + 1) * split.rows // split.segs
            for lane in range(32):
                m = 32 * strip + lane
                t_last = lq - (1 if m >= lr else 0)
                if m >= g2:
                    continue
                for t in range(t0, min(t1, t_last + 1)):
                    yield warp, j, lane, t, m + t * g2


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype, as a 0-dim tensor on its device."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


# the short names of the kernels' types
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16"}

# the (compute, load) forms of the streamed and xl kernels; the resident
# kernel and K-b/K-c have the compute forms only
FORMS = ("f32", "bf16", "f32_bf16", "f32_f16")
COMPUTE_FORMS = ("f32", "bf16")


def form_of(compute: torch.dtype, load: torch.dtype | None = None) -> str:
    """The kernel form that computes at ``compute`` and loads its operands
    at ``load`` (None: at ``compute``): "f32", "bf16", "f32_bf16" or
    "f32_f16". Raises for a pair no kernel is built for."""
    load = compute if load is None else load
    name = DTYPE_NAMES.get(compute, str(compute))
    if load != compute:
        name += "_" + DTYPE_NAMES.get(load, str(load))
    if name not in FORMS:
        raise ValueError(
            f"no kernel computes at {compute} with operands at {load}: the "
            f"forms are {', '.join(FORMS)} (compute, then operand loads)")
    return name


def counter(kernel: str, form: str) -> str:
    """The launch counter (``_build.LAUNCHES``) of ``kernel``'s ``form``:
    the kernel's own name for f32, ``<kernel>_<form>`` for the others."""
    return kernel if form == "f32" else f"{kernel}_{form}"


def total(x: torch.Tensor) -> torch.Tensor:
    """Σx accumulated in double and rounded once to x's dtype, through
    float when that is narrower, as the kernels sum
    (``csrc/grid_sync.cuh``)."""
    s = torch.sum(x, dtype=torch.float64)
    return s.to(x.dtype) if x.dtype.itemsize >= 4 else s.float().to(x.dtype)


def held(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a plain version holds it: a narrow tensor upcast to f32
    (exact), a wider one as it is."""
    return x if x.dtype.itemsize >= 4 else x.float()


def rounder(dtype: torch.dtype):
    """q(x): a held value rounded to the compute dtype ``dtype``, where a
    kernel stores it (the identity from f32 up)."""
    if dtype.itemsize >= 4:
        return lambda x: x
    return lambda x: x.to(dtype).float()


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


def below_guard(denom, dtype: torch.dtype):
    """The breakdown test, the guard rounded to the compute dtype as a
    comparison of a ``dtype`` tensor with the Python float rounds it."""
    return denom < rounded(DENOM_GUARD, dtype)


def guarded_alpha(zr, denom, q, dtype: torch.dtype):
    """α = zr/denom rounded by ``q`` to the compute ``dtype``, 0 when the
    denominator guard trips."""
    guard = below_guard(denom, dtype)
    alpha = q(zr / torch.where(guard, torch.ones_like(denom), denom))
    return torch.where(guard, torch.zeros_like(alpha), alpha)


def guarded_reciprocal(dinv):
    """1/dinv on the interior, 0 where dinv is 0."""
    nonzero = dinv != 0.0
    return torch.where(nonzero,
                       1.0 / torch.where(nonzero, dinv, torch.ones_like(dinv)),
                       torch.zeros_like(dinv))


class Carry:
    """The plain loops' scalar carry (0-dim tensors), each value rounded by
    ``q`` (``rounder``) where it is formed."""

    def __init__(self, zr: torch.Tensor, q=None):
        self.q = q or (lambda x: x)
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
        q = self.q
        zr_new = q(zr_raw * hh)
        ndiff = q(torch.sqrt(dw2 * hh) if weighted else torch.sqrt(dw2))
        converged = ~breakdown & (ndiff < delta)
        self.diff = torch.where(breakdown, self.diff, ndiff)
        self.beta = torch.where(breakdown, self.beta, q(zr_new / self.zr))
        self.zr = torch.where(breakdown, self.zr, zr_new)
        self.converged = converged
        self.breakdown = breakdown


def plain_result(w, iters: int, carry: Carry, dtype=None) -> PCGResult:
    """The result of a plain loop, w and diff at the compute ``dtype``
    (default: w's)."""
    dtype = dtype or w.dtype
    return PCGResult(
        w=w.to(dtype),
        iters=torch.tensor(iters, dtype=torch.int32, device=w.device),
        diff=carry.diff.to(dtype),
        converged=carry.converged,
        breakdown=carry.breakdown,
    )


def check_operands(kernel: str, problem: Problem, arrays: dict,
                   dtypes: dict) -> None:
    """Raise for what the kernels do not take: every array of the dtype
    ``dtypes`` names for it (its form's compute or load type), 2-D of the
    node grid's shape, contiguous, on one CUDA device."""
    shape = problem.node_shape
    first = next(iter(arrays.values()))
    if shape[0] * shape[1] >= 2**31:
        raise ValueError(f"{kernel}: grid {shape} exceeds 32-bit indexing")
    for name, t in arrays.items():
        if (t.dtype != dtypes[name] or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != first.device):
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); expected "
                f"contiguous {dtypes[name]} {shape} on {first.device}"
            )


@functools.lru_cache(maxsize=256)
def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (through float, as PyTorch rounds a
    Python float to bf16), as the float a launcher takes: the kernels
    compare and multiply by the values their plain versions hold. Rounded
    on the host, so a launch reads nothing back from the card."""
    return float(torch.tensor(x, dtype=dtype))


def h1h2_rounded(problem: Problem, dtype: torch.dtype) -> float:
    """``h1h2`` as the float a whole-solve launcher takes."""
    return rounded(float(problem.h1) * float(problem.h2), dtype)


def scratch(like: torch.Tensor, nblocks: int):
    """(status, diff, partials) for one launch of ``nblocks`` blocks; diff
    at ``like``'s (the compute) dtype."""
    status = torch.zeros(N_STATUS, dtype=torch.int32, device=like.device)
    diff = torch.empty(1, dtype=like.dtype, device=like.device)
    partials = torch.empty(N_PARTIALS * nblocks, dtype=torch.float64,
                           device=like.device)
    return status, diff, partials


# the timing instantiations of the resident and streamed kernels: block
# 0's stamps a body besides two a block (csrc/grid_sync.cuh kWholeStamps)
WHOLE_STAMPS = 6


def stamps_buffer(problem: Problem, nblocks: int, device) -> torch.Tensor:
    """The zeroed stamps of one timed launch of the resident or streamed
    kernel (their ``stamps=``): a row a body, WHOLE_STAMPS of block 0, then
    each block's stencil-phase end and each block's update-phase end."""
    return torch.zeros((problem.max_iterations, WHOLE_STAMPS + 2 * nblocks),
                       dtype=torch.int64, device=device)


def launch_form(library: str, kernel: str, form: str, signature: list,
                args: tuple, stamps: torch.Tensor | None,
                stamp_shape: tuple) -> None:
    """Launch ``form`` of a whole-solve kernel, or with ``stamps`` its
    timing instantiation (counted as ``<counter>_stamps``); ``stamps``
    must have ``stamp_shape``."""
    if stamps is None:
        launch(library, counter(kernel, form), f"pe_{library}_{form}",
               signature, *args)
        return
    if tuple(stamps.shape) != stamp_shape or stamps.dtype != torch.int64:
        raise ValueError(f"{kernel}: stamps must be int64 {stamp_shape}")
    launch(library, f"{counter(kernel, form)}_stamps",
           f"pe_{library}_stamps_{form}", signature + [PTR], *args,
           stamps.data_ptr())


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
