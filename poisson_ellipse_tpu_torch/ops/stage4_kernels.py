"""The reference's stage-4 vector kernels as Hopper kernels, with plain twins.

The counterpart of the last four kernels of
``poisson_ellipse_tpu/ops/pallas_kernels.py:556-710``, the TPU forms of the
reference's ``apply_Dinv_kernel``, ``dot_kernel``, ``update_w_r_kernel``
and ``update_p_kernel`` (``poisson_mpi_cuda2.cu:541-676``). Each keeps its
JAX name, argument order and return convention:

- ``apply_dinv_pallas(r, d)`` → z = r/D, 0 where D = 0;
- ``dot_pallas(x, y, h1, h2)`` → h1·h2·Σxy, a 0-d tensor;
- ``update_w_r_pallas(alpha, w, r, p, ap)`` → (w + αp, r − α·ap, Σdw²),
  Σdw² raw (unweighted) and taken from the realised increment
  w_new − w_old, not from α·p;
- ``update_p_pallas(beta, z, p)`` → z + βp.

α and β are 0-d tensors on the arrays' device; the kernels read them
through a pointer, so no call reads a value back to the host.

The kernels are ``csrc/stage4.cu``, templated on f32 and f64 (the
reference's own stage-4 dtype, at which the JAX package's tests run
these kernels). Any other dtype raises. No engine calls them, in the JAX
package or here: the path is these public functions.

Each ``*_plain`` is the same floating-point expression tree in PyTorch:
the elementwise results are two rounded operations, as the kernels built
with ``-fmad=false`` compute them, so arrays agree bitwise; the sums take
each product in double, add in double and round once to the dtype, as the
kernels do in another order, so they agree to one rounding of the dtype.

A dispatcher runs the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. There is no fallback.

The host path of a launch is kept short, since a loop of calls is paced by
whichever of the host and the kernel is slower: the library's signatures
are declared once (``_build.load``), h1 and h2 are rounded on the host
without a tensor (``stencil.rounded``), and the sums' scratch (block
partials and the last-block ticket) is the pair ``ops.scratch`` keeps per
device and stream (``_scratch``): the kernels leave the ticket at 0, so a
call issues its kernel and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from poisson_ellipse_tpu_torch.ops import _build, scratch
from poisson_ellipse_tpu_torch.ops.stencil import apply_dinv, rounded, spacing

LIBRARY = "stage4"

# launch-counter names, one a kernel
DINV_KERNEL = "dinv"
DOT_KERNEL = "dot"
UPDATE_W_R_KERNEL = "update_w_r"
UPDATE_P_KERNEL = "update_p"

# the dtypes the kernels take, by their names in the C entry points
DTYPES = {torch.float32: "f32", torch.float64: "f64"}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SCALAR = {"f32": ctypes.c_float, "f64": ctypes.c_double}
SIGNATURES = {
    "pe_stage4_error_string": (ctypes.c_char_p, [_I]),
    "pe_stage4_scratch_len": (_I, [_I]),
    **{sym: sig for form, h in _SCALAR.items() for sym, sig in (
        # r, d, z, n, stream
        (f"pe_dinv_{form}", (_I, [_P] * 3 + [_L, _P])),
        # x, y, n, h1, h2, partials, ticket, out, stream
        (f"pe_dot_{form}", (_I, [_P, _P, _L, h, h] + [_P] * 4)),
        # alpha, w, r, p, ap, w_new, r_new, n, partials, ticket, dw2, stream
        (f"pe_update_w_r_{form}", (_I, [_P] * 7 + [_L] + [_P] * 4)),
        # beta, z, p, out, n, stream
        (f"pe_update_p_{form}", (_I, [_P] * 4 + [_L, _P])),
    )},
}


def _form(kernel: str, *tensors) -> str:
    """The C form name of the tensors' common dtype; raise unless they
    share a dtype the kernels take, a device and a shape."""
    t0 = tensors[0]
    form = DTYPES.get(t0.dtype)
    if form is None:
        raise ValueError(f"{kernel}: the kernel runs float32 or float64, "
                         f"got {t0.dtype}")
    for t in tensors[1:]:
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{kernel}: got {t.dtype} on {t.device} beside "
                             f"{t0.dtype} on {t0.device}")
    return form


def _check_grids(kernel: str, *grids) -> None:
    shape = grids[0].shape
    for g in grids:
        if g.shape != shape or g.dim() != 2:
            raise ValueError(f"{kernel}: need 2-D grids of one shape, got "
                             f"{tuple(g.shape)} beside {tuple(shape)}")


def _check_scalar(kernel: str, name: str, s) -> None:
    if not isinstance(s, torch.Tensor) or s.dim() != 0:
        raise ValueError(f"{kernel}: {name} must be a 0-d tensor on the "
                         "arrays' device")


def _contiguous(kernel: str, *tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel}: inputs must be contiguous")


# the doubles of partials the sums need on a device, by device index
_LENGTHS: dict = {}


def _scratch(lib, device, stream: int):
    """The sums' (partials, ticket) for launches on ``stream`` of
    ``device``: the shared pair of ``ops.scratch``, at least the length
    ``pe_stage4_scratch_len`` gives for the device (asked once a device)."""
    length = _LENGTHS.get(device.index)
    if length is None:
        length = lib.pe_stage4_scratch_len(device.index)
        if length < 0:
            _build.check(lib.pe_stage4_error_string, "stage4 scratch",
                         -length)
        _LENGTHS[device.index] = length
    return scratch.sums_scratch(device, stream, length)


# -- z = r / D ---------------------------------------------------------------


def apply_dinv_plain(r, d):
    """z = r/D with z = 0 where D = 0: ``ops.stencil.apply_dinv``."""
    return apply_dinv(r, d)


def apply_dinv_pallas(r, d):
    """z = r/D with a zero guard (``apply_Dinv_kernel``): the port of
    ``apply_dinv_pallas``."""
    form = _form(DINV_KERNEL, r, d)
    _check_grids(DINV_KERNEL, r, d)
    if r.device.type == "cpu":
        return apply_dinv_plain(r, d)
    _contiguous(DINV_KERNEL, r, d)
    z = torch.empty_like(r)
    lib = _build.load(LIBRARY, SIGNATURES)
    rc = getattr(lib, f"pe_dinv_{form}")(
        r.data_ptr(), d.data_ptr(), z.data_ptr(), r.numel(),
        _build.stream_handle(r.device))
    _build.check(lib.pe_stage4_error_string, DINV_KERNEL, rc)
    _build.count_launch(DINV_KERNEL)
    return z


# -- h1·h2·Σxy ----------------------------------------------------------------


def sum_in_double(x, y):
    """Σ x·y with each product taken in double and the sum rounded once to
    x's dtype: the kernels' sums, in another order."""
    return (x.double() * y.double()).sum().to(x.dtype)


def dot_plain(x, y, h1: float, h2: float):
    """h1·h2·Σxy: the raw sum rounded once to the dtype, then times h1 and
    h2 in the dtype (``dot_pallas``'s ``s[0] * h1 * h2``)."""
    return sum_in_double(x, y) * spacing(h1, x) * spacing(h2, x)


def dot_pallas(x, y, h1: float, h2: float):
    """The grid-weighted inner product h1·h2·Σxy (``dot_kernel``) as a 0-d
    tensor on the arrays' device: the port of ``dot_pallas``."""
    form = _form(DOT_KERNEL, x, y)
    _check_grids(DOT_KERNEL, x, y)
    if x.is_cpu:
        return dot_plain(x, y, h1, h2)
    _contiguous(DOT_KERNEL, x, y)
    lib = _build.load(LIBRARY, SIGNATURES)
    device = x.device
    stream = _build.stream_handle(device)
    partials, ticket = _scratch(lib, device, stream)
    out = x.new_empty(())
    rc = getattr(lib, f"pe_dot_{form}")(
        x.data_ptr(), y.data_ptr(), x.numel(), rounded(h1, x.dtype),
        rounded(h2, x.dtype), partials.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), stream)
    _build.check(lib.pe_stage4_error_string, DOT_KERNEL, rc)
    _build.count_launch(DOT_KERNEL)
    return out


# -- w += αp, r −= α·Ap, Σdw² -------------------------------------------------


def update_w_r_plain(alpha, w, r, p, ap):
    """(w + αp, r − α·ap, Σ(w_new − w)²): each update a rounded product and
    a rounded sum; the step norm from the realised increment, raw, summed
    in double and rounded once."""
    w_new = w + alpha * p
    r_new = r - alpha * ap
    dw = w_new - w
    return w_new, r_new, sum_in_double(dw, dw)


def update_w_r_pallas(alpha, w, r, p, ap):
    """Fused w += αp, r −= α·Ap and Σ(Δw)² (``update_w_r_kernel``) in one
    launch: the port of ``update_w_r_pallas``. Returns
    ``(w_new, r_new, dw2)``, dw2 a 0-d tensor."""
    form = _form(UPDATE_W_R_KERNEL, w, r, p, ap)
    _check_grids(UPDATE_W_R_KERNEL, w, r, p, ap)
    _check_scalar(UPDATE_W_R_KERNEL, "alpha", alpha)
    _form(UPDATE_W_R_KERNEL, w, alpha)
    if w.device.type == "cpu":
        return update_w_r_plain(alpha, w, r, p, ap)
    _contiguous(UPDATE_W_R_KERNEL, w, r, p, ap)
    lib = _build.load(LIBRARY, SIGNATURES)
    stream = _build.stream_handle(w.device)
    partials, ticket = _scratch(lib, w.device, stream)
    w_new, r_new = torch.empty_like(w), torch.empty_like(r)
    dw2 = torch.empty((), dtype=w.dtype, device=w.device)
    rc = getattr(lib, f"pe_update_w_r_{form}")(
        alpha.data_ptr(), w.data_ptr(), r.data_ptr(), p.data_ptr(),
        ap.data_ptr(), w_new.data_ptr(), r_new.data_ptr(), w.numel(),
        partials.data_ptr(), ticket.data_ptr(), dw2.data_ptr(), stream)
    _build.check(lib.pe_stage4_error_string, UPDATE_W_R_KERNEL, rc)
    _build.count_launch(UPDATE_W_R_KERNEL)
    return w_new, r_new, dw2


# -- p = z + βp ---------------------------------------------------------------


def update_p_plain(beta, z, p):
    """z + βp: a rounded product, then a rounded sum."""
    return z + beta * p


def update_p_pallas(beta, z, p):
    """p = z + βp (``update_p_kernel``): the port of ``update_p_pallas``."""
    form = _form(UPDATE_P_KERNEL, z, p)
    _check_grids(UPDATE_P_KERNEL, z, p)
    _check_scalar(UPDATE_P_KERNEL, "beta", beta)
    _form(UPDATE_P_KERNEL, z, beta)
    if z.is_cpu:
        return update_p_plain(beta, z, p)
    _contiguous(UPDATE_P_KERNEL, z, p)
    out = torch.empty_like(p)
    lib = _build.load(LIBRARY, SIGNATURES)
    rc = getattr(lib, f"pe_update_p_{form}")(
        beta.data_ptr(), z.data_ptr(), p.data_ptr(), out.data_ptr(),
        p.numel(), _build.stream_handle(z.device))
    _build.check(lib.pe_stage4_error_string, UPDATE_P_KERNEL, rc)
    _build.count_launch(UPDATE_P_KERNEL)
    return out
