"""Storage-vs-compute precision: narrow state in device memory, wide math.

The counterpart of ``poisson_ellipse_tpu.ops.precision``. A solve with a
storage dtype keeps its vector state (and the rounded operands a, b, D) in
that dtype, bf16 or f16, half the bytes of f32. Every load upcasts to the
compute dtype, all arithmetic and every accumulator run at compute width,
and each store rounds back once.

``storage_dtype=None`` everywhere means "storage == compute": every
consumer then runs the code it ran before the storage axis existed.

The raw narrow solve converges to the storage floor: an l2 error near
bf16's rounding, not the compute dtype's. Recovering full accuracy is the
guard's promotion rung (ROADMAP Queue A item 9), which is not ported.
"""

from __future__ import annotations

import torch

# storage dtypes the axis accepts: half-width floats (the point), plus the
# identity widths so "f32" is expressible
STORAGE_DTYPES = ("bf16", "f16", "f32", "f64")

_NAMES = {
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "f32": torch.float32,
    # "f64" names only the identity width of f64-compute runs:
    # resolve_storage_dtype refuses storage wider than compute
    "f64": torch.float64,
}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (numpy's and JAX's names)."""
    return str(dtype).removeprefix("torch.")


def resolve_storage_dtype(storage_dtype, compute_dtype):
    """Normalise a storage-dtype request against the compute dtype.

    Accepts a short name ("bf16"), a canonical name ("bfloat16"), a torch
    dtype, or None. Returns a torch dtype, or None for "storage ==
    compute". Refuses an unknown name, a dtype that is not floating, and
    storage wider than compute (computing below the width the state is
    stored at would invert the accuracy contract).
    """
    if storage_dtype is None:
        return None
    if isinstance(storage_dtype, str):
        name = storage_dtype
        storage_dtype = _NAMES.get(name, getattr(torch, name, None))
        if not isinstance(storage_dtype, torch.dtype):
            raise ValueError(
                f"unknown storage dtype {name!r} "
                f"(choose from {', '.join(STORAGE_DTYPES)})"
            )
    if not isinstance(storage_dtype, torch.dtype):
        raise ValueError(f"unknown storage dtype {storage_dtype!r} "
                         f"(choose from {', '.join(STORAGE_DTYPES)})")
    if not storage_dtype.is_floating_point:
        raise ValueError(
            f"storage dtype must be floating, got {dtype_name(storage_dtype)}"
        )
    if storage_dtype == compute_dtype:
        return None
    if storage_dtype.itemsize > compute_dtype.itemsize:
        raise ValueError(
            f"storage dtype {dtype_name(storage_dtype)} is wider than "
            f"compute dtype {dtype_name(compute_dtype)}; storage exists to "
            "shrink HBM traffic — widen the compute dtype instead"
        )
    return storage_dtype


def store(x: torch.Tensor, storage_dtype) -> torch.Tensor:
    """Round to storage width (identity when storage is None), as XLA
    rounds: once from f32, and from f64 once to f16 but through f32 to
    bf16. PyTorch rounds f64 to f16 through f32 too; rounding to odd at
    f32 first makes that second rounding the correct one."""
    if storage_dtype is None:
        return x
    if x.dtype == torch.float64 and storage_dtype == torch.float16:
        return _round_to_odd_f32(x).to(storage_dtype)
    return x.to(storage_dtype)


def _round_to_odd_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 → f32 rounded toward zero, with the last bit set where that
    was inexact: a later round-to-nearest to 22 bits or fewer then equals
    one round-to-nearest from f64."""
    t = x.float()
    over = t.double().abs() > x.abs()
    t = torch.where(over, torch.nextafter(t, torch.zeros_like(t)), t)
    inexact = (t.double() != x).to(torch.int32)
    return (t.view(torch.int32) | inexact).view(torch.float32)


def load(x: torch.Tensor, compute_dtype, storage_dtype) -> torch.Tensor:
    """Upcast a stored array to compute width (identity when storage is
    None; exact, since every storage dtype is a subset of compute's)."""
    return x if storage_dtype is None else x.to(compute_dtype)


def effective_dtype(compute_dtype, storage_dtype):
    """The dtype whose rounding floor governs the solve's drift: the
    storage dtype when one is set, else the compute dtype. Accepts the
    short storage names as well as dtypes."""
    st = resolve_storage_dtype(storage_dtype, compute_dtype)
    return compute_dtype if st is None else st


def replace_every(storage_dtype=None, compute_dtype=torch.float32) -> int:
    """Residual-replacement cadence (iterations) of the recurrence engines:
    32 at f32 or wider, 8 when the effective dtype is 2 bytes (each store
    rounds at ~2⁻⁸, so the rebuilds come 4× as often). Both divide the
    s-step block sizes 2 and 4."""
    return 8 if effective_dtype(compute_dtype, storage_dtype).itemsize <= 2 \
        else 32


def storage_itemsize(compute_dtype, storage_dtype=None) -> int:
    """Bytes per element as stored in device memory."""
    return effective_dtype(compute_dtype, storage_dtype).itemsize
