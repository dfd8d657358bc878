"""Device resolution and the card's capacity probe.

Every entry point of the port runs on ``cuda`` unless the caller asks for
the CPU. Without a card and without that request it raises: a run that
quietly carried on on the CPU would report CPU numbers under a GPU name.

The capacity figures come from ``torch.cuda.get_device_properties`` and,
for what PyTorch does not report (the cooperative-launch attribute and a
kernel's occupancy), from the kernel libraries' own launch query, which
calls ``cudaDeviceGetAttribute`` and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``. Nothing here is a table
of published sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when no card is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def rank_device(device=None, rank: int = 0, world: int = 1) -> torch.device:
    """The device rank ``rank`` of ``world`` runs on: the CPU when asked
    for, else a card. A rank takes the card of its local rank (torchrun's
    ``LOCAL_RANK``, else ``rank``) when there is a card a rank; ranks that
    outnumber the cards share them, all of them the one card of a
    one-card machine.

    Raises ``RuntimeError`` when the rank should have a card and none is
    visible: there is no fallback to the CPU.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None and world == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device, world: int) -> str:
    """The ``torch.distributed`` backend of a ``world``-rank group on
    ``device``'s type: ``nccl`` when every rank has a card of its own,
    ``gloo`` on the CPU and when ranks share a card (NCCL takes one rank a
    card; under gloo each message goes through the host, as the
    reference's stage 4 stages its halos and sums)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class DeviceCapacity:
    """What the kernels' launch shapes and the engine policy can read.

    ``index`` is the CUDA ordinal the figures were read from; a capacity
    built by hand (``index=None``, as the gate tests build one) describes
    a card for the gates but cannot answer an occupancy query.
    """

    name: str
    sm_count: int
    smem_per_block: int   # bytes a block may opt into
    smem_per_sm: int      # bytes of shared memory on one SM
    l2_bytes: int
    total_memory: int
    index: Optional[int] = None

    def _launch_query(self, library: str, smem_bytes: int,
                      form: str = "f32") -> tuple[int, int]:
        if self.index is None:
            raise ValueError(
                f"{self.name}: a hand-built capacity has no kernel occupancy"
            )
        from poisson_ellipse_tpu_torch.ops import _build

        return _build.launch_query(library, self.index, smem_bytes, form)

    def cooperative_launch(self, library: str) -> bool:
        """The card's cooperative-launch attribute, read through
        ``library``'s launch query (which builds that library)."""
        return bool(self._launch_query(library, 0)[0])

    def max_co_resident(self, library: str, smem_bytes: int,
                        form: str = "f32") -> int:
        """How many blocks of ``library``'s whole-solve kernel in ``form``
        (its dtype form, ``ops.whole_solve.FORMS``), each with
        ``smem_bytes`` of dynamic shared memory, can be resident on the
        card at once: the limit of a cooperative launch. Raises if the
        card takes no cooperative launch at all."""
        cooperative, per_sm = self._launch_query(library, smem_bytes, form)
        if not cooperative:
            raise RuntimeError(f"{self.name} does not take cooperative "
                               "launches, which the whole-solve kernels need")
        return per_sm * self.sm_count


# a cap on the shared memory a block may take, which the capacity gates
# read in place of the card's (``smem_override``); None: the card's own
_SMEM_OVERRIDE: Optional[int] = None


@contextlib.contextmanager
def smem_override(capacity_bytes: int):
    """Make the capacity gates budget a block's shared memory at no more
    than ``capacity_bytes`` while the context is active: the counterpart
    of the JAX package's ``vmem_capacity_override``, the deterministic
    stand-in for a smaller card (``resilience.simulated_vmem``). It moves
    which engine ``auto`` selects, not the launch shape of an engine that
    runs: the kernels keep the card's real budget."""
    global _SMEM_OVERRIDE
    prev = _SMEM_OVERRIDE
    _SMEM_OVERRIDE = int(capacity_bytes)
    try:
        yield
    finally:
        _SMEM_OVERRIDE = prev


def gate_capacity(cap: DeviceCapacity) -> DeviceCapacity:
    """``cap`` as the capacity gates see it: under ``smem_override`` its
    shared memory cut to the override."""
    if _SMEM_OVERRIDE is None:
        return cap
    return dataclasses.replace(
        cap, smem_per_block=min(cap.smem_per_block, _SMEM_OVERRIDE),
        smem_per_sm=min(cap.smem_per_sm, _SMEM_OVERRIDE))


def capacity(device=None) -> DeviceCapacity:
    """The capacity of a CUDA device, read from the driver."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("capacity() describes a CUDA device")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    smem = getattr(props, "shared_memory_per_block_optin", None) or getattr(
        props, "shared_memory_per_block", 0
    )
    return DeviceCapacity(
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_per_block=int(smem),
        smem_per_sm=int(getattr(props, "shared_memory_per_multiprocessor", 0)),
        l2_bytes=int(getattr(props, "L2_cache_size", 0)),
        total_memory=int(props.total_memory),
        index=index,
    )
