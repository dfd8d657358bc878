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

import dataclasses
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

    def _launch_query(self, library: str, smem_bytes: int) -> tuple[int, int]:
        if self.index is None:
            raise ValueError(
                f"{self.name}: a hand-built capacity has no kernel occupancy"
            )
        from poisson_ellipse_tpu_torch.ops import _build

        return _build.launch_query(library, self.index, smem_bytes)

    def cooperative_launch(self, library: str) -> bool:
        """The card's cooperative-launch attribute, read through
        ``library``'s launch query (which builds that library)."""
        return bool(self._launch_query(library, 0)[0])

    def max_co_resident(self, library: str, smem_bytes: int) -> int:
        """How many blocks of ``library``'s whole-solve kernel, each with
        ``smem_bytes`` of dynamic shared memory, can be resident on the
        card at once: the limit of a cooperative launch. Raises if the
        card takes no cooperative launch at all."""
        cooperative, per_sm = self._launch_query(library, smem_bytes)
        if not cooperative:
            raise RuntimeError(f"{self.name} does not take cooperative "
                               "launches, which the whole-solve kernels need")
        return per_sm * self.sm_count


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
