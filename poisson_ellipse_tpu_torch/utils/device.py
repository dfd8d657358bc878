"""Device resolution and the card's capacity probe.

Every entry point of the port runs on ``cuda`` unless the caller asks for
the CPU. Without a card and without that request it raises: a run that
quietly carried on on the CPU would report CPU numbers under a GPU name.

The capacity figures come from ``torch.cuda.get_device_properties``;
nothing here is a table of published sizes.
"""

from __future__ import annotations

import dataclasses

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
    """What the kernels' launch shapes and the engine policy can read."""

    name: str
    sm_count: int
    smem_per_block: int   # bytes a block may opt into
    l2_bytes: int
    total_memory: int


def capacity(device=None) -> DeviceCapacity:
    """The capacity of a CUDA device, read from the driver."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("capacity() describes a CUDA device")
    props = torch.cuda.get_device_properties(dev)
    smem = getattr(props, "shared_memory_per_block_optin", None) or getattr(
        props, "shared_memory_per_block", 0
    )
    return DeviceCapacity(
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_per_block=int(smem),
        l2_bytes=int(getattr(props, "L2_cache_size", 0)),
        total_memory=int(props.total_memory),
    )
