"""The sums' scratch of the kernels that finish their sums in a last block.

The stage-4 ``dot`` and ``update_w_r`` (``ops.stage4_kernels``) and the
K-d family (K-d, its bf16 form, K-f, K-h: ``ops.hopper_kernels``) write
one partial a block into a buffer of doubles; the block that takes the
last ticket adds the partials and writes its ticket back to 0. So the
(partials, tickets) pair is zeroed once and reused by every later launch
on its stream: a call issues its kernel and nothing else.

One pair is kept per (device, stream), shared by every such kernel:
launches on one stream run in order, and each leaves its tickets at 0. It
grows to the largest launch seen there (partials of K-d at 2401x3201 are
8 pairs x 1919 blocks; K-f needs a ticket a lane). A pair that is
outgrown is kept alive, not freed, since a CUDA graph captured with it
still points at it. Inside a graph capture a pair that does not exist or
is too small is made for the call and not kept: its zeroing is a node of
that graph only. A graph captured on a stream that has a large enough
pair uses that pair: do not replay it while launches run on the stream it
was captured on.
"""

from __future__ import annotations

import torch

# (partials, tickets) by (device index, stream handle)
_SCRATCH: dict = {}
# pairs that were outgrown, kept for the graphs captured with them
_RETIRED: list = []


def sums_scratch(device, stream: int, n_partials: int, n_tickets: int = 1):
    """(partials, tickets) for a launch on ``stream`` of ``device``: at
    least ``n_partials`` doubles and ``n_tickets`` int32 tickets, all 0."""
    key = (device.index, stream)
    pair = _SCRATCH.get(key)
    if (pair is not None and pair[0].numel() >= n_partials
            and pair[1].numel() >= n_tickets):
        return pair
    if pair is not None:
        n_partials = max(n_partials, pair[0].numel())
        n_tickets = max(n_tickets, pair[1].numel())
    new = (torch.empty(n_partials, dtype=torch.float64, device=device),
           torch.zeros(n_tickets, dtype=torch.int32, device=device))
    if not torch.cuda.is_current_stream_capturing():
        if pair is not None:
            _RETIRED.append(pair)
        _SCRATCH[key] = new
    return new
