"""The rank grid (reference layer L2: process grid + partition).

The counterpart of ``poisson_ellipse_tpu.parallel.mesh``. JAX runs its
mesh from one process over many devices; here each rank of a
``torch.distributed`` group is one process, and a ``Mesh`` is that
process's view of the grid: the shape (px, py), its own place (ix, iy),
the process group, its device and the group's backend.

``choose_process_grid`` reproduces the reference's factorisation
(``stage2-mpi/poisson_mpi_decomp.cpp:60-64``): px = ⌊√size⌋ decremented to
the nearest divisor, py = size/px. Ranks sit in JAX's row-major
``reshape(px, py)``: rank r at (r // py, r % py), x the first array axis.
Where ``decompose_2d`` (``:75-111``) hands out blocks differing by one
row, the global node grid is zero-padded to a multiple of the mesh shape
instead (``padded_dims``): padded nodes carry zero coefficients and a zero
right-hand side and behave like the exterior Dirichlet ring.

The mesh's two per-iteration collectives are the halo exchange
(``parallel.halo``) and the sum of per-rank partials (``Mesh.reduce``).
Both count themselves in ``COLLECTIVES`` (per process, as
``ops._build.LAUNCHES`` counts launches), so a test can read the cadence
of a loop: the classical and fused loops make 1 halo exchange and 2
reductions an iteration. The resilience layer's decisions at a chunk
boundary (the health word, a deadline, the checkpoint step) are agreed
with one collective each off the loop (``Mesh.agree_or``,
``Mesh.agree_first``), counted apart as "agree".

A mesh may be a sub-group of the process group (``parallel.elastic``'s
survivors): ``rank`` is this process's position in the grid (its rank in
``group``) and ``ranks`` the global rank at each position, which is what
a point-to-point message names (``Mesh.peer``).

``Mesh.reduce`` gathers every rank's partials (``all_gather``, one double
each) and adds them in rank order on every rank, in double, rounded once
to the run dtype: every rank then holds the same bits and takes the same
branch. It never all-reduces floats, whose order the backend chooses.
Under gloo the partials go through the host; under NCCL they stay on the
card.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.utils.device import rank_device

# collectives per process by kind: "halo" (one exchange of one or a stack
# of blocks), "reduce" (one gathered sum), "gather" (a block gathered for
# the report or a checkpoint, off the loop), "agree" (a decision every rank
# takes from the same bits, at a chunk boundary)
COLLECTIVES: collections.Counter = collections.Counter()


def count(kind: str) -> None:
    COLLECTIVES[kind] += 1


def reset_collectives() -> None:
    COLLECTIVES.clear()


def choose_process_grid(size: int) -> tuple[int, int]:
    """Factor ``size`` ranks into a near-square (px, py), px ≤ py.

    Reference: ``stage2-mpi/poisson_mpi_decomp.cpp:60-64``.
    """
    if size < 1:
        raise ValueError("need at least one device")
    px = int(math.isqrt(size))
    while size % px:
        px -= 1
    return px, size // px


def padded_dims_of(problem_nodes: tuple[int, int], px: int,
                   py: int) -> tuple[int, int]:
    """Global node-grid dims padded up to multiples of (px, py)."""
    g1, g2 = problem_nodes
    return (-(-g1 // px) * px, -(-g2 // py) * py)


def padded_dims(problem_nodes: tuple[int, int], mesh: "Mesh") -> tuple[int, int]:
    """Global node-grid dims padded up to multiples of the mesh shape."""
    return padded_dims_of(problem_nodes, mesh.px, mesh.py)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (px, py) rank grid.

    ``rank`` is this process's position in the grid, row-major; ``group``
    is the process group its collectives run in; ``backend`` is that
    group's ("gloo" or "nccl"), or "none" for a one-rank mesh with no
    process group, whose collectives are local. ``ranks`` holds the global
    rank at each position (None: the identity, the mesh over every rank of
    the default group).
    """

    px: int
    py: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    ranks: Optional[tuple] = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.px, self.py

    @property
    def world(self) -> int:
        return self.px * self.py

    @property
    def ix(self) -> int:
        return self.rank // self.py

    @property
    def iy(self) -> int:
        return self.rank % self.py

    def rank_of(self, ix: int, iy: int) -> int:
        return ix * self.py + iy

    @property
    def global_ranks(self) -> tuple:
        """The global rank at each position."""
        return tuple(range(self.world)) if self.ranks is None else self.ranks

    def peer(self, pos: int) -> int:
        """The global rank of the process at grid position ``pos``: the
        rank a point-to-point message names."""
        return self.global_ranks[pos]

    @property
    def global_rank(self) -> int:
        return self.peer(self.rank)

    @property
    def via_host(self) -> bool:
        """Whether messages go through host tensors (gloo with a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a contiguous tensor the backend can send: copied to the
        host under gloo with a card (the one wait for the card a message
        costs), as it is otherwise."""
        return x.to("cpu").contiguous() if self.via_host else x.contiguous()

    def wire_zeros(self, shape, dtype) -> torch.Tensor:
        """A zeroed receive buffer the backend can fill: in pinned host
        memory under gloo with a card, so that ``unwire`` copies it to the
        card without waiting."""
        if self.via_host:
            return torch.zeros(shape, dtype=dtype, pin_memory=True)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def unwire(self, x: torch.Tensor) -> torch.Tensor:
        """A received buffer on this rank's device (queued on the stream
        from pinned memory; the host does not wait)."""
        return x.to(self.device, non_blocking=True)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (same shape on every rank), in rank order, as
        the backend delivers them (host tensors under gloo with a card)."""
        if self.backend == "none":
            return [x]
        send = self.wire(x)
        bufs = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(bufs, send, group=self.group)
        return bufs

    def reduce(self, partials: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The sum over ranks of each rank's (k,) double ``partials``:
        gathered, added in rank order in double, rounded once to
        ``dtype``; bitwise the same on every rank. Under gloo with a card
        the sum is taken on the host (IEEE double adds and one rounding,
        the same bits as on the card) and copied back once."""
        count("reduce")
        gathered = self.all_gather(partials.to(torch.float64))
        total = gathered[0]
        for part in gathered[1:]:
            total = total + part
        total = total.to(dtype)
        if total.device == self.device:
            return total
        staged = torch.empty(total.shape, dtype=dtype, pin_memory=True)
        return self.unwire(staged.copy_(total))

    def gather_blocks(self, block: torch.Tensor) -> torch.Tensor:
        """The (..., px·bm, py·bn) global array of every rank's (..., bm,
        bn) block, on every rank (for the report after the timed solve, or
        a checkpoint at a chunk boundary): one gather, a stack of blocks
        too."""
        count("gather")
        bm, bn = block.shape[-2:]
        out = torch.empty((*block.shape[:-2], self.px * bm, self.py * bn),
                          dtype=block.dtype, device=self.device)
        for r, blk in enumerate(self.all_gather(block)):
            ix, iy = divmod(r, self.py)
            out[..., ix * bm:(ix + 1) * bm, iy * bn:(iy + 1) * bn] = blk.to(
                self.device)
        return out

    def agree_or(self, word: torch.Tensor) -> torch.Tensor:
        """The bitwise OR over ranks of each rank's integer 0-d ``word``: a
        flag any rank raised (a NaN in its own block) raised on every
        rank."""
        count("agree")
        if self.backend == "none":
            return word
        words = self.all_gather(word.to(torch.int64).reshape(1))
        out = words[0]
        for got in words[1:]:
            out = out | got
        return out.reshape(()).to(device=word.device, dtype=word.dtype)

    def agree_sum(self, x: torch.Tensor) -> float:
        """The sum over ranks of each rank's 0-d ``x``, added in rank order
        in double (a norm over the whole grid, off the loop)."""
        count("agree")
        parts = self.all_gather(x.to(torch.float64).reshape(1))
        return float(sum(float(part) for part in parts))

    def agree_first(self, value):
        """The first position's ``value`` (any picklable object) on every
        rank: a decision one rank takes from its own clock or its own view
        of the disk, taken by all."""
        count("agree")
        if self.backend == "none":
            return value
        box = [value]
        dist.broadcast_object_list(box, src=self.peer(0), group=self.group)
        return box[0]

    def barrier(self) -> None:
        if self.backend != "none":
            dist.barrier(group=self.group)


def rank_sums(*pairs) -> torch.Tensor:
    """This rank's Σ x·y of each pair as a (k,) double tensor: each product
    rounded in the operands' dtype, the terms added in double."""
    return torch.stack([torch.sum(x * y, dtype=torch.float64)
                        for x, y in pairs])


def make_mesh(mesh_shape: Optional[tuple[int, int]] = None,
              device=None) -> Mesh:
    """This process's ``Mesh`` over the default process group: shape
    ``mesh_shape``, or near-square over every rank (JAX's ``make_mesh``
    over every device). Without a process group it is the one-rank mesh.
    Raises, with the JAX harness's message, when the shape does not match
    the group's size."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend, group = str(dist.get_backend()), dist.group.WORLD
    else:
        rank, world, backend, group = 0, 1, "none", None
    px, py = choose_process_grid(world) if mesh_shape is None else mesh_shape
    if px < 1 or py < 1:
        raise ValueError(f"mesh {px}x{py} is empty")
    if px * py != world:
        raise ValueError(
            f"mesh {px}x{py} needs {px * py} devices, have {world}"
        )
    return Mesh(px=px, py=py, rank=rank,
                device=rank_device(device, rank, world), backend=backend,
                group=group)


def sub_mesh(mesh: Mesh, survivors, group) -> Mesh:
    """This process's mesh over the global ranks ``survivors`` (in
    order), a near-square grid (``choose_process_grid``) in the process
    group ``group`` made for them; the process must be one of them."""
    survivors = tuple(survivors)
    px, py = choose_process_grid(len(survivors))
    if len(survivors) == 1:
        group, backend = None, "none"
    else:
        backend = mesh.backend
    return Mesh(px=px, py=py, rank=survivors.index(mesh.global_rank),
                device=mesh.device, backend=backend, group=group,
                ranks=survivors)
