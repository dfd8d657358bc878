"""Compilation caching: every request shape hits a warm bucket.

The counterpart of ``poisson_ellipse_tpu.runtime.compile_cache``. A
serving worker pays for cold starts twice: once a process (the kernel
libraries a fresh worker builds) and once a shape (a new (M, N, lanes)
request would otherwise set up its buffers and its launch sequence
anew). Two layers, one for each:

- **The kernel-library directory** (:func:`enable_persistent_cache`): the
  counterpart of XLA's on-disk compilation cache. It points
  ``ops._build``'s library directory at a directory that outlives the
  process (``$POISSON_COMPILE_CACHE`` when set), for this process only,
  and on the card builds the hand-written kernel libraries there, so a
  restarted worker loads them instead of running ``nvcc``.

- **The in-process warm pool** (:class:`WarmPool`): one bucket for the
  batched engines a key ``(engine, grid-bucket, dtype, lane-bucket,
  norm, storage)``, the JAX package's key. Request shapes round up to the
  nearest bucket and are **pad-and-mask embedded**: operands zero-padded
  to the bucket's node grid, an interior mask pinning every node outside
  the true problem to zero, and every size-dependent number (h1, h2, δ,
  the iteration cap) held in a 0-d device tensor the loop reads. Where
  the JAX package compiles ``jit(...).lower().compile()`` once a bucket,
  the port builds the bucket's static buffers once and captures one
  chunk of lane steps as a ``torch.cuda.CUDAGraph``; ``solve`` copies a
  request into the buffers, runs ``init_state`` and replays the graph,
  reading the loop's flags once a chunk, until no lane is active. A
  second request for the bucket returns the same entry and replays the
  same graph. On the CPU the same chunk runs eagerly. The pipelined
  engine's first chunk (β = 0) and its later ones (a residual
  replacement every 32 iterations) are two graphs over the same buffers.

  Lane counts round up to powers of two; surplus lanes carry a zero RHS
  and stop on the breakdown guard at their first iteration, and are
  cropped from the result.

  Embedding note: the masked arithmetic adds only ×1 and +0 on the true
  interior and exact zeros outside, but the lane sums run over the
  bucket's grid, so a bucketed solve agrees with the exact-shape solve to
  round-off, not bitwise, and its count may differ by a step.

Every pool lookup emits a ``cache:hit`` / ``cache:miss`` trace event and
bumps the ``compile_cache_hits`` / ``compile_cache_misses`` counters
(``obs``). ``python -m poisson_ellipse_tpu_torch.harness warmup`` fills
both layers.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg, batched_pipelined
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import (
    dtype_name,
    replace_every,
    resolve_storage_dtype,
)
from poisson_ellipse_tpu_torch.solver.pcg import DEFAULT_CHUNK
from poisson_ellipse_tpu_torch.utils.device import resolve_device

ENV_CACHE_DIR = "POISSON_COMPILE_CACHE"

_persistent_dir: str | None = None


def enable_persistent_cache(path: str | None = None, device=None) -> str:
    """Point the kernel libraries' directory at ``path`` (default:
    ``$POISSON_COMPILE_CACHE``, else the build directory ``ops._build``
    already uses) for this process, and on ``device`` (cuda unless
    ``device='cpu'``) build every missing library there. Idempotent;
    emits ``cache:persistent-enabled`` and returns the directory."""
    global _persistent_dir
    from poisson_ellipse_tpu_torch.ops import _build

    dev = resolve_device(device)
    path = path or os.environ.get(ENV_CACHE_DIR) or str(_build.BUILD_DIR)
    if _persistent_dir != path:
        os.makedirs(path, exist_ok=True)
        _build.BUILD_DIR = Path(path)
        _persistent_dir = path
    if dev.type == "cuda":
        _build.build()
    obs_trace.event("cache:persistent-enabled", dir=path)
    return path


# -- shape bucketing ---------------------------------------------------------

# grid-dimension ladder: powers of two and their 1.5× midpoints — at
# most 2 buckets per octave bounds pad waste at ≤ 50% per dim while
# keeping the executable population logarithmic in served sizes
_MAX_DIM = 1 << 20


def _ladder():
    k = 3
    while (1 << k) <= _MAX_DIM:
        yield 1 << k
        yield 3 << (k - 1)
        k += 1


def bucket_dim(n: int) -> int:
    """Smallest ladder value ≥ n (cells per grid dimension)."""
    if n < 2:
        raise ValueError("need at least 2 cells per dimension")
    for v in _ladder():
        if v >= n:
            return v
    raise ValueError(f"dimension {n} exceeds the bucket ladder")


def grid_bucket(M: int, N: int) -> tuple[int, int]:
    """The (Mb, Nb) cell-count bucket an (M, N) request embeds into."""
    return bucket_dim(M), bucket_dim(N)


def lane_bucket(lanes: int) -> int:
    """Smallest power of two ≥ lanes."""
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    return 1 << (lanes - 1).bit_length()


def warm_affinity_key(M: int, N: int, norm: str = "weighted") -> tuple:
    """The bucket affinity key a request of grid (M, N) lands in:
    ``(grid_bucket, norm)``, the key the serve scheduler's batch contexts
    (``serve.scheduler``) and this pool's buckets share."""
    return (grid_bucket(M, N), norm)


# -- the warm pool -----------------------------------------------------------


class BucketGraphs:
    """One bucket's static device buffers and its chunk of lane steps.

    The buffers are the traced arguments of the JAX package's bucket
    executable: lane-shared ``a``, ``b`` and ``mask`` (g1, g2), the
    (lanes, g1, g2) ``rhs``, 0-d ``h1``, ``h2``, ``delta`` and ``limit``,
    and the carry. A chunk is ``chunk`` bodies of the engine's
    ``make_body`` over those buffers, its last carry copied back into
    them and the loop's flags (``batched_pcg.running``) into ``flags``;
    bodies past the loop's exit change nothing, so a chunk equals the
    eager ``advance`` bitwise. On the card each chunk form is captured
    once as a CUDA graph (a capture that fails raises); on the CPU the
    chunk runs eagerly.
    """

    def __init__(self, engine: str, bucket: tuple[int, int], dtype,
                 lanes: int, norm: str, storage_dtype, device: torch.device,
                 chunk: int = DEFAULT_CHUNK):
        if engine == "batched":
            self.mod = batched_pcg
        elif engine == "batched-pipelined":
            self.mod = batched_pipelined
        else:
            raise ValueError(
                f"the warm pool serves the batched engines; got {engine!r}"
            )
        if storage_dtype is not None and engine != "batched":
            raise ValueError(
                "narrow-storage bucket executables cover the 'batched' "
                f"engine; got {engine!r}"
            )
        self.pipelined = engine == "batched-pipelined"
        if self.pipelined:
            if chunk % replace_every(None, dtype):
                raise ValueError(
                    "a pipelined chunk must hold whole replacement periods"
                )
        self.kw = ({} if storage_dtype is None
                   else {"storage_dtype": storage_dtype})
        Mb, Nb = bucket
        self.proto = Problem(M=Mb, N=Nb, norm=norm)
        self.chunk = chunk
        self.device = device
        g2 = (Mb + 1, Nb + 1)

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.a, self.b, self.mask = zeros(g2), zeros(g2), zeros(g2)
        self.rhs = zeros((lanes,) + g2)
        self.h1 = torch.ones((), dtype=dtype, device=device)
        self.h2 = torch.ones((), dtype=dtype, device=device)
        self.delta = torch.full((), 1e-6, dtype=dtype, device=device)
        self.limit = zeros((), torch.int32)
        self.flags = zeros(3, torch.int32)
        # every field its own tensor: init_state shares one flag tensor
        # between the three flags, and the buffers are written in place
        init = self._init()
        self.state = type(init)(*(t.clone() for t in init))
        self.limit_value = 0
        self.graphs: dict[bool, object] = {}
        if device.type == "cuda":
            self._capture()

    def _init(self):
        return self.mod.init_state(self.proto, self.a, self.b, self.rhs,
                                   mask=self.mask, h1=self.h1, h2=self.h2,
                                   **self.kw)

    def _forms(self) -> tuple:
        """The chunk forms: the pipelined body branches on its first
        iteration (k = 0), the classical body on nothing."""
        return (True, False) if self.pipelined else (False,)

    def _form_of(self, k: int) -> bool:
        if not self.pipelined:
            return False
        if k % self.chunk:
            raise RuntimeError(f"a pipelined chunk must start at a multiple "
                               f"of {self.chunk}, not at {k}")
        return k == 0

    def _chunk(self, first: bool) -> None:
        """One chunk of bodies over the buffers (the graphs' body)."""
        body = self.mod.make_body(self.proto, self.a, self.b, self.rhs,
                                  self.limit, self.mask, self.h1, self.h2,
                                  self.delta, **self.kw)
        k0 = 0 if first else self.chunk
        s = self.state
        for j in range(self.chunk):
            s = body(s, k0 + j)
        for dst, src in zip(self.state, s):
            dst.copy_(src)
        self.flags.copy_(batched_pcg.running(s))

    def _capture(self) -> None:
        """Warm each chunk form up on a side stream, then capture it."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for first in self._forms():
                self._chunk(first)
        current.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for first in self._forms():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                self._chunk(first)
            self.graphs[first] = graph
        torch.cuda.synchronize(self.device)

    def load(self, a, b, rhs, mask, h1: float, h2: float, delta: float,
             limit: int) -> None:
        """Copy one embedded request into the buffers and set the carry to
        its ``init_state``."""
        for dst, src in ((self.a, a), (self.b, b), (self.rhs, rhs),
                         (self.mask, mask)):
            dst.copy_(src)
        self.h1.fill_(h1)
        self.h2.fill_(h2)
        self.delta.fill_(delta)
        self.limit_value = min(limit, self.proto.max_iterations)
        self.limit.fill_(self.limit_value)
        for dst, src in zip(self.state, self._init()):
            dst.copy_(src)

    def run(self) -> int:
        """Replay chunks until no lane is active or k reaches the limit;
        returns the host reads (one a chunk and one before the first)."""
        flags = batched_pcg.running(self.state).tolist()
        syncs = 1
        while not (flags[1] or flags[0] >= self.limit_value):
            first = self._form_of(flags[0])
            graph = self.graphs.get(first)
            if graph is not None:
                graph.replay()
            else:
                self._chunk(first)
            flags = self.flags.tolist()
            syncs += 1
        return syncs


@dataclass
class _Entry:
    """One warm bucket plus the bucket geometry it serves. ``compiled`` is
    the bucket's :class:`BucketGraphs`; ``compile_s`` the seconds its
    buffers and graph capture took."""

    compiled: BucketGraphs
    engine: str
    bucket: tuple[int, int]
    lanes: int
    dtype: str
    norm: str
    compile_s: float
    # the storage width of the lane fields ("" = storage == compute): a
    # narrow-storage bucket runs a different program with a different
    # accuracy contract, so it is a key of its own
    storage: str = ""
    device: str = "cuda"


@dataclass
class WarmPool:
    """Warm buckets for the batched engines, keyed by bucket.

    One pool per process is the intended shape (:func:`warm_pool`); the
    class is separate so tests can build throwaway pools. Entries are
    kept per device as well as per key.
    """

    entries: dict = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    @staticmethod
    def key(engine: str, grid: tuple[int, int], dtype, lanes: int,
            norm: str = "weighted", storage_dtype=None):
        """The JAX package's key: (engine, grid bucket, dtype name, lane
        bucket, norm, storage dtype name or "")."""
        st = resolve_storage_dtype(storage_dtype, dtype)
        storage = "" if st is None else dtype_name(st)
        return (
            engine, grid_bucket(*grid), dtype_name(dtype),
            lane_bucket(lanes), norm, storage,
        )

    def warmup(self, engine: str, grid: tuple[int, int],
               dtype=torch.float32, lanes: int = 1, norm: str = "weighted",
               storage_dtype=None, device=None) -> _Entry:
        """The warm bucket for (engine, grid, dtype, lanes, norm, storage)
        on ``device`` (cuda unless ``device='cpu'``), built and captured
        on a miss. Emits ``cache:hit``/``cache:miss`` and bumps the obs
        counters; a hit returns the same entry object as the miss that
        made it. ``engine="auto"`` resolves to ``batched``."""
        dev = resolve_device(device)
        if engine == "auto":
            engine = "batched"
        key = self.key(engine, grid, dtype, lanes, norm, storage_dtype)
        entry = self.entries.get(key + (str(dev),))
        _, bucket, name, lb, _, storage = key
        if entry is not None:
            self.hits += 1
            obs_metrics.counter("compile_cache_hits").inc()
            obs_trace.event(
                "cache:hit", engine=engine, bucket=list(bucket),
                lanes=lb, dtype=name,
            )
            return entry
        self.misses += 1
        obs_metrics.counter("compile_cache_misses").inc()
        t0 = time.perf_counter()
        compiled = BucketGraphs(
            engine, bucket, dtype, lb, norm,
            resolve_storage_dtype(storage_dtype, dtype), dev,
        )
        compile_s = time.perf_counter() - t0
        obs_trace.event(
            "cache:miss", engine=engine, bucket=list(bucket), lanes=lb,
            dtype=name, compile_s=round(compile_s, 4),
        )
        entry = _Entry(
            compiled=compiled, engine=engine, bucket=bucket, lanes=lb,
            dtype=name, norm=norm, compile_s=compile_s, storage=storage,
            device=str(dev),
        )
        self.entries[key + (str(dev),)] = entry
        return entry

    def solve(self, problem: Problem, lanes: int, engine: str = "batched",
              dtype=torch.float32, rhs=None, device=None):
        """Serve one request from the pool: embed, replay, crop.

        ``rhs`` optionally supplies the (lanes, M+1, N+1) stack (default:
        the problem's RHS tiled). Returns a per-lane
        :class:`~poisson_ellipse_tpu_torch.batch.BatchedPCGResult` cropped
        to the request's true shape and lane count, its tensors the
        caller's own.
        """
        entry = self.warmup(engine, (problem.M, problem.N), dtype, lanes,
                            problem.norm, device=device)
        bucket = entry.compiled
        bucket.load(*_embed(problem, lanes, entry, dtype, rhs),
                    problem.h1, problem.h2, problem.delta,
                    problem.max_iterations)
        bucket.run()
        result = bucket.mod.result_of(bucket.state)
        g1, g2 = problem.M + 1, problem.N + 1
        return batched_pcg.BatchedPCGResult(
            w=result.w[:lanes, :g1, :g2].clone(),
            iters=result.iters[:lanes].clone(),
            diff=result.diff[:lanes].clone(),
            converged=result.converged[:lanes].clone(),
            breakdown=result.breakdown[:lanes].clone(),
            quarantined=result.quarantined[:lanes].clone(),
        )


def _embed(problem: Problem, lanes: int, entry: _Entry, dtype, rhs=None):
    """Pad-and-mask a request into ``entry``'s bucket, on the host: the
    zero-padded operands, the RHS stack, the interior mask over the true
    problem (surplus lanes zero: they stop on the breakdown guard at
    their first iteration and are cropped)."""
    Mb, Nb = entry.bucket
    Lb = entry.lanes
    a, b, r = assembly.assemble_numpy(problem)
    g1, g2 = problem.M + 1, problem.N + 1
    pad2 = ((0, Mb + 1 - g1), (0, Nb + 1 - g2))
    if rhs is None:
        rhs_p = np.broadcast_to(np.pad(r, pad2), (Lb, Mb + 1, Nb + 1))
    else:
        rhs = np.asarray(rhs)
        if rhs.shape != (lanes, g1, g2):
            raise ValueError(
                f"rhs shape {rhs.shape} != {(lanes, g1, g2)}"
            )
        rhs_p = np.zeros((Lb, Mb + 1, Nb + 1))
        rhs_p[:lanes, :g1, :g2] = rhs
    mask = np.zeros((Mb + 1, Nb + 1))
    mask[1: problem.M, 1: problem.N] = 1.0
    return tuple(assembly.to_host(x, dtype)
                 for x in (np.pad(a, pad2), np.pad(b, pad2), rhs_p, mask))


# -- the process-wide pool ---------------------------------------------------

_POOL: Optional[WarmPool] = None


def warm_pool() -> WarmPool:
    """The process's shared warm pool (created on first use)."""
    global _POOL
    if _POOL is None:
        _POOL = WarmPool()
    return _POOL
