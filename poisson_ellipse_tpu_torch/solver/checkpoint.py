"""Checkpoint / resume for long PCG solves.

The port's counterpart of ``poisson_ellipse_tpu.solver.checkpoint``, with
``torch.save`` in place of orbax. The classical PCG carry
(``solver.pcg.PCGState``) is saved every ``chunk`` iterations, and a
restart resumes exactly: the chunks issue the loop's own bodies, so a
checkpointed run, and a run resumed from disk, is bitwise the straight
solve.

Each step is a directory named by its iteration, holding

- ``state.pt``: the carry's eight tensors (``STATE_KEYS``), saved from
  host copies;
- ``meta.json``: the fingerprint of the problem, dtype (named as numpy and
  the JAX package name it, "float32"), stencil and mesh;
- ``integrity.json``: the manifest (relative path → byte size).

A step is written under a temporary name and moved into place with
``os.replace``, so a kill mid-save never leaves a half step that a resume
would pick up. The manifest covers what the rename cannot: damage after
the commit (a truncated file). ``resume=True`` verifies the newest step
against its manifest and then loads it (``torch.load(...,
weights_only=True)`` onto the solve's device); a step that fails either is
quarantined (renamed ``quarantined-<step>``, with an ``obs.trace``
``recovery:checkpoint-quarantine`` event and a ``RuntimeWarning``) and the
previous step is tried. Only when no step survives does the run restart
from iteration 0. A checkpoint written for another problem, dtype or
stencil is refused (``CheckpointMismatchError``), never quarantined.

At a chunk's boundary the carry is copied to the host (the read the loop
makes there anyway, for its flags); the files are written on a background
thread while the next chunk runs, and that thread is joined before a
restore and at ``close()``. ``save_seconds`` and ``write_seconds`` keep
each save's host copy and its write.

``mesh=`` checkpoints the sharded classical loop
(``parallel.pcg_sharded.build_sharded_stepper``), every rank of the mesh
driving it together. At a chunk boundary the ranks gather the global
(padded) w, r and p in one collective and the mesh's first rank writes
them, so ``directory`` must be one every rank sees. The fingerprint holds
the mesh shape; a step written on another shape (or on one device) is
resharded on restore, as in the JAX package: cropped to the node grid,
re-padded to this mesh's dims, cut to this rank's block
(``parallel.elastic.reshard_state``), and a single-device solve crops a
mesh's step the same way. Which step a mesh restores, after the
verification and any quarantine, is the first rank's decision, taken by
every rank (``Mesh.agree_first``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import time
import warnings
from typing import Optional

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import dtype_name
from poisson_ellipse_tpu_torch.parallel.mesh import padded_dims_of
from poisson_ellipse_tpu_torch.resilience.errors import (
    _is_loud_error,
    classify_error,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    STENCILS,
    PCGResult,
    PCGState,
    init_state,
    make_body,
    result_of,
    run_chunked,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

STATE_KEYS = ("k", "w", "r", "p", "zr", "diff", "converged", "breakdown")
_GRID_KEYS = ("w", "r", "p")

# per-step integrity manifest (relative path -> byte size)
MANIFEST_NAME = "integrity.json"
STATE_NAME = "state.pt"
META_NAME = "meta.json"


class CheckpointMismatchError(ValueError):
    """Resume refused: the checkpoint was written by a different
    problem/dtype/stencil/mesh. Deliberate refusal, not corruption: never
    quarantined."""


def _write_json_atomic(path: str, payload: dict) -> None:
    """Write-temp-then-rename: a kill mid-write leaves the old file (or
    nothing), never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _fingerprint(problem: Problem, dtype, stencil: str, mesh_shape) -> dict:
    fp = dataclasses.asdict(problem)
    fp["dtype"] = dtype_name(dtype)
    # the xla and pallas stencils agree only to an ulp or two: a resume
    # under the other operator would be a mixed-arithmetic solve
    fp["stencil"] = stencil
    fp["mesh"] = list(mesh_shape)
    return fp


class CheckpointingSolver:
    """PCG that persists its carry every ``chunk`` iterations, on
    ``device`` (cuda unless ``device='cpu'``), or over ``mesh`` (every
    rank of it constructs and drives the solver together).

    >>> solver = CheckpointingSolver(problem, "/path/ckpts", chunk=500)
    >>> result = solver.run()          # resumes automatically if killed
    """

    def __init__(
        self,
        problem: Problem,
        directory: str,
        chunk: int = 500,
        dtype=torch.float32,
        stencil: str = "xla",
        keep: int = 2,
        mesh=None,
        device=None,
    ):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if stencil not in STENCILS:
            raise ValueError(f"unknown stencil: {stencil!r} (choose from "
                             f"{STENCILS})")
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.problem = problem
        self.chunk = chunk
        self.dtype = dtype
        self.stencil = stencil
        self.keep = keep
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if mesh is None:
            a, b, rhs = assembly.assemble(problem, dtype, self.device)
            self._init = lambda: init_state(problem, a, b, rhs)
            # the loop's own body, masked at the iteration cap; a chunk
            # issues exactly its bodies
            self._body = make_body(problem, a, b, rhs,
                                   problem.max_iterations, stencil)
        else:
            # the sharded stepper, built on first use (the mesh guard
            # drives its own and uses this class for durability only)
            self._stepper = None
        self._fp = _fingerprint(problem, dtype, stencil,
                                (1, 1) if mesh is None else mesh.shape)
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []
        self.save_seconds: list[float] = []
        self.write_seconds: list[float] = []
        # host reads of the last run: its start and one a save
        self.host_syncs = 0

    @property
    def _writes(self) -> bool:
        """Whether this process writes the steps: one device, or the
        mesh's first rank."""
        return self.mesh is None or self.mesh.rank == 0

    def _parts(self):
        if self._stepper is None:
            from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
                build_sharded_stepper,
            )

            self._stepper = build_sharded_stepper(
                self.problem, self.mesh, self.dtype,
                stencil_impl=self.stencil)
        return self._stepper

    # -- persistence --------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The newest finalized step on disk (saves in flight included);
        on a mesh, the first rank's view, taken by every rank."""
        self.wait_until_finished()
        steps = self._step_dirs()
        step = steps[-1] if steps else None
        return self.mesh.agree_first(step) if self.mesh is not None else step

    def _save(self, state: PCGState) -> dict:
        """Copy the carry to the host and queue its write; returns the
        host copy (its flags are what the loop reads). On a mesh the
        global w, r and p are gathered (one collective on every rank) and
        the first rank writes them."""
        t0 = time.perf_counter()
        fields = dict(zip(STATE_KEYS, state))
        if self.mesh is not None:
            grids = self.mesh.gather_blocks(torch.stack(
                [fields[key] for key in _GRID_KEYS]))
            fields.update(zip(_GRID_KEYS, grids))
        host = {key: x.detach().to("cpu", copy=True)
                for key, x in fields.items()}
        self.save_seconds.append(time.perf_counter() - t0)
        if self._writes:
            step = int(host["k"])
            self._pending.append(self._writer.submit(self._write, step,
                                                     host))
        return host

    def _write(self, step: int, host: dict) -> None:
        """Write one step under a temporary name, then move it into place;
        drop the steps past ``keep``."""
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f"tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_NAME)
        with open(path, "wb") as fh:
            torch.save(host, fh)
            fh.flush()
            os.fsync(fh.fileno())
        _write_json_atomic(os.path.join(tmp, META_NAME), self._fp)
        manifest = {
            name: os.path.getsize(os.path.join(tmp, name))
            for name in (STATE_NAME, META_NAME)
        }
        _write_json_atomic(os.path.join(tmp, MANIFEST_NAME), manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._step_dirs()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        self.write_seconds.append(time.perf_counter() - t0)

    def wait_until_finished(self) -> None:
        """Join every write in flight (raising the first one's error)."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    # -- integrity / quarantine ---------------------------------------------

    def _step_dirs(self) -> list[int]:
        """Finalized step directories on disk, by number."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    def _verify_step(self, step: int) -> Optional[str]:
        """None when the step's files match its manifest; else the defect.
        A step without a manifest passes here: the load is its check."""
        step_dir = os.path.join(self.directory, str(step))
        path = os.path.join(step_dir, MANIFEST_NAME)
        if not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            return f"unreadable integrity manifest: {e}"
        for rel, size in manifest.items():
            full = os.path.join(step_dir, rel)
            if not os.path.exists(full):
                return f"missing file {rel}"
            actual = os.path.getsize(full)
            if actual != size:
                return f"{rel} is {actual} bytes, manifest says {size}"
        return None

    def _quarantine(self, step: int, reason: str) -> str:
        """Move a damaged step out of the step namespace (never delete it)
        and trace it."""
        src = os.path.join(self.directory, str(step))
        dst = os.path.join(self.directory, f"quarantined-{step}")
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(self.directory, f"quarantined-{step}.{n}")
        os.rename(src, dst)
        warnings.warn(
            f"checkpoint step {step} is corrupt ({reason}); quarantined to "
            f"{dst} — resuming from the previous step",
            RuntimeWarning,
            stacklevel=3,
        )
        obs_trace.event(
            "recovery:checkpoint-quarantine",
            step=step,
            reason=reason,
            moved_to=os.path.basename(dst),
        )
        return dst

    def _restore_latest_valid(self):
        """The newest step that verifies and loads; damaged steps are
        quarantined and the next older one tried. None when no step
        survives. On a mesh the first rank verifies, quarantines and
        picks the step, and every rank loads it (or raises the first
        rank's refusal)."""
        if self.mesh is None:
            return self._newest_valid()[0]
        verdict = state = None
        if self._writes:
            try:
                state, step = self._newest_valid()
                verdict = ("step", step)
            except Exception as e:  # noqa: BLE001 — shared, raised below
                verdict = ("error", e)
        kind, value = self.mesh.agree_first(verdict)
        if kind == "error":
            raise value
        if value is None or self._writes:
            return state
        return self._restore(value)

    def _newest_valid(self):
        """(carry, step) of the newest step that verifies and loads, or
        (None, None); damaged steps are quarantined on the way."""
        self.wait_until_finished()
        while True:
            steps = self._step_dirs()
            if not steps:
                return None, None
            step = steps[-1]
            reason = self._verify_step(step)
            if reason is None:
                try:
                    return self._restore(step), step
                except CheckpointMismatchError:
                    raise  # a deliberate refusal, not damage
                except Exception as e:  # noqa: BLE001 — quarantined below
                    if classify_error(e) != "unknown" or _is_loud_error(e):
                        raise  # the device failed, not the step's files
                    reason = f"restore failed: {type(e).__name__}: {e}"
            self._quarantine(step, reason)

    def _restore(self, step: int) -> PCGState:
        """Step ``step``'s carry for this solve: this rank's block of it on
        a mesh, the node grid on one device. A step written on another
        mesh shape is resharded (the elastic resume): only the mesh may
        differ from the fingerprint."""
        step_dir = os.path.join(self.directory, str(step))
        # the fingerprint first: it must refuse before a shape mismatch
        # could fail the load with an opaque error
        with open(os.path.join(step_dir, META_NAME), encoding="utf-8") as fh:
            meta = json.load(fh)
        if meta != self._fp:
            drop = lambda fp: {k: v for k, v in fp.items() if k != "mesh"}
            if drop(meta) != drop(self._fp):
                raise CheckpointMismatchError(
                    "checkpoint was written by a different problem/dtype: "
                    f"saved {meta}, current {self._fp}"
                )
            if self._writes:
                obs_trace.event(
                        "degrade:checkpoint-reshard",
                    step=step,
                    from_mesh=meta["mesh"],
                    to_mesh=self._fp["mesh"],
                )
        tree = torch.load(os.path.join(step_dir, STATE_NAME),
                          map_location="cpu", weights_only=True)
        # the arrays as the writing solve laid them out: its mesh's padded
        # node grid (the node grid itself on one device)
        dims = padded_dims_of(self.problem.node_shape, *meta["mesh"])
        for key in STATE_KEYS:
            got = tree[key]
            want = (dims if key in _GRID_KEYS else ())
            if (tuple(got.shape) != tuple(want) or got.dtype != (
                    torch.int32 if key == "k" else torch.bool
                    if key in ("converged", "breakdown") else self.dtype)):
                raise ValueError(
                    f"field {key} is {got.dtype} {tuple(got.shape)}, the "
                    f"solve's is {want}")
        state = PCGState(*(tree[key] for key in STATE_KEYS))
        if self.mesh is not None:
            from poisson_ellipse_tpu_torch.parallel.elastic import (
                reshard_state,
            )

            return reshard_state(self.problem, state, self.mesh, self.dtype)
        g1, g2 = self.problem.node_shape
        return PCGState(*(x[:g1, :g2].to(self.device) if x.dim() == 2
                          else x.to(self.device) for x in state))

    # -- the surface the mesh guard drives ---------------------------------

    def initial_state(self) -> PCGState:
        """A fresh iteration-0 carry (this rank's, on a mesh)."""
        return self._parts()[0]() if self.mesh is not None else self._init()

    def save(self, state) -> None:
        """Persist the classical 8-field prefix of ``state`` (an ABFT tail
        is never saved: shadow sums are re-anchored on whatever mesh the
        carry wakes up on)."""
        self._save(PCGState(*tuple(state)[:8]))

    def restore_latest(self):
        """The newest valid step's carry, laid out for this solver's mesh
        (quarantining damage, resharding across mesh shapes), or None."""
        return self._restore_latest_valid()

    # -- driving ------------------------------------------------------------

    def run(self, resume: bool = True) -> PCGResult:
        """Solve to convergence, saving every ``chunk`` iterations.

        resume=True picks up from the newest valid checkpoint in
        ``directory`` (quarantining damaged steps); resume=False starts
        from iteration 0 regardless. On a mesh the result's w is the
        global (M+1, N+1) solution on every rank."""
        state = self._restore_latest_valid() if resume else None
        if self.mesh is not None:
            return self._run_mesh(state)
        carry = [state if state is not None else self._init()]
        issued = [False]

        def step(it: int):
            carry[0] = self._body(carry[0], it)
            issued[0] = True

        def flags():
            # after a chunk, the save's host copy is the read; the start
            # reads the carry it resumes from
            st = carry[0]
            if issued[0]:
                issued[0] = False
                host = self._save(st)
                return torch.stack([host["k"], host["converged"].to(
                    host["k"].dtype), host["breakdown"].to(host["k"].dtype)])
            return torch.stack([st.k, st.converged.to(st.k.dtype),
                                st.breakdown.to(st.k.dtype)])

        self.host_syncs = run_chunked(step, flags,
                                      self.problem.max_iterations, self.chunk)
        return result_of(carry[0])

    def _run_mesh(self, state) -> PCGResult:
        """The mesh's run: the stepper's chunks, a save (a gather and the
        first rank's write) after each."""
        from poisson_ellipse_tpu_torch.parallel.pcg_sharded import gather_w

        init_fn, advance_fn = self._parts()
        if state is None:
            state = init_fn()
        cap = self.problem.max_iterations
        k, converged, breakdown = (int(v) for v in torch.stack([
            state.k, state.converged.to(state.k.dtype),
            state.breakdown.to(state.k.dtype)]).tolist())
        self.host_syncs = 1
        while not (converged or breakdown or k >= cap):
            state = advance_fn(state, min(k + self.chunk, cap), k)
            host = self._save(state)
            self.host_syncs += 1
            k, converged, breakdown = (int(host["k"]),
                                       bool(host["converged"]),
                                       bool(host["breakdown"]))
        result = result_of(state)
        return result._replace(w=gather_w(self.problem, self.mesh,
                                          result.w))

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def solve_with_checkpoints(
    problem: Problem,
    directory: str,
    chunk: int = 500,
    dtype=torch.float32,
    stencil: str = "xla",
    resume: bool = True,
    mesh=None,
    device=None,
) -> PCGResult:
    """One-call form of CheckpointingSolver."""
    with CheckpointingSolver(
        problem, directory, chunk=chunk, dtype=dtype, stencil=stencil,
        mesh=mesh, device=device,
    ) as solver:
        return solver.run(resume=resume)
