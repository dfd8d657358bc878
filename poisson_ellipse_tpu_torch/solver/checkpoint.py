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

The mesh's checkpoints (``mesh=``, the resharded restore) are ROADMAP
Queue A item 21b.
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
    unported,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

STATE_KEYS = ("k", "w", "r", "p", "zr", "diff", "converged", "breakdown")

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
    """Single-device PCG that persists its carry every ``chunk``
    iterations, on ``device`` (cuda unless ``device='cpu'``).

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
        if mesh is not None:
            raise unported("checkpointing on the mesh (mesh=)",
                           "Queue A item 21b")
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
        self.device = resolve_device(device)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        a, b, rhs = assembly.assemble(problem, dtype, self.device)
        self._operands = (a, b, rhs)
        self._init = lambda: init_state(problem, a, b, rhs)
        # the loop's own body, masked at the iteration cap; a chunk issues
        # exactly its bodies
        self._body = make_body(problem, a, b, rhs, problem.max_iterations,
                               stencil)
        self._fp = _fingerprint(problem, dtype, stencil, (1, 1))
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []
        self.save_seconds: list[float] = []
        self.write_seconds: list[float] = []
        # host reads of the last run: its start and one a save
        self.host_syncs = 0

    # -- persistence --------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The newest finalized step on disk (saves in flight included)."""
        self.wait_until_finished()
        steps = self._step_dirs()
        return steps[-1] if steps else None

    def _save(self, state: PCGState) -> dict:
        """Copy the carry to the host and queue its write; returns the
        host copy (its flags are what the loop reads)."""
        t0 = time.perf_counter()
        host = {key: x.detach().to("cpu", copy=True)
                for key, x in zip(STATE_KEYS, state)}
        self.save_seconds.append(time.perf_counter() - t0)
        step = int(host["k"])
        self._pending.append(self._writer.submit(self._write, step, host))
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
        survives."""
        self.wait_until_finished()
        while True:
            steps = self._step_dirs()
            if not steps:
                return None
            step = steps[-1]
            reason = self._verify_step(step)
            if reason is None:
                try:
                    return self._restore(step)
                except (CheckpointMismatchError, NotImplementedError):
                    raise  # deliberate refusals, not damage
                except Exception as e:  # noqa: BLE001 — quarantined below
                    if classify_error(e) != "unknown" or _is_loud_error(e):
                        raise  # the device failed, not the step's files
                    reason = f"restore failed: {type(e).__name__}: {e}"
            self._quarantine(step, reason)

    def _restore(self, step: int) -> PCGState:
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
            raise unported(
                f"resuming a checkpoint written on a {meta['mesh']} mesh",
                "Queue A item 21b")
        tree = torch.load(os.path.join(step_dir, STATE_NAME),
                          map_location=self.device, weights_only=True)
        template = self._init()
        for key, want in zip(STATE_KEYS, template):
            got = tree[key]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"field {key} is {got.dtype} {tuple(got.shape)}, the "
                    f"solve's is {want.dtype} {tuple(want.shape)}")
        return PCGState(*(tree[key] for key in STATE_KEYS))

    # -- the surface the mesh guard drives ---------------------------------

    def initial_state(self) -> PCGState:
        """A fresh iteration-0 carry."""
        return self._init()

    def save(self, state) -> None:
        """Persist the classical 8-field prefix of ``state``."""
        self._save(PCGState(*state[:8]))

    def restore_latest(self):
        """The newest valid step's carry (quarantining damage), or None."""
        return self._restore_latest_valid()

    # -- driving ------------------------------------------------------------

    def run(self, resume: bool = True) -> PCGResult:
        """Solve to convergence, saving every ``chunk`` iterations.

        resume=True picks up from the newest valid checkpoint in
        ``directory`` (quarantining damaged steps); resume=False starts
        from iteration 0 regardless."""
        state = self._restore_latest_valid() if resume else None
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
