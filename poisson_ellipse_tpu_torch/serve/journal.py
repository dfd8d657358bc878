"""Crash-safe request journal: a killed server replays, never loses.

The port's own copy of ``poisson_ellipse_tpu.serve.journal``: its
snapshot files are the JAX package's, field for field, so a journal one
package wrote replays in the other.

The durability stance mirrors ``solver.checkpoint``'s integrity
manifest: every state transition rewrites one JSON snapshot under a
temporary name and ``os.replace``s it into place — atomic on POSIX, so
a kill at any instant leaves either the previous snapshot or the new
one on disk, never a torn file. The write-ahead contract is the
standard one: :meth:`RequestJournal.record_admit` returns only after
the snapshot holding the request is durable, and the scheduler
acknowledges admission only after that return — so on restart,
:meth:`unfinished` is exactly the set of acknowledged-but-unfinished
requests, and replaying them loses nothing the server ever promised.

Double completion is a journal-level error: :meth:`record_outcome` on a
request already in a terminal state raises instead of overwriting —
the chaos harness's zero-double-completion invariant is enforced where
the record lives, not just asserted after the fact.

Fleet fencing rides the same choke point: a journal owned by a fleet
replica carries a **fencing token** (``fence`` — issued by the fleet's
lease authority, ``fleet.replica``), every mutation calls
``fence.check()`` BEFORE touching the record, and every flushed
snapshot embeds ``fence.value``. A replica whose lease expired has its
token revoked, so a zombie resurrecting mid-handoff cannot admit or
complete anything — the stale write raises (and is trace-evented by the
token) at the exact layer the zero-lost/zero-double promises live.

Finished records are compacted: a terminal outcome *removes* the
request's record from the snapshot (its id is retained in a small
in-process set so double completion still raises) and bumps a durable
``finished`` counter, so each flush serializes only the live
admitted-but-unfinished set — O(live) disk work per transition on a
server meant to see millions of requests, not O(everything ever
served). Crash safety is unchanged: the compaction rides the same
atomic rename as the transition it records, so a restart either sees
the request admitted (and replays it — a single completion) or already
compacted (finished — never replayed).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from poisson_ellipse_tpu_torch.serve.request import OUTCOMES, ServeRequest

JOURNAL_VERSION = 1


class DoubleCompletionError(RuntimeError):
    """A second terminal outcome for an already-finished request — the
    lost-or-doubled bug class the journal exists to make impossible."""


class RequestJournal:
    """One server's request ledger, snapshotted atomically per transition.

    ``path`` is the snapshot file; a missing file is an empty journal
    (first boot). A leftover ``<path>.tmp`` from a mid-write kill is
    ignored and overwritten — the rename never happened, so the main
    snapshot is still the truth.

    ``fence`` is an optional fencing token (``fleet.replica``'s
    ``FencingToken``, or any object with ``check()`` and ``value``):
    when set, every mutation is fenced — ``check()`` runs before the
    record is touched and raises on a revoked token — and every
    snapshot embeds ``value`` so the on-disk ledger names the epoch
    that wrote it.
    """

    def __init__(self, path, fence=None):
        self.path = os.fspath(path)
        self.fence = fence
        self._records: dict[str, dict] = {}
        self._finished_ids: set[str] = set()
        self._finished_total = 0
        # the fencing token embedded in the loaded snapshot (None for a
        # fresh journal or one written unfenced) — forensic evidence of
        # WHICH epoch last wrote the ledger, surfaced for the fleet's
        # stale-write tests and post-incident reads
        self.loaded_fence_token = None
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as fh:
                data = json.load(fh)
            if data.get("v") != JOURNAL_VERSION:
                raise ValueError(
                    f"journal {self.path} carries version {data.get('v')!r},"
                    f" expected {JOURNAL_VERSION}"
                )
            self._records = data["requests"]
            self._finished_total = data.get("finished", 0)
            self.loaded_fence_token = data.get("fence_token")
            # a snapshot predating compaction may still carry done
            # records — fold them into the counter and drop them
            done = [
                rid for rid, rec in self._records.items()
                if rec["state"] == "done"
            ]
            for rid in done:
                del self._records[rid]
            self._finished_total += len(done)

    # -- transitions --------------------------------------------------------

    def record_admit(self, request: ServeRequest) -> None:
        """Durably record an admission; the scheduler acknowledges the
        request only after this returns (the write-ahead contract).
        Replayed requests re-admit under their original id — idempotent,
        their spec is simply refreshed."""
        self._check_fence()
        if request.request_id in self._finished_ids:
            raise DoubleCompletionError(
                f"request {request.request_id} is already finished; "
                f"it cannot be re-admitted"
            )
        self._records[request.request_id] = {
            "state": "admitted",
            "spec": request.spec(),
            "t_admit_unix": time.time(),
        }
        self._flush()

    def record_outcome(self, request_id: str, outcome: str,
                       detail: str | None = None) -> None:
        """Durably record a terminal outcome — exactly once per request.
        The terminal record is compacted away (see the module
        docstring); only the durable ``finished`` counter and the
        in-process id set remember it."""
        self._check_fence()
        if outcome not in OUTCOMES:
            raise ValueError(f"outcome {outcome!r} not one of {OUTCOMES}")
        if request_id in self._finished_ids:
            raise DoubleCompletionError(
                f"request {request_id} already finished; "
                f"refusing the second outcome {outcome!r}"
            )
        if request_id not in self._records:
            raise KeyError(f"request {request_id} was never admitted")
        del self._records[request_id]
        self._finished_ids.add(request_id)
        self._finished_total += 1
        self._flush()

    # -- replay -------------------------------------------------------------

    def unfinished(self, now: float) -> list[ServeRequest]:
        """Admitted-but-unfinished requests, rebuilt for resubmission
        (deadline budgets restart from ``now`` — see
        ``ServeRequest.from_spec``). Admission order is preserved."""
        return [
            ServeRequest.from_spec(rec["spec"], now)
            for rec in self._records.values()
            if rec["state"] == "admitted"
        ]

    def admitted_ids(self) -> set[str]:
        """Ids with a LIVE admitted record (finished/compacted ones
        excluded) — the fleet's co-ownership audit reads this."""
        return {
            rid for rid, rec in self._records.items()
            if rec["state"] == "admitted"
        }

    def state_of(self, request_id: str) -> dict | None:
        """The live record, a compacted ``{"state": "done"}`` stub for a
        request this journal instance saw finish, or None."""
        rec = self._records.get(request_id)
        if rec is not None:
            return dict(rec)
        if request_id in self._finished_ids:
            return {"state": "done"}
        return None

    def counts(self) -> dict:
        return {
            "admitted": len(self._records) + self._finished_total,
            "finished": self._finished_total,
            "unfinished": len(self._records),
        }

    # -- durability ---------------------------------------------------------

    def _check_fence(self) -> None:
        """The fencing gate every mutation passes first: a revoked token
        raises (``fleet.replica.StaleLeaseError``) BEFORE the record is
        touched, so a fenced zombie's admit/outcome never lands — in
        memory or on disk."""
        if self.fence is not None:
            self.fence.check()

    def _flush(self) -> None:
        """Write-temp-fsync-rename, the ``solver.checkpoint`` idiom: a
        kill mid-write leaves the previous snapshot, never a torn one."""
        payload = {
            "v": JOURNAL_VERSION,
            "requests": self._records,
            "finished": self._finished_total,
        }
        if self.fence is not None:
            # every journal write carries the fencing token: the on-disk
            # snapshot names the epoch that produced it
            payload["fence_token"] = self.fence.value
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".journal-", dir=directory)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(payload, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
