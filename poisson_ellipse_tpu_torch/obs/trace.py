"""Structured run tracing: dependency-free JSONL events with one schema.

A copy of ``poisson_ellipse_tpu.obs.trace`` (pure Python): the same schema
v3 and the same validator, so one validator reads the traces of both
packages.

The reference publishes its runs as free-form stdout tables (rank-0
printf blocks, ``poisson_mpi_cuda2.cu:1000-1034``); this framework's
entry points likewise grew ad-hoc ``print(..., file=sys.stderr)``
narration.
A serving stack needs the machine-readable form: every run emits a
stream of JSONL records — monotonic spans for the coarse phases
(assemble/compile/solve/finalize), point events for run reports and
bench rows, counters/gauges from :mod:`.metrics` — all under one run id
and one validated schema, so traces diff, grep and aggregate cleanly.

Activation is explicit (``--trace FILE`` on the harness CLI, or
:func:`start` from code) or ambient (the ``POISSON_TRACE`` environment
variable names the sink file); when no tracer is active every emitting
helper is a no-op, so instrumented code pays nothing. Nothing here
imports beyond the standard library — the tracer must work in the
leanest headless environment the solvers do.

Record schema (one JSON object per line; :func:`validate_record`):

  | key    | required | meaning                                        |
  |--------|----------|------------------------------------------------|
  | v      | yes      | schema version (``SCHEMA_VERSION``; v1 traces  |
  |        |          | still validate — v2 only added ``lane``)       |
  | run    | yes      | run id, shared by every record of one tracer   |
  | t      | yes      | seconds since the tracer started (monotonic)   |
  | kind   | yes      | meta / span / event / counter / gauge          |
  | name   | yes      | record name (``phase:solver``, ``bench_row``…) |
  | dur    | span     | span duration in seconds (monotonic)           |
  | value  | ctr/gauge| the counter/gauge value at emit time           |
  | lane   | no       | lane index of a lane-addressed event (the      |
  |        |          | batched engines' quarantine/fault records) —   |
  |        |          | first-class so lane filters need no field poke |
  | request| no       | request id of a request-addressed event (the   |
  | _id    |          | serve scheduler's admit/refill/retire/shed     |
  |        |          | records) — first-class so one request's whole  |
  |        |          | lifecycle greps out of a mixed stream          |
  | fields | no       | free-form JSON object of extra attributes      |

Timing inside traced device loops is out of scope by design: a span is a
*host-side* bracket, and the one rule is that no emitting call ever
lands inside a loop body that runs on the device's clock — on-device
per-iteration data goes through :mod:`.convergence` instead.
"""

from __future__ import annotations

import json
import os
import sys
import time
import uuid

# v2 added the optional top-level ``lane`` key (lane-addressed batched
# events); v3 the optional ``request_id`` key (request-addressed serving
# events); v1/v2 records remain valid — see VALID_VERSIONS
SCHEMA_VERSION = 3

VALID_VERSIONS = frozenset({1, 2, 3})

KINDS = frozenset({"meta", "span", "event", "counter", "gauge"})

# the closed top-level key set: unknown keys fail validation so the
# schema cannot grow silently (add here + bump SCHEMA_VERSION instead)
_ALLOWED_KEYS = frozenset(
    {
        "v", "run", "t", "kind", "name", "dur", "value", "lane",
        "request_id", "fields",
    }
)

ENV_VAR = "POISSON_TRACE"


class Tracer:
    """One run's JSONL event stream.

    ``sink`` is a path (opened for append, so multiple runs can share a
    file — each under its own run id) or any object with ``write``.
    Every record is flushed as it is written: a killed run keeps every
    event emitted before the kill, which is the point of tracing it.
    """

    def __init__(self, sink, run_id: str | None = None):
        if hasattr(sink, "write"):
            self._fh = sink
            self._owns = False
        else:
            self._fh = open(os.fspath(sink), "a", encoding="utf-8")
            self._owns = True
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._t0 = time.monotonic()
        self.emit(
            "meta",
            "trace-start",
            fields={
                "schema": SCHEMA_VERSION,
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "unix_time": time.time(),
            },
        )

    # -- emission -----------------------------------------------------------

    def emit(self, kind: str, name: str, dur: float | None = None,
             value: float | None = None, fields: dict | None = None,
             t: float | None = None, lane: int | None = None,
             request_id: str | None = None) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown record kind: {kind!r} (one of {sorted(KINDS)})")
        rec: dict = {
            "v": SCHEMA_VERSION,
            "run": self.run_id,
            "t": round(
                (time.monotonic() - self._t0) if t is None else max(t, 0.0), 6
            ),
            "kind": kind,
            "name": name,
        }
        if dur is not None:
            rec["dur"] = round(dur, 6)
        if value is not None:
            rec["value"] = value
        if lane is not None:
            rec["lane"] = int(lane)
        if request_id is not None:
            rec["request_id"] = str(request_id)
        if fields:
            rec["fields"] = fields
        # default=str: a numpy scalar or Path in a field must degrade to
        # text, never kill the traced run
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()

    def event(self, name: str, lane: int | None = None,
              request_id: str | None = None, **fields) -> None:
        self.emit(
            "event", name, fields=fields or None, lane=lane,
            request_id=request_id,
        )

    def span(self, name: str, **fields) -> "_Span":
        return _Span(self, name, fields)

    @property
    def closed(self) -> bool:
        """True once the sink can no longer accept records (late
        emitters — metrics flushes after ``stop()`` — check this
        instead of writing into a closed file)."""
        return bool(getattr(self._fh, "closed", False))

    def close(self) -> None:
        if self._owns and not self._fh.closed:
            self._fh.close()


class _Span:
    """Context manager emitting one ``span`` record at exit (monotonic
    duration; ``t`` is the span's start offset, as the schema table says)."""

    def __init__(self, tracer: Tracer, name: str, fields: dict):
        self.tracer = tracer
        self.name = name
        self.fields = fields

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc):
        fields = dict(self.fields)
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        self.tracer.emit(
            "span",
            self.name,
            dur=time.monotonic() - self._start,
            fields=fields or None,
            # t is the span's START offset (the schema table's contract),
            # so spans sort and nest by when they began, not ended
            t=self._start - self.tracer._t0,
        )
        return False


# -- the ambient tracer ------------------------------------------------------

_active: Tracer | None = None
_env_checked = False


def start(sink, run_id: str | None = None) -> Tracer:
    """Open a tracer on ``sink`` and make it the ambient one."""
    global _active, _env_checked
    if _active is not None:
        _active.close()
    _active = Tracer(sink, run_id=run_id)
    _env_checked = True  # an explicit start outranks the env variable
    return _active


def stop() -> None:
    """Close and clear the ambient tracer (no-op when none is active).

    Re-arms the ``POISSON_TRACE`` lookup: an explicit start/stop cycle
    (e.g. the harness CLI's ``--trace``) must not permanently silence an
    env-requested trace for the rest of the process."""
    global _active, _env_checked
    if _active is not None:
        _active.close()
        _active = None
    _env_checked = False


def active() -> Tracer | None:
    """The ambient tracer; on first call, ``POISSON_TRACE=FILE`` in the
    environment starts one transparently."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        path = os.environ.get(ENV_VAR)
        if path:
            _active = Tracer(path)
    return _active


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **fields):
    """A span on the ambient tracer, or a no-op context when inactive."""
    tracer = active()
    return tracer.span(name, **fields) if tracer else _NULL_SPAN


def span_event(name: str, dur: float, **fields) -> None:
    """Emit an already-measured span (the PhaseTimer shim's entry).

    The span ended "now", so its schema-mandated start offset is now
    minus ``dur`` — same t convention as a live ``span()`` bracket."""
    tracer = active()
    if tracer:
        tracer.emit(
            "span",
            name,
            dur=dur,
            fields=fields or None,
            t=(time.monotonic() - tracer._t0) - dur,
        )


def event(name: str, lane: int | None = None,
          request_id: str | None = None, **fields) -> None:
    tracer = active()
    if tracer:
        tracer.event(name, lane=lane, request_id=request_id, **fields)


def note(message: str, file=None, _event: str = "note", **fields) -> None:
    """Print ``message`` (stderr by default) AND emit it as a structured
    event when tracing — the drop-in for the entry points' ad-hoc narration
    prints, so human output and the machine trace cannot drift apart."""
    print(message, file=sys.stderr if file is None else file)
    tracer = active()
    if tracer:
        tracer.event(_event, message=message, **fields)


# -- schema validation -------------------------------------------------------


def validate_record(rec) -> str | None:
    """None when ``rec`` is a schema-valid trace record, else the error.

    The checks mirror the schema table in the module docstring; the
    dryrun smoke-check and the tests run every emitted line through this.
    """
    if not isinstance(rec, dict):
        return f"record is {type(rec).__name__}, not an object"
    unknown = set(rec) - _ALLOWED_KEYS
    if unknown:
        return f"unknown key(s): {', '.join(sorted(unknown))}"
    for key in ("v", "run", "t", "kind", "name"):
        if key not in rec:
            return f"missing required key: {key}"
    if rec["v"] not in VALID_VERSIONS:
        return (
            f"schema version {rec['v']!r} not one of "
            f"{sorted(VALID_VERSIONS)}"
        )
    if not isinstance(rec["run"], str) or not rec["run"]:
        return "run must be a non-empty string"
    if not isinstance(rec["t"], (int, float)) or rec["t"] < 0:
        return "t must be a non-negative number"
    if rec["kind"] not in KINDS:
        return f"kind {rec['kind']!r} not one of {sorted(KINDS)}"
    if not isinstance(rec["name"], str) or not rec["name"]:
        return "name must be a non-empty string"
    if rec["kind"] == "span":
        if not isinstance(rec.get("dur"), (int, float)) or rec["dur"] < 0:
            return "span records need a non-negative dur"
    if rec["kind"] in ("counter", "gauge"):
        if not isinstance(rec.get("value"), (int, float)):
            return f"{rec['kind']} records need a numeric value"
    if "lane" in rec:
        lane = rec["lane"]
        if isinstance(lane, bool) or not isinstance(lane, int) or lane < 0:
            return "lane must be a non-negative integer"
    if "request_id" in rec:
        rid = rec["request_id"]
        if not isinstance(rid, str) or not rid:
            return "request_id must be a non-empty string"
    if "fields" in rec and not isinstance(rec["fields"], dict):
        return "fields must be an object"
    return None


def read_jsonl(path) -> list[dict]:
    """Parse a trace file into records (blank lines skipped)."""
    out = []
    with open(os.fspath(path), encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
    return out


def validate_file(path) -> list[str]:
    """All schema errors in a trace file (empty list = valid)."""
    errors = []
    for i, rec in enumerate(read_jsonl(path), start=1):
        err = validate_record(rec)
        if err:
            errors.append(f"record {i}: {err}")
    return errors
