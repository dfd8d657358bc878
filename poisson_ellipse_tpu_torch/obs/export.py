"""Metrics export: OpenMetrics text format + snapshot-to-file wiring.

A copy of ``poisson_ellipse_tpu.obs.export`` (pure Python).

``obs.metrics`` aggregates; this module publishes. The wire format is
the OpenMetrics/Prometheus text exposition format — the lingua franca
every scraping stack already speaks — rendered from a
``MetricsRegistry.snapshot()``:

- counters  →  ``# TYPE <name> counter`` + ``<name>_total <v>``
- gauges    →  ``# TYPE <name> gauge``   + ``<name> <v>``
- histograms → ``# TYPE <name> summary`` + per-quantile samples
  (``<name>{quantile="0.5"} <v>`` …) + ``<name>_count`` / ``<name>_sum``

plus the ``# EOF`` terminator OpenMetrics mandates. Like the tracer,
nothing here imports beyond the standard library.

:func:`parse_openmetrics` / :func:`validate_openmetrics` are the
read-side: the renderer's output round-trips back into a snapshot-shaped
dict, and the validator is what the tests (and the dryrun gate) hold the
renderer to — an exporter whose output its own validator rejects is how
scrape endpoints rot silently.

:class:`MetricsExporter` is the file wiring: atomic (temp-then-rename)
one-shot ``write()``, and optional periodic snapshots on a daemon thread
(``interval_s``) — the hook a serving worker points its node scraper at,
inherited for free by anything that uses the default registry (the
harness CLI's ``--metrics FILE`` does exactly this).
"""

from __future__ import annotations

import os
import re
import tempfile
import threading

from poisson_ellipse_tpu_torch.obs import metrics as _metrics

# OpenMetrics metric-name grammar; everything else maps onto "_"
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

_QUANTILE_BY_KEY = {
    f"p{int(q * 100)}": q for q in _metrics.HISTOGRAM_QUANTILES
}


def metric_name(name: str, prefix: str = "") -> str:
    """``name`` mapped onto the OpenMetrics grammar (prefixed, invalid
    characters → ``_``, leading digit guarded)."""
    full = f"{prefix}_{name}" if prefix else name
    full = _SANITIZE_RE.sub("_", full)
    if not full or not _NAME_RE.match(full):
        full = f"_{full}"
    return full


def render_openmetrics(snapshot: dict, prefix: str = "poisson") -> str:
    """One snapshot as OpenMetrics text (see module docstring).

    Deterministic: the snapshot is already name-sorted
    (``MetricsRegistry.snapshot``), and rendering adds no ordering of
    its own — two identical registries render byte-identically.
    """
    lines: list[str] = []
    for name, value in snapshot.get("counters", {}).items():
        full = metric_name(name, prefix)
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full}_total {_num(value)}")
    for name, value in snapshot.get("gauges", {}).items():
        full = metric_name(name, prefix)
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {_num(value)}")
    for name, summary in snapshot.get("histograms", {}).items():
        full = metric_name(name, prefix)
        lines.append(f"# TYPE {full} summary")
        for key, q in _QUANTILE_BY_KEY.items():
            if summary.get(key) is not None:
                lines.append(
                    f'{full}{{quantile="{q:g}"}} {_num(summary[key])}'
                )
        lines.append(f"{full}_count {_num(summary.get('count', 0))}")
        lines.append(f"{full}_sum {_num(summary.get('sum', 0.0))}")
        if summary.get("window") is not None:
            # sliding-window occupancy: the staleness guard a scraper
            # reads next to the quantiles (a stalled server's frozen p99
            # shows a window that stops turning over with count)
            lines.append(f"{full}_window {_num(summary['window'])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _num(v) -> str:
    """OpenMetrics sample value: repr(float) round-trips exactly, ints
    stay integral for readability."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def parse_openmetrics(text: str) -> dict:
    """Parse renderer-shaped OpenMetrics text back into a snapshot dict.

    Raises ``ValueError`` on anything malformed — use
    :func:`validate_openmetrics` for the error-list form.
    """
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    histograms: dict[str, dict] = {}
    types: dict[str, str] = {}
    saw_eof = False
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "summary"
            ):
                raise ValueError(f"line {lineno}: malformed TYPE line")
            if not _NAME_RE.match(parts[2]):
                raise ValueError(
                    f"line {lineno}: invalid metric name {parts[2]!r}"
                )
            if parts[2] in types:
                raise ValueError(
                    f"line {lineno}: duplicate TYPE for {parts[2]!r}"
                )
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue  # HELP/comment lines: legal, carried by other tools
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$", line)
        if not m:
            raise ValueError(f"line {lineno}: not a sample line: {raw!r}")
        name, labels, value = m.group(1), m.group(2), m.group(3)
        try:
            value = float(value)
        except ValueError as e:
            raise ValueError(f"line {lineno}: non-numeric value") from e
        base, kind = _family_of(name, types)
        if kind is None:
            raise ValueError(
                f"line {lineno}: sample {name!r} precedes its TYPE line"
            )
        if kind == "counter":
            counters[base] = value
        elif kind == "gauge":
            gauges[base] = value
        else:
            entry = histograms.setdefault(base, {})
            if labels:
                qm = re.match(r'\{quantile="([0-9.eE+-]+)"\}$', labels)
                if not qm:
                    raise ValueError(
                        f"line {lineno}: summary sample needs a quantile label"
                    )
                entry[f"p{int(float(qm.group(1)) * 100)}"] = value
            elif name.endswith("_count"):
                entry["count"] = value
            elif name.endswith("_sum"):
                entry["sum"] = value
            elif name.endswith("_window"):
                entry["window"] = value
            else:
                raise ValueError(
                    f"line {lineno}: unlabelled summary sample {name!r}"
                )
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return {"counters": counters, "gauges": gauges, "histograms": histograms}


def _family_of(sample_name: str, types: dict[str, str]):
    """(family base name, declared type) for one sample name."""
    if sample_name in types:
        return sample_name, types[sample_name]
    for suffix in ("_total", "_count", "_sum", "_window"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in types:
                return base, types[base]
    return sample_name, None


def validate_openmetrics(text: str) -> list[str]:
    """All format errors in an exposition (empty list = valid)."""
    try:
        parse_openmetrics(text)
        return []
    except ValueError as e:
        return [str(e)]


class MetricsExporter:
    """Snapshot-to-file wiring over a registry (default: the process
    registry). ``write()`` renders one atomic snapshot file;
    ``start()``/``stop()`` run it periodically on a daemon thread.
    Usable as a context manager (periodic while inside, final snapshot
    on exit)."""

    def __init__(self, path, registry=None, prefix: str = "poisson",
                 interval_s: float | None = None):
        self.path = os.fspath(path)
        self.registry = registry if registry is not None else _metrics.REGISTRY
        self.prefix = prefix
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def write(self) -> str:
        """Render the current snapshot to ``path`` (temp-then-rename, so
        a scraper never reads a torn file); returns the path."""
        text = render_openmetrics(self.registry.snapshot(), self.prefix)
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix=".metrics-", suffix=".prom", dir=directory
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(text)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path

    def try_write(self) -> str | None:
        """``write()`` that reports instead of raising: returns None on
        success, the OSError text on failure. The one helper behind both
        halves of every ``--metrics`` consumer's contract — the
        fail-fast path probe at startup (error string → curated exit 2)
        and the never-crash final snapshot at exit (error string → a
        warning that must not discard the run's computed rc)."""
        try:
            self.write()
            return None
        except OSError as e:
            return str(e)

    def start(self) -> None:
        """Begin periodic snapshots (requires a positive ``interval_s``
        — ``Event.wait(0)`` returns immediately, so a non-positive
        cadence would busy-spin the daemon thread on atomic rewrites)."""
        if self.interval_s is None or self.interval_s <= 0:
            raise ValueError("periodic export needs a positive interval_s")
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            warned = False
            while not self._stop.wait(self.interval_s):
                try:
                    self.write()
                    warned = False
                except OSError as e:
                    # one transient failure (disk full, NFS blip) must
                    # not kill periodic export for the rest of the run;
                    # warn once per outage, keep trying
                    if not warned:
                        warned = True
                        import sys

                        print(
                            f"warning: periodic metrics snapshot failed "
                            f"({e}); retrying each interval",
                            file=sys.stderr,
                        )

        self._thread = threading.Thread(
            target=run, name="metrics-exporter", daemon=True
        )
        self._thread.start()

    def stop(self, final_write: bool = True) -> None:
        """Stop the periodic thread; by default flush one last snapshot
        (the at-exit state is the one a post-mortem wants)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_write:
            self.write()

    def __enter__(self) -> "MetricsExporter":
        if self.interval_s is not None and self.interval_s > 0:
            self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
