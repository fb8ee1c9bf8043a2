"""Metrics registry (counterpart of ``fl4health_tpu/observability/registry.py``,
the same code on the port's ``core/io.atomic_write``, with a process-wide
``get_registry()`` of its own): counters/gauges/histograms.

Role: the per-round byte/time accounting that communication-efficiency work
treats as a first-class experimental output (arXiv:1610.05492 reports
per-round upload bytes; FedJAX logs simulation timing). Two exposition
surfaces:

- ``to_prometheus()`` — the Prometheus text format (``# HELP``/``# TYPE`` +
  samples), scrapable or diffable in tests;
- ``log_event()`` + ``dump_jsonl()`` — an append-only JSONL event log (one
  JSON object per line) that ``tools/perf_report.py`` renders into a
  per-round summary table.

All instruments are host-side Python on plain floats: no device syncs, no
tensor imports — safe to call from transport code and the round loop alike.
Thread-safe via one registry lock (instrument mutation is a dict update;
contention is negligible next to a round's dispatch).
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import re
import threading
import time
from typing import Any, Iterable, Mapping

from fl4health_tpu_torch.core.io import atomic_write

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf,
)


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"  # exposition-format canonical spelling
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # Exposition-format 0.0.4: HELP text escapes backslash and newline
    # (quotes are NOT escaped in HELP, unlike label values).
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. ``inc`` with a negative amount raises — a counter
    that can decrease silently corrupts rate() math downstream."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels: Mapping[str, str] | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    @property
    def exposition_name(self) -> str:
        # Prometheus conformance: counters MUST carry the _total suffix in
        # the text exposition. Registry names stay as-given (snapshot() and
        # the programmatic API are unchanged); only the exposed family name
        # gains the suffix when the caller omitted it.
        return self.name if self.name.endswith("_total") else f"{self.name}_total"

    def expose(self) -> list[str]:
        return [
            f"{self.exposition_name}{_label_str(self.labels)} "
            f"{_fmt_value(self._value)}"
        ]

    def snapshot(self) -> float:
        return self._value

    prom_type = "counter"


class Gauge:
    """Last-write-wins instantaneous value; supports inc/dec for level
    tracking (in-flight RPCs)."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels: Mapping[str, str] | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    @property
    def exposition_name(self) -> str:
        return self.name

    def expose(self) -> list[str]:
        return [f"{self.name}{_label_str(self.labels)} {_fmt_value(self._value)}"]

    def snapshot(self) -> float:
        return self._value

    prom_type = "gauge"


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le`` bucket
    counts observations <= bound; ``+Inf`` equals ``_count``)."""

    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Mapping[str, str] | None = None,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        bs = sorted(set(float(b) for b in buckets) | {math.inf})
        self.buckets = tuple(bs)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def exposition_name(self) -> str:
        return self.name

    def expose(self) -> list[str]:
        lines = []
        for b, c in zip(self.buckets, self._counts):
            lbl = _label_str({**self.labels, "le": _fmt_value(b)})
            lines.append(f"{self.name}_bucket{lbl} {c}")
        lines.append(f"{self.name}_sum{_label_str(self.labels)} {_fmt_value(self._sum)}")
        lines.append(f"{self.name}_count{_label_str(self.labels)} {self._count}")
        return lines

    def snapshot(self) -> dict:
        return {
            "count": self._count,
            "sum": self._sum,
            "buckets": {_fmt_value(b): c for b, c in zip(self.buckets, self._counts)},
        }

    prom_type = "histogram"


DEFAULT_MAX_EVENTS = 100_000


class MetricsRegistry:
    """Names + label sets -> instruments. Getter-or-create semantics: the
    same (name, labels) always returns the same instrument, so call sites
    never coordinate registration. Re-requesting a name as a different
    instrument kind raises (a counter silently shadowed by a gauge is the
    classic metrics-soup bug).

    The JSONL event log is CAPPED at ``max_events`` records (rollover:
    oldest dropped first, counted by ``fl_events_dropped_total``) so a
    multi-thousand-round run — a few events per round plus per-client
    telemetry vectors — cannot grow host memory and the dumped log without
    bound. ``max_events=None`` disables the cap.

    ``rollover="archive"`` (opt-in; requires ``archive_path``) preserves
    evicted history instead of dropping it: evictions happen in segments of
    ~10% of the cap, each gzipped to ``<archive_path>.NNNN.jsonl.gz`` next
    to where the log will be dumped, retaining at most ``max_archives``
    segments (oldest deleted first) — so postmortem bundles can include
    pre-rollover events while disk stays bounded. The default
    (``rollover="drop"``) is byte-identical to the legacy behavior."""

    def __init__(self, max_events: int | None = DEFAULT_MAX_EVENTS,
                 rollover: str = "drop", archive_path: str | None = None,
                 max_archives: int = 8):
        if max_events is not None and max_events < 1:
            raise ValueError(f"max_events must be >= 1 or None, got {max_events}")
        if rollover not in ("drop", "archive"):
            raise ValueError(
                f"rollover must be 'drop' or 'archive'; got {rollover!r}"
            )
        if rollover == "archive" and not archive_path:
            raise ValueError("rollover='archive' requires archive_path")
        if max_archives < 1:
            raise ValueError(f"max_archives must be >= 1; got {max_archives}")
        self.max_events = max_events
        self.rollover = rollover
        self.archive_path = archive_path
        self.max_archives = int(max_archives)
        # resume the sequence past any segments already on disk — a new
        # registry reusing an archive_path must not overwrite history
        self._archive_seq = self._existing_archive_seq()
        self._metrics: dict[tuple[str, tuple], Any] = {}
        self._helps: dict[str, str] = {}
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # -- instruments -----------------------------------------------------
    def _get(self, cls, name, help, labels, **kwargs):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, requested {cls.__name__}"
                    )
                if help:
                    # a metric first touched help-lessly (e.g. a baseline
                    # read) still earns its # HELP line from a later caller
                    self._helps.setdefault(name, help)
                return existing
            m = cls(name, help=help, labels=labels, **kwargs)
            self._metrics[key] = m
            if help:
                self._helps.setdefault(name, help)
            return m

    def counter(self, name: str, help: str = "", labels: Mapping[str, str] | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Mapping[str, str] | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Mapping[str, str] | None = None,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- event log -------------------------------------------------------
    def log_event(self, event: str, **fields: Any) -> dict:
        """Append one structured event (stamped with wall time) to the JSONL
        log. Returns the record for immediate reuse (reporter bridging).
        Past ``max_events`` the log rolls over (oldest records dropped,
        visible in ``fl_events_dropped_total``)."""
        rec = {"ts": time.time(), "event": event, **fields}
        dropped = 0
        evicted: list[dict] | None = None
        with self._lock:
            self._events.append(rec)
            if self.max_events is not None and len(self._events) > self.max_events:
                if self.rollover == "archive":
                    # evict a SEGMENT (~10% of the cap) so the gzip cost
                    # amortizes instead of landing on every append
                    n = max(len(self._events) - self.max_events,
                            max(self.max_events // 10, 1))
                    n = min(n, len(self._events) - 1)  # keep the new record
                    evicted = self._events[:n]
                    del self._events[:n]
                else:
                    dropped = len(self._events) - self.max_events
                    del self._events[:dropped]
        if dropped:
            # outside the registry lock: counter() re-acquires it
            self.counter(
                "fl_events_dropped_total",
                help="JSONL event-log records dropped by size rollover",
            ).inc(dropped)
        if evicted:
            self._archive_segment(evicted)
        return rec

    def _archive_segment(self, records: list[dict]) -> None:
        """Gzip one evicted segment next to the (future) log dump and prune
        the archive set to ``max_archives``. Archive failures degrade to
        drop semantics — the log must never take down the run."""
        try:
            with self._lock:
                # seq/path allocation under the registry lock: concurrent
                # evicting threads (round consumer + checkpoint on_save)
                # must not collide on one segment path
                self._archive_seq += 1
                path = (f"{self.archive_path}."
                        f"{self._archive_seq:04d}.jsonl.gz")
            with atomic_write(path, "wb") as f:
                with gzip.GzipFile(fileobj=f, mode="wb") as gz:
                    for rec in records:
                        gz.write((json.dumps(rec, default=str) + "\n")
                                 .encode("utf-8"))
            segs = self.archive_paths()
            for old in segs[:max(len(segs) - self.max_archives, 0)]:
                try:
                    os.remove(old)
                except OSError:
                    pass
            self.counter(
                "fl_events_archived_total",
                help="JSONL event-log records preserved to gzip archive "
                     "segments by rollover",
            ).inc(len(records))
        except Exception:
            self.counter(
                "fl_events_dropped_total",
                help="JSONL event-log records dropped by size rollover",
            ).inc(len(records))

    def archive_paths(self) -> list[str]:
        """Existing archive segments, oldest first (empty without
        ``rollover='archive'``)."""
        if not self.archive_path:
            return []
        # escape the base: a path with glob metacharacters ([run-v4] ...)
        # must still discover/prune its own segments
        return sorted(glob.glob(f"{glob.escape(self.archive_path)}"
                                ".*.jsonl.gz"))

    def _existing_archive_seq(self) -> int:
        best = 0
        for p in self.archive_paths():
            m = re.search(r"\.(\d+)\.jsonl\.gz$", p)
            if m:
                best = max(best, int(m.group(1)))
        return best

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump_jsonl(self, path: str) -> str:
        """Atomic JSONL dump of the event log."""
        with atomic_write(path) as f:
            for rec in self.events:
                f.write(json.dumps(rec) + "\n")
        return path

    # -- exposition ------------------------------------------------------
    def snapshot(self) -> dict:
        """{name: value | {labels...} | histogram-dict} — the programmatic
        view tests and the reporter bridge consume."""
        out: dict[str, Any] = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), m in items:
            val = m.snapshot()
            if labels:
                slot = out.setdefault(name, {})
                slot[_label_str(dict(labels))] = val
            else:
                out[name] = val
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: families grouped by
        EXPOSITION name (counters gain the mandatory ``_total`` suffix if
        registered without it), one ``# HELP``/``# TYPE`` pair per family,
        HELP text escaped per the spec."""
        with self._lock:
            items = list(self._metrics.items())
            helps = dict(self._helps)
        by_name: dict[str, list] = {}
        raw_names: dict[str, str] = {}
        for (name, _), m in items:
            by_name.setdefault(m.exposition_name, []).append(m)
            raw_names.setdefault(m.exposition_name, name)
        lines: list[str] = []
        for name in sorted(by_name):
            ms = by_name[name]
            help_text = helps.get(raw_names[name], "")
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {ms[0].prom_type}")
            for m in ms:
                lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path: str) -> str:
        with atomic_write(path) as f:
            f.write(self.to_prometheus())
        return path

    def clear_events(self) -> None:
        """Drop the event log only (instruments keep their process-lifetime
        counter semantics) — called after a run's JSONL dump so a second run
        in the same process doesn't re-dump round records it didn't own."""
        with self._lock:
            self._events.clear()

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._helps.clear()
            self._events.clear()


# ---------------------------------------------------------------------------
# Process-wide default registry: transport counters and the simulation's
# round accounting land in ONE snapshot unless a caller wires a private one.
# ---------------------------------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process default; returns the previous one
    (tests swap in a private registry and restore)."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev
