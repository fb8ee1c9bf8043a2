"""Span tracer (counterpart of ``fl4health_tpu/observability/spans.py``, the
same code): Chrome trace-event JSON on monotonic clocks.

The reference instruments rounds with coarse ``time.time()`` deltas fed to
reporters (base_server.py:288-300 wall-clock accounting). A round is a few
batched dispatches, so the interesting structure is *inside* a
round: configure_fit vs. device execute vs. host aggregation vs. checkpoint.
This tracer records nested context-manager spans on ``perf_counter_ns`` and
exports the Chrome trace-event format (``{"traceEvents": [...]}``) that
Perfetto / ``chrome://tracing`` render as a per-round flame timeline — the
FedJAX-style built-in simulation timing (arXiv:2108.02117 §4) without any
external dependency.

Disabled-path contract: a disabled tracer's ``span()`` returns a shared
no-op context manager — no allocation, no locking, no clock reads — so the
round hot loop pays nothing when observability is off.

Crash safety: ``export()`` publishes a complete ``{"traceEvents": [...]}``
envelope atomically at shutdown, but a process that DIES mid-run never
reaches it. ``stream_to(path)`` additionally appends each event to ``path``
as it is recorded, in the Chrome trace *JSON Array Format* — whose closing
``]`` is optional per the trace-event spec, so the file stays loadable in
Perfetto even after a SIGKILL mid-run. An ``atexit`` hook terminates the
array on any orderly interpreter exit, and :func:`load_trace` is the
tolerant reader (complete envelope, terminated array, or a stream torn
mid-line) the postmortem tooling uses.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any

from fl4health_tpu_torch.core.io import atomic_write


def load_trace(path: str) -> dict:
    """Load a Chrome trace written by this module — the complete
    ``{"traceEvents": [...]}`` envelope, a bare event array, or an
    UNTERMINATED streamed array (the crash case: trailing comma, or a
    partial final line torn by the kill). Returns the envelope form;
    raises ``ValueError`` when nothing parseable remains."""
    with open(path) as f:
        text = f.read()
    doc = None
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # streamed array killed mid-run: strip any torn final line, close
        # the array ourselves
        body = text.strip()
        while body:
            candidate = body.rstrip().rstrip(",")
            try:
                doc = json.loads(candidate + "]")
                break
            except json.JSONDecodeError:
                # drop the last (possibly partial) line and retry
                cut = body.rfind("\n")
                if cut < 0:
                    break
                body = body[:cut]
    if doc is None:
        raise ValueError(f"{path}: no parseable trace content")
    if isinstance(doc, list):
        events = [e for e in doc if e]  # drop the {} terminator sentinel
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    return doc


class _NullSpan:
    """Shared no-op span: reentrant, stateless, free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One live span; records a complete ("ph": "X") trace event on exit."""

    __slots__ = ("tracer", "name", "cat", "args", "_start_ns", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._start_ns = 0
        self._depth = 0

    def set(self, **args: Any) -> None:
        """Attach/override args mid-span (e.g. measured byte counts)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._depth = self.tracer._enter_depth()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_ns = time.perf_counter_ns()
        self.tracer._exit_depth()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tracer._record(
            self.name, self.cat, self._start_ns, end_ns, self._depth, self.args
        )
        return False


class Tracer:
    """Collects spans; thread-safe; exports Chrome trace-event JSON.

    Timestamps are microseconds since tracer construction (monotonic clock),
    so traces from one process align across threads. ``depth`` is recorded in
    each event's args for programmatic nesting assertions; the viewer derives
    visual nesting from ts/dur containment on its own.
    """

    def __init__(self, enabled: bool = True, process_name: str = "fl4health_tpu_torch"):
        self.enabled = enabled
        self.process_name = process_name
        # Two clocks sampled back-to-back: event timestamps stay on the
        # monotonic clock (cheap, never steps backwards), while the wall
        # anchor lets tools/trace_merge.py place this process's ts=0 on a
        # cross-process wall-clock axis.
        self._t0_ns = time.perf_counter_ns()
        self._wall0_ns = time.time_ns()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._thread_names: dict[int, str] = {}
        self._stream = None
        self._stream_path: str | None = None
        self._atexit_registered = False

    # -- cross-process metadata ------------------------------------------
    @property
    def wall0_ns(self) -> int:
        """Wall-clock time (``time.time_ns()``) at tracer construction —
        the instant all event ``ts`` values are relative to."""
        return self._wall0_ns

    def set_process_name(self, name: str) -> None:
        """Rename the process lane (e.g. ``coordinator`` vs ``silo:1``)
        shown in Perfetto. Takes effect in subsequent exports; a live
        stream gets a fresh ``process_name`` metadata event immediately."""
        self.process_name = name
        evt = {
            "name": "process_name", "ph": "M", "pid": os.getpid(),
            "tid": 0, "args": {"name": name},
        }
        with self._lock:
            self._stream_event(evt)

    def _clock_sync_event(self) -> dict:
        # a pinned instant at ts=0 carrying the wall anchor; trace_merge
        # shifts each process's events by the wall delta between anchors
        return {
            "name": "clock_sync", "cat": "__metadata", "ph": "i", "s": "p",
            "ts": 0.0, "pid": os.getpid(), "tid": 0,
            "args": {"wall_ns": self._wall0_ns},
        }

    def _thread_meta_locked(self, tid: int) -> None:
        # caller holds self._lock; first sighting of a thread emits its
        # thread_name metadata event so merged timelines label lanes
        if tid in self._thread_names:
            return
        name = threading.current_thread().name
        self._thread_names[tid] = name
        evt = {
            "name": "thread_name", "ph": "M", "pid": os.getpid(),
            "tid": tid, "args": {"name": name},
        }
        self._events.append(evt)
        self._stream_event(evt)

    # -- crash-safe streaming -------------------------------------------
    def stream_to(self, path: str) -> str | None:
        """Mirror every recorded event to ``path`` as it happens, in the
        Chrome JSON Array Format (loadable even unterminated — the spec
        makes the closing ``]`` optional, and :func:`load_trace` tolerates
        a torn final line). Events are flushed per record: span volume is a
        handful per round, so durability costs nothing measurable. Returns
        the path, or None when a different stream is already open (the
        first owner wins — a second Observability handle must not redirect
        a shared tracer's black box)."""
        with self._lock:
            if self._stream is not None:
                return path if self._stream_path == path else None
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._stream = open(path, "w")
            self._stream_path = path
            self._stream.write("[\n")
            self._stream.write(json.dumps({
                "name": "process_name", "ph": "M", "pid": os.getpid(),
                "tid": 0, "args": {"name": self.process_name},
            }) + ",\n")
            self._stream.write(json.dumps(self._clock_sync_event()) + ",\n")
            self._stream.flush()
            # replay whatever was recorded before the stream opened, so a
            # tracer enabled earlier than Observability.start() loses
            # nothing
            for evt in self._events:
                self._stream.write(json.dumps(evt) + ",\n")
            self._stream.flush()
        if not self._atexit_registered:
            # orderly exits (incl. unhandled exceptions) terminate the
            # array; a SIGKILL can't run this, which is why the format is
            # chosen to stay loadable without it
            atexit.register(self.close_stream)
            self._atexit_registered = True
        return path

    @property
    def stream_path(self) -> str | None:
        return self._stream_path

    def _stream_event(self, evt: dict) -> None:
        # caller holds self._lock
        if self._stream is not None:
            try:
                self._stream.write(json.dumps(evt, default=str) + ",\n")
                self._stream.flush()
            except (OSError, ValueError):  # closed/readonly fs: stop trying
                self._stream = None

    def close_stream(self) -> None:
        """Terminate the streamed array (``{}]`` — the empty object is the
        terminator sentinel ``load_trace`` drops) and close the file.
        Idempotent; safe from ``atexit``."""
        with self._lock:
            stream, self._stream = self._stream, None
            self._stream_path = None
        if stream is not None:
            try:
                stream.write("{}]\n")
                stream.close()
            except (OSError, ValueError):
                pass

    # -- depth bookkeeping (thread-local; tests assert nesting) ----------
    def _enter_depth(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit_depth(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    # -- recording -------------------------------------------------------
    def span(self, name: str, cat: str = "round", **args: Any):
        """Context manager timing a block. No-op (shared instance) when
        disabled — zero overhead on the hot path."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat, dict(args))

    def instant(self, name: str, cat: str = "event", **args: Any) -> None:
        """A zero-duration marker ("ph": "i")."""
        if not self.enabled:
            return
        ts = (time.perf_counter_ns() - self._t0_ns) / 1000.0
        tid = threading.get_ident()
        evt = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": ts, "pid": os.getpid(), "tid": tid,
            "args": dict(args),
        }
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(evt)
            self._stream_event(evt)

    def flow(self, ph: str, name: str, flow_id: int,
             cat: str = "flow", **args: Any) -> None:
        """A Chrome flow event: ``ph`` is ``"s"`` (start), ``"t"`` (step)
        or ``"f"`` (end). Events sharing ``flow_id`` are drawn as arrows
        between the slices that enclose them — across threads in one
        trace, and across processes once ``tools/trace_merge.py`` has put
        the traces on a shared clock."""
        if not self.enabled:
            return
        if ph not in ("s", "t", "f"):
            raise ValueError(f"flow ph must be 's'/'t'/'f', got {ph!r}")
        ts = (time.perf_counter_ns() - self._t0_ns) / 1000.0
        tid = threading.get_ident()
        evt = {
            "name": name, "cat": cat, "ph": ph, "id": flow_id,
            "ts": ts, "pid": os.getpid(), "tid": tid,
            "args": dict(args),
        }
        if ph == "f":
            evt["bp"] = "e"  # bind to the enclosing slice, not the next one
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(evt)
            self._stream_event(evt)

    def counter(self, name: str, **series: float) -> None:
        """A Chrome counter track sample ("ph": "C")."""
        if not self.enabled:
            return
        ts = (time.perf_counter_ns() - self._t0_ns) / 1000.0
        tid = threading.get_ident()
        evt = {
            "name": name, "cat": "counter", "ph": "C",
            "ts": ts, "pid": os.getpid(), "tid": tid,
            "args": {k: float(v) for k, v in series.items()},
        }
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(evt)
            self._stream_event(evt)

    def _record(self, name, cat, start_ns, end_ns, depth, args) -> None:
        tid = threading.get_ident()
        evt = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (start_ns - self._t0_ns) / 1000.0,
            "dur": (end_ns - start_ns) / 1000.0,
            "pid": os.getpid(),
            "tid": tid,
            "args": {**args, "depth": depth},
        }
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(evt)
            self._stream_event(evt)

    # -- introspection / export -----------------------------------------
    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def spans_named(self, name: str) -> list[dict]:
        return [e for e in self.events if e["ph"] == "X" and e["name"] == name]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event envelope Perfetto expects."""
        meta = {
            "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
            "args": {"name": self.process_name},
        }
        sync = self._clock_sync_event()
        return {"traceEvents": [meta, sync, *self.events],
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Atomically write the trace JSON (a crash mid-dump never leaves a
        truncated, unloadable trace at the published path). When a live
        stream targets the same path it is closed first, so the complete
        envelope REPLACES the streamed array at shutdown."""
        if self._stream_path == path:
            self.close_stream()
        with atomic_write(path) as f:
            json.dump(self.to_chrome_trace(), f, default=str)
        return path


# ---------------------------------------------------------------------------
# Process-wide default tracer: free functions (transport/codec.py,
# transport/coordinator.py) trace through this without threading a handle.
# Starts disabled; Observability(enabled=True) flips it on.
# ---------------------------------------------------------------------------

_default_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process default; returns the previous one
    (tests swap in a private tracer and restore)."""
    global _default_tracer
    prev = _default_tracer
    _default_tracer = tracer
    return prev
