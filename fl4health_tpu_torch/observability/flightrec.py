"""Flight recorder (counterpart of
``fl4health_tpu/observability/flightrec.py``, the same code): bounded
black-box capture of the last ``window`` rounds.

The live observability stack (spans, Prometheus/JSONL, in-graph
``RoundTelemetry``, ``/metrics`` + ``/manifest``) tells you what a healthy
run is doing — but when a run ends abnormally (watchdog halt, quorum loss,
SIGTERM preemption) the richest evidence dies with the process: the JSONL
log may be mid-rollover, the Chrome trace unterminated, and nobody
snapshots the last rounds' per-client telemetry or quarantine state.
Production FL debugging is POSTMORTEM debugging (stragglers, poisoned
silos, divergence onset — the failure modes FedBuff-style async schedules
care about, arXiv:2106.06639), so the :class:`FlightRecorder` keeps a ring
of the last ``window`` rounds' full-fidelity host-side round records and
``observability.bundle.dump_bundle`` publishes them on any abnormal end.

Cost contract (the reason this can default on):

- fed from the existing ``RoundConsumer`` epilogue / chunked epilogue with
  data the fused device->host transfer ALREADY pulled — recording adds
  zero device syncs and no change to the round programs on either execution
  mode (recorder-on is pinned bit-identical to recorder-off by tests);
- memory is O(window x cohort slots), never O(rounds) or O(registry): each
  entry holds [K]-shaped host arrays (telemetry vectors, masks, the
  round's REGISTRY ids under cohort-slot execution) plus a scalar summary
  dict, and the deque evicts beyond ``window`` (asserted by a
  registry-size-invariance test at fixed K).

The SIGTERM half lives here too: :func:`trap_sigterm` converts a SIGTERM
delivered during ``fit()`` into a :class:`SigtermShutdown` raised in the
main thread, which the simulation's abnormal-end hook turns into a
postmortem bundle before the process exits 143.
"""

from __future__ import annotations

import collections
import contextlib
import signal
import threading
from typing import Any, Iterator, Mapping

import numpy as np

DEFAULT_WINDOW = 16

# conventional "terminated by SIGTERM" exit status (128 + 15)
SIGTERM_EXIT_CODE = 143


class SigtermShutdown(SystemExit):
    """SIGTERM arrived mid-``fit()``. A ``SystemExit`` subclass so an
    unhandled propagation exits with the conventional 143 status; the
    simulation's abnormal-end hook dumps a postmortem bundle first."""

    def __init__(self) -> None:
        super().__init__(SIGTERM_EXIT_CODE)


@contextlib.contextmanager
def trap_sigterm(on_signal: Any = None) -> Iterator[bool]:
    """Install a SIGTERM -> :class:`SigtermShutdown` handler for the scope.

    Installed only when running on the main thread (CPython delivers
    signals there) AND the process still has the default disposition — a
    caller-installed SIGTERM handler is never displaced. Yields whether the
    trap is armed; the previous disposition is restored on exit.

    ``on_signal`` (optional, exception-proof) runs inside the handler
    BEFORE the raise — the simulation snapshots "which round was the run
    at when the signal arrived" here, because by the time the exception
    finishes unwinding, the pipeline's teardown drains will have recorded
    later rounds into the black box."""
    if threading.current_thread() is not threading.main_thread():
        yield False
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)
    except (ValueError, OSError):  # exotic embedding without signal support
        yield False
        return
    if prev not in (signal.SIG_DFL, None):
        yield False
        return

    def _handler(signum, frame):  # noqa: ARG001 (signal API)
        if on_signal is not None:
            try:
                on_signal()
            except Exception:
                pass
        raise SigtermShutdown()

    signal.signal(signal.SIGTERM, _handler)
    try:
        yield True
    finally:
        signal.signal(signal.SIGTERM, prev)


def _host_arrays(tree: Mapping[str, Any] | None) -> dict[str, np.ndarray] | None:
    if tree is None:
        return None
    return {k: np.asarray(v) for k, v in tree.items()}


class FlightRecorder:
    """Ring buffer of the last ``window`` rounds' host-side round records.

    One entry per completed round: the round's scalar metrics summary (the
    same dict the ``round`` JSONL event carries — execution mode,
    compile/device/host walls, wire bytes, async buffer/staleness, cohort
    staging facts), aggregate fit/eval losses, the participation mask, the
    per-client ``RoundTelemetry`` vectors, the in-graph quarantine mask,
    the round's injected-fault summary and — under cohort-slot execution —
    the [K] REGISTRY ids the slots mapped to, so postmortem attribution
    names real clients, not slot positions.

    Thread-safe: the pipelined path records from the ``RoundConsumer``
    thread while ``dump_bundle`` may run on the main thread.
    """

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        self.window = int(window)
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=self.window
        )
        self._lock = threading.Lock()
        self._checkpoint: dict[str, Any] = {}
        self._run_facts: dict[str, Any] = {}
        # lock-FREE mirror of last_round() for signal handlers: a SIGTERM
        # can land while THIS thread holds self._lock (chunked-mode
        # record_round runs on the main thread) — the handler must never
        # acquire the lock or the process deadlocks instead of exiting 143
        self._last_round_hint: int | None = None

    # -- feeding (consumer thread / chunked epilogue) --------------------
    def record_round(
        self,
        round_idx: int,
        summary: Mapping[str, Any],
        *,
        fit_loss: float | None = None,
        eval_loss: float | None = None,
        mask: Any = None,
        telemetry: Mapping[str, Any] | None = None,
        registry_ids: Any = None,
        fault: Mapping[str, Any] | None = None,
    ) -> None:
        """Append one round's record (evicting past ``window``). Every
        array argument is host data the round's fused transfer already
        materialized — never pass device buffers that still back live
        state."""
        entry: dict[str, Any] = {
            "round": int(round_idx),
            "summary": dict(summary),
        }
        if fit_loss is not None:
            entry["fit_loss"] = float(fit_loss)
        if eval_loss is not None:
            entry["eval_loss"] = float(eval_loss)
        if mask is not None:
            entry["mask"] = np.asarray(mask)
        if telemetry is not None:
            entry["telemetry"] = _host_arrays(telemetry)
        if registry_ids is not None:
            entry["registry_ids"] = np.asarray(registry_ids)
        if fault is not None:
            entry["fault"] = dict(fault)
        with self._lock:
            self._ring.append(entry)
            self._bump_hint(int(round_idx))

    def attach(self, round_idx: int, **fields: Any) -> None:
        """Merge late-arriving facts (e.g. the quarantine mask, emitted
        after the round's metrics) into that round's entry; silently a
        no-op when the round already left the ring."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry["round"] == int(round_idx):
                    for k, v in fields.items():
                        entry[k] = (np.asarray(v)
                                    if isinstance(v, np.ndarray) or hasattr(v, "shape")
                                    else v)
                    return

    def _bump_hint(self, round_idx: int) -> None:
        # caller holds self._lock; plain int assignment is atomic to read
        if self._last_round_hint is None or round_idx > self._last_round_hint:
            self._last_round_hint = round_idx

    def note_checkpoint(self, stats: Mapping[str, Any]) -> None:
        """Remember the newest durable checkpoint's facts (path,
        generation, round, bytes) — the bundle's "what to resume from"."""
        with self._lock:
            self._checkpoint = dict(stats)
            if stats.get("round") is not None:
                self._bump_hint(int(stats["round"]))

    def set_run_facts(self, **facts: Any) -> None:
        """Run-level provenance (execution mode, config hash, cohort
        shape) merged into the bundle header."""
        with self._lock:
            self._run_facts.update(facts)

    # -- reading ---------------------------------------------------------
    @property
    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    @property
    def rounds(self) -> list[int]:
        with self._lock:
            return [int(e["round"]) for e in self._ring]

    @property
    def checkpoint(self) -> dict:
        with self._lock:
            return dict(self._checkpoint)

    @property
    def run_facts(self) -> dict:
        with self._lock:
            return dict(self._run_facts)

    def last_round(self) -> int | None:
        """Newest round the recorder knows about — the ring's newest entry
        or the newest checkpoint note, whichever is later (a SIGTERM
        landing inside round r's checkpoint save may beat the epilogue's
        record of round r into the recorder)."""
        with self._lock:
            return self._last_round_hint

    @property
    def last_round_hint(self) -> int | None:
        """LOCK-FREE read of :meth:`last_round` for signal handlers — a
        handler runs on whatever thread currently holds (or is about to
        take) the recorder lock, so it must never acquire it."""
        return self._last_round_hint

    def nbytes(self) -> int:
        """Host bytes of the ring's array payload — the O(window x slots)
        quantity the bounded-memory contract is asserted on (scalar
        summaries are negligible and excluded so the figure is
        registry-size-invariant by construction)."""
        total = 0
        with self._lock:
            for entry in self._ring:
                for v in entry.values():
                    if isinstance(v, np.ndarray):
                        total += v.nbytes
                    elif isinstance(v, dict):
                        total += sum(
                            a.nbytes for a in v.values()
                            if isinstance(a, np.ndarray)
                        )
        return total

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._checkpoint = {}
            self._run_facts = {}
            self._last_round_hint = None
