"""Bounded round time-series (counterpart of
``fl4health_tpu/observability/timeseries.py``, the same code) — the serving
KPIs behind the operations plane.

Role: ROADMAP item 3 frames production federation as a *service* with
service-level indicators — sustained rounds/hour, wire bytes per client,
straggler tail, recovery MTTR — not a ``fit()`` call an operator watches.
This module turns the per-round summaries the RoundConsumer / chunked
epilogues already computed (``_record_round_metrics`` — host floats, zero
extra device syncs) into those KPIs.

Memory discipline: a ``deque(maxlen=window)`` of small dicts plus KLL
quantile sketches (``sketches.QuantileSketch``) for the lifetime
round-duration distribution — O(window + k log n) total, invariant in both
registry size and run length. No torch imports; every input is a host float
the epilogue already held.

Threading: ``observe_round`` runs on whichever thread owns the epilogue
(consumer thread on pipelined runs, main thread on chunked/cohort/async);
``note_recovery`` arrives via ``Observability.log_event`` from the
supervisor, and ``kpis()`` is read by the HTTP handler thread serving
``GET /admin/slo``. One lock covers all three.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Mapping

from fl4health_tpu_torch.observability.sketches import QuantileSketch

__all__ = ["RoundTimeSeries"]


class RoundTimeSeries:
    """Sliding-window KPIs over the per-round summaries the epilogue emits.

    ``observe_round(summary, ...)`` ingests one round summary (the dict
    ``_record_round_metrics`` logs as a ``round`` event) and returns the
    current KPI dict; ``note_recovery(phase)`` folds the supervisor's
    ``recovery`` events into an MTTR estimate (engage → probation_passed
    wall-clock, the time the run spent limping before the ladder repaired
    it). ``clock`` is injectable so tests pin wall-time KPIs exactly.
    """

    def __init__(self, window: int = 256,
                 clock: Callable[[], float] = time.time):
        if window < 2:
            raise ValueError(f"RoundTimeSeries window must be >= 2; got {window}")
        self.window = int(window)
        self._clock = clock
        self._lock = threading.Lock()
        self._points: deque[dict[str, Any]] = deque(maxlen=self.window)
        self._round_s = QuantileSketch()  # lifetime round-duration sketch
        self._mttr_s: deque[float] = deque(maxlen=self.window)
        self._incident_t0: float | None = None  # first engage of open incident
        self.rounds_seen = 0
        self.recoveries = 0
        self.halts = 0

    # ------------------------------------------------------------------ feed
    def observe_round(self, summary: Mapping[str, Any], *,
                      fit_loss: float | None = None,
                      eval_loss: float | None = None,
                      ts: float | None = None) -> dict[str, Any]:
        """Ingest one epilogue summary; returns the refreshed KPI dict."""
        now = float(ts if ts is not None else self._clock())
        wall = float(summary.get("fit_s") or 0.0) + float(summary.get("eval_s") or 0.0)
        participants = summary.get("participants")
        # prefer post-compression wire bytes when the wire path recorded them
        gather = summary.get("gather_bytes_wire", summary.get("gather_bytes"))
        wire = None
        if gather is not None or summary.get("broadcast_bytes") is not None:
            wire = float(gather or 0.0) + float(summary.get("broadcast_bytes") or 0.0)
        fleet = summary.get("fleet") or {}
        point = {
            "round": summary.get("round"),
            "ts": now,
            "wall_s": wall,
            "participants": participants,
            "wire_bytes": wire,
            "straggler_p99": fleet.get("straggler_p99"),
            "fit_loss": None if fit_loss is None else float(fit_loss),
            "eval_loss": None if eval_loss is None else float(eval_loss),
        }
        with self._lock:
            self._points.append(point)
            if wall > 0.0:
                self._round_s.add(wall)
            self.rounds_seen += 1
            return self._kpis_locked()

    def note_recovery(self, phase: Any, *, ts: float | None = None) -> None:
        """Fold one supervisor ``recovery`` event into the MTTR estimate.

        An incident opens at its FIRST ``engage`` (re-engages while open
        are the same outage escalating rungs, not a new one) and closes at
        ``probation_passed``; ``halt`` closes it unrepaired.
        """
        now = float(ts if ts is not None else self._clock())
        with self._lock:
            if phase == "engage":
                if self._incident_t0 is None:
                    self._incident_t0 = now
            elif phase == "probation_passed":
                if self._incident_t0 is not None:
                    self._mttr_s.append(max(0.0, now - self._incident_t0))
                    self._incident_t0 = None
                    self.recoveries += 1
            elif phase == "halt":
                self._incident_t0 = None
                self.halts += 1

    # ------------------------------------------------------------------ read
    def kpis(self) -> dict[str, Any]:
        """Current serving KPIs. Keys with insufficient signal are None."""
        with self._lock:
            return self._kpis_locked()

    def _kpis_locked(self) -> dict[str, Any]:
        pts = list(self._points)
        out: dict[str, Any] = {
            "window": self.window,
            "rounds_seen": self.rounds_seen,
            "rounds_per_hour": None,
            "round_s_p50": self._round_s.quantile(0.5),
            "round_s_p99": self._round_s.quantile(0.99),
            "bytes_per_client": None,
            "straggler_p99": None,
            "straggler_p99_trend": None,
            "eval_loss": None,
            "fit_loss": None,
            "mttr_s": None,
            "mttr_open_s": None,
            "recoveries": self.recoveries,
            "halts": self.halts,
        }
        if len(pts) >= 2:
            dt = pts[-1]["ts"] - pts[0]["ts"]
            if dt > 0.0:
                out["rounds_per_hour"] = (len(pts) - 1) / dt * 3600.0
        if pts:
            last = pts[-1]
            out["eval_loss"] = last["eval_loss"]
            out["fit_loss"] = last["fit_loss"]
            if last["wire_bytes"] is not None and last["participants"]:
                out["bytes_per_client"] = last["wire_bytes"] / float(last["participants"])
            tails = [p["straggler_p99"] for p in pts if p["straggler_p99"] is not None]
            if tails:
                out["straggler_p99"] = tails[-1]
                if len(tails) >= 2:
                    out["straggler_p99_trend"] = tails[-1] - tails[0]
        if self._mttr_s:
            out["mttr_s"] = sum(self._mttr_s) / len(self._mttr_s)
        if self._incident_t0 is not None:
            out["mttr_open_s"] = max(0.0, self._clock() - self._incident_t0)
        return out

    @property
    def nbytes(self) -> int:
        """Rough footprint — pinned O(window) regardless of registry size."""
        with self._lock:
            per_point = 8 * 16  # ~8 slots of float/ref per point
            return (len(self._points) * per_point
                    + len(self._mttr_s) * 8
                    + self._round_s.nbytes() + 128)
