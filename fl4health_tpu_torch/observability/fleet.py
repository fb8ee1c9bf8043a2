"""Fleet ledger (counterpart of ``fl4health_tpu/observability/fleet.py``, the
same numpy code): per-client lifetime records at registry scale.

Every observability layer before this one sees a single round window —
in-graph telemetry is per-round, the flight recorder keeps a 16-round
ring, postmortems render what the ring held. The questions a long-lived
federation actually asks are per-client over a LIFETIME: which clients
are chronic stragglers, repeat poisoners, never sampled? This module is
that memory.

Design constraints (the client registry's row discipline):

- **Zero extra device syncs.** ``absorb_round`` consumes only host data
  the RoundConsumer / chunked epilogues already pulled (the fused
  ``HostPull``, the telemetry dict, the quarantine mask, the cached
  payload byte counts). No tensor imports, no device pulls, no RNG — which is
  what makes ledger-on trajectories bit-identical to ledger-off by
  construction on every execution mode.
- **O(participated) host memory.** Records exist only for clients that
  have actually appeared (participated, or been named by quarantine /
  fault evidence). A 10M-client registry with 50 sampled per round costs
  50·rounds records, not 10M. Fleet-level distributions live in
  streaming sketches (``observability/sketches.py``) at
  registry-size-invariant memory.
- **Checkpoint-durable.** ``snapshot()`` is a JSON-safe dict the
  simulation folds into the checkpoint frame's host header, so the
  ledger rides the checkpoint ring: resume restores it as-of the
  restored round, and a supervisor rollback cannot double-count the
  rolled-back rounds (they re-absorb exactly once on replay).

Thread-safety follows ``flightrec.FlightRecorder``: one lock around all
mutation, scrape-side readers (``/fleet``, ``/clients/<id>``) take the
same lock and copy out.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from fl4health_tpu_torch.observability.sketches import (
    FixedHistogram,
    QuantileSketch,
    gini,
)

# EMA horizon for per-client loss / update-norm (≈ last 10 appearances)
_EMA_ALPHA = 0.2

# staleness measured in server versions (async modes); bytes in powers of 2
_STALENESS_BOUNDS = (0, 1, 2, 4, 8, 16, 32, 64)
_BYTES_BOUNDS = tuple(float(1 << s) for s in range(10, 34, 2))

# lifetime suspect scoring — deliberately the same vocabulary as
# resilience/suspects.py's ring scoring so the two rankings compose
_W_NONFINITE = 4.0
_W_STRIKE = 3.0
_W_FAULT = 2.0
_W_FAILED = 1.0


def _iter(x) -> Any:
    """None -> (); anything else passes through. ``x or ()`` would choke
    on numpy arrays (ambiguous truth value), which the simulation's
    slot->registry id mapping hands in."""
    return () if x is None else x


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class ClientRecord:
    """One client's lifetime, stored sparsely. ``__slots__`` because a
    long run holds one of these per participated client."""

    __slots__ = (
        "client_id", "rounds_participated", "first_seen_round",
        "last_seen_round", "loss_ema", "update_norm_ema", "nonfinite_rounds",
        "failed_rounds", "staleness_sum", "staleness_max",
        "quarantine_strikes", "quarantine_releases", "quarantined",
        "fault_rounds", "bytes_down", "bytes_up",
    )

    def __init__(self, client_id: int):
        self.client_id = int(client_id)
        self.rounds_participated = 0
        self.first_seen_round = -1
        self.last_seen_round = -1
        self.loss_ema: float | None = None
        self.update_norm_ema: float | None = None
        self.nonfinite_rounds = 0
        self.failed_rounds = 0
        self.staleness_sum = 0.0
        self.staleness_max = 0.0
        self.quarantine_strikes = 0
        self.quarantine_releases = 0
        self.quarantined = False
        self.fault_rounds = 0
        self.bytes_down = 0
        self.bytes_up = 0

    # -- derived ----------------------------------------------------------
    def suspect_score(self) -> float:
        return (self.nonfinite_rounds * _W_NONFINITE
                + self.quarantine_strikes * _W_STRIKE
                + self.fault_rounds * _W_FAULT
                + self.failed_rounds * _W_FAILED)

    def straggler_score(self, current_round: int) -> float:
        """Rounds of silence + lifetime mean staleness — high for clients
        the sampler keeps missing AND clients whose updates arrive stale."""
        gap = max(0, int(current_round) - self.last_seen_round)
        mean_stale = (self.staleness_sum / self.rounds_participated
                      if self.rounds_participated else 0.0)
        return float(gap + mean_stale)

    def to_doc(self) -> dict:
        return {k: _jsonable(getattr(self, k)) for k in self.__slots__}

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "ClientRecord":
        rec = cls(int(doc["client_id"]))
        for k in cls.__slots__:
            if k == "client_id" or k not in doc:
                continue
            setattr(rec, k, doc[k])
        return rec


class FleetLedger:
    """Registry-scale per-client lifetime ledger + fleet sketches."""

    def __init__(self, *, sketch_k: int = 128):
        self._lock = threading.Lock()
        self._records: dict[int, ClientRecord] = {}
        self._sketch_k = int(sketch_k)
        self._loss_sketch = QuantileSketch(k=self._sketch_k)
        self._gap_sketch = QuantileSketch(k=self._sketch_k)
        self._staleness_hist = FixedHistogram(_STALENESS_BOUNDS)
        self._bytes_hist = FixedHistogram(_BYTES_BOUNDS)
        self.rounds_absorbed = 0
        self.last_round = -1
        self.registry_size: int | None = None

    # -- ingestion --------------------------------------------------------
    def absorb_round(
        self,
        rnd: int,
        participants: Sequence[int],
        *,
        losses: "Sequence[float] | None" = None,
        update_norms: "Sequence[float] | None" = None,
        nonfinite: "Sequence[float] | None" = None,
        staleness: "Sequence[float] | None" = None,
        staleness_pool: "Sequence[float] | None" = None,
        failed_ids: "Iterable[int] | None" = None,
        quarantined_ids: "Iterable[int] | None" = None,
        unquarantined_ids: "Iterable[int] | None" = None,
        fault_ids: "Iterable[int] | None" = None,
        bytes_down_per_client: int = 0,
        bytes_up_per_client: int = 0,
        registry_size: "int | None" = None,
    ) -> dict:
        """Fold one completed round into the ledger. All vector args are
        aligned with ``participants`` (registry ids). Returns the round's
        fleet facts (``participants_new``, ``participation_gini``,
        ``straggler_p99``) for the round summary. Pure host work.

        Idempotence across resume/rollback is positional, not internal:
        the caller absorbs BEFORE the round's checkpoint is written, so a
        restored ledger is always as-of its frame's round and re-run
        rounds absorb exactly once.
        """
        rnd = int(rnd)
        ids = [int(c) for c in participants]
        with self._lock:
            if registry_size is not None:
                self.registry_size = int(registry_size)
            new = 0
            for i, cid in enumerate(ids):
                rec = self._records.get(cid)
                if rec is None:
                    rec = self._records[cid] = ClientRecord(cid)
                    rec.first_seen_round = rnd
                    new += 1
                else:
                    # participation gap feeds the straggler distribution
                    self._gap_sketch.add(float(rnd - rec.last_seen_round))
                rec.rounds_participated += 1
                rec.last_seen_round = rnd
                if losses is not None:
                    v = float(losses[i])
                    if v == v:  # not NaN
                        self._loss_sketch.add(v)
                        rec.loss_ema = (v if rec.loss_ema is None else
                                        (1 - _EMA_ALPHA) * rec.loss_ema
                                        + _EMA_ALPHA * v)
                if update_norms is not None:
                    v = float(update_norms[i])
                    if v == v:
                        rec.update_norm_ema = (
                            v if rec.update_norm_ema is None else
                            (1 - _EMA_ALPHA) * rec.update_norm_ema
                            + _EMA_ALPHA * v)
                if nonfinite is not None and float(nonfinite[i]) > 0:
                    rec.nonfinite_rounds += 1
                if staleness is not None:
                    s = float(staleness[i])
                    rec.staleness_sum += s
                    rec.staleness_max = max(rec.staleness_max, s)
                    self._staleness_hist.observe(s)
                if bytes_down_per_client:
                    rec.bytes_down += int(bytes_down_per_client)
                if bytes_up_per_client:
                    rec.bytes_up += int(bytes_up_per_client)
                    self._bytes_hist.observe(float(bytes_up_per_client))
            # fleet-level staleness with no per-client alignment (the
            # buffered-async event's consumed-update staleness list)
            for s in _iter(staleness_pool):
                self._staleness_hist.observe(float(s))
            for cid in _iter(failed_ids):
                rec = self._records.get(int(cid))
                if rec is not None:
                    rec.failed_rounds += 1
            # quarantine standing: a strike is the False->True transition,
            # a release the True->False one (matching the simulation's own
            # entered/released diffing)
            for cid in _iter(quarantined_ids):
                cid = int(cid)
                rec = self._records.get(cid)
                if rec is None:
                    rec = self._records[cid] = ClientRecord(cid)
                    rec.first_seen_round = rnd
                if not rec.quarantined:
                    rec.quarantined = True
                    rec.quarantine_strikes += 1
            for cid in _iter(unquarantined_ids):
                rec = self._records.get(int(cid))
                if rec is not None and rec.quarantined:
                    rec.quarantined = False
                    rec.quarantine_releases += 1
            for cid in _iter(fault_ids):
                rec = self._records.get(int(cid))
                if rec is not None:
                    rec.fault_rounds += 1
            self.rounds_absorbed += 1
            self.last_round = max(self.last_round, rnd)
            facts = {
                "participants_new": new,
                "participation_gini": gini(
                    [r.rounds_participated for r in self._records.values()]
                ),
                "straggler_p99": self._gap_sketch.quantile(0.99),
            }
        return facts

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def get(self, client_id: int) -> "dict | None":
        """One client's lifetime record (JSON-safe), or None if never seen
        — backs the ``/clients/<id>`` endpoint."""
        with self._lock:
            rec = self._records.get(int(client_id))
            if rec is None:
                return None
            doc = rec.to_doc()
            doc["suspect_score"] = rec.suspect_score()
            doc["straggler_score"] = rec.straggler_score(self.last_round)
            return doc

    def top_stragglers(self, k: int = 5) -> list[dict]:
        with self._lock:
            ranked = sorted(
                self._records.values(),
                key=lambda r: (-r.straggler_score(self.last_round),
                               r.client_id),
            )[:max(0, int(k))]
            return [
                {"client": r.client_id,
                 "score": round(r.straggler_score(self.last_round), 3),
                 "last_seen_round": r.last_seen_round,
                 "rounds_participated": r.rounds_participated}
                for r in ranked
            ]

    def top_suspects(self, k: int = 5) -> list[dict]:
        with self._lock:
            ranked = sorted(
                (r for r in self._records.values() if r.suspect_score() > 0),
                key=lambda r: (-r.suspect_score(), r.client_id),
            )[:max(0, int(k))]
            return [
                {"client": r.client_id,
                 "score": round(r.suspect_score(), 3),
                 "nonfinite_rounds": r.nonfinite_rounds,
                 "quarantine_strikes": r.quarantine_strikes,
                 "fault_rounds": r.fault_rounds,
                 "quarantined": r.quarantined}
                for r in ranked
            ]

    def summary(self, top: int = 5) -> dict:
        """The ``/fleet`` endpoint body: fleet-level standing at a glance."""
        with self._lock:
            counts = [r.rounds_participated for r in self._records.values()]
            quarantined = sum(1 for r in self._records.values()
                              if r.quarantined)
            never_sampled = (None if self.registry_size is None
                             else max(0, self.registry_size
                                      - len(self._records)))
            out = {
                "rounds_absorbed": self.rounds_absorbed,
                "last_round": self.last_round,
                "clients_seen": len(self._records),
                "registry_size": self.registry_size,
                "never_sampled": never_sampled,
                "quarantined_now": quarantined,
                "participation": {
                    "gini": gini(counts),
                    "mean_rounds": (float(np.mean(counts)) if counts
                                    else None),
                    "max_rounds": (int(max(counts)) if counts else None),
                },
                "loss": self._loss_sketch.summary(),
                "participation_gap_rounds": self._gap_sketch.summary(),
                "staleness": self._staleness_hist.summary(),
                "update_bytes": self._bytes_hist.summary(),
                "ledger_bytes": self._nbytes_locked(),
            }
        # ranked views take the lock themselves
        out["top_stragglers"] = self.top_stragglers(top)
        out["top_suspects"] = self.top_suspects(top)
        return out

    # -- memory accounting -------------------------------------------------
    def _nbytes_locked(self) -> int:
        per_rec = 16 * len(ClientRecord.__slots__) + 64
        return (len(self._records) * per_rec
                + self._loss_sketch.nbytes() + self._gap_sketch.nbytes()
                + self._staleness_hist.nbytes() + self._bytes_hist.nbytes())

    def nbytes(self) -> int:
        """Approximate host bytes held — O(participated), pinned
        registry-size-invariant by the fleet tests."""
        with self._lock:
            return self._nbytes_locked()

    # -- durability --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe state for the checkpoint frame's host header."""
        with self._lock:
            return {
                "version": 1,
                "rounds_absorbed": self.rounds_absorbed,
                "last_round": self.last_round,
                "registry_size": self.registry_size,
                "clients": [r.to_doc() for r in self._records.values()],
                "sketches": {
                    "loss": self._loss_sketch.snapshot(),
                    "gap": self._gap_sketch.snapshot(),
                    "staleness": self._staleness_hist.snapshot(),
                    "bytes": self._bytes_hist.snapshot(),
                },
            }

    def restore(self, doc: "Mapping[str, Any] | None") -> None:
        """Adopt a ``snapshot()`` dict (checkpoint resume / rollback).
        ``None`` or a legacy frame without fleet state clears the ledger."""
        with self._lock:
            self._restore_locked(doc)

    def _restore_locked(self, doc: "Mapping[str, Any] | None") -> None:
        self._records = {}
        self._loss_sketch = QuantileSketch(k=self._sketch_k)
        self._gap_sketch = QuantileSketch(k=self._sketch_k)
        self._staleness_hist = FixedHistogram(_STALENESS_BOUNDS)
        self._bytes_hist = FixedHistogram(_BYTES_BOUNDS)
        self.rounds_absorbed = 0
        self.last_round = -1
        self.registry_size = None
        if not doc:
            return
        self.rounds_absorbed = int(doc.get("rounds_absorbed", 0))
        self.last_round = int(doc.get("last_round", -1))
        rs = doc.get("registry_size")
        self.registry_size = None if rs is None else int(rs)
        for cd in doc.get("clients") or []:
            rec = ClientRecord.from_doc(cd)
            self._records[rec.client_id] = rec
        sk = doc.get("sketches") or {}
        if sk.get("loss"):
            self._loss_sketch = QuantileSketch.restore(sk["loss"])
        if sk.get("gap"):
            self._gap_sketch = QuantileSketch.restore(sk["gap"])
        if sk.get("staleness"):
            self._staleness_hist = FixedHistogram.restore(sk["staleness"])
        if sk.get("bytes"):
            self._bytes_hist = FixedHistogram.restore(sk["bytes"])

    def clear(self) -> None:
        with self._lock:
            self._restore_locked(None)
