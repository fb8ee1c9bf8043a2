"""Suspect-client ranking over flight-recorder evidence (counterpart of
``fl4health_tpu/resilience/suspects.py``, a copy of its numpy scoring, so
the port ranks a ring as JAX does).

The flight recorder (``observability/flightrec.py``) keeps the last
``window`` rounds' per-client telemetry; when a run ends abnormally, the
question an operator (or the :class:`~fl4health_tpu_torch.resilience.
supervisor.RecoverySupervisor`) asks first is *which clients did this*.
This module is the scoring the recovery supervisor quarantines by:

- non-finite state (NaN/Inf in losses/params/eval) is the dominant signal;
- grad-norm / update-norm outliers beyond 2 sigma of the participating
  cohort accumulate their z-scores (the scaled/sign-flipped-update proxy);
- in-graph quarantine standing and watchdog strikes corroborate;
- consumed-update staleness above the round mean (buffered-async runs);
- chaos-layer disclosure: when a ``FaultPlan`` was active, each ring
  entry carries the round's injected-fault summary, and a client the plan
  corrupted on record is a suspect (packet corruption is invisible to
  the local-training telemetry: clients train honestly and lie upstream).

The 2-sigma cut is JAX's. Over a cohort of ``n`` the population z-score
of one client is at most ``sqrt(n - 1)`` (2.236 at six clients), so in a
small cohort an honest client with the largest norm can sit just above
the cut; the ranking then names it, in both packages alike.

All entries are host dicts: the live recorder's
(:attr:`FlightRecorder.entries`) or a loaded bundle's ring (the two share
one schema; cohort entries carry ``registry_ids`` so scores attribute to
real clients, not slot positions). Pure numpy: safe on any thread.
"""

from __future__ import annotations

import math

import numpy as np

#: training-loss factor over the ring best treated as divergence onset
DIVERGENCE_FACTOR = 2.0


def client_ids_for_entry(entry: dict) -> np.ndarray:
    """Registry ids for the entry's per-client vectors (cohort runs store
    them; dense runs fall back to positional ids)."""
    ids = entry.get("registry_ids")
    tele = entry.get("telemetry") or {}
    n = 0
    for v in tele.values():
        v = np.asarray(v)
        if v.ndim >= 1:
            n = max(n, v.shape[0])
    mask = entry.get("mask")
    if mask is not None:
        n = max(n, np.asarray(mask).shape[0])
    if ids is not None:
        return np.asarray(ids)[:n] if n else np.asarray(ids)
    return np.arange(n)


def detect_divergence_onset(ring: list[dict],
                            factor: float = DIVERGENCE_FACTOR) -> dict | None:
    """First recorded round whose training loss exceeded ``factor`` x the
    best loss seen earlier IN THE RING (the black box only holds the tail,
    so onset may predate the window — the report says so)."""
    best = math.inf
    for entry in sorted(ring, key=lambda e: e.get("round", 0)):
        loss = entry.get("fit_loss")
        if loss is None or not math.isfinite(float(loss)):
            # a non-finite aggregate IS the onset
            if loss is not None:
                return {"round": int(entry["round"]), "loss": float(loss),
                        "best": (None if best is math.inf else best),
                        "reason": "non-finite aggregate training loss"}
            continue
        loss = float(loss)
        if best is not math.inf and loss > factor * best:
            return {"round": int(entry["round"]), "loss": loss, "best": best,
                    "reason": f"loss > {factor}x ring best"}
        best = min(best, loss)
    return None


def _ledger_records(ledger) -> "dict[int, dict]":
    """Per-client lifetime docs from a live
    :class:`~fl4health_tpu_torch.observability.fleet.FleetLedger` or its
    ``snapshot()`` dict (what a postmortem bundle's ``fleet.json``
    holds). Tolerant: anything unrecognizable yields no priors."""
    if ledger is None:
        return {}
    snap = ledger.snapshot() if hasattr(ledger, "snapshot") else ledger
    if not isinstance(snap, dict):
        return {}
    out: dict[int, dict] = {}
    for doc in snap.get("clients") or []:
        try:
            out[int(doc["client_id"])] = doc
        except (KeyError, TypeError, ValueError):
            continue
    return out


def rank_suspects(ring: list[dict], top: int = 5,
                  ledger=None) -> list[dict]:
    """Score every client the ring saw, by REGISTRY id. Signals (each
    normalized across the participating cohort per round, then summed over
    the ring): non-finite counts (dominant), grad-norm and update-norm
    outlier z-scores, quarantine strikes, consumed-update staleness above
    the round mean. Higher = more suspect. Returns
    ``[{client, score, evidence}, ...]`` most-suspect first.

    ``ledger`` (a live fleet ledger or its snapshot dict) adds a bounded
    repeat-offender prior: a client the WINDOW already implicated whose
    lifetime record shows prior non-finite rounds / quarantine strikes /
    injected faults gets up to +5.0, so between two equally-suspicious
    clients in the ring the one with history ranks first. Lifetime
    history alone never creates a suspect — the flight window carries the
    incident evidence, the ledger only breaks ties."""
    scores: dict[int, float] = {}
    evidence: dict[int, list[str]] = {}

    def bump(cid: int, amount: float, why: str | None = None):
        cid = int(cid)
        scores[cid] = scores.get(cid, 0.0) + float(amount)
        if why:
            evidence.setdefault(cid, []).append(why)

    for entry in sorted(ring, key=lambda e: e.get("round", 0)):
        rnd = int(entry.get("round", 0))
        ids = client_ids_for_entry(entry)
        if ids.size == 0:
            continue
        mask = entry.get("mask")
        part = (np.asarray(mask)[:ids.size] > 0 if mask is not None
                else np.ones(ids.size, bool))
        tele = entry.get("telemetry") or {}

        nonfinite = np.zeros(ids.size)
        for key in ("nonfinite_loss", "nonfinite_params",
                    "nonfinite_eval_loss"):
            v = tele.get(key)
            if v is not None:
                nonfinite[:len(v)] += np.nan_to_num(
                    np.asarray(v, np.float64)[:ids.size], nan=1.0
                )
        for i in np.nonzero((nonfinite > 0) & part)[0]:
            bump(ids[i], 10.0, f"non-finite state in round {rnd}")

        for key, label in (("grad_norm_mean", "grad norm"),
                           ("update_norm", "update norm")):
            v = tele.get(key)
            if v is None:
                continue
            v = np.asarray(v, np.float64)[:ids.size]
            live = part & np.isfinite(v)
            if live.sum() >= 3:
                mu, sd = float(v[live].mean()), float(v[live].std())
                if sd > 0:
                    z = (v - mu) / sd
                    for i in np.nonzero(live & (z > 2.0))[0]:
                        bump(ids[i], float(z[i]),
                             f"{label} {v[i]:.3g} is {z[i]:.1f} sigma above "
                             f"the round-{rnd} cohort mean")

        fault = entry.get("fault") or {}
        for cid in fault.get("corrupted") or []:
            cid = int(cid)
            if 0 <= cid < ids.size:
                cid = int(ids[cid])  # slot position -> registry id
            bump(cid, 6.0,
                 f"chaos layer corrupted this client's update in round "
                 f"{rnd} ({','.join(sorted((fault.get('kinds') or {})))})")

        q = entry.get("quarantine")
        if q is not None:
            q = np.asarray(q, np.float64)[:ids.size]
            for i in np.nonzero(q > 0)[0]:
                bump(ids[i], 3.0, f"quarantined in round {rnd}")
        for cid in entry.get("quarantine_active") or []:
            bump(cid, 1.0)

        stale = tele.get("staleness")
        if stale is not None:
            v = np.asarray(stale, np.float64)[:ids.size]
            live = part & np.isfinite(v)
            if live.any():
                mu = float(v[live].mean())
                for i in np.nonzero(live & (v > mu + 2))[0]:
                    bump(ids[i], 1.0,
                         f"staleness {v[i]:.0f} in round {rnd} "
                         f"(round mean {mu:.1f})")

    records = _ledger_records(ledger)
    if records:
        for cid in list(scores):
            if scores[cid] <= 0:
                continue
            doc = records.get(cid)
            if not doc:
                continue
            # lifetime suspect weight on the ledger's own scale
            # (observability/fleet.py ClientRecord.suspect_score), clamped
            # so history amplifies window evidence but cannot outvote it
            lifetime = (4.0 * float(doc.get("nonfinite_rounds") or 0)
                        + 3.0 * float(doc.get("quarantine_strikes") or 0)
                        + 2.0 * float(doc.get("fault_rounds") or 0)
                        + 1.0 * float(doc.get("failed_rounds") or 0))
            if lifetime > 0:
                prior = min(5.0, 0.5 * lifetime)
                bump(cid, prior,
                     f"repeat offender on the fleet ledger "
                     f"(lifetime suspect weight {lifetime:.0f} over "
                     f"{int(doc.get('rounds_participated') or 0)} rounds)")

    ranked = sorted(scores.items(), key=lambda kv: -kv[1])
    return [
        {"client": cid, "score": round(s, 3),
         "evidence": evidence.get(cid, [])[:4]}
        for cid, s in ranked[:top] if s > 0
    ]
