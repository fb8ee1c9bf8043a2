"""Self-healing federation, a declarative recovery supervisor
(counterpart of ``fl4health_tpu/resilience/supervisor.py``).

The framework detects (``HealthWatchdog``, the flight recorder), isolates
(quarantine, ``RobustFedAvg``) and persists (the checkpoint ring, the
postmortem bundles); the :class:`RecoverySupervisor` closes the loop, so
an abnormal end no longer waits for an operator.

Per abnormal end of a supervised ``fit()``:

1. **Classify.** The exception goes through the same
   ``observability.bundle.verdict_from_exception`` that labels the
   postmortem bundles (``TrainingHealthError`` / ``ClientFailuresError`` /
   ``QuorumError`` / ``CheckpointCorruptError``); anything outside the
   policy's ``recover_kinds`` (SIGTERM, generic exceptions) propagates
   untouched.
2. **Attribute.** Suspects are the verdict's named clients, then the
   flight-recorder ring scored by :mod:`~fl4health_tpu_torch.resilience.
   suspects` with the fleet ledger's prior; under cohort execution they
   are registry ids.
3. **Roll back.** Checkpoint-ring generations at or past the failure (or
   its divergence onset) are pruned
   (``StateCheckpointer.prune_generations_from_round``), so the next
   ``fit()`` restores the newest generation that predates it; sync, async
   and cohort frames all resume. With no ring (or an all-corrupt one) the
   run restarts from its seed-derived init (``sim._reset_to_initial``).
4. **Mitigate** per the :class:`RecoveryPolicy` ladder (``retry`` ->
   ``quarantine`` -> ``robustify`` -> ``degrade`` -> halt), with bounded
   attempts per rung:

   - ``retry``: rollback and resume only (transients, corrupt frames);
   - ``quarantine``: the suspects are masked out of sampling on every
     route (by registry id under a cohort) until their release round,
     a mask and no rebuild; when the strategy is a
     :class:`~fl4health_tpu_torch.resilience.quarantine.
     QuarantiningStrategy` its in-graph ``QuarantineState`` is seeded with
     the same suspects;
   - ``robustify``: a plain ``FedAvg`` innermost strategy becomes
     :class:`~fl4health_tpu_torch.resilience.aggregators.RobustFedAvg`
     (their server states are the same tree, so restored frames still
     load), or an existing trimmed-mean ``RobustFedAvg`` trims more; the
     round functions are rebuilt once;
   - ``degrade``: a bound :class:`QuorumControl` is relaxed, a
     fraction-sampling client manager's cohort shrinks, and where the
     strategy has the ``server_lr`` state binding the server learning
     rate cools through ``sweep.hoisting.apply_state_scalars`` (a
     server-state leaf write).

5. **Resume and observe.** The supervised ``fit()`` re-enters (every
   attempt that dies still publishes its postmortem bundle first); one
   ``recovery`` JSONL event and ``fl_recovery_*`` metrics land per
   attempt. After ``probation_rounds`` consecutive healthy rounds past the
   failure the ladder resets and ``/healthz`` answers 200 again
   (``Observability.mark_healthy``). An exhausted ladder re-raises the
   original exception: halt is the last rung.

The supervisor journals its ladder position and quarantine roster to an
atomic JSON ledger next to the checkpoint ring (``recovery_ledger.json``,
JAX's document, so either package's supervisor reads the other's), so a
SIGKILLed process resumes with the same mitigations armed.

``recovery=None`` (the default) and an armed policy that never engages
both leave a run bit for bit as it was, on every route: the hooks do
nothing until an engagement.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

RUNG_RETRY = "retry"
RUNG_QUARANTINE = "quarantine"
RUNG_ROBUSTIFY = "robustify"
RUNG_DEGRADE = "degrade"
KNOWN_RUNGS = (RUNG_RETRY, RUNG_QUARANTINE, RUNG_ROBUSTIFY, RUNG_DEGRADE)

#: the structured abnormal-end taxonomy the supervisor may act on — the
#: verdict kinds ``observability.bundle.verdict_from_exception`` assigns
#: to the typed failures ("sigterm"/"exception" stay operator territory)
RECOVERABLE_KINDS = (
    "training_health", "client_failures", "quorum", "checkpoint_corrupt",
)

LEDGER_NAME = "recovery_ledger.json"
_LEDGER_VERSION = 1

#: loss-over-ring-best factor used to spot the divergence ONSET for
#: rollback targeting — tighter than the postmortem report's display
#: factor (2.0): a compounding poison trips the watchdog rounds after it
#: started contaminating checkpoints, and the worst case of a
#: false-positive here is re-running one extra healthy round
ONSET_FACTOR = 1.3


@dataclasses.dataclass
class QuorumControl:
    """Mutable quorum handle for supervised cross-silo loops: the caller
    passes ``quorum=ctl.quorum`` to every ``broadcast_round`` and binds
    ``ctl`` to the supervisor (``RecoverySupervisor(quorum_control=...)``)
    — the ``degrade`` rung then relaxes it in place (an int quorum
    decrements toward 1, a fractional one multiplies by
    ``RecoveryPolicy.quorum_relax``, both floored at ``minimum``)."""

    quorum: Any  # int count or float fraction (broadcast_round semantics)
    minimum: Any = 1

    def relax(self, factor: float) -> bool:
        """One degrade step; returns whether anything changed."""
        if isinstance(self.quorum, float):
            new = max(float(self.quorum) * factor, float(self.minimum))
        else:
            new = max(int(self.quorum) - 1, int(self.minimum))
        changed = new != self.quorum
        self.quorum = new
        return changed


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Declarative escalation ladder for :class:`RecoverySupervisor`.

    ``rungs`` orders the mitigations tried on repeated failures; each rung
    gets ``attempts_per_rung`` engagements before the supervisor
    escalates, and a rung that cannot apply to the run (no suspects to
    quarantine, nothing to robustify or degrade) is skipped. When every
    rung is exhausted — or ``max_total_attempts`` trips first — the
    original exception propagates: halt is the ladder's implicit last
    rung. A probation window of ``probation_rounds`` consecutive healthy
    rounds resets the ladder to its first rung (and flips ``/healthz``
    back to 200), so an incident next week starts from ``retry`` again,
    not from where last week's left off.

    Quarantine knobs: suspects are the verdict's named clients plus ring
    suspects scoring at least ``suspect_score_threshold``
    (:func:`~fl4health_tpu_torch.resilience.suspects.rank_suspects`), capped at
    ``max_suspects`` per engagement; they are masked out of sampling for
    ``quarantine_rounds`` rounds after the resume point (``0`` = the rest
    of the run). ``robust_method``/``trim_fraction`` configure the
    ``robustify`` swap; ``quorum_relax``/``cohort_shrink``/
    ``server_lr_factor`` the ``degrade`` step (``server_lr_factor=None``
    disables the lr cool-down)."""

    rungs: tuple[str, ...] = KNOWN_RUNGS
    attempts_per_rung: int = 1
    max_total_attempts: int = 8
    probation_rounds: int = 3
    quarantine_rounds: int = 0
    suspect_score_threshold: float = 2.0
    max_suspects: int = 3
    robust_method: str = "trimmed_mean"
    trim_fraction: float = 0.2
    quorum_relax: float = 0.5
    cohort_shrink: float = 0.5
    server_lr_factor: float | None = None
    recover_kinds: tuple[str, ...] = RECOVERABLE_KINDS

    def __post_init__(self):
        object.__setattr__(self, "rungs", tuple(self.rungs))
        object.__setattr__(self, "recover_kinds", tuple(self.recover_kinds))
        if not self.rungs:
            raise ValueError("RecoveryPolicy needs at least one rung")
        for r in self.rungs:
            if r not in KNOWN_RUNGS:
                raise ValueError(
                    f"unknown rung {r!r}; rungs must be drawn from "
                    f"{KNOWN_RUNGS}"
                )
        if len(set(self.rungs)) != len(self.rungs):
            raise ValueError("rungs must be unique")
        for k in self.recover_kinds:
            if k not in RECOVERABLE_KINDS:
                raise ValueError(
                    f"unknown recoverable kind {k!r}; must be drawn from "
                    f"{RECOVERABLE_KINDS}"
                )
        if self.attempts_per_rung < 1:
            raise ValueError("attempts_per_rung must be >= 1")
        if self.max_total_attempts < 1:
            raise ValueError("max_total_attempts must be >= 1")
        if self.probation_rounds < 1:
            raise ValueError("probation_rounds must be >= 1")
        if self.quarantine_rounds < 0:
            raise ValueError("quarantine_rounds must be >= 0 (0 = rest of "
                             "the run)")
        if self.max_suspects < 1:
            raise ValueError("max_suspects must be >= 1")
        if not 0.0 < self.quorum_relax <= 1.0:
            raise ValueError("quorum_relax must be in (0, 1]")
        if not 0.0 < self.cohort_shrink <= 1.0:
            raise ValueError("cohort_shrink must be in (0, 1]")
        if (self.server_lr_factor is not None
                and not 0.0 < self.server_lr_factor <= 1.0):
            raise ValueError("server_lr_factor must be in (0, 1] or None")
        from fl4health_tpu_torch.resilience.aggregators import ROBUST_METHODS

        if self.robust_method not in ROBUST_METHODS:
            raise ValueError(
                f"robust_method must be one of {ROBUST_METHODS}; got "
                f"{self.robust_method!r}"
            )


class RecoverySupervisor:
    """Drives a :class:`RecoveryPolicy` over a supervised simulation.

    Normally constructed by ``FederatedSimulation`` when
    ``recovery=RecoveryPolicy(...)`` is passed — ``sim.fit`` then routes
    through :meth:`run`. The simulation consults the supervisor on three
    hooks (all no-ops while nothing is engaged, so an armed-but-idle
    policy never perturbs the run): :meth:`keep_mask` /
    :meth:`quarantined_ids` multiply the per-round sampling mask,
    :meth:`note_round` counts healthy rounds for probation, and
    :meth:`on_resume` re-applies pending state mitigations after every
    checkpoint restore.

    Thread-safety: ``note_round`` runs on the RoundConsumer thread while
    ``keep_mask`` runs on the producer — one lock covers the ladder and
    the quarantine roster.
    """

    def __init__(self, sim: Any, policy: RecoveryPolicy,
                 ledger_path: str | None = None,
                 quorum_control: QuorumControl | None = None):
        if not isinstance(policy, RecoveryPolicy):
            raise TypeError(
                f"policy must be a RecoveryPolicy; got "
                f"{type(policy).__name__}"
            )
        self.sim = sim
        self.policy = policy
        self.quorum_control = quorum_control
        sc = getattr(sim, "state_checkpointer", None)
        if ledger_path is None and sc is not None:
            directory = getattr(sc, "directory", None)
            if directory:
                ledger_path = os.path.join(str(directory), LEDGER_NAME)
        self.ledger_path = ledger_path
        self._lock = threading.Lock()
        # ladder state
        self._engaged = False
        self._rung_idx = 0
        self._attempts: dict[str, int] = {}
        self._total_attempts = 0
        # quarantine roster: registry/client id -> release round (0 = the
        # rest of the run); consulted by keep_mask on every path
        self._quarantine: dict[int, int] = {}
        self._last_active: list[int] = []
        # probation bookkeeping: healthy rounds only count once the run is
        # PAST the round that failed — after a rollback, re-running rounds
        # the run had already survived is not new health evidence (a
        # deterministic round-N failure would otherwise pass probation on
        # the replayed prefix every attempt and retry forever)
        self._healthy_rounds = 0
        self._probation_after = 0
        self._resume_round = 1
        # one-shot mitigations applied at the next on_resume (post-restore)
        self._pending_seed: list[int] = []
        self._pending_scalars: dict[str, float] = {}
        # durable mitigation state (robustify swap, degrade quorum/
        # fraction) journaled so a SIGKILLed process re-arms them
        self._mitigations: dict[str, Any] = {}
        self._last_verdict: dict | None = None
        self._load_ledger()

    # -- observability helpers ------------------------------------------
    @property
    def _obs(self):
        return getattr(self.sim, "observability", None)

    def _metric(self, kind: str, name: str, help: str, **kw):
        obs = self._obs
        if obs is None or not getattr(obs, "enabled", False):
            return None
        return getattr(obs, kind)(name, help=help, **kw)

    def _log_event(self, **fields) -> None:
        obs = self._obs
        if obs is not None and getattr(obs, "enabled", False):
            obs.log_event("recovery", **fields)

    # -- ledger (SIGKILL survival) --------------------------------------
    def _ledger_doc(self) -> dict:
        return {
            "version": _LEDGER_VERSION,
            "engaged": self._engaged,
            "rung_idx": self._rung_idx,
            "attempts": dict(self._attempts),
            "total_attempts": self._total_attempts,
            "quarantine": {str(k): int(v)
                           for k, v in self._quarantine.items()},
            "probation_after": self._probation_after,
            "pending_seed": [int(c) for c in self._pending_seed],
            "pending_scalars": dict(self._pending_scalars),
            "mitigations": dict(self._mitigations),
            "last_verdict": self._last_verdict,
        }

    def _persist_ledger(self) -> None:
        # under a mesh the ledger is written by rank 0 alone
        if self.ledger_path is None or not getattr(self.sim, "_is_leader", True):
            return
        from fl4health_tpu_torch.core.io import atomic_write

        try:
            with atomic_write(self.ledger_path) as f:
                json.dump(self._ledger_doc(), f, indent=2, default=str)
        except OSError:
            logger.warning("recovery ledger write failed (%s) — a SIGKILL "
                           "before the next write loses ladder state",
                           self.ledger_path, exc_info=True)

    def _load_ledger(self) -> None:
        if self.ledger_path is None or not os.path.exists(self.ledger_path):
            return
        try:
            with open(self.ledger_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            logger.warning("recovery ledger %s unreadable — starting with "
                           "a fresh ladder", self.ledger_path)
            return
        self._engaged = bool(doc.get("engaged"))
        self._rung_idx = int(doc.get("rung_idx", 0))
        self._attempts = {str(k): int(v)
                          for k, v in (doc.get("attempts") or {}).items()}
        self._total_attempts = int(doc.get("total_attempts", 0))
        self._quarantine = {int(k): int(v)
                            for k, v in (doc.get("quarantine") or {}).items()}
        self._probation_after = int(doc.get("probation_after", 0))
        self._pending_seed = [int(c) for c in (doc.get("pending_seed")
                                               or [])]
        self._pending_scalars = {
            str(k): float(v)
            for k, v in (doc.get("pending_scalars") or {}).items()
        }
        self._mitigations = dict(doc.get("mitigations") or {})
        self._last_verdict = doc.get("last_verdict")
        if self._engaged or self._quarantine:
            logger.info(
                "recovery ledger restored from %s: rung %d, %d total "
                "attempt(s), %d quarantined client(s)", self.ledger_path,
                self._rung_idx, self._total_attempts, len(self._quarantine),
            )
        # a SIGKILLed process's durable mitigations re-arm HERE, at
        # construction — the factory rebuilt the sim with its original
        # strategy/manager/quorum, so the "resumes with the same
        # mitigations armed" contract needs them re-applied, not just the
        # attempt budgets remembered
        self._reapply_mitigations()

    def _reapply_mitigations(self) -> None:
        m = self._mitigations
        if not m:
            return
        rob = m.get("robustify")
        if rob:
            try:
                self._restore_robustify(rob)
            except Exception:
                logger.warning("recovery: could not re-apply the journaled "
                               "robustify swap", exc_info=True)
        frac = m.get("cohort_fraction")
        manager = getattr(self.sim, "client_manager", None)
        if frac is not None and manager is not None and hasattr(
                manager, "fraction"):
            self._set_manager_fraction(manager, float(frac))
        q = m.get("quorum")
        if q is not None and self.quorum_control is not None:
            self.quorum_control.quorum = (float(q) if isinstance(
                self.quorum_control.quorum, float) else int(q))

    def _restore_robustify(self, rob: Mapping[str, Any]) -> None:
        """Re-arm a journaled robustify mitigation on the freshly rebuilt
        strategy chain: swap a plain innermost FedAvg for the recorded
        RobustFedAvg, or restore the tightened trim fraction."""
        from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg

        target = self._robustify_target(for_restore=True)
        if target is None:
            return
        if isinstance(target, RobustFedAvg):
            trim = rob.get("trim_fraction")
            if trim is None or target.trim_fraction == trim:
                return
            self._swap_innermost(lambda t: self._copy_with_trim(t, trim))
        else:
            self._swap_innermost(lambda t: RobustFedAvg(
                method=str(rob.get("method", self.policy.robust_method)),
                trim_fraction=float(rob.get(
                    "trim_fraction", self.policy.trim_fraction
                )),
                weighted_aggregation=getattr(
                    t, "weighted_aggregation", True
                ),
            ))
        self.sim._build_compiled()

    # -- hooks the simulation calls -------------------------------------
    def keep_mask(self, round_idx: int, n_clients: int) -> np.ndarray | None:
        """[n_clients] keep-mask (0.0 = quarantined at this round), or
        None while nothing is quarantined — the never-engaged fast path
        multiplies nothing, preserving bit-identical trajectories."""
        with self._lock:
            if not self._quarantine:
                return None
            keep = np.ones((n_clients,), np.float32)
            hit = False
            for cid, release in self._quarantine.items():
                if release and round_idx >= release:
                    continue  # probation served — participates again
                if 0 <= cid < n_clients:
                    keep[cid] = 0.0
                    hit = True
            return keep if hit else None

    def quarantined_ids(self, round_idx: int) -> list[int]:
        """Registry/client ids quarantined at ``round_idx`` (sorted) —
        the cohort-slot path masks staged slots whose sampled id is
        listed here."""
        with self._lock:
            return self._quarantined_ids_locked(round_idx)

    def note_round(self, round_idx: int) -> None:
        """One completed healthy round (called from the round epilogues on
        every execution path, AFTER the watchdog passed). Drives probation
        and quarantine-release accounting."""
        with self._lock:
            if not self._engaged and not self._quarantine:
                return  # never-engaged fast path: zero work per round
            active = [
                cid for cid, release in self._quarantine.items()
                if not release or round_idx + 1 < release
            ]
            released = sorted(set(self._last_active) - set(active))
            self._last_active = sorted(active)
            passed = False
            if self._engaged and round_idx > self._probation_after:
                self._healthy_rounds += 1
                if self._healthy_rounds >= self.policy.probation_rounds:
                    passed = True
                    self._engaged = False
                    self._rung_idx = 0
                    self._attempts = {}
                    self._pending_scalars = {}
        if released:
            logger.info(
                "recovery: clients %s released from supervisor quarantine "
                "at round %d (probation served)", released, round_idx + 1,
            )
            g = self._metric(
                "gauge", "fl_recovery_quarantined_clients",
                "clients currently masked out of sampling by the recovery "
                "supervisor",
            )
            if g is not None:
                g.set(float(len(self._last_active)))
        if passed:
            self._on_probation_passed(round_idx)

    def _on_probation_passed(self, round_idx: int) -> None:
        obs = self._obs
        logger.info(
            "recovery: probation passed at round %d (%d healthy rounds) — "
            "ladder reset, run healthy", round_idx,
            self.policy.probation_rounds,
        )
        if obs is not None and getattr(obs, "enabled", False):
            mark = getattr(obs, "mark_healthy", None)
            if mark is not None:
                mark()  # /healthz back to 200: the run self-healed
            obs.gauge(
                "fl_recovery_engaged",
                help="1 while the recovery supervisor is between an "
                     "engagement and a passed probation window",
            ).set(0.0)
            obs.counter(
                "fl_recovery_probations_passed_total",
                help="probation windows completed (ladder resets)",
            ).inc()
        self._log_event(phase="probation_passed", round=int(round_idx),
                        healthy_rounds=self.policy.probation_rounds)
        self._persist_ledger()

    def on_resume(self, start_round: int) -> None:
        """Called by ``fit()`` right after its checkpoint restore: record
        the resume point, keep ``/healthz`` at 503 while recovery is in
        flight (``Observability.start()`` cleared the verdict), and apply
        the pending post-restore mitigations (in-graph quarantine seeding,
        hoisted-scalar overrides) onto the freshly restored state."""
        with self._lock:
            self._resume_round = int(start_round)
            self._healthy_rounds = 0
            seed = list(self._pending_seed)
            self._pending_seed = []
            scalars = dict(self._pending_scalars)
            engaged = self._engaged
            self._last_active = self._quarantined_ids_locked(start_round)
        obs = self._obs
        if engaged and obs is not None and getattr(obs, "enabled", False):
            mark = getattr(obs, "mark_unhealthy", None)
            if mark is not None:
                # start() reset the verdict; a recovering run must not
                # scrape 200 until probation passes
                mark(f"recovering (rung {self._current_rung_name()}, "
                     f"attempt {self._total_attempts})")
        if seed:
            self._seed_in_graph_quarantine(seed)
        if scalars:
            self._apply_scalars(scalars)

    def _quarantined_ids_locked(self, round_idx: int) -> list[int]:
        # caller holds self._lock (private: the lock contract must not
        # leak into the public API)
        return sorted(
            cid for cid, release in self._quarantine.items()
            if not release or round_idx < release
        )

    def _current_rung_name(self) -> str:
        if self._rung_idx < len(self.policy.rungs):
            return self.policy.rungs[self._rung_idx]
        return "halt"

    # -- the supervised run loop ----------------------------------------
    def run(self, n_rounds: int):
        """Run ``sim.fit(n_rounds)`` under the recovery policy: every
        recoverable abnormal end is classified, rolled back, mitigated per
        the ladder and resumed; anything else (or an exhausted ladder)
        propagates after its postmortem bundle published."""
        while True:
            try:
                return self.sim._fit_unsupervised(n_rounds)
            except BaseException as exc:
                if not self._engage(exc):
                    raise

    def _classify(self, exc: BaseException) -> dict:
        from fl4health_tpu_torch.observability.bundle import verdict_from_exception

        obs = self._obs
        recorder = (getattr(obs, "flight_recorder", None)
                    if obs is not None else None)
        try:
            return verdict_from_exception(exc, recorder=recorder)
        except Exception:  # classification must never mask the failure
            logger.warning("recovery: verdict classification failed",
                           exc_info=True)
            return {"kind": "exception", "exception": type(exc).__name__,
                    "message": str(exc)}

    def _ring_entries(self) -> list[dict]:
        obs = self._obs
        recorder = (getattr(obs, "flight_recorder", None)
                    if obs is not None else None)
        if recorder is None:
            return []
        try:
            return recorder.entries
        except Exception:
            return []

    def _suspects(self, verdict: dict) -> tuple[list[int], list[dict]]:
        """(suspect ids, ranking evidence): the verdict's named clients
        first, then ring suspects at or above the score threshold, capped
        at ``max_suspects``. Ids are REGISTRY ids under cohort execution
        (both sources already translate)."""
        from fl4health_tpu_torch.resilience.suspects import rank_suspects

        # fleet-ledger priors (observability/fleet.py): repeat offenders
        # on the lifetime record outrank first-time suspects with equal
        # window evidence — quarantine lands on the chronic client first
        ledger = (getattr(self._obs, "fleet_ledger", None)
                  if self._obs is not None else None)
        ranked = rank_suspects(self._ring_entries(),
                               top=max(self.policy.max_suspects * 2, 8),
                               ledger=ledger)
        out: list[int] = []
        for c in verdict.get("clients") or []:
            c = int(c)
            if c not in out:
                out.append(c)
        for s in ranked:
            if len(out) >= self.policy.max_suspects:
                break
            if (s["score"] >= self.policy.suspect_score_threshold
                    and int(s["client"]) not in out):
                out.append(int(s["client"]))
        return out[:self.policy.max_suspects], ranked

    # -- rollback --------------------------------------------------------
    def _rollback(self, verdict: dict) -> dict:
        """Bring training state back behind the failure: prune checkpoint
        generations at/past the verdict round so the next ``fit()``
        restores the newest PRE-failure generation; with nothing durable
        left, reset to the seed-derived init. Returns the rollback facts
        for the ``recovery`` event (incl. the expected resume round)."""
        sim = self.sim
        sc = getattr(sim, "state_checkpointer", None)
        # NOTE on buffered-async runs: every "round" here is an EVENT —
        # async round records, ring entries, watchdog verdicts and the
        # frames' meta["round"] (save_async_snapshot stamps the event
        # cursor) are all numbered by the same buffer-fill event index,
        # so pruning frames by the verdict round stays a like-for-like
        # comparison on every execution mode.
        bad_round = verdict.get("round")
        onset = self._divergence_onset()
        if onset is not None and (bad_round is None or onset < bad_round):
            # the ring saw the loss leave its envelope EARLIER than the
            # verdict round (a compounding poison trips the watchdog late)
            # — checkpoints from the onset on are contaminated too
            bad_round = onset
        facts: dict[str, Any] = {"mode": "restart"}
        if verdict.get("kind") == "checkpoint_corrupt" and sc is not None:
            # the ring fallback already failed (this error only surfaces
            # when EVERY candidate is corrupt): clear the wreckage
            try:
                sc.clear()
            except Exception:
                logger.warning("recovery: could not clear corrupt "
                               "checkpoint ring", exc_info=True)
        if sc is not None and hasattr(sc, "candidate_paths"):
            pruned: list[str] = []
            if bad_round is not None and hasattr(
                    sc, "prune_generations_from_round"):
                pruned = sc.prune_generations_from_round(int(bad_round))
            if sc.exists():
                newest_round, generation = self._newest_frame_round(sc)
                facts = {
                    "mode": "checkpoint",
                    "pruned_generations": len(pruned),
                    "resume_generation": generation,
                    "resume_round": ((newest_round + 1)
                                     if newest_round is not None else None),
                }
                c = self._metric(
                    "counter", "fl_recovery_rollbacks_total",
                    "checkpoint-ring rollbacks performed by the recovery "
                    "supervisor",
                )
                if c is not None:
                    c.inc()
                return facts
            facts["pruned_generations"] = len(pruned)
        # nothing durable predates the failure: restart from init —
        # rollback to "generation zero"
        sim._reset_to_initial()
        facts["resume_round"] = 1
        return facts

    def _divergence_onset(self) -> int | None:
        """Earliest checkpoint round contaminated by the failure, per the
        ring's loss trajectory. Round ``r``'s recorded training loss is
        measured on the model pulled from round ``r-1``'s aggregate, so
        the first out-of-envelope loss at ``r`` convicts the ``r-1``
        checkpoint — prune from ``r-1`` and the newest survivor predates
        the poison."""
        from fl4health_tpu_torch.resilience.suspects import detect_divergence_onset

        onset = detect_divergence_onset(self._ring_entries(),
                                        factor=ONSET_FACTOR)
        if onset is None:
            return None
        return max(int(onset["round"]) - 1, 1)

    @staticmethod
    def _newest_frame_round(sc) -> tuple[int | None, int | None]:
        """(round, generation) of the newest readable ring frame."""
        from fl4health_tpu_torch.checkpointing.state import (
            CheckpointCorruptError,
            read_frame,
        )

        for gen, path in sc.candidate_paths():
            try:
                _host, meta, _blob = read_frame(path)
            except CheckpointCorruptError:
                continue
            r = meta.get("round")
            return (int(r) if r is not None else None), int(gen)
        return None, None

    # -- mitigations -----------------------------------------------------
    def _rung_applicable(self, rung: str, suspects: Sequence[int]) -> bool:
        if rung == RUNG_RETRY:
            return True
        if rung == RUNG_QUARANTINE:
            return bool(suspects) and not getattr(
                self.sim, "_async_active", False
            )
        if rung == RUNG_ROBUSTIFY:
            return self._robustify_target() is not None
        if rung == RUNG_DEGRADE:
            return bool(self._degrade_targets())
        return False

    def _robustify_target(self, for_restore: bool = False):
        from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg
        from fl4health_tpu_torch.strategies.fedavg import FedAvg
        from fl4health_tpu_torch.sweep.hoisting import wrapper_chain

        inner = wrapper_chain(self.sim.strategy)[-1]
        if isinstance(inner, RobustFedAvg):
            # as a fresh MITIGATION there is only something to do when the
            # trimming can tighten — a median/Krum RobustFedAvg has no
            # knob here, so the rung is inapplicable (skipped) rather than
            # a parameter-identical copy that wastes a rebuild and an
            # attempt; ledger RESTORE still needs the handle either way
            if not for_restore and inner.method != "trimmed_mean":
                return None
            return inner
        # strict type check: only the plain FedAvg shares RobustFedAvg's
        # exact server-state pytree (FedOpt/SCAFFOLD carry more state, so
        # a swap would orphan the restored checkpoint's structure)
        if type(inner) is FedAvg:
            return inner
        return None

    def _swap_innermost(self, make_new) -> None:
        """Replace the innermost strategy with ``make_new(innermost)``,
        rebuilding the wrapper chain around shallow copies (the
        ``_wire_zero1_server_optimizer`` pattern: never mutate a strategy
        a caller may share with another simulation)."""
        import copy

        from fl4health_tpu_torch.sweep.hoisting import wrapper_chain

        chain = wrapper_chain(self.sim.strategy)
        rebuilt = make_new(chain[-1])
        for wrapper in reversed(chain[:-1]):
            wrapper = copy.copy(wrapper)
            wrapper.inner = rebuilt
            rebuilt = wrapper
        self.sim.strategy = rebuilt

    @staticmethod
    def _copy_with_trim(target, trim: float):
        import copy

        new = copy.copy(target)
        new.trim_fraction = float(trim)
        return new

    @staticmethod
    def _set_manager_fraction(manager, fraction: float) -> None:
        manager.fraction = float(fraction)
        if hasattr(manager, "k"):
            # FixedFraction/FixedSampling cache the realized count at
            # construction — re-derive it with the manager's own
            # epsilon-safe floor or the shrink is a no-op
            from fl4health_tpu_torch.server.client_manager import _fraction_floor

            manager.k = min(
                manager.n_clients,
                max(getattr(manager, "min_clients", 1),
                    _fraction_floor(manager.fraction, manager.n_clients)),
            )

    def _degrade_targets(self) -> list[str]:
        out = []
        if self.quorum_control is not None:
            out.append("quorum")
        manager = getattr(self.sim, "client_manager", None)
        if manager is not None and hasattr(manager, "fraction"):
            out.append("cohort")
        if self.policy.server_lr_factor is not None:
            try:
                from fl4health_tpu_torch.sweep.hoisting import applicable_scalars

                if "server_lr" in applicable_scalars(self.sim.strategy):
                    out.append("server_lr")
            except Exception:
                pass
        return out

    def _apply_quarantine(self, suspects: Sequence[int],
                          resume_round: int | None) -> dict:
        resume_round = int(resume_round or 1)
        release = (0 if self.policy.quarantine_rounds == 0
                   else resume_round + self.policy.quarantine_rounds)
        with self._lock:
            for cid in suspects:
                self._quarantine[int(cid)] = release
            self._pending_seed = [int(c) for c in suspects]
            active = self._quarantined_ids_locked(resume_round)
        g = self._metric(
            "gauge", "fl_recovery_quarantined_clients",
            "clients currently masked out of sampling by the recovery "
            "supervisor",
        )
        if g is not None:
            g.set(float(len(active)))
        obs = self._obs
        if obs is not None and getattr(obs, "enabled", False):
            obs.log_event(
                "quarantine", round=resume_round, source="recovery",
                active=active, entered=sorted(int(c) for c in suspects),
                released=[],
            )
        return {"quarantined": sorted(int(c) for c in suspects),
                "release_round": release}

    def _seed_in_graph_quarantine(self, suspects: Sequence[int]) -> None:
        """When the strategy is a ``QuarantiningStrategy`` (dense modes:
        cohort persistence lives in registry rows keyed by id, outside the
        live slot state), seed its in-graph ``QuarantineState`` so the
        strategy's own strike/probation bookkeeping names the same
        offenders the supervisor masked."""
        sim = self.sim
        strategy = sim.strategy
        if getattr(sim, "_cohort_active", False):
            return
        if not hasattr(strategy, "quarantine_mask"):
            return
        try:
            state = sim.server_state
            q = state.quarantine
            # the rows this process holds: under a mesh its block of the
            # clients, [lo, hi)
            lo = getattr(sim, "_client_lo", 0)
            hi = getattr(sim, "_client_hi", lo + q.quarantined.shape[0])
            idx = torch.as_tensor([int(c) - lo for c in suspects if lo <= int(c) < hi],
                                  dtype=torch.long, device=q.quarantined.device)
            rounds = float(self.policy.quarantine_rounds
                           or sim._fit_n_rounds or 10_000)
            new_q = dataclasses.replace(
                q,
                quarantined=q.quarantined.index_fill(0, idx, 1.0),
                release_in=q.release_in.index_fill(0, idx, rounds),
                strikes=q.strikes.index_fill(0, idx, 0.0),
            )
            sim.server_state = dataclasses.replace(state, quarantine=new_q)
        except Exception:
            logger.warning("recovery: in-graph quarantine seeding failed "
                           "(host-side sampling quarantine still applies)",
                           exc_info=True)

    def _apply_robustify(self) -> dict | None:
        from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg

        sim = self.sim
        target = self._robustify_target()
        if target is None:
            return None
        if isinstance(target, RobustFedAvg):
            trim = min(0.45, float(target.trim_fraction) + 0.1)
            self._swap_innermost(lambda t: self._copy_with_trim(t, trim))
            facts = {"robustify": "tighten", "method": target.method,
                     "trim_fraction": trim}
        else:
            facts = {"robustify": "swap",
                     "method": self.policy.robust_method,
                     "trim_fraction": self.policy.trim_fraction}
            self._swap_innermost(lambda t: RobustFedAvg(
                method=self.policy.robust_method,
                trim_fraction=self.policy.trim_fraction,
                weighted_aggregation=getattr(
                    t, "weighted_aggregation", True
                ),
            ))
        # the aggregation changed: rebuild the round functions
        # (RobustFedAvg's state IS FedAvgState, so the restored checkpoint
        # structure still fits)
        sim._build_compiled()
        # journal the swap so a SIGKILLed process re-arms it at ledger load
        self._mitigations["robustify"] = {
            "method": facts["method"],
            "trim_fraction": facts["trim_fraction"],
        }
        return facts

    def _apply_degrade(self) -> dict | None:
        targets = self._degrade_targets()
        if not targets:
            return None
        facts: dict[str, Any] = {}
        if "quorum" in targets:
            before = self.quorum_control.quorum
            if self.quorum_control.relax(self.policy.quorum_relax):
                facts["quorum"] = {"from": before,
                                   "to": self.quorum_control.quorum}
                self._mitigations["quorum"] = self.quorum_control.quorum
        if "cohort" in targets:
            manager = self.sim.client_manager
            before = float(manager.fraction)
            self._set_manager_fraction(manager, max(
                before * self.policy.cohort_shrink,
                1.0 / max(getattr(manager, "n_clients", 1), 1),
            ))
            facts["cohort_fraction"] = {"from": before,
                                        "to": float(manager.fraction)}
            self._mitigations["cohort_fraction"] = float(manager.fraction)
        if "server_lr" in targets:
            from fl4health_tpu_torch.sweep.hoisting import binding

            b = binding("server_lr")
            try:
                current = self._pending_scalars.get(
                    "server_lr", b.default(self.sim.strategy)
                )
                new = float(current) * float(self.policy.server_lr_factor)
                # applied to the restored state at on_resume via
                # apply_state_scalars: a server-state leaf write
                self._pending_scalars["server_lr"] = new
                facts["server_lr"] = {"from": float(current), "to": new}
            except Exception:
                logger.warning("recovery: server_lr cool-down failed",
                               exc_info=True)
        return facts or None

    def _apply_scalars(self, scalars: dict[str, float]) -> None:
        try:
            from fl4health_tpu_torch.sweep.hoisting import apply_state_scalars

            self.sim.server_state = apply_state_scalars(
                self.sim.strategy, self.sim.server_state, scalars
            )
        except Exception:
            logger.warning("recovery: hoisted-scalar override failed "
                           "(%s)", scalars, exc_info=True)

    # -- engagement ------------------------------------------------------
    def _engage(self, exc: BaseException) -> bool:
        """Classify -> select rung -> rollback -> mitigate. Returns False
        (caller re-raises) when the failure is outside the policy's
        taxonomy or the ladder is exhausted."""
        verdict = self._classify(exc)
        kind = verdict.get("kind")
        if kind not in self.policy.recover_kinds:
            return False
        with self._lock:
            if self._total_attempts >= self.policy.max_total_attempts:
                logger.error(
                    "recovery: max_total_attempts=%d exhausted — halting "
                    "with the original %s", self.policy.max_total_attempts,
                    type(exc).__name__,
                )
                self._log_event(phase="halt", reason="max_total_attempts",
                                kind=kind, round=verdict.get("round"))
                return False
        suspects, ranked = self._suspects(verdict)
        rung = self._select_rung(suspects)
        if rung is None:
            self._log_event(phase="halt", reason="ladder_exhausted",
                            kind=kind, round=verdict.get("round"))
            logger.error(
                "recovery: escalation ladder exhausted — halting with the "
                "original %s", type(exc).__name__,
            )
            return False
        rollback = self._rollback(verdict)
        resume_round = rollback.get("resume_round") or 1
        mitigation: dict[str, Any] | None = None
        if rung == RUNG_QUARANTINE:
            mitigation = self._apply_quarantine(suspects, resume_round)
        elif rung == RUNG_ROBUSTIFY:
            mitigation = self._apply_robustify()
        elif rung == RUNG_DEGRADE:
            mitigation = self._apply_degrade()
        with self._lock:
            self._attempts[rung] = self._attempts.get(rung, 0) + 1
            self._total_attempts += 1
            self._engaged = True
            self._healthy_rounds = 0
            if verdict.get("round") is not None:
                # probation bar: only rounds BEYOND the failure count
                self._probation_after = int(verdict["round"])
            self._last_verdict = {
                "kind": kind, "round": verdict.get("round"),
                "ts": time.time(),
            }
            total = self._total_attempts
        obs = self._obs
        if obs is not None and getattr(obs, "enabled", False):
            obs.counter(
                "fl_recovery_attempts_total",
                help="recovery-supervisor engagements, by ladder rung",
                labels={"rung": rung},
            ).inc()
            obs.gauge(
                "fl_recovery_engaged",
                help="1 while the recovery supervisor is between an "
                     "engagement and a passed probation window",
            ).set(1.0)
            obs.gauge(
                "fl_recovery_rung",
                help="current escalation-ladder position (0-based rung "
                     "index)",
            ).set(float(self._rung_idx))
        self._log_event(
            phase="engage", attempt=total, rung=rung, kind=kind,
            round=verdict.get("round"), suspects=suspects,
            suspect_scores=[
                {"client": s["client"], "score": s["score"]}
                for s in ranked[:self.policy.max_suspects]
            ],
            rollback=rollback, mitigation=mitigation,
            resume_round=resume_round,
        )
        self._persist_ledger()
        logger.warning(
            "recovery attempt %d: %s at round %s -> rung %r "
            "(suspects=%s, rollback=%s, mitigation=%s); resuming at "
            "round %s", total, kind, verdict.get("round"), rung, suspects,
            rollback.get("mode"), mitigation, resume_round,
        )
        return True

    def _select_rung(self, suspects: Sequence[int]) -> str | None:
        """The first rung, from the current ladder position, with budget
        left AND applicable to this run; advances the ladder position past
        exhausted/inapplicable rungs. None = ladder exhausted (halt)."""
        with self._lock:
            idx = self._rung_idx
            while idx < len(self.policy.rungs):
                rung = self.policy.rungs[idx]
                if (self._attempts.get(rung, 0)
                        < self.policy.attempts_per_rung
                        and self._rung_applicable(rung, suspects)):
                    self._rung_idx = idx
                    return rung
                idx += 1
            self._rung_idx = idx
            return None
