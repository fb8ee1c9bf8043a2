"""Training-health watchdog (counterpart of
``fl4health_tpu/observability/health.py``, the same numpy code): a
declarative policy over the round telemetry.

The reference stack surfaces training failures as log lines (or not at
all: a silently-diverging client just degrades the aggregate). Here the
:class:`HealthWatchdog` consumes each round's host copy of
:class:`~fl4health_tpu_torch.observability.telemetry.RoundTelemetry` — in the
``RoundConsumer`` thread on the pipelined path, in the post-run epilogue
on the chunked path — evaluates a :class:`HealthPolicy`, and:

- sets per-check Prometheus gauges / counters in the run's registry,
- appends one ``health`` event per round to the JSONL log,
- bridges the health summary to every reporter,
- and, for checks whose action is ``"halt"``, terminates ``fit()`` with a
  :class:`TrainingHealthError` naming the round and the offending clients.

On the chunked path the whole run has already executed on device when the
watchdog sees round *r*'s telemetry (one dispatch covers every round), so
"halt" there means "fail the fit() call loudly with the first offending
round" rather than "stop mid-run" — the structured error is identical.
Host-side only, pure numpy: safe on the consumer thread.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Mapping, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_ACTIONS = ("halt", "warn", "mitigate", "off")

HALT = "halt"
WARN = "warn"
MITIGATE = "mitigate"
OFF = "off"


class TrainingHealthError(RuntimeError):
    """Raised by the watchdog when a ``halt`` check trips.

    Attributes: ``round`` (1-based federated round), ``clients`` (offending
    client indices; empty for cohort-level checks), ``check`` (policy check
    name).
    """

    def __init__(self, message: str, *, round: int, clients: Sequence[int],
                 check: str):
        super().__init__(message)
        self.round = int(round)
        self.clients = [int(c) for c in clients]
        self.check = check


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Declarative thresholds; each check carries its own action
    (``"halt"`` | ``"warn"`` | ``"mitigate"`` | ``"off"``).

    ``"mitigate"`` (resilience subsystem) masks the offending clients out
    of subsequent rounds instead of halting: the watchdog quarantines them
    for ``quarantine_rounds`` rounds and ``FederatedSimulation`` multiplies
    its sampling mask by :meth:`HealthWatchdog.quarantine_keep_mask` on the
    pipelined path (probation served, the client is re-admitted; a
    re-offender re-enters). Cohort-level checks with no client attribution
    (loss divergence) degrade mitigate to warn. On the chunked path the
    run has already executed when telemetry is screened — use the in-graph
    ``resilience.QuarantiningStrategy`` there.

    - **non-finite** (``on_nonfinite``): a participating client produced
      NaN/Inf in its training loss, parameter stack, or eval loss.
    - **loss divergence** (``loss_divergence_window`` > 0 enables): the
      aggregate training loss exceeded ``loss_divergence_factor`` x the
      best loss seen so far for that many CONSECUTIVE rounds.
    - **dead clients** (``dead_client_norm`` > 0 enables): a participating
      client's update norm stayed <= the threshold for
      ``dead_client_rounds`` consecutive participations (a client that
      pulls the global model and pushes it back unchanged).
    - **contribution skew** (``skew_ratio`` > 0 enables): max participating
      update norm exceeded ``skew_ratio`` x the median — one client
      dominating the aggregate (poisoning / LR misconfiguration proxy).
    """

    on_nonfinite: str = HALT
    loss_divergence_window: int = 0
    loss_divergence_factor: float = 2.0
    on_loss_divergence: str = HALT
    dead_client_norm: float = 0.0
    dead_client_rounds: int = 3
    on_dead_client: str = WARN
    skew_ratio: float = 0.0
    on_skew: str = WARN
    quarantine_rounds: int = 5

    def __post_init__(self):
        for field in ("on_nonfinite", "on_loss_divergence", "on_dead_client",
                      "on_skew"):
            v = getattr(self, field)
            if v not in _ACTIONS:
                raise ValueError(
                    f"HealthPolicy.{field} must be one of {_ACTIONS}; got {v!r}"
                )
        if self.loss_divergence_window < 0 or self.dead_client_rounds < 1:
            raise ValueError("HealthPolicy windows must be positive")
        if self.quarantine_rounds < 1:
            raise ValueError("HealthPolicy.quarantine_rounds must be >= 1")


class HealthWatchdog:
    """Stateful per-run evaluator of a :class:`HealthPolicy`.

    ``FederatedSimulation`` calls :meth:`reset` at each ``fit()`` entry and
    :meth:`observe` once per round with the host telemetry. State (loss
    best/streak, per-client dead streaks) is per-run; observation order is
    guaranteed by the single consumer thread / the chunked epilogue loop.
    """

    def __init__(self, policy: HealthPolicy | None = None):
        self.policy = policy or HealthPolicy()
        # producer thread reads the quarantine while the consumer thread
        # writes it (pipelined path) — one lock covers both
        self._quarantine_lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self._best_loss = float("inf")
        self._divergent_rounds = 0
        self._dead_streak: dict[int, int] = {}
        with self._quarantine_lock:
            # client -> first round at which it is released again
            self._quarantine: dict[int, int] = {}

    # -- mitigation (action="mitigate") --------------------------------
    def active_quarantine(self) -> list[int]:
        """Clients currently quarantined by mitigate checks (sorted)."""
        with self._quarantine_lock:
            return sorted(self._quarantine)

    def quarantine_keep_mask(self, n_clients: int) -> "np.ndarray | None":
        """[n_clients] keep-mask (0.0 = quarantined), or None while nothing
        is quarantined — the caller's fast path multiplies nothing."""
        with self._quarantine_lock:
            if not self._quarantine:
                return None
            keep = np.ones((n_clients,), np.float32)
            for c in self._quarantine:
                if 0 <= c < n_clients:
                    keep[c] = 0.0
            return keep

    # ------------------------------------------------------------------
    def observe(
        self,
        round_idx: int,
        telemetry: Mapping[str, np.ndarray],
        mask: np.ndarray,
        agg_train_loss: float,
        obs: Any = None,
        reporters: Sequence[Any] = (),
    ) -> dict:
        """Evaluate every enabled check against one round's telemetry.

        Emits gauges + a ``health`` JSONL event through ``obs`` (an
        :class:`~fl4health_tpu_torch.observability.Observability`, optional) and a
        ``{"health": ...}`` payload to each reporter, THEN raises
        :class:`TrainingHealthError` if any halt check tripped — the round's
        own record always lands before the run dies."""
        pol = self.policy
        mask = np.asarray(mask)
        participants = np.nonzero(mask > 0)[0]
        summary: dict[str, Any] = {"round": int(round_idx), "status": "ok"}
        problems: list[tuple[str, str, list[int], str]] = []

        # -- probation expiry (mitigate recovery) -----------------------
        released: list[int] = []
        with self._quarantine_lock:
            for c, until in list(self._quarantine.items()):
                if until <= round_idx:
                    del self._quarantine[c]
                    released.append(c)
        if released:
            logger.info(
                "health: clients %s released from quarantine at round %d "
                "(probation served)", sorted(released), round_idx,
            )

        # -- non-finite --------------------------------------------------
        if pol.on_nonfinite != OFF:
            bad_count = (
                np.asarray(telemetry["nonfinite_loss"], np.float64)
                + np.asarray(telemetry["nonfinite_params"], np.float64)
                + np.asarray(telemetry["nonfinite_eval_loss"], np.float64)
            )
            loss_mean = np.asarray(telemetry["train_loss"], np.float64)
            bad = (bad_count > 0) | ~np.isfinite(loss_mean)
            clients = [int(c) for c in participants if bad[c]]
            summary["nonfinite_clients"] = clients
            if clients:
                problems.append((
                    "nonfinite", pol.on_nonfinite, clients,
                    f"non-finite training state (NaN/Inf) in clients {clients}",
                ))

        # -- loss divergence window -------------------------------------
        if pol.loss_divergence_window > 0:
            loss = float(agg_train_loss)
            if np.isfinite(loss):
                if loss > pol.loss_divergence_factor * self._best_loss:
                    self._divergent_rounds += 1
                else:
                    self._divergent_rounds = 0
                self._best_loss = min(self._best_loss, loss)
            summary["divergent_rounds"] = self._divergent_rounds
            if self._divergent_rounds >= pol.loss_divergence_window:
                problems.append((
                    "loss_divergence", pol.on_loss_divergence, [],
                    f"aggregate train loss {loss:.4g} > "
                    f"{pol.loss_divergence_factor}x best {self._best_loss:.4g} "
                    f"for {self._divergent_rounds} consecutive rounds",
                ))

        # -- dead clients ------------------------------------------------
        if pol.dead_client_norm > 0:
            upd = np.asarray(telemetry["update_norm"], np.float64)
            dead_now = []
            for c in participants:
                c = int(c)
                if np.isfinite(upd[c]) and upd[c] <= pol.dead_client_norm:
                    self._dead_streak[c] = self._dead_streak.get(c, 0) + 1
                else:
                    self._dead_streak.pop(c, None)
                if self._dead_streak.get(c, 0) >= pol.dead_client_rounds:
                    dead_now.append(c)
            summary["dead_clients"] = dead_now
            if dead_now:
                problems.append((
                    "dead_client", pol.on_dead_client, dead_now,
                    f"clients {dead_now} pushed near-zero updates "
                    f"(norm <= {pol.dead_client_norm}) for "
                    f"{pol.dead_client_rounds} consecutive rounds",
                ))

        # -- contribution skew ------------------------------------------
        if pol.skew_ratio > 0:
            upd = np.asarray(telemetry["update_norm"], np.float64)
            live = upd[participants][np.isfinite(upd[participants])]
            if live.size >= 2:
                med = float(np.median(live))
                peak = float(np.max(live))
                # peak==0 means nobody moved — no outlier, whatever the
                # median; a zero median under a positive peak IS maximal skew
                if med > 0:
                    ratio = peak / med
                else:
                    ratio = float("inf") if peak > 0 else 0.0
                summary["update_norm_skew"] = ratio
                if ratio > pol.skew_ratio:
                    worst = [int(participants[int(np.argmax(
                        np.where(np.isfinite(upd[participants]),
                                 upd[participants], -np.inf)))])]
                    problems.append((
                        "contribution_skew", pol.on_skew, worst,
                        f"client {worst[0]} update norm {peak:.4g} is "
                        f"{ratio:.1f}x the cohort median {med:.4g} "
                        f"(> skew_ratio={pol.skew_ratio})",
                    ))

        halts = [p for p in problems if p[1] == HALT]
        warns = [p for p in problems if p[1] == WARN]
        mitigations = [p for p in problems if p[1] == MITIGATE]
        # -- mitigation: quarantine offenders instead of halting --------
        entered: list[int] = []
        for check, _action, clients, msg in mitigations:
            if not clients:
                # cohort-level checks carry no client attribution; masking
                # "nobody in particular" is a warn, not a mitigation
                logger.warning(
                    "health[%s] round %d: %s (mitigate has no client "
                    "attribution for this check — treated as warn)",
                    check, round_idx, msg,
                )
                continue
            with self._quarantine_lock:
                for c in clients:
                    c = int(c)
                    if c not in self._quarantine:
                        entered.append(c)
                    self._quarantine[c] = round_idx + pol.quarantine_rounds
            logger.warning(
                "health[%s] round %d: %s — quarantining clients %s for "
                "%d rounds", check, round_idx, msg, clients,
                pol.quarantine_rounds,
            )
        if problems:
            summary["status"] = ("halt" if halts
                                 else "mitigate" if mitigations else "warn")
            summary["checks_tripped"] = [p[0] for p in problems]
        if entered or released or self._quarantine:
            summary["quarantined_clients"] = self.active_quarantine()
            summary["released_clients"] = sorted(released)
        for check, _action, clients, msg in warns:
            logger.warning("health[%s] round %d: %s", check, round_idx, msg)

        # -- export: gauges, JSONL, reporters ---------------------------
        if obs is not None and getattr(obs, "enabled", False):
            obs.gauge(
                "fl_health_nonfinite_clients",
                help="participating clients with non-finite training state",
            ).set(float(len(summary.get("nonfinite_clients", []))))
            obs.gauge(
                "fl_health_dead_clients",
                help="clients flagged dead (near-zero update norm streak)",
            ).set(float(len(summary.get("dead_clients", []))))
            obs.gauge(
                "fl_health_divergent_rounds",
                help="consecutive rounds over the loss-divergence threshold",
            ).set(float(summary.get("divergent_rounds", 0)))
            if warns:
                obs.counter(
                    "fl_health_warnings_total",
                    help="health checks that tripped with action=warn",
                ).inc(len(warns))
            if entered or released or self._quarantine:
                # guarded like the counters below: a halt/warn-only policy
                # must not grow a new always-zero metric family
                obs.gauge(
                    "fl_quarantine_active_clients",
                    help="clients currently masked out of aggregation by "
                         "quarantine",
                ).set(float(len(self.active_quarantine())))
            if entered:
                obs.counter(
                    "fl_quarantine_entries_total",
                    help="clients entering quarantine",
                ).inc(len(entered))
            if released:
                obs.counter(
                    "fl_quarantine_releases_total",
                    help="clients released from quarantine (probation "
                         "served)",
                ).inc(len(released))
            if entered or released:
                obs.log_event(
                    "quarantine", round=int(round_idx), source="watchdog",
                    active=self.active_quarantine(),
                    entered=sorted(entered), released=sorted(released),
                )
            obs.log_event("health", **summary)
        for rep in reporters:
            rep.report({"health": dict(summary)}, round=int(round_idx))

        if halts:
            check, _action, clients, msg = halts[0]
            err = TrainingHealthError(
                f"HealthWatchdog[{check}] halted training at round "
                f"{round_idx}: {msg}",
                round=round_idx, clients=clients, check=check,
            )
            if obs is not None and getattr(obs, "enabled", False):
                # flip the live /healthz probe to 503 BEFORE the raise
                # unwinds fit() — an orchestrator polling the armed scrape
                # endpoint must not see "ok" mid-teardown
                mark = getattr(obs, "mark_unhealthy", None)
                if mark is not None:
                    mark(str(err))
            raise err
        return summary
