"""Declarative SLOs over the round time-series (counterpart of
``fl4health_tpu/observability/slo.py``, the same code) — the "is the service
OK" layer.

Role: an orchestrator probing ``/healthz`` can tell *dead* (503) from
*alive* (200), but not *limping* — a run that still completes rounds while
its cadence collapses, its eval loss stalls, or its wire budget blows out.
``SLOPolicy`` declares the service levels ROADMAP item 3 names (round-cadence
floor, eval-loss ceiling/stall, bytes-per-client budget, MTTR target,
straggler-p99 bound) and ``SLOEngine`` evaluates them each round in the
epilogue against the KPIs ``timeseries.RoundTimeSeries`` computed — still
zero extra device syncs.

Burn-rate semantics (the SRE multi-window idiom): each objective keeps a
bounded window of per-round pass/fail samples; the *burn rate* over a window
is ``violating_fraction / error_budget``. Sustained burn >= 1 over BOTH the
short and long window means the error budget is being spent faster than
allowed — standing ``breach`` (run degraded); short-window burn alone is
``warn`` (blip, don't page). Transitions emit ``slo`` JSONL events and every
evaluation refreshes ``fl_slo_*`` gauges, so both the log and the scrape
surface carry the verdicts ``tools/run_diff.py`` compares across runs.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Mapping

__all__ = ["SLOPolicy", "SLOEngine", "SLO_OBJECTIVES"]

# Declared order doubles as severity tie-break: when several objectives
# breach at once, /healthz names the first.
SLO_OBJECTIVES = (
    "round_cadence",
    "eval_loss",
    "eval_stall",
    "bytes_per_client",
    "mttr",
    "straggler_p99",
)


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Service-level objectives for a federated run. ``None`` disables one.

    - ``min_rounds_per_hour``: cadence floor (windowed wall-clock rate).
    - ``max_eval_loss``: ceiling on the checkpoint eval loss.
    - ``stall_rounds`` / ``stall_min_delta``: eval loss must improve by at
      least ``stall_min_delta`` within any ``stall_rounds`` consecutive
      evaluated rounds.
    - ``max_bytes_per_client``: per-round wire budget (broadcast + gather,
      post-compression when the wire path recorded it).
    - ``max_mttr_s``: recovery MTTR target — mean engage→probation_passed
      wall time, and any still-open incident older than this violates too.
    - ``max_straggler_p99``: bound on the fleet straggler p99 (needs the
      fleet ledger; unevaluated otherwise).
    - ``error_budget``: allowed violating fraction of rounds per window.
    - ``short_window`` / ``long_window``: burn-rate windows, in rounds.
    """

    min_rounds_per_hour: float | None = None
    max_eval_loss: float | None = None
    stall_rounds: int | None = None
    stall_min_delta: float = 0.0
    max_bytes_per_client: float | None = None
    max_mttr_s: float | None = None
    max_straggler_p99: float | None = None
    error_budget: float = 0.1
    short_window: int = 5
    long_window: int = 30

    def __post_init__(self):
        if not (0.0 < self.error_budget <= 1.0):
            raise ValueError(
                f"error_budget must be in (0, 1]; got {self.error_budget}")
        if self.short_window < 1 or self.long_window < self.short_window:
            raise ValueError(
                "windows must satisfy 1 <= short_window <= long_window; "
                f"got short={self.short_window} long={self.long_window}")
        if self.stall_rounds is not None and self.stall_rounds < 1:
            raise ValueError(f"stall_rounds must be >= 1; got {self.stall_rounds}")
        for name in ("min_rounds_per_hour", "max_eval_loss",
                     "max_bytes_per_client", "max_mttr_s",
                     "max_straggler_p99"):
            v = getattr(self, name)
            if v is not None and float(v) <= 0.0:
                raise ValueError(f"{name} must be positive; got {v}")

    def objectives(self) -> tuple[str, ...]:
        """Objective names this policy actually arms, in severity order."""
        armed = {
            "round_cadence": self.min_rounds_per_hour is not None,
            "eval_loss": self.max_eval_loss is not None,
            "eval_stall": self.stall_rounds is not None,
            "bytes_per_client": self.max_bytes_per_client is not None,
            "mttr": self.max_mttr_s is not None,
            "straggler_p99": self.max_straggler_p99 is not None,
        }
        return tuple(n for n in SLO_OBJECTIVES if armed[n])

    def describe(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class SLOEngine:
    """Evaluates an ``SLOPolicy`` per round; tracks burn-rate standing.

    ``evaluate`` runs on the epilogue thread; ``standing()`` is read by the
    HTTP handler serving ``GET /admin/slo`` — one lock covers both.
    """

    def __init__(self, policy: SLOPolicy, registry=None):
        self.policy = policy
        self._registry = registry
        self._lock = threading.Lock()
        self._samples: dict[str, deque[bool]] = {
            n: deque(maxlen=policy.long_window) for n in policy.objectives()
        }
        self._standing: dict[str, str] = {n: "ok" for n in self._samples}
        self._best_eval: float | None = None
        self._since_improve = 0
        self._last_verdict: dict[str, Any] | None = None
        self._last_kpis: dict[str, Any] | None = None

    # ------------------------------------------------------------ evaluation
    def _violations(self, kpis: Mapping[str, Any]) -> dict[str, bool | None]:
        """Per-objective violation this round; None = signal absent, skip."""
        p = self.policy
        out: dict[str, bool | None] = {}
        if "round_cadence" in self._samples:
            rph = kpis.get("rounds_per_hour")
            out["round_cadence"] = (
                None if rph is None else rph < p.min_rounds_per_hour)
        eval_loss = kpis.get("eval_loss")
        if "eval_loss" in self._samples:
            out["eval_loss"] = (
                None if eval_loss is None else eval_loss > p.max_eval_loss)
        if "eval_stall" in self._samples:
            if eval_loss is None:
                out["eval_stall"] = None
            else:
                if (self._best_eval is None
                        or eval_loss < self._best_eval - p.stall_min_delta):
                    self._best_eval = eval_loss
                    self._since_improve = 0
                else:
                    self._since_improve += 1
                out["eval_stall"] = self._since_improve >= p.stall_rounds
        if "bytes_per_client" in self._samples:
            bpc = kpis.get("bytes_per_client")
            out["bytes_per_client"] = (
                None if bpc is None else bpc > p.max_bytes_per_client)
        if "mttr" in self._samples:
            mttr, open_s = kpis.get("mttr_s"), kpis.get("mttr_open_s")
            if mttr is None and open_s is None:
                out["mttr"] = None  # no incident ever — nothing to judge
            else:
                out["mttr"] = ((mttr is not None and mttr > p.max_mttr_s)
                               or (open_s is not None and open_s > p.max_mttr_s))
        if "straggler_p99" in self._samples:
            tail = kpis.get("straggler_p99")
            out["straggler_p99"] = (
                None if tail is None else tail > p.max_straggler_p99)
        return out

    @staticmethod
    def _burn(samples: deque[bool], window: int, budget: float) -> float:
        recent = list(samples)[-window:]
        if not recent:
            return 0.0
        return (sum(recent) / len(recent)) / budget

    def evaluate(self, rnd: int, kpis: Mapping[str, Any]) -> dict[str, Any]:
        """Fold one round of KPIs in; returns the verdict for this round.

        Verdict: ``{"round", "state", "degraded_slo", "objectives": {name:
        {"violated", "burn_short", "burn_long", "standing"}}}``. Emits an
        ``slo`` JSONL event per standing *transition* (logs stay quiet on
        healthy runs) and refreshes ``fl_slo_*`` gauges every round.
        """
        p = self.policy
        with self._lock:
            violations = self._violations(kpis)
            objectives: dict[str, dict[str, Any]] = {}
            degraded: str | None = None
            transitions: list[tuple[str, str, dict[str, Any]]] = []
            for name in self._samples:
                v = violations.get(name)
                if v is not None:
                    self._samples[name].append(bool(v))
                burn_short = self._burn(self._samples[name], p.short_window,
                                        p.error_budget)
                burn_long = self._burn(self._samples[name], p.long_window,
                                       p.error_budget)
                if burn_short >= 1.0 and burn_long >= 1.0:
                    standing = "breach"
                elif burn_short >= 1.0:
                    standing = "warn"
                else:
                    standing = "ok"
                obj = {
                    "violated": v,
                    "burn_short": round(burn_short, 4),
                    "burn_long": round(burn_long, 4),
                    "standing": standing,
                }
                objectives[name] = obj
                if standing == "breach" and degraded is None:
                    degraded = name
                if standing != self._standing[name]:
                    transitions.append((name, standing, obj))
                    self._standing[name] = standing
            state = ("breach" if degraded is not None
                     else "warn" if any(o["standing"] == "warn"
                                        for o in objectives.values())
                     else "ok")
            verdict = {"round": int(rnd), "state": state,
                       "degraded_slo": degraded, "objectives": objectives}
            self._last_verdict = verdict
            self._last_kpis = dict(kpis)
        reg = self._registry
        if reg is not None:
            for name, standing, obj in transitions:
                reg.log_event("slo", round=int(rnd), slo=name,
                              standing=standing, violated=obj["violated"],
                              burn_short=obj["burn_short"],
                              burn_long=obj["burn_long"], state=state)
            for name, obj in objectives.items():
                reg.gauge("fl_slo_burn_rate",
                          help="error-budget burn rate over the short window "
                               "(>=1 means burning faster than budgeted)",
                          labels={"slo": name, "window": "short"},
                          ).set(obj["burn_short"])
                reg.gauge("fl_slo_burn_rate",
                          help="error-budget burn rate over the short window "
                               "(>=1 means burning faster than budgeted)",
                          labels={"slo": name, "window": "long"},
                          ).set(obj["burn_long"])
                if obj["violated"]:
                    reg.counter("fl_slo_violations",
                                help="rounds that violated an SLO objective",
                                labels={"slo": name}).inc()
            reg.gauge("fl_slo_degraded",
                      help="1 while any SLO objective stands in breach "
                           "(healthz answers 'degraded: <slo>')",
                      ).set(1.0 if degraded is not None else 0.0)
        return verdict

    # ----------------------------------------------------------------- reads
    @property
    def degraded_slo(self) -> str | None:
        with self._lock:
            v = self._last_verdict
            return None if v is None else v["degraded_slo"]

    def standing(self) -> dict[str, Any]:
        """The JSON document ``GET /admin/slo`` serves."""
        with self._lock:
            v = self._last_verdict
            return {
                "policy": self.policy.describe(),
                "objectives_armed": list(self.policy.objectives()),
                "state": "ok" if v is None else v["state"],
                "degraded_slo": None if v is None else v["degraded_slo"],
                "round": None if v is None else v["round"],
                "objectives": {} if v is None else v["objectives"],
                "kpis": dict(self._last_kpis or {}),
            }
