"""Resilience (counterpart of ``fl4health_tpu/resilience/``): tolerate and
route around client failures on every route of ``fit``.

- :mod:`.aggregators`: Byzantine-robust aggregation packaged as the
  drop-in :class:`RobustFedAvg` strategy;
- :mod:`.quarantine`: an in-graph quarantine mask carried in server state
  with strike, probation and release (:class:`QuarantiningStrategy` wraps
  any strategy); offenders are masked, never dropped, so shapes never
  change;
- :mod:`.faults`: the deterministic, seeded :class:`FaultPlan` chaos
  layer robustness claims are tested against;
- :mod:`.retry`: retry/backoff, failure classification and per-silo
  circuit breakers for the cross-silo transport;
- :mod:`.recovery`: the crash drill (a subprocess ``fit()`` SIGKILLed at
  a seeded point, resumed from the retention ring, pinned bit-equal to
  the uninterrupted run);
- :mod:`.supervisor`: the self-healing loop, a :class:`RecoverySupervisor`
  driving a :class:`RecoveryPolicy` escalation ladder (retry ->
  quarantine -> robustify -> degrade -> halt) with flight-recorder
  suspect attribution (:mod:`.suspects`), checkpoint-ring rollback and
  probation;
- :func:`chaos_handler`: deterministic wire chaos around a cross-silo
  silo's handler (``transport/``).
"""

from fl4health_tpu_torch.resilience.aggregators import (
    ROBUST_METHODS,
    RobustFedAvg,
    coordinate_median,
    krum_weights,
    norm_bounded_mean,
    trimmed_mean,
)
from fl4health_tpu_torch.resilience.faults import (
    ClientFault,
    FaultPlan,
    TransportFaultPolicy,
    chaos_handler,
)
from fl4health_tpu_torch.resilience.quarantine import (
    QuarantinePolicy,
    QuarantineServerState,
    QuarantineState,
    QuarantiningStrategy,
    init_quarantine,
    quarantine_step,
)
from fl4health_tpu_torch.resilience.recovery import (
    DrillResult,
    KillPoint,
    corrupt_newest_generation,
    install_kill_hook,
    run_child,
)
from fl4health_tpu_torch.resilience.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryDeadlineError,
    RetryPolicy,
    call_with_retry,
    classify_failure,
)
from fl4health_tpu_torch.resilience.supervisor import (
    QuorumControl,
    RecoveryPolicy,
    RecoverySupervisor,
)
from fl4health_tpu_torch.resilience.suspects import (
    detect_divergence_onset,
    rank_suspects,
)

__all__ = [
    "DrillResult",
    "KillPoint",
    "corrupt_newest_generation",
    "install_kill_hook",
    "run_child",
    "ROBUST_METHODS",
    "RobustFedAvg",
    "coordinate_median",
    "trimmed_mean",
    "norm_bounded_mean",
    "krum_weights",
    "QuarantinePolicy",
    "QuarantineState",
    "QuarantineServerState",
    "QuarantiningStrategy",
    "init_quarantine",
    "quarantine_step",
    "ClientFault",
    "FaultPlan",
    "TransportFaultPolicy",
    "chaos_handler",
    "RetryPolicy",
    "RetryDeadlineError",
    "CircuitBreaker",
    "CircuitOpenError",
    "call_with_retry",
    "classify_failure",
    "QuorumControl",
    "RecoveryPolicy",
    "RecoverySupervisor",
    "rank_suspects",
    "detect_divergence_onset",
]
