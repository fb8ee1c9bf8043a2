"""Scenario sweeps (counterpart of ``fl4health_tpu/sweep/``): a grid runner
over {strategy x client algorithm x non-IID partitioner x cohort size x
fault plan x sampling manager x seed x scalar hyperparameter} that runs
every cell through one set of round functions per shape bucket.

1. scalar hoisting (:mod:`.hoisting`): scalars enter the rounds as inputs
   (state leaves, or attributes read as 0-d tensors on the device);
2. shape bucketing (:mod:`.bucketing`): cohorts pad to buckets with
   zero-weight phantom clients, banks pad to a group's row budget;
3. the runner (:mod:`.runner`): each cell runs the chunked route's rounds
   with one pull at its end, cells back to back in packs, and a completion
   ledger restores finished cells on a rerun.

Every cell reproduces its standalone chunked ``FederatedSimulation.fit``,
bit for bit up to 32 clients a bucket (``tests/test_torch_sweep.py``;
ROADMAP.md C, R11, above).
"""

from fl4health_tpu_torch.sweep.bucketing import GroupKey, SweepGroup, SweepPlan
from fl4health_tpu_torch.sweep.hoisting import (
    SCALAR_BINDINGS,
    ScalarBinding,
    applicable_scalars,
    apply_state_scalars,
    bind_traced_scalars,
)
from fl4health_tpu_torch.sweep.runner import (
    CellResult,
    SweepLedger,
    SweepResult,
    SweepRunner,
    run_sweep,
)
from fl4health_tpu_torch.sweep.spec import SweepCell, SweepSpec

__all__ = [
    "CellResult",
    "SweepLedger",
    "GroupKey",
    "SCALAR_BINDINGS",
    "ScalarBinding",
    "SweepCell",
    "SweepGroup",
    "SweepPlan",
    "SweepResult",
    "SweepRunner",
    "SweepSpec",
    "applicable_scalars",
    "apply_state_scalars",
    "bind_traced_scalars",
    "run_sweep",
]
