"""Scenario sweeps (counterpart of ``fl4health_tpu/sweep/``). Ported so
far: the scalar hyperparameter hoisting (:mod:`.hoisting`), which the
recovery supervisor's degrade rung uses. The grid spec, the shape
bucketing and the sweep runner come with ROADMAP.md A11."""

from fl4health_tpu_torch.sweep.hoisting import (
    SCALAR_BINDINGS,
    ScalarBinding,
    applicable_scalars,
    apply_state_scalars,
    bind_traced_scalars,
)

__all__ = [
    "SCALAR_BINDINGS",
    "ScalarBinding",
    "applicable_scalars",
    "apply_state_scalars",
    "bind_traced_scalars",
]
