"""Weight-drift penalty (counterpart of ``weight_drift_loss`` in
``fl4health_tpu/losses/drift.py``; the rest of that module waits for the
personalisation slice)."""

from __future__ import annotations

import torch

from fl4health_tpu_torch.core.pytree import flax_leaf_order
from fl4health_tpu_torch.core.types import Params


def weight_drift_loss(params: Params, reference_params: Params,
                      weight: torch.Tensor | float = 1.0) -> torch.Tensor:
    """``weight * ||params - reference||^2`` summed over every leaf, in f32
    (the master params are f32 whatever the compute dtype), the leaves
    summed in JAX's order."""
    sq = sum(torch.sum(torch.square((params[k] - reference_params[k]).float()))
             for k in flax_leaf_order(params))
    return torch.as_tensor(weight, dtype=torch.float32) * sq
