"""Functional optimizers in optax's order (counterpart of the optax
transforms the JAX package uses). ``torch.optim`` applies updates in another
order, so the port keeps optax's ``init``/``update`` + ``apply_updates``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from fl4health_tpu_torch.core.types import Params


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params | None], tuple[Params, Any]]


def sgd(learning_rate: float) -> GradientTransformation:
    """``optax.sgd(learning_rate)`` without momentum: updates ``-lr * g``."""

    def init(params: Params):
        return {}

    def update(grads: Params, state, params: Params | None = None):
        return {k: -learning_rate * g for k, g in grads.items()}, state

    return GradientTransformation(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` in the param's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
