"""FedProx client logic (counterpart of ``fl4health_tpu/clients/fedprox.py``):
the training loss is the criterion plus ``mu / 2 * ||w - w_received||^2``;
mu arrives in the payload, and the un-penalised ("vanilla") train loss is
packed for the server's mu adaptation."""

from __future__ import annotations

import dataclasses
from typing import Any

from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket
from fl4health_tpu_torch.losses.drift import weight_drift_loss


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ProxContext:
    initial_params: Params  # the params pulled this round
    drift_penalty_weight: Any  # mu, a 0-d tensor


class FedProxClientLogic(ClientLogic):
    extra_loss_keys = ("vanilla", "penalty")

    def init_round_context(self, state: TrainState, payload) -> ProxContext:
        """mu from the payload (JAX's client falls back to 0.1 without one,
        but its only strategy, as the port's, always sends it)."""
        return ProxContext(initial_params=state.params,
                           drift_penalty_weight=payload.drift_penalty_weight)

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: ProxContext):
        vanilla = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        penalty = 0.5 * weight_drift_loss(params, ctx.initial_params,
                                          ctx.drift_penalty_weight)
        return vanilla + penalty, {"vanilla": vanilla, "penalty": penalty}

    def pack(self, state: TrainState, pushed_params, train_losses) -> AdaptiveConstraintPacket:
        return AdaptiveConstraintPacket(params=pushed_params,
                                        loss_for_adaptation=train_losses["vanilla"])
