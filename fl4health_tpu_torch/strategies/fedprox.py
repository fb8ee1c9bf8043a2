"""FedAvg with an adaptive proximal constraint (counterpart of
``fl4health_tpu/strategies/fedprox.py``: ``adapt_drift_penalty`` and
``FedAvgWithAdaptiveConstraint``). Clients pack their un-penalised train
loss beside the weights; the server tracks the aggregated loss: after
``loss_weight_patience`` consecutive rounds of no increase mu drops by
``loss_weight_delta`` (floored at 0), on any increase it rises by it. mu,
the previous loss (+inf at init) and the streak are 0-d tensors on the
device, and the adaptation runs there: nothing waits for the host.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveConstraintState:
    params: Params
    drift_penalty_weight: torch.Tensor  # mu
    previous_loss: torch.Tensor
    loss_drop_streak: torch.Tensor  # int32: consecutive rounds without an increase


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveConstraintPayload:
    params: Params
    drift_penalty_weight: torch.Tensor


def adapt_drift_penalty(mu: torch.Tensor, streak: torch.Tensor, train_loss: torch.Tensor,
                        previous_loss: torch.Tensor, patience: int, delta: float,
                        adapt: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The mu/streak rules: drop mu after ``patience`` consecutive rounds
    without an increase, raise it on any increase."""
    improved = train_loss <= previous_loss
    streak = torch.where(improved, streak + 1, torch.zeros_like(streak))
    if adapt:
        hit = streak >= patience
        mu = torch.where(hit, torch.clamp(mu - delta, min=0.0), mu)
        mu = torch.where(~improved, mu + delta, mu)
        streak = torch.where(hit, torch.zeros_like(streak), streak)
    return mu, streak


class FedAvgWithAdaptiveConstraint(Strategy):
    def __init__(
        self,
        initial_drift_penalty_weight: float = 0.1,
        adapt_loss_weight: bool = True,
        loss_weight_delta: float = 0.1,
        loss_weight_patience: int = 5,
        weighted_aggregation: bool = True,
        weighted_train_losses: bool = True,
    ):
        self.mu0 = initial_drift_penalty_weight
        self.adapt = adapt_loss_weight
        self.delta = loss_weight_delta
        self.patience = loss_weight_patience
        self.weighted_aggregation = weighted_aggregation
        self.weighted_train_losses = weighted_train_losses

    def init(self, params: Params) -> AdaptiveConstraintState:
        device = next(iter(params.values())).device
        return AdaptiveConstraintState(
            params=params,
            drift_penalty_weight=torch.tensor(self.mu0, dtype=torch.float32, device=device),
            previous_loss=torch.tensor(float("inf"), dtype=torch.float32, device=device),
            loss_drop_streak=torch.zeros((), dtype=torch.int32, device=device))

    def client_payload(self, server_state: AdaptiveConstraintState, round_idx: int):
        return AdaptiveConstraintPayload(
            params=server_state.params,
            drift_penalty_weight=server_state.drift_penalty_weight)

    def aggregate(self, server_state: AdaptiveConstraintState, results: FitResults,
                  round_idx: int) -> AdaptiveConstraintState:
        packets: AdaptiveConstraintPacket = results.packets
        new_params = agg.aggregate(packets.params, results.sample_counts, results.mask,
                                   self.weighted_aggregation)
        train_loss = agg.aggregate_losses(packets.loss_for_adaptation,
                                          results.sample_counts, results.mask,
                                          self.weighted_train_losses)
        mu, streak = adapt_drift_penalty(
            server_state.drift_penalty_weight, server_state.loss_drop_streak, train_loss,
            server_state.previous_loss, self.patience, self.delta, self.adapt)
        any_client = agg.client_total(results.mask) > 0
        return AdaptiveConstraintState(
            params={k: torch.where(any_client, v, server_state.params[k])
                    for k, v in new_params.items()},
            drift_penalty_weight=mu,
            previous_loss=torch.where(any_client, train_loss, server_state.previous_loss),
            loss_drop_streak=streak)
