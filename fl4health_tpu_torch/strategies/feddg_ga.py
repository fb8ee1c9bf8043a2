"""FedDG-GA, generalisation-adjustment aggregation weights (counterpart
of ``fl4health_tpu/strategies/feddg_ga.py``), and its combination with the
adaptive drift constraint.

- The aggregate is ``sum_i w_i params_i`` with per-client adjustment
  weights (``1 / N`` at init, kept at unit sum) over the round's
  participants.
- After the round's evaluation (``update_after_eval``, which the
  simulation runs between rounds, so ``fit`` takes the pipelined route) the
  generalisation gap of client i is its eval loss of the global model less
  its validation loss right after local training (``evaluate_after_fit``:
  ``val_checkpoint_post_fit``); the centred gaps, scaled by their largest
  magnitude and a step size that decays linearly over ``num_rounds``, move
  the weights, which are clipped to [0, 1] and renormalised.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core.aggregate import weighted_mean
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy
from fl4health_tpu_torch.strategies.fedprox import (AdaptiveConstraintPayload,
                                                    adapt_drift_penalty)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedDgGaState:
    params: Params
    adjustment_weights: torch.Tensor  # [n_clients], unit sum
    local_val_losses: torch.Tensor  # [n_clients], post-fit, pre-aggregation
    round_idx: torch.Tensor


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


def _normalized_weights(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The round's weights of this rank's block of clients (all of them
    without a mesh), at unit sum over every rank's."""
    w = agg.client_block(weights) * mask
    return w / torch.clamp(agg.client_total(w), min=1e-12)


def _post_fit_val_losses(results: FitResults, previous: torch.Tensor) -> torch.Tensor:
    """Every client's post-fit validation loss, the previous one where a
    client did not report (its block's rows gathered under a mesh)."""
    return torch.where(agg.client_all(results.mask) > 0,
                       agg.client_all(results.train_losses["val_checkpoint_post_fit"]),
                       previous)


def _keep_if_empty(new: Params, old: Params, mask: torch.Tensor) -> Params:
    any_client = agg.client_total(mask) > 0
    return {k: torch.where(any_client, v, old[k]) for k, v in new.items()}


def _round_tensor(round_idx, like: torch.Tensor) -> torch.Tensor:
    """The round index as an int32 0-d tensor beside ``like``; a Python
    int is filled in on the device (a copy from the host would wait for
    the stream)."""
    if isinstance(round_idx, torch.Tensor):
        return round_idx.to(device=like.device, dtype=torch.int32)
    return torch.full_like(like, int(round_idx))


class FedDgGa(Strategy):
    evaluate_after_fit = True

    def __init__(
        self,
        n_clients: int,
        num_rounds: int,
        adjustment_weight_step_size: float = 0.2,
        signal: float = 1.0,  # +1 for loss metrics, -1 for accuracy-like ones
    ):
        self.n_clients = n_clients
        self.num_rounds = num_rounds
        self.step_size = adjustment_weight_step_size
        self.signal = signal

    def init(self, params: Params) -> FedDgGaState:
        device = _device(params)
        return FedDgGaState(
            params=params,
            adjustment_weights=torch.full((self.n_clients,), 1.0 / self.n_clients,
                                          dtype=torch.float32, device=device),
            local_val_losses=torch.zeros((self.n_clients,), dtype=torch.float32,
                                         device=device),
            round_idx=torch.zeros((), dtype=torch.int32, device=device))

    def aggregate(self, server_state: FedDgGaState, results: FitResults,
                  round_idx: int) -> FedDgGaState:
        # a client the failure screen dropped (mask 0) enters neither the
        # average nor the gaps
        w = _normalized_weights(server_state.adjustment_weights, results.mask)
        new_params = weighted_mean(results.packets, w)
        new_val = _post_fit_val_losses(results, server_state.local_val_losses)
        return dataclasses.replace(
            server_state,
            params=_keep_if_empty(new_params, server_state.params, results.mask),
            local_val_losses=new_val,
            round_idx=_round_tensor(round_idx, server_state.round_idx))

    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        gaps = eval_losses["checkpoint"] - server_state.local_val_losses
        centered = gaps - gaps.mean()
        max_dev = centered.abs().max()
        step = self.step_size - ((server_state.round_idx.to(torch.float32) - 1.0)
                                 * self.step_size / self.num_rounds)
        delta = torch.where(max_dev > 0,
                            self.signal * step * centered / torch.clamp(max_dev, min=1e-12),
                            torch.zeros_like(centered))
        w = torch.clamp(server_state.adjustment_weights + delta, 0.0, 1.0)
        w = w / torch.clamp(w.sum(), min=1e-12)
        return dataclasses.replace(server_state, adjustment_weights=w)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedDgGaAdaptiveConstraintState:
    params: Params
    adjustment_weights: torch.Tensor
    local_val_losses: torch.Tensor
    round_idx: torch.Tensor
    drift_penalty_weight: torch.Tensor  # mu
    previous_loss: torch.Tensor
    loss_drop_streak: torch.Tensor


class FedDgGaAdaptiveConstraint(Strategy):
    """FedDG-GA's aggregation with FedProx's mu adaptation: the clients
    pack their vanilla train loss beside the weights, the params aggregate
    with the adjustment weights, and mu follows the aggregated train loss
    as ``FedAvgWithAdaptiveConstraint``'s does."""

    evaluate_after_fit = True

    def __init__(
        self,
        n_clients: int,
        num_rounds: int,
        adjustment_weight_step_size: float = 0.2,
        signal: float = 1.0,
        initial_drift_penalty_weight: float = 0.1,
        adapt_loss_weight: bool = True,
        loss_weight_delta: float = 0.1,
        loss_weight_patience: int = 5,
        weighted_train_losses: bool = True,
    ):
        self.ga = FedDgGa(n_clients, num_rounds, adjustment_weight_step_size, signal)
        self.mu0 = initial_drift_penalty_weight
        self.adapt = adapt_loss_weight
        self.delta = loss_weight_delta
        self.patience = loss_weight_patience
        self.weighted_train_losses = weighted_train_losses

    def init(self, params: Params) -> FedDgGaAdaptiveConstraintState:
        ga = self.ga.init(params)
        device = _device(params)
        return FedDgGaAdaptiveConstraintState(
            params=ga.params, adjustment_weights=ga.adjustment_weights,
            local_val_losses=ga.local_val_losses, round_idx=ga.round_idx,
            drift_penalty_weight=torch.tensor(self.mu0, dtype=torch.float32, device=device),
            previous_loss=torch.tensor(float("inf"), dtype=torch.float32, device=device),
            loss_drop_streak=torch.zeros((), dtype=torch.int32, device=device))

    def client_payload(self, server_state, round_idx):
        return AdaptiveConstraintPayload(params=server_state.params,
                                         drift_penalty_weight=server_state.drift_penalty_weight)

    def aggregate(self, server_state, results: FitResults, round_idx):
        packets = results.packets  # AdaptiveConstraintPacket
        w = _normalized_weights(server_state.adjustment_weights, results.mask)
        new_params = weighted_mean(packets.params, w)
        train_loss = agg.aggregate_losses(packets.loss_for_adaptation, results.sample_counts,
                                          results.mask, self.weighted_train_losses)
        mu, streak = adapt_drift_penalty(
            server_state.drift_penalty_weight, server_state.loss_drop_streak, train_loss,
            server_state.previous_loss, self.patience, self.delta, self.adapt)
        any_client = agg.client_total(results.mask) > 0
        new_val = _post_fit_val_losses(results, server_state.local_val_losses)
        return dataclasses.replace(
            server_state,
            params=_keep_if_empty(new_params, server_state.params, results.mask),
            local_val_losses=new_val,
            round_idx=_round_tensor(round_idx, server_state.round_idx),
            drift_penalty_weight=mu,
            previous_loss=torch.where(any_client, train_loss, server_state.previous_loss),
            loss_drop_streak=streak)

    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        # the same rule; it reads and replaces fields the combined state
        # carries too
        return self.ga.update_after_eval(server_state, eval_losses, eval_metrics, mask)
