"""Ditto and MR-MTL client logics, drift-constrained personal models
(counterpart of ``fl4health_tpu/clients/ditto.py``).

- Ditto trains a global model (exchanged, the vanilla loss) and a personal
  model (private) with an l2 drift term pulling the personal weights toward
  the global weights received this round. Validation runs on the personal
  model. The adaptive variant packs the global model's vanilla train loss
  so the server can adapt lambda.
- MR-MTL keeps one personal model that the server never overwrites
  (``KeepLocalExchanger``): the received aggregate is only the drift
  target. The personal weights are still sent up for averaging.

Ditto's twin models are one ``Params`` dict with ``global_model/...`` and
``personal_model/...`` paths (``models.bases.TwinModel``): one gradient of
the summed loss gives both of the reference's backward passes, because the
two loss terms touch disjoint leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket
from fl4health_tpu_torch.losses.drift import weight_drift_loss


def _subtree(params: Params, name: str) -> Params:
    """The leaves under ``name/``, keyed by their path below it (the flax
    subtree ``params[name]``)."""
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _drift_weight(payload, lam: float, params: Params) -> torch.Tensor:
    """lambda from the payload (``FedAvgWithAdaptiveConstraint`` sends it),
    else the logic's own as an f32 scalar."""
    weight = getattr(payload, "drift_penalty_weight", None)
    if weight is None:
        device = next(iter(params.values())).device
        weight = torch.tensor(lam, dtype=torch.float32, device=device)
    return weight


def _payload_params(payload) -> Params:
    return payload.params if hasattr(payload, "params") else payload


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class DittoContext:
    initial_global_params: Params  # the received global weights (drift target)
    drift_penalty_weight: Any  # lambda


class DittoClientLogic(ClientLogic):
    """Pair with ``models.bases.TwinModel`` (``global_model/...`` and
    ``personal_model/...`` params) and a ``FixedLayerExchanger`` on
    ``TwinModel.exchange_global_model``. The loss is the global model's
    criterion plus the personal model's plus ``lam / 2 * ||personal -
    received global||^2``."""

    extra_loss_keys = ("global_ce", "personal_ce", "penalty")

    def __init__(self, model, criterion, lam: float = 1.0, adaptive: bool = False):
        super().__init__(model, criterion)
        self.lam = lam
        self.adaptive = adaptive

    def init_round_context(self, state: TrainState, payload) -> DittoContext:
        params = _payload_params(payload)
        return DittoContext(initial_global_params=_subtree(params, "global_model"),
                            drift_penalty_weight=_drift_weight(payload, self.lam, params))

    def training_loss(self, preds, features, batch: Batch, params, state, ctx: DittoContext):
        global_ce = self.criterion(preds["global"], batch.y, batch.example_mask)
        personal_ce = self.criterion(preds["personal"], batch.y, batch.example_mask)
        penalty = 0.5 * weight_drift_loss(_subtree(params, "personal_model"),
                                          ctx.initial_global_params,
                                          ctx.drift_penalty_weight)
        total = global_ce + personal_ce + penalty
        return total, {"global_ce": global_ce, "personal_ce": personal_ce,
                       "penalty": penalty}

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        # validation runs on the personal model
        return self.criterion(preds["personal"], batch.y, batch.example_mask), {}

    def pack(self, state: TrainState, pushed_params, train_losses):
        if not self.adaptive:
            return pushed_params
        return AdaptiveConstraintPacket(params=pushed_params,
                                        loss_for_adaptation=train_losses["global_ce"])


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MrMtlContext:
    initial_params: Params  # the received aggregate (drift target only)
    drift_penalty_weight: Any


class KeepLocalExchanger:
    """MR-MTL's wire: push the personal weights for aggregation, never
    overwrite them on pull; the aggregate is read as the drift target in
    the loss."""

    def push(self, params: Params, initial_params: Params | None = None) -> Params:
        del initial_params
        return params

    def pull(self, payload: Params, local: Params) -> Params:
        del payload
        return local


class MrMtlClientLogic(ClientLogic):
    """Mean-regularised multi-task learning; pair with
    ``KeepLocalExchanger``. The loss is the criterion plus ``lam / 2 * ||w -
    w_aggregate||^2``; the adaptive variant packs the vanilla loss."""

    extra_loss_keys = ("vanilla", "penalty")

    def __init__(self, model, criterion, lam: float = 1.0, adaptive: bool = False):
        super().__init__(model, criterion)
        self.lam = lam
        self.adaptive = adaptive

    def init_round_context(self, state: TrainState, payload) -> MrMtlContext:
        params = _payload_params(payload)
        return MrMtlContext(initial_params=params,
                            drift_penalty_weight=_drift_weight(payload, self.lam, params))

    def training_loss(self, preds, features, batch: Batch, params, state, ctx: MrMtlContext):
        vanilla = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        penalty = 0.5 * weight_drift_loss(params, ctx.initial_params,
                                          ctx.drift_penalty_weight)
        return vanilla + penalty, {"vanilla": vanilla, "penalty": penalty}

    def pack(self, state: TrainState, pushed_params, train_losses):
        if not self.adaptive:
            return pushed_params
        return AdaptiveConstraintPacket(params=pushed_params,
                                        loss_for_adaptation=train_losses["vanilla"])
