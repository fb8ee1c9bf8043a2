"""FENDA, PerFCL, Constrained FENDA and FENDA+Ditto client logics
(counterpart of ``fl4health_tpu/clients/fenda.py``).

- FENDA: a ``ParallelSplitModel`` whose ``second_feature_extractor`` is
  exchanged; no extra loss, so the plain logic over the FENDA exchanger.
- PerFCL: two MOON-style contrastive terms. Global: anchor the current
  global features, positive the features of the received (aggregated)
  model, negative those of last round's final model. Local: anchor the
  current local features, positive last round's final local features,
  negative the received model's global features.
- Constrained FENDA: FENDA plus a cosine term between the local and
  global streams and a MOON contrastive term on the local stream against
  last round's local extractor.
- FENDA+Ditto: a twin of FENDA models whose personal copy's global
  extractor is drift-constrained toward the received one.

Last round's params live in ``extra`` and the received params in the round
context, tensors under the client vmap. The frozen feature passes run the
model with ``train=False`` and are detached (JAX's ``stop_gradient``); the
port's models draw nothing there, so JAX's ``fold_in(rng, 17)`` and
``fold_in(rng, 19)`` keys have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.clients.ditto import _drift_weight, _payload_params, _subtree
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.losses.contrastive import cosine_similarity, moon_contrastive_loss
from fl4health_tpu_torch.losses.drift import weight_drift_loss

# FENDA needs no logic subclass: ClientLogic over
# FixedLayerExchanger(ParallelSplitModel.exchange_global_extractor)
FendaClientLogic = ClientLogic


def _features(model, params: Params, model_state, x) -> dict:
    """A frozen feature pass: the model's features at ``train=False`` on the
    client's model state, detached."""
    (_, features), _ = model.apply(params, model_state, x, train=False)
    return {k: v.detach() for k, v in features.items()}


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class PerFclExtra:
    old_params: Params  # last round's final params
    have_old: torch.Tensor  # 0/1: a last round exists


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class PerFclContext:
    # the params after the pull: the received (aggregated) model
    initial_params: Params


class PerFclClientLogic(ClientLogic):
    """Pair with ``models.bases.PerFclModel`` (which exposes
    ``local_features`` and ``global_features``) and the FENDA exchanger."""

    extra_loss_keys = ("vanilla", "global_contrastive", "local_contrastive")

    def __init__(self, model, criterion,
                 global_feature_loss_weight: float = 1.0,
                 local_feature_loss_weight: float = 1.0,
                 global_feature_loss_temperature: float = 0.5,
                 local_feature_loss_temperature: float = 0.5):
        super().__init__(model, criterion)
        self.mu = global_feature_loss_weight
        self.gamma = local_feature_loss_weight
        self.t_global = global_feature_loss_temperature
        self.t_local = local_feature_loss_temperature

    def init_extra(self, params: Params) -> PerFclExtra:
        device = next(iter(params.values())).device
        return PerFclExtra(old_params=params,
                           have_old=torch.zeros((), dtype=torch.float32, device=device))

    def init_round_context(self, state: TrainState, payload) -> PerFclContext:
        del payload
        return PerFclContext(initial_params={k: v.detach() for k, v in state.params.items()})

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: PerFclContext):
        vanilla = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        old_f = _features(self.model, state.extra.old_params, state.model_state, batch.x)
        init_f = _features(self.model, ctx.initial_params, state.model_state, batch.x)
        z_p, z_s = features["local_features"], features["global_features"]
        # the two halves of perfcl_loss, each at its own temperature
        g_term = moon_contrastive_loss(z_s, init_f["global_features"][None],
                                       old_f["global_features"][None], self.t_global,
                                       batch.example_mask)
        l_term = moon_contrastive_loss(z_p, old_f["local_features"][None],
                                       init_f["global_features"][None], self.t_local,
                                       batch.example_mask)
        have_old = state.extra.have_old
        g_term, l_term = g_term * have_old, l_term * have_old
        total = vanilla + self.mu * g_term + self.gamma * l_term
        return total, {"vanilla": vanilla, "global_contrastive": g_term,
                       "local_contrastive": l_term}

    def finalize_round(self, state: TrainState, ctx, local_steps) -> TrainState:
        return dataclasses.replace(state, extra=PerFclExtra(
            old_params=state.params, have_old=torch.ones_like(state.extra.have_old)))


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ConstrainedFendaExtra:
    old_local_params: Params
    have_old: torch.Tensor


class ConstrainedFendaClientLogic(ClientLogic):
    """FENDA plus any of: a cosine term between the local and global
    features, and a MOON contrastive term on the local features (positive
    the current global stream, negative last round's local extractor).

    The cosine term is the masked mean of cos^2, as JAX's is, although the
    docstring there and the reference's ``cosine_similarity_loss`` speak of
    the mean |cos| (R12, ROADMAP.md C): mirrored."""

    extra_loss_keys = ("vanilla", "cos_sim", "contrastive")

    def __init__(self, model, criterion,
                 cos_sim_loss_weight: float = 0.0,
                 contrastive_loss_weight: float = 0.0,
                 temperature: float = 0.5):
        super().__init__(model, criterion)
        self.cos_w = cos_sim_loss_weight
        self.con_w = contrastive_loss_weight
        self.temperature = temperature

    def init_extra(self, params: Params) -> ConstrainedFendaExtra:
        device = next(iter(params.values())).device
        return ConstrainedFendaExtra(
            old_local_params=params,
            have_old=torch.zeros((), dtype=torch.float32, device=device))

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        vanilla = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        m = batch.example_mask.float()
        z_p, z_s = features["local_features"], features["global_features"]
        cos_sim = (torch.square(cosine_similarity(z_p, z_s)) * m).sum() / torch.clamp(
            m.sum(), min=1.0)
        contrastive = torch.zeros((), device=vanilla.device)
        if self.con_w > 0.0:
            old_local = _features(self.model, state.extra.old_local_params,
                                  state.model_state, batch.x)["local_features"]
            contrastive = moon_contrastive_loss(
                z_p, z_s.detach()[None], old_local[None], self.temperature,
                batch.example_mask) * state.extra.have_old
        total = vanilla + self.cos_w * cos_sim + self.con_w * contrastive
        return total, {"vanilla": vanilla, "cos_sim": cos_sim, "contrastive": contrastive}

    def finalize_round(self, state: TrainState, ctx, local_steps) -> TrainState:
        return dataclasses.replace(state, extra=ConstrainedFendaExtra(
            old_local_params=state.params,
            have_old=torch.ones_like(state.extra.have_old)))


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FendaDittoContext:
    # the received global FENDA model's global extractor: the drift target
    # of the personal model's
    initial_global_params: Params
    drift_penalty_weight: Any


class FendaDittoClientLogic(ClientLogic):
    """FENDA + Ditto: pair with ``models.bases.TwinModel`` over two FENDA
    models and a ``FixedLayerExchanger`` on the global copy (``TwinModel.
    exchange_global_model``). The loss is both copies' criterion plus
    ``lam / 2 * ||personal global extractor - received global extractor||^2``;
    validation runs on the personal copy."""

    extra_loss_keys = ("global_ce", "personal_ce", "penalty")

    def __init__(self, model, criterion, lam: float = 1.0):
        super().__init__(model, criterion)
        self.lam = lam

    def init_round_context(self, state: TrainState, payload) -> FendaDittoContext:
        params = _payload_params(payload)
        return FendaDittoContext(
            initial_global_params=_subtree(params, "global_model/second_feature_extractor"),
            drift_penalty_weight=_drift_weight(payload, self.lam, params))

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: FendaDittoContext):
        global_ce = self.criterion(preds["global"], batch.y, batch.example_mask)
        personal_ce = self.criterion(preds["personal"], batch.y, batch.example_mask)
        penalty = 0.5 * weight_drift_loss(
            _subtree(params, "personal_model/second_feature_extractor"),
            ctx.initial_global_params, ctx.drift_penalty_weight)
        total = global_ce + personal_ce + penalty
        return total, {"global_ce": global_ce, "personal_ce": personal_ce,
                       "penalty": penalty}

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        return self.criterion(preds["personal"], batch.y, batch.example_mask), {}
