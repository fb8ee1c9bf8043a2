"""GPFL client logic (counterpart of ``fl4health_tpu/clients/gpfl.py``).

Each round the client freezes the received GCE embedding table ``E`` [C,
D] and computes two conditional inputs from it and its class-sample
proportions: the global ``g = sum_c E_c / C`` and the personal ``p = E^T
props / C``; they reach ``GpflModel``'s forward through ``predict``'s
context. The training loss is the head's cross-entropy, plus the GCE
softmax loss (cross-entropy over the cosine logits of the general
features), plus ``lam`` times the magnitude loss ``||general features -
E_frozen[y]||`` over the valid rows, plus ``mu`` times half the squared
norm of the GCE and CoV params (the reference's weight decay on those
groups, the same gradients).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fl4health_tpu_torch.clients.engine import (Batch, ClientLogic, ModelDef, TrainState,
                                                from_module)
from fl4health_tpu_torch.core.pytree import flax_leaf_order, tree_dataclass


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class GpflContext:
    frozen_embeddings: torch.Tensor  # [C, D] the received GCE table
    p_cond: torch.Tensor  # [D]
    g_cond: torch.Tensor  # [D]


class GpflClientLogic(ClientLogic):
    """Pair with ``models.bases.GpflModel`` through ``gpfl_model_def`` and
    ``FixedLayerExchanger(GpflModel.exchange_shared)``."""

    extra_loss_keys = ("prediction_ce", "gce_softmax", "magnitude")

    def __init__(self, model, criterion, n_classes: int, class_proportions=None,
                 lam: float = 0.01, mu: float = 0.01):
        super().__init__(model, criterion)
        self.n_classes = n_classes
        # the client's label marginal; uniform where unknown
        self.class_proportions = (
            torch.as_tensor(class_proportions, dtype=torch.float32)
            if class_proportions is not None
            else torch.full((n_classes,), 1.0 / n_classes))
        self.lam = lam
        self.mu = mu

    def init_round_context(self, state: TrainState, payload) -> GpflContext:
        # after the pull state.params holds the received table
        emb = state.params["gce/embedding"].detach()
        props = self.class_proportions.to(emb.device)
        return GpflContext(frozen_embeddings=emb,
                           p_cond=(emb.T @ props) / self.n_classes,
                           g_cond=emb.sum(dim=0) / self.n_classes)

    def predict(self, params, model_state, batch: Batch, rng=None, train: bool = False,
                extra=None, ctx=None):
        kwargs = {"rng": rng} if self.model.takes_rng else {}
        return self.model.apply(params, model_state, batch.x, train=train,
                                p_cond=None if ctx is None else ctx.p_cond,
                                g_cond=None if ctx is None else ctx.g_cond, **kwargs)

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: GpflContext):
        m = batch.example_mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        ce = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        per = F.cross_entropy(preds["gce_logits"], batch.y.long(), reduction="none")
        gce_loss = (per * m).sum() / denom
        target_emb = ctx.frozen_embeddings[batch.y.long()]  # [B, D]
        diff = (features["general_features"] - target_emb) * m[:, None]
        magnitude = torch.linalg.vector_norm(diff)
        total = ce + gce_loss + self.lam * magnitude
        if self.mu > 0.0:
            # the GCE subtree's leaves, then the CoV's, each in flax's order
            leaves = [k for sub in ("gce/", "cov/")
                      for k in flax_leaf_order({k: v for k, v in params.items()
                                                if k.startswith(sub)})]
            l2 = 0.5 * sum(torch.sum(torch.square(params[k])) for k in leaves)
            total = total + self.mu * l2
        return total, {"prediction_ce": ce, "gce_softmax": gce_loss, "magnitude": magnitude}


def gpfl_model_def(module) -> ModelDef:
    """The ``ModelDef`` of a ``GpflModel``: ``from_module`` forwards the
    conditional inputs already."""
    return from_module(module)
