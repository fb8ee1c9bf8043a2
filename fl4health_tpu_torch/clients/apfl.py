"""APFL client logic, adaptive personalised federated learning
(counterpart of ``fl4health_tpu/clients/apfl.py``).

Twin local and global models; the personal prediction is the alpha
mixture of their logits (``models.bases.ApflModule``). Each step trains
the global model on its own loss and the local model on the mixture's,
the global branch detached there; with ``adaptive_alpha`` alpha then takes
its own gradient step on the step's logits (``update_after_step``) and is
clipped to [0, 1].

alpha lives in ``TrainState.extra`` (it never crosses the wire) and
reaches the forward through ``predict``'s ``extra``, on train and eval
calls alike. Its gradient is ``torch.func.grad`` through the mixing alone,
the reference's analytic ``<dL/d(mix), local - global>``, at no model
cost. The engine runs ``update_after_step`` unmasked, so a padding step
selects alpha back here.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.clients.engine import (Batch, ClientLogic, ModelDef, TrainState,
                                                from_module)
from fl4health_tpu_torch.core.pytree import tree_dataclass


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ApflExtra:
    alpha: torch.Tensor  # f32 scalar in [0, 1]


class ApflClientLogic(ClientLogic):
    """Pair with ``models.bases.ApflModule`` and a ``FixedLayerExchanger``
    on ``ApflModule.exchange_global_model``."""

    extra_loss_keys = ("global_ce", "personal_ce")

    def __init__(self, model, criterion, alpha: float = 0.5,
                 alpha_lr: float = 0.01, adaptive_alpha: bool = True):
        super().__init__(model, criterion)
        self.alpha0 = alpha
        self.alpha_lr = alpha_lr
        self.adaptive_alpha = adaptive_alpha

    def init_extra(self, params) -> ApflExtra:
        device = next(iter(params.values())).device
        return ApflExtra(alpha=torch.tensor(self.alpha0, dtype=torch.float32, device=device))

    def predict(self, params, model_state, batch: Batch, rng=None, train: bool = False,
                extra=None, ctx=None):
        alpha = extra.alpha if extra is not None else self.alpha0
        kwargs = {"rng": rng} if self.model.takes_rng else {}
        return self.model.apply(params, model_state, batch.x, train=train,
                                alpha=alpha, **kwargs)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        # the global model learns from its own logits, the local one from
        # the mixture with the global branch frozen
        global_ce = self.criterion(preds["global"], batch.y, batch.example_mask)
        alpha = state.extra.alpha
        mixed = alpha * preds["local"] + (1.0 - alpha) * preds["global"].detach()
        personal_ce = self.criterion(mixed, batch.y, batch.example_mask)
        return global_ce + personal_ce, {"global_ce": global_ce, "personal_ce": personal_ce}

    def update_after_step(self, state: TrainState, ctx, batch: Batch,
                          preds=None) -> TrainState:
        if not self.adaptive_alpha:
            return state
        local, glob = preds["local"].detach(), preds["global"].detach()

        def personal_loss(alpha):
            mixed = alpha * local + (1.0 - alpha) * glob
            return self.criterion(mixed, batch.y, batch.example_mask)

        alpha = state.extra.alpha
        new_alpha = torch.clamp(alpha - self.alpha_lr * torch.func.grad(personal_loss)(alpha),
                                0.0, 1.0)
        # a padding step must not move alpha
        new_alpha = torch.where(batch.step_mask > 0, new_alpha, alpha)
        return dataclasses.replace(state, extra=ApflExtra(alpha=new_alpha))

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        return self.criterion(preds["personal"], batch.y, batch.example_mask), {}


def apfl_model_def(module) -> ModelDef:
    """The ``ModelDef`` of an ``ApflModule``: ``from_module`` forwards the
    alpha keyword already."""
    return from_module(module)
