"""MOON client logic (counterpart of ``fl4health_tpu/clients/moon.py``):
model-contrastive federated learning.

The client keeps a buffer of up to ``buffer_len`` frozen previous local
models in ``TrainState.extra``: a ``Params`` tree whose leaves carry a
leading ``[L]`` axis (``[K, L, ...]`` under the client vmap), the newest
model last. The training loss adds ``mu`` times the contrastive term, with
the received global model's features as the positive and the old models'
as negatives. Both come from the model's ``features`` output with
``train=False``, detached (JAX's ``stop_gradient``); the old models' through
a nested ``torch.func.vmap`` over ``L``. ``n_valid`` counts the filled
slots: empty slots are masked out of the logits, and the term is exactly 0
until the buffer holds a model (round 1). The port's models draw nothing
at apply time, so the JAX client's ``fold_in(rng, 13)`` has no counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.losses.contrastive import moon_contrastive_loss


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MoonExtra:
    old_params: Params  # [L, ...] previous local params, newest last
    n_valid: torch.Tensor  # int32 scalar: filled slots


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MoonContext:
    global_params: Params  # the frozen received global model


class MoonClientLogic(ClientLogic):
    """Pair with ``models.bases.MoonModel`` (which exposes ``features``)."""

    extra_loss_keys = ("vanilla", "contrastive")

    def __init__(self, model, criterion, contrastive_weight: float = 1.0,
                 temperature: float = 0.5, buffer_len: int = 1):
        super().__init__(model, criterion)
        self.mu = contrastive_weight
        self.temperature = temperature
        self.buffer_len = buffer_len

    def init_extra(self, params: Params) -> MoonExtra:
        device = next(iter(params.values())).device
        return MoonExtra(
            old_params={k: torch.stack([p] * self.buffer_len) for k, p in params.items()},
            n_valid=torch.zeros((), dtype=torch.int32, device=device))

    def init_round_context(self, state: TrainState, payload) -> MoonContext:
        return MoonContext(global_params=getattr(payload, "params", payload))

    def _features_of(self, params: Params, model_state, x: torch.Tensor) -> torch.Tensor:
        (_, features), _ = self.model.apply(params, model_state, x, train=False)
        return features["features"]

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: MoonContext):
        vanilla = self.criterion(preds["prediction"], batch.y, batch.example_mask)
        z = features["features"]  # [B, D]
        z_glob = self._features_of(ctx.global_params, state.model_state, batch.x).detach()
        z_old = torch.func.vmap(lambda p: self._features_of(p, state.model_state, batch.x))(
            state.extra.old_params).detach()  # [L, B, D]
        # the last n_valid slots hold real models
        slots = torch.arange(self.buffer_len, device=z.device)
        valid = (slots >= self.buffer_len - state.extra.n_valid).float()
        contrastive = moon_contrastive_loss(z, z_glob[None], z_old, self.temperature,
                                            batch.example_mask, negative_mask=valid)
        contrastive = contrastive * (state.extra.n_valid > 0).float()
        return vanilla + self.mu * contrastive, {"vanilla": vanilla,
                                                 "contrastive": contrastive}

    def finalize_round(self, state: TrainState, ctx, local_steps) -> TrainState:
        """Shift the buffer and append this round's final local params."""
        old = state.extra.old_params
        new_buf = {k: torch.cat([old[k][1:], p[None]], dim=0)
                   for k, p in state.params.items()}
        n_valid = torch.clamp(state.extra.n_valid + 1, max=self.buffer_len)
        return dataclasses.replace(state, extra=MoonExtra(old_params=new_buf,
                                                          n_valid=n_valid))
