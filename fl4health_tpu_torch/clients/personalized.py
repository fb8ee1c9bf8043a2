"""``make_it_personal``, a personalisation combinator for client logics
(counterpart of ``fl4health_tpu/clients/personalized.py``).

``make_it_personal(base, PersonalizedMode.DITTO)`` returns a logic that
twins the base model (an exchanged ``global_model`` and a private
``personal_model``), runs the base logic's whole loss on the personal
copy, trains the global copy with the plain criterion and adds the l2
drift penalty toward the received global weights (Ditto). ``MR_MTL`` keeps
the base model single, never overwrites it on pull (``KeepLocalExchanger``)
and adds the drift penalty toward the received aggregate.

The twin is built at the ``ModelDef`` level (``twin_model_def``), so any
base model twins the same way, and the base logic sees plain single-model
views of the twin's ``Params`` (the ``personal_model/`` leaves keyed below
it), its own code the same whether wrapped or not. A base whose gradient
(DP) or, for Ditto, whose forward (APFL, GPFL) is its own is refused, as in
JAX: the wrapper would silently bypass it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from fl4health_tpu_torch import rng as rng_mod
from fl4health_tpu_torch.clients.ditto import (KeepLocalExchanger, _drift_weight,
                                               _payload_params, _subtree)
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, ModelDef, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket
from fl4health_tpu_torch.losses.drift import weight_drift_loss

GLOBAL = "global_model"
PERSONAL = "personal_model"


class PersonalizedMode(enum.Enum):
    DITTO = "ditto"
    MR_MTL = "mr_mtl"


def _prefixed(params: Params, name: str) -> Params:
    return {f"{name}/{k}": v for k, v in params.items()}


def twin_model_def(base: ModelDef) -> ModelDef:
    """Two independent copies of ``base`` under ``global_model/`` and
    ``personal_model/`` (``TwinModel``'s layout at the ``ModelDef``
    level); the model state ``{"global_model": ..., "personal_model":
    ...}``, as JAX's. Predictions: ``global``, ``personal``, ``prediction``
    (the personal copy's) and each copy's whole dict (``_global_preds``,
    ``_personal_preds``); features ``{"global": ..., "personal": ...}``.
    A base that takes a key gets one split off the step's for each copy."""

    def init(generator):
        return {**_prefixed(base.init(generator), GLOBAL),
                **_prefixed(base.init(generator), PERSONAL)}

    def init_state(generator):
        return {GLOBAL: base.init_state(generator), PERSONAL: base.init_state(generator)}

    def apply(params, model_state, x, train=True, rng=None, **kwargs):
        keys = {GLOBAL: {}, PERSONAL: {}}
        if base.takes_rng and rng is not None:
            rng_g, rng_p = rng_mod.split(rng)
            keys = {GLOBAL: {"rng": rng_g}, PERSONAL: {"rng": rng_p}}
        (g_preds, g_feats), g_ms = base.apply(_subtree(params, GLOBAL), model_state[GLOBAL],
                                              x, train=train, **keys[GLOBAL], **kwargs)
        (p_preds, p_feats), p_ms = base.apply(_subtree(params, PERSONAL),
                                              model_state[PERSONAL], x, train=train,
                                              **keys[PERSONAL], **kwargs)
        preds = {"global": g_preds["prediction"], "personal": p_preds["prediction"],
                 # validation and metrics run on the personal copy
                 "prediction": p_preds["prediction"],
                 "_global_preds": g_preds, "_personal_preds": p_preds}
        return (preds, {"global": g_feats, "personal": p_feats}), {GLOBAL: g_ms,
                                                                   PERSONAL: p_ms}

    return ModelDef(init=init, apply=apply, module=base.module, takes_rng=base.takes_rng,
                    init_state=init_state)


def exchange_global_subtree(path: str) -> bool:
    """The twin's wire: the global copy (``TwinModel.exchange_global_model``)."""
    return path.startswith(GLOBAL)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class _DittoWrapCtx:
    base_ctx: Any
    received_global: Params
    drift_penalty_weight: Any


def _base_ctx(ctx, wrapper_type):
    return ctx.base_ctx if isinstance(ctx, wrapper_type) else ctx


class DittoPersonalizedLogic(ClientLogic):
    """``base`` on the personal copy, the plain global copy and the drift
    penalty; pair with ``FixedLayerExchanger(exchange_global_subtree)``."""

    def __init__(self, base: ClientLogic, lam: float = 1.0, adaptive: bool = False):
        super().__init__(twin_model_def(base.model), base.criterion)
        self.base = base
        self.lam = lam
        self.adaptive = adaptive
        self.extra_loss_keys = ("global_loss", "penalty") + tuple(
            f"personal_{k}" for k in getattr(base, "extra_loss_keys", ()))
        self.eval_loss_keys = tuple(
            f"personal_{k}" for k in getattr(base, "eval_loss_keys", ()))

    def _view(self, state: TrainState, params: Params | None = None) -> TrainState:
        """The state as the base logic sees it: the personal copy's params
        and model state."""
        p = params if params is not None else state.params
        return dataclasses.replace(state, params=_subtree(p, PERSONAL),
                                   model_state=state.model_state[PERSONAL])

    def init_extra(self, params: Params):
        return self.base.init_extra(_subtree(params, PERSONAL))

    def augment(self, batch: Batch, rng_key, ctx: _DittoWrapCtx) -> Batch:
        """The base logic's train-time augmentation, forwarded."""
        return self.base.augment(batch, rng_key, ctx.base_ctx)

    def init_round_context(self, state: TrainState, payload) -> _DittoWrapCtx:
        params = _payload_params(payload)
        received = _subtree(params, GLOBAL)
        # the base logic reads the received global copy as its payload
        return _DittoWrapCtx(base_ctx=self.base.init_round_context(self._view(state), received),
                             received_global=received,
                             drift_penalty_weight=_drift_weight(payload, self.lam, params))

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: _DittoWrapCtx):
        if self.criterion is not None:
            global_loss = self.criterion(preds["global"], batch.y, batch.example_mask)
        else:
            # a criterion-less base trains the global copy with its own loss
            global_params = _subtree(params, GLOBAL)
            global_loss, _ = self.base.training_loss(
                preds["_global_preds"], features["global"], batch, global_params,
                dataclasses.replace(state, params=global_params,
                                    model_state=state.model_state[GLOBAL]), ctx.base_ctx)
        personal_params = _subtree(params, PERSONAL)
        personal_loss, personal_extra = self.base.training_loss(
            preds["_personal_preds"], features["personal"], batch, personal_params,
            self._view(state, params), ctx.base_ctx)
        penalty = 0.5 * weight_drift_loss(personal_params, ctx.received_global,
                                          ctx.drift_penalty_weight)
        out = {"global_loss": global_loss, "penalty": penalty}
        out.update({f"personal_{k}": v for k, v in personal_extra.items()})
        return global_loss + personal_loss + penalty, out

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        loss, extra = self.base.eval_loss(
            preds["_personal_preds"], features["personal"], batch,
            _subtree(params, PERSONAL), self._view(state, params),
            _base_ctx(ctx, _DittoWrapCtx))
        return loss, {f"personal_{k}": v for k, v in extra.items()}

    def transform_gradients(self, grads: Params, state: TrainState,
                            ctx: _DittoWrapCtx) -> Params:
        personal = self.base.transform_gradients(_subtree(grads, PERSONAL),
                                                 self._view(state), ctx.base_ctx)
        return {**grads, **_prefixed(personal, PERSONAL)}

    def _merge_hook(self, state: TrainState, new_view: TrainState) -> TrainState:
        # the hooks move extra and the key; the params stay with the step
        return dataclasses.replace(state, extra=new_view.extra, rng=new_view.rng)

    def update_before_step(self, state, ctx: _DittoWrapCtx, batch):
        return self._merge_hook(
            state, self.base.update_before_step(self._view(state), ctx.base_ctx, batch))

    def update_after_step(self, state, ctx: _DittoWrapCtx, batch, preds=None):
        base_preds = None if preds is None else preds["_personal_preds"]
        return self._merge_hook(state, self.base.update_after_step(
            self._view(state), ctx.base_ctx, batch, base_preds))

    def finalize_round(self, state, ctx: _DittoWrapCtx, local_steps):
        return self._merge_hook(state, self.base.finalize_round(
            self._view(state), ctx.base_ctx, local_steps))

    def pack(self, state: TrainState, pushed_params, train_losses):
        if not self.adaptive:
            return pushed_params
        return AdaptiveConstraintPacket(params=pushed_params,
                                        loss_for_adaptation=train_losses["global_loss"])


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class _MrMtlWrapCtx:
    base_ctx: Any
    initial_params: Params
    drift_penalty_weight: Any


class MrMtlPersonalizedLogic(ClientLogic):
    """``base`` plus the drift penalty toward the received aggregate; pair
    with ``KeepLocalExchanger`` so the local weights are never
    overwritten. On a plain base it is ``MrMtlClientLogic`` under other
    loss-key names (``base_loss`` for ``vanilla``)."""

    def __init__(self, base: ClientLogic, lam: float = 1.0, adaptive: bool = False):
        super().__init__(base.model, base.criterion)
        self.base = base
        self.lam = lam
        self.adaptive = adaptive
        # the base's keys are namespaced: a base's own "penalty" (FedProx)
        # must not shadow the drift penalty
        self.extra_loss_keys = ("base_loss", "penalty") + tuple(
            f"base_{k}" for k in getattr(base, "extra_loss_keys", ()))
        self.eval_loss_keys = tuple(getattr(base, "eval_loss_keys", ()))

    def init_extra(self, params: Params):
        return self.base.init_extra(params)

    def augment(self, batch: Batch, rng_key, ctx) -> Batch:
        return self.base.augment(batch, rng_key, _base_ctx(ctx, _MrMtlWrapCtx))

    def init_round_context(self, state: TrainState, payload) -> _MrMtlWrapCtx:
        params = _payload_params(payload)
        return _MrMtlWrapCtx(base_ctx=self.base.init_round_context(state, payload),
                             initial_params=params,
                             drift_penalty_weight=_drift_weight(payload, self.lam, params))

    def predict(self, params, model_state, batch, rng=None, train=False, extra=None,
                ctx=None):
        return self.base.predict(params, model_state, batch, rng, train, extra=extra,
                                 ctx=_base_ctx(ctx, _MrMtlWrapCtx))

    def training_loss(self, preds, features, batch: Batch, params, state,
                      ctx: _MrMtlWrapCtx):
        base_loss, base_extra = self.base.training_loss(preds, features, batch, params,
                                                        state, ctx.base_ctx)
        penalty = 0.5 * weight_drift_loss(params, ctx.initial_params,
                                          ctx.drift_penalty_weight)
        out = {"base_loss": base_loss, "penalty": penalty}
        out.update({f"base_{k}": v for k, v in base_extra.items()})
        return base_loss + penalty, out

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        return self.base.eval_loss(preds, features, batch, params, state,
                                   _base_ctx(ctx, _MrMtlWrapCtx))

    def transform_gradients(self, grads, state, ctx: _MrMtlWrapCtx):
        return self.base.transform_gradients(grads, state, ctx.base_ctx)

    def update_before_step(self, state, ctx: _MrMtlWrapCtx, batch):
        return self.base.update_before_step(state, ctx.base_ctx, batch)

    def update_after_step(self, state, ctx: _MrMtlWrapCtx, batch, preds=None):
        return self.base.update_after_step(state, ctx.base_ctx, batch, preds)

    def finalize_round(self, state, ctx: _MrMtlWrapCtx, local_steps):
        return self.base.finalize_round(state, ctx.base_ctx, local_steps)

    def pack(self, state: TrainState, pushed_params, train_losses):
        if not self.adaptive:
            return pushed_params
        return AdaptiveConstraintPacket(params=pushed_params,
                                        loss_for_adaptation=train_losses["base_loss"])


def make_it_personal(base: ClientLogic, mode: PersonalizedMode, lam: float = 1.0,
                     adaptive: bool = False) -> ClientLogic:
    """``base`` wrapped into its personalised variant. Wire the matching
    exchanger: ``FixedLayerExchanger(exchange_global_subtree)`` for DITTO,
    ``KeepLocalExchanger()`` for MR_MTL (exported here)."""
    # a base that computes its own gradients (DP's clip and noise) or, for
    # Ditto, runs its own forward would be bypassed silently: refuse it
    if type(base).value_and_grads is not ClientLogic.value_and_grads:
        raise TypeError(
            f"make_it_personal cannot wrap {type(base).__name__}: it overrides "
            "value_and_grads (e.g. DP per-example gradients), which the "
            "personalization wrapper would silently discard. Compose DP with "
            "the dedicated client instead (e.g. DittoClientLogic + "
            "InstanceLevelDpMixin).")
    if mode is PersonalizedMode.DITTO:
        if type(base).predict is not ClientLogic.predict:
            raise TypeError(
                f"make_it_personal(DITTO) cannot wrap {type(base).__name__}: "
                "it overrides predict; the twin forward calls the base MODEL "
                "directly, so a bespoke forward (APFL/GPFL-style) would be "
                "bypassed. Those logics are already personalized by design.")
        return DittoPersonalizedLogic(base, lam=lam, adaptive=adaptive)
    if mode is PersonalizedMode.MR_MTL:
        return MrMtlPersonalizedLogic(base, lam=lam, adaptive=adaptive)
    raise ValueError(f"unknown personalization mode: {mode}")


__all__ = [
    "PersonalizedMode",
    "make_it_personal",
    "DittoPersonalizedLogic",
    "MrMtlPersonalizedLogic",
    "twin_model_def",
    "exchange_global_subtree",
    "KeepLocalExchanger",
]
