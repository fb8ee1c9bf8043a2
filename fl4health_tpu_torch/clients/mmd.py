"""MMD-regularised personalisation clients (counterpart of
``fl4health_tpu/clients/mmd.py``): Ditto and MR-MTL with an MK-MMD or a
deep-kernel MMD penalty between the local model's features and the
features the round's frozen target model gives on the same batch.

- Ditto's target is the received global model, run through the
  single-branch ``feature_model`` with the round-start snapshot of the
  global branch's model state; MR-MTL's is the received aggregate through
  the logic's own model.
- MK-MMD's kernel weights (betas, in ``extra["mkmmd_betas"]``) are
  re-optimised on the step's batch: every step before the loss at
  interval -1, every ``beta_global_update_interval`` steps after the
  optimizer at a positive interval (first after the second step, as the
  reference's counter), never at 0. The deep-kernel variants train their
  kernels (``extra["deep_mmd"]``) the same way under
  ``mmd_kernel_train_interval``.
- The refresh is computed on every step and selected by ``torch.where``
  on the step's condition, as JAX's ``lax.cond`` runs under the client
  vmap (both branches, then a select): a host ``if`` on a tensor would
  break the vmap.

Every statistic reads ``batch.example_mask``: padded rows never count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients.ditto import (DittoClientLogic, DittoContext,
                                                MrMtlClientLogic, MrMtlContext, _subtree)
from fl4health_tpu_torch.clients.engine import Batch, ModelDef, TrainState
from fl4health_tpu_torch.core.pytree import tree_dataclass, tree_map
from fl4health_tpu_torch.losses.mmd import (DeepMmd, default_gammas, mkmmd,
                                            optimize_betas, uniform_betas)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _branch_state(model_state: Any, branch: str) -> Any:
    """A twin model's collections cut down to one branch, for the
    single-branch feature model (its ``batch_stats``)."""
    if not model_state:
        return {}
    return {coll: tree[branch] for coll, tree in model_state.items() if branch in tree}


def _select(cond: torch.Tensor, new, old):
    """``new`` where ``cond`` holds, else ``old``, leaf by leaf."""
    return tree_map(lambda n, o: torch.where(cond, n, o), new, old)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class DittoMmdContext(DittoContext):
    round_start_step: Any = 0
    # the round-start model state, so the frozen target is frozen in its
    # statistics too
    initial_model_state: Any = None


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MrMtlMmdContext(MrMtlContext):
    round_start_step: Any = 0
    initial_model_state: Any = None


def _interval_due(state: TrainState, ctx, batch: Batch, interval: int) -> torch.Tensor:
    """Whether a positive interval's refresh runs after this step: the
    hook sees the incremented step, the reference's counter the one before,
    so it first fires after the second real step."""
    step_in_round = state.step - ctx.round_start_step  # 1-based at hook time
    return ((step_in_round - 2) % interval == 0) & (batch.step_mask > 0)


class _MkMmdMixin:
    """The betas in ``extra``, their refresh, the per-key penalty sum and
    the optional feature-l2 penalty."""

    def _init_mkmmd(self, feature_keys: Sequence[str], mkmmd_weight: float,
                    beta_interval: int, gammas, normalize_features: bool,
                    feature_l2_norm_weight: float):
        self.feature_keys = tuple(feature_keys)
        self.mkmmd_weight = mkmmd_weight
        self.beta_interval = beta_interval
        # None: the reference's bank, built on the step's device; a given
        # bank is read on the device it is given on (a copy to another
        # device inside the step waits for the stream)
        self.gammas = None if gammas is None else torch.as_tensor(gammas)
        self.normalize_features = normalize_features
        self.feature_l2_norm_weight = feature_l2_norm_weight
        if beta_interval < -1:
            raise ValueError("beta_global_update_interval must be -1, 0 or positive")

    def _gammas_on(self, device: torch.device) -> torch.Tensor:
        return default_gammas(device) if self.gammas is None else self.gammas.to(device)

    def _init_betas(self, device) -> dict:
        k = (default_gammas() if self.gammas is None else self.gammas).shape[0]
        return {key: uniform_betas(k, device) for key in self.feature_keys}

    def init_extra(self, params):
        return {"mkmmd_betas": self._init_betas(next(iter(params.values())).device)}

    def _mkmmd_penalty(self, local_feats: Mapping[str, torch.Tensor],
                       target_feats: Mapping[str, torch.Tensor],
                       betas: Mapping[str, torch.Tensor], mask: torch.Tensor):
        total = torch.zeros((), dtype=torch.float32, device=mask.device)
        gammas = self._gammas_on(mask.device)
        for key in self.feature_keys:
            total = total + mkmmd(_flat(local_feats[key]), _flat(target_feats[key]).detach(),
                                  betas[key], gammas,
                                  normalize_features=self.normalize_features, mask=mask)
        return total

    def _feature_l2_penalty(self, local_feats: Mapping[str, torch.Tensor],
                            mask: torch.Tensor) -> torch.Tensor:
        """The average feature l2 norm."""
        f = _flat(local_feats[self.feature_keys[0]]) * mask[:, None]
        return torch.linalg.vector_norm(f) / torch.clamp(mask.sum(), min=1.0)

    def _optimized_betas(self, state: TrainState, ctx, batch: Batch) -> dict:
        local_f, target_f = self._mmd_features(state, ctx, batch)
        gammas = self._gammas_on(batch.example_mask.device)
        return {key: optimize_betas(_flat(local_f[key]), _flat(target_f[key]), gammas,
                                    normalize_features=self.normalize_features,
                                    mask=batch.example_mask)
                for key in self.feature_keys}

    def _refreshed(self, state: TrainState, ctx, batch: Batch, due: torch.Tensor):
        betas = _select(due, self._optimized_betas(state, ctx, batch),
                        state.extra["mkmmd_betas"])
        return dataclasses.replace(state, extra={**state.extra, "mkmmd_betas": betas})

    def update_before_step(self, state: TrainState, ctx, batch: Batch) -> TrainState:
        """Interval -1: re-optimise the betas on every batch before the loss
        reads them."""
        if self.mkmmd_weight == 0 or self.beta_interval != -1:
            return state
        return self._refreshed(state, ctx, batch, batch.step_mask > 0)

    def update_after_step(self, state: TrainState, ctx, batch: Batch,
                          preds=None) -> TrainState:
        """A positive interval: refresh the betas at the step interval."""
        if self.mkmmd_weight == 0 or self.beta_interval <= 0:
            return state
        return self._refreshed(state, ctx, batch,
                               _interval_due(state, ctx, batch, self.beta_interval))

    def _with_mkmmd(self, total, parts, local_feats, target_feats, state, batch):
        mmd = self._mkmmd_penalty(local_feats, target_feats, state.extra["mkmmd_betas"],
                                  batch.example_mask)
        parts["mkmmd"] = mmd
        total = total + self.mkmmd_weight * mmd
        if self.feature_l2_norm_weight != 0:
            l2 = self._feature_l2_penalty(local_feats, batch.example_mask)
            parts["feature_l2_norm"] = l2
            total = total + self.feature_l2_norm_weight * l2
        return total, parts


class _DittoFeatures:
    """Ditto's features: the personal branch and the frozen received
    global model, both through the single-branch ``feature_model``."""

    def init_round_context(self, state: TrainState, payload) -> DittoMmdContext:
        base = DittoClientLogic.init_round_context(self, state, payload)
        return DittoMmdContext(initial_global_params=base.initial_global_params,
                               drift_penalty_weight=base.drift_penalty_weight,
                               round_start_step=state.step,
                               initial_model_state=state.model_state)

    def _frozen_global_features(self, ctx, batch: Batch) -> dict:
        (_, feats), _ = self.feature_model.apply(
            ctx.initial_global_params, _branch_state(ctx.initial_model_state, "global_model"),
            batch.x, train=False)
        return feats

    def _mmd_features(self, state: TrainState, ctx, batch: Batch):
        (_, pfeats), _ = self.feature_model.apply(
            _subtree(state.params, "personal_model"),
            _branch_state(state.model_state, "personal_model"), batch.x, train=False)
        return pfeats, self._frozen_global_features(ctx, batch)

    def _local_and_target(self, features, ctx, batch: Batch):
        local = {k: features[f"personal_{k}"] for k in self.feature_keys}
        return local, self._frozen_global_features(ctx, batch)


class _MrMtlFeatures:
    """MR-MTL's features: the model, and the frozen received aggregate
    through the same model."""

    def init_round_context(self, state: TrainState, payload) -> MrMtlMmdContext:
        base = MrMtlClientLogic.init_round_context(self, state, payload)
        return MrMtlMmdContext(initial_params=base.initial_params,
                               drift_penalty_weight=base.drift_penalty_weight,
                               round_start_step=state.step,
                               initial_model_state=state.model_state)

    def _frozen_features(self, ctx, batch: Batch) -> dict:
        (_, feats), _ = self.model.apply(ctx.initial_params, ctx.initial_model_state,
                                         batch.x, train=False)
        return feats

    def _mmd_features(self, state: TrainState, ctx, batch: Batch):
        (_, feats), _ = self.model.apply(state.params, state.model_state, batch.x,
                                         train=False)
        return feats, self._frozen_features(ctx, batch)

    def _local_and_target(self, features, ctx, batch: Batch):
        return {k: features[k] for k in self.feature_keys}, self._frozen_features(ctx, batch)


class DittoMkMmdClientLogic(_MkMmdMixin, _DittoFeatures, DittoClientLogic):
    """Ditto + MK-MMD feature alignment. ``model`` is the ``TwinModel``;
    ``feature_model`` the single-branch model that runs the frozen received
    global params for the target features."""

    extra_loss_keys = ("global_ce", "personal_ce", "penalty", "mkmmd")

    def __init__(self, model: ModelDef, criterion, feature_model: ModelDef,
                 lam: float = 1.0, mkmmd_loss_weight: float = 10.0,
                 feature_keys: Sequence[str] = ("features",),
                 beta_global_update_interval: int = 20,
                 gammas=None, normalize_features: bool = True,
                 feature_l2_norm_weight: float = 0.0,
                 adaptive: bool = False):
        DittoClientLogic.__init__(self, model, criterion, lam=lam, adaptive=adaptive)
        self.feature_model = feature_model
        self._init_mkmmd(feature_keys, mkmmd_loss_weight, beta_global_update_interval,
                         gammas, normalize_features, feature_l2_norm_weight)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, parts = DittoClientLogic.training_loss(self, preds, features, batch, params,
                                                      state, ctx)
        local, target = self._local_and_target(features, ctx, batch)
        return self._with_mkmmd(total, parts, local, target, state, batch)


class MrMtlMkMmdClientLogic(_MkMmdMixin, _MrMtlFeatures, MrMtlClientLogic):
    """MR-MTL + MK-MMD alignment to the frozen aggregate."""

    extra_loss_keys = ("vanilla", "penalty", "mkmmd")

    def __init__(self, model: ModelDef, criterion, lam: float = 1.0,
                 mkmmd_loss_weight: float = 10.0,
                 feature_keys: Sequence[str] = ("features",),
                 beta_global_update_interval: int = 20,
                 gammas=None, normalize_features: bool = True,
                 feature_l2_norm_weight: float = 0.0,
                 adaptive: bool = False):
        MrMtlClientLogic.__init__(self, model, criterion, lam=lam, adaptive=adaptive)
        self._init_mkmmd(feature_keys, mkmmd_loss_weight, beta_global_update_interval,
                         gammas, normalize_features, feature_l2_norm_weight)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, parts = MrMtlClientLogic.training_loss(self, preds, features, batch, params,
                                                      state, ctx)
        local, target = self._local_and_target(features, ctx, batch)
        return self._with_mkmmd(total, parts, local, target, state, batch)


# ---------------------------------------------------------------------------
# Deep-kernel MMD variants
# ---------------------------------------------------------------------------

class _DeepMmdMixin:
    """One learned kernel a feature key in ``extra["deep_mmd"]``, trained
    under ``mmd_kernel_train_interval``: -1 on every batch before the loss,
    0 never, N every N steps (on the step's batch)."""

    def _init_deep_mmd(self, feature_sizes: Mapping[str, int], weight: float,
                       lr: float, hidden_size: int, output_size: int,
                       optimization_steps: int, train_interval: int):
        self.deep_mmd_weight = weight
        self.kernel_train_interval = train_interval
        if train_interval < -1:
            raise ValueError("mmd_kernel_train_interval must be -1, 0 or positive")
        self.feature_keys = tuple(feature_sizes.keys())
        self.kernels = {key: DeepMmd(size, hidden_size=hidden_size, output_size=output_size,
                                     lr=lr, optimization_steps=optimization_steps)
                        for key, size in feature_sizes.items()}

    def _init_kernel_states(self, key: torch.Tensor) -> dict:
        keys = rng.split(key, max(len(self.feature_keys), 1))
        return {k: self.kernels[k].init(keys[i]) for i, k in enumerate(self.feature_keys)}

    def init_extra(self, params):
        device = next(iter(params.values())).device
        return {"deep_mmd": self._init_kernel_states(rng.PRNGKey(self._seed, device))}

    def _deep_mmd_penalty(self, local_feats, target_feats, kernel_states,
                          mask: torch.Tensor):
        total = torch.zeros((), dtype=torch.float32, device=mask.device)
        for key in self.feature_keys:
            total = total + self.kernels[key].value(
                kernel_states[key], _flat(local_feats[key]),
                _flat(target_feats[key]).detach(), mask=mask)
        return total

    def _trained_kernels(self, state: TrainState, ctx, batch: Batch) -> dict:
        local_f, target_f = self._mmd_features(state, ctx, batch)
        key = rng.fold_in_many(state.rng, state.step)
        return {k: self.kernels[k].train(state.extra["deep_mmd"][k], _flat(local_f[k]),
                                         _flat(target_f[k]), rng.fold_in(key, i),
                                         mask=batch.example_mask)
                for i, k in enumerate(self.feature_keys)}

    def _refreshed(self, state: TrainState, ctx, batch: Batch, due: torch.Tensor):
        kernels = _select(due, self._trained_kernels(state, ctx, batch),
                          state.extra["deep_mmd"])
        return dataclasses.replace(state, extra={**state.extra, "deep_mmd": kernels})

    def update_before_step(self, state: TrainState, ctx, batch: Batch) -> TrainState:
        """Interval -1: train the kernels on this batch before the loss."""
        if self.deep_mmd_weight == 0 or self.kernel_train_interval != -1:
            return state
        return self._refreshed(state, ctx, batch, batch.step_mask > 0)

    def update_after_step(self, state: TrainState, ctx, batch: Batch,
                          preds=None) -> TrainState:
        """A positive interval: train the kernels every N steps."""
        if self.deep_mmd_weight == 0 or self.kernel_train_interval <= 0:
            return state
        return self._refreshed(state, ctx, batch,
                               _interval_due(state, ctx, batch, self.kernel_train_interval))

    def _with_deep_mmd(self, total, parts, local_feats, target_feats, state, batch):
        mmd = self._deep_mmd_penalty(local_feats, target_feats, state.extra["deep_mmd"],
                                     batch.example_mask)
        parts["deep_mmd"] = mmd
        return total + self.deep_mmd_weight * mmd, parts


class DittoDeepMmdClientLogic(_DeepMmdMixin, _DittoFeatures, DittoClientLogic):
    """Ditto + deep-kernel MMD. ``feature_sizes`` maps each feature key to
    its flattened width."""

    extra_loss_keys = ("global_ce", "personal_ce", "penalty", "deep_mmd")

    def __init__(self, model: ModelDef, criterion, feature_model: ModelDef,
                 feature_sizes: Mapping[str, int], lam: float = 1.0,
                 deep_mmd_loss_weight: float = 10.0, lr: float = 0.001,
                 hidden_size: int = 10, output_size: int = 50,
                 optimization_steps: int = 5,
                 mmd_kernel_train_interval: int = 20,
                 adaptive: bool = False, seed: int = 0):
        DittoClientLogic.__init__(self, model, criterion, lam=lam, adaptive=adaptive)
        self.feature_model = feature_model
        self._seed = seed
        self._init_deep_mmd(feature_sizes, deep_mmd_loss_weight, lr, hidden_size,
                            output_size, optimization_steps, mmd_kernel_train_interval)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, parts = DittoClientLogic.training_loss(self, preds, features, batch, params,
                                                      state, ctx)
        local, target = self._local_and_target(features, ctx, batch)
        return self._with_deep_mmd(total, parts, local, target, state, batch)


class MrMtlDeepMmdClientLogic(_DeepMmdMixin, _MrMtlFeatures, MrMtlClientLogic):
    """MR-MTL + deep-kernel MMD."""

    extra_loss_keys = ("vanilla", "penalty", "deep_mmd")

    def __init__(self, model: ModelDef, criterion,
                 feature_sizes: Mapping[str, int], lam: float = 1.0,
                 deep_mmd_loss_weight: float = 10.0, lr: float = 0.001,
                 hidden_size: int = 10, output_size: int = 50,
                 optimization_steps: int = 5,
                 mmd_kernel_train_interval: int = 20,
                 adaptive: bool = False, seed: int = 0):
        MrMtlClientLogic.__init__(self, model, criterion, lam=lam, adaptive=adaptive)
        self._seed = seed
        self._init_deep_mmd(feature_sizes, deep_mmd_loss_weight, lr, hidden_size,
                            output_size, optimization_steps, mmd_kernel_train_interval)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, parts = MrMtlClientLogic.training_loss(self, preds, features, batch, params,
                                                      state, ctx)
        local, target = self._local_and_target(features, ctx, batch)
        return self._with_deep_mmd(total, parts, local, target, state, batch)
