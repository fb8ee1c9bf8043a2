"""Instance-level DP client logic — per-example clipped and noised gradients
(counterpart of ``fl4health_tpu/clients/instance_level_dp.py``).

``InstanceLevelDpMixin`` overrides only ``value_and_grads``: the whole-batch
gradient becomes per-example gradients (``torch.func.vmap`` over singleton
batches) -> flat clip -> masked sum -> Gaussian noise (``privacy/dpsgd.py``).
The step's key splits into ``grad_rng, noise_rng`` as JAX's does; the noise
draws from ``noise_rng`` (the port's models draw nothing from
``grad_rng``).

As a mixin over the ``ClientLogic`` hooks it composes with SCAFFOLD
(``DpScaffoldClientLogic``): the engine applies ``transform_gradients``
(``g - c_i + c``) after this hook, to the clipped and noised mean, once a
step.

One departure from the JAX clients, by design: the clip and the sum always
take the fused route through the DP kernels (``use_fused_kernel=True``),
which the JAX clients, DP-SCAFFOLD's included, leave off. Both routes
compute the same function.
"""

from __future__ import annotations

from typing import Any

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic
from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.privacy import dpsgd


class InstanceLevelDpMixin:
    """Mix in BEFORE a ClientLogic subclass:

        class MyDpLogic(InstanceLevelDpMixin, MyLogic): ...

    kwargs consumed: ``clipping_bound`` (C), ``noise_multiplier`` (sigma).
    """

    # per-step statistics the simulation averages into the fit losses
    telemetry_loss_keys = ("clip_fraction",)

    def __init__(self, *args, clipping_bound: float, noise_multiplier: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.clipping_bound = float(clipping_bound)
        self.noise_multiplier = float(noise_multiplier)
        dpsgd.validate_dp_safe_model_state(self.model.module)

    def value_and_grads(self, state: TrainState, ctx: Any, batch: Batch,
                        step_rng: torch.Tensor):
        _, noise_rng = rng.split(step_rng)

        def single_loss(params, x1, y1):
            b1 = Batch(x=x1[None], y=y1[None],
                       example_mask=torch.ones((1,), dtype=torch.float32,
                                               device=batch.step_mask.device),
                       step_mask=batch.step_mask)
            (preds, features), _ = self.predict(params, state.model_state, b1, train=True,
                                                extra=state.extra, ctx=ctx)
            loss, additional = self.training_loss(preds, features, b1, params,
                                                  state, ctx)
            return loss, (preds, additional)

        grad_fn = torch.func.vmap(
            torch.func.grad_and_value(single_loss, has_aux=True),
            in_dims=(None, 0, 0))
        per_grads, (per_losses, (per_preds, per_additional)) = grad_fn(
            state.params, batch.x, batch.y)

        grads, clip_fraction = dpsgd.noisy_clipped_mean_grads(
            per_grads, batch.example_mask, noise_rng,
            self.clipping_bound, self.noise_multiplier,
            use_fused_kernel=True, return_clip_fraction=True,
        )

        m = batch.example_mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        backward = (per_losses * m).sum() / denom
        # composed logics' auxiliary losses are per-example scalars after
        # vmap: masked-average them back to batch scalars
        additional = tree_map(lambda v: (v * m).sum() / denom, per_additional)
        additional = {**additional, "clip_fraction": clip_fraction}
        # per-example predict ran on singleton batches: squeeze back to [B,...]
        preds = tree_map(lambda p: p[:, 0], per_preds)
        # no batch statistics (refused above): the model state stays
        return (backward, (preds, additional, state.model_state)), grads


class InstanceLevelDpClientLogic(InstanceLevelDpMixin, ClientLogic):
    """Plain FedAvg client with instance-level DP-SGD."""


class DpScaffoldClientLogic(InstanceLevelDpMixin, ScaffoldClientLogic):
    """DP-SCAFFOLD: noisy per-example gradients with the control-variate
    correction and variate updates."""
