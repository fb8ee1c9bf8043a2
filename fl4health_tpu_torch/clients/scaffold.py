"""SCAFFOLD client logic (counterpart of ``fl4health_tpu/clients/scaffold.py``):
control-variate-corrected local SGD.

- Each step's gradient is corrected, ``g <- g - c_i + c``
  (``transform_gradients``).
- After the round's local steps, option II of the variate update:
  ``c_i+ = c_i - c + (x - y_i) / (K lr)`` and ``delta_c_i = c_i+ - c_i``,
  where K is the client's own count of real steps (padding steps moved
  nothing, so an uneven client divides by its own K).
- The packet carries the weights and ``delta_c_i``.

Pair it with ``optim.sgd(learning_rate)``: the variate update assumes plain
SGD at that rate. Under the client vmap ``c`` is shared (the payload) and
``c_i`` is per client (``TrainState.extra``); a non-participant's ``extra``
rolls back through ``client_fit``'s mask.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.clients.engine import ClientLogic, TrainState
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import ControlVariatesPacket


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ScaffoldExtra:
    client_variates: Params  # c_i
    delta: Params  # delta_c_i of the last finished round


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ScaffoldContext:
    initial_params: Params  # x, the received global model
    server_variates: Params  # c


class ScaffoldClientLogic(ClientLogic):
    def __init__(self, model, criterion, learning_rate: float):
        super().__init__(model, criterion)
        self.learning_rate = learning_rate

    def init_extra(self, params: Params) -> ScaffoldExtra:
        zeros = ptu.tree_zeros_like(params)
        return ScaffoldExtra(client_variates=zeros, delta=zeros)

    def init_round_context(self, state: TrainState, payload) -> ScaffoldContext:
        return ScaffoldContext(initial_params=payload.params,
                               server_variates=payload.control_variates)

    def transform_gradients(self, grads: Params, state: TrainState,
                            ctx: ScaffoldContext) -> Params:
        ci, c = state.extra.client_variates, ctx.server_variates
        return {k: g - ci[k] + c[k] for k, g in grads.items()}

    def finalize_round(self, state: TrainState, ctx: ScaffoldContext,
                       local_steps: torch.Tensor) -> TrainState:
        k_lr = torch.clamp(local_steps.float(), min=1.0) * self.learning_rate
        ci, c, x = state.extra.client_variates, ctx.server_variates, ctx.initial_params
        new_ci = {k: ci[k] - c[k] + (x[k] - y) / k_lr for k, y in state.params.items()}
        return dataclasses.replace(state, extra=ScaffoldExtra(
            client_variates=new_ci, delta=ptu.tree_sub(new_ci, ci)))

    def pack(self, state: TrainState, pushed_params, train_losses) -> ControlVariatesPacket:
        return ControlVariatesPacket(params=pushed_params,
                                     control_variates=state.extra.delta)
