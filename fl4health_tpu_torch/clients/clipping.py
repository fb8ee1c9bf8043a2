"""Client-level DP clipping client (counterpart of
``fl4health_tpu/clients/clipping.py``): after local training the client
takes its update ``delta = w_local - w_received``, clips it as one flat
vector to the bound C the server sent (``factor = min(1, C / ||delta||)``)
and sends the clipped delta with a clipping bit. The bit follows the
reference: 1 when the norm is at or below the bound (the server's adaptive
bound estimates ``P(||delta|| <= C)``), and 0 always when adaptive clipping
is off, so the bit leaks no norm it is not needed for.

The clip is ``global_norm`` and a scale, as in JAX; no DP kernel is on this
path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.clients.engine import ClientLogic, TrainState
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import ClippingBitPacket


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ClippingContext:
    initial_params: Params
    clipping_bound: torch.Tensor


class ClippingClientLogic(ClientLogic):
    def __init__(self, model, criterion, adaptive_clipping: bool = False):
        super().__init__(model, criterion)
        self.adaptive_clipping = adaptive_clipping

    def init_round_context(self, state: TrainState, payload: Any) -> ClippingContext:
        return ClippingContext(initial_params=state.params,
                               clipping_bound=payload.clipping_bound)

    def init_extra(self, params: Params):
        return {"delta": ptu.tree_zeros_like(params),
                "clipping_bit": torch.zeros((), dtype=torch.float32,
                                            device=next(iter(params.values())).device)}

    def finalize_round(self, state: TrainState, ctx: ClippingContext,
                       local_steps: torch.Tensor) -> TrainState:
        delta = ptu.tree_sub(state.params, ctx.initial_params)
        norm = ptu.global_norm(delta)
        bound = torch.as_tensor(ctx.clipping_bound, dtype=torch.float32,
                                device=norm.device)
        factor = torch.clamp(bound / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = ptu.tree_scale(delta, factor)
        bit = (norm <= bound).to(torch.float32)
        if not self.adaptive_clipping:
            bit = torch.zeros_like(bit)  # leak no norm when the bound is fixed
        return dataclasses.replace(state, extra={"delta": clipped, "clipping_bit": bit})

    def pack(self, state: TrainState, pushed_params: Params,
             train_losses: dict) -> ClippingBitPacket:
        # finalize_round stashed the clipped delta and the bit
        return ClippingBitPacket(params=state.extra["delta"],
                                 clipping_bit=state.extra["clipping_bit"])
