"""Parameter packets (counterpart of ``fl4health_tpu/exchange/packer.py``:
``ControlVariatesPacket``, ``ClippingBitPacket`` and
``AdaptiveConstraintPacket``): a packet is a dataclass whose fields keep their
structure, so the simulation stacks it over clients like any tree."""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ControlVariatesPacket:
    """SCAFFOLD payload: the weights and the control variates (the server's
    ``c`` going out, shared by every client; a client's ``delta_c_i``
    coming back)."""

    params: Params
    control_variates: Params


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ClippingBitPacket:
    """Client-level DP payload: the clipped update and the clipping bit (a
    0/1 f32 scalar)."""

    params: Params
    clipping_bit: torch.Tensor


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveConstraintPacket:
    """FedProx-family payload: the weights and the client's un-penalised
    train loss, which the server's drift-penalty adaptation reads."""

    params: Params
    loss_for_adaptation: torch.Tensor
