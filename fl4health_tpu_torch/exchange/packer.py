"""Parameter packets (counterpart of ``fl4health_tpu/exchange/packer.py``):
a packet is a dataclass whose fields keep their structure, so the
simulation stacks it over clients like any tree. The partial-exchange
packets carry dense masks beside full-shaped params
(``LayerMaskPacket``, ``SparseMaskPacket``)."""

from __future__ import annotations

import dataclasses
from typing import Any

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


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class Packet:
    """A generic payload: the params and an optional auxiliary tree."""

    params: Params
    aux: Any = None


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class LayerMaskPacket:
    """Dynamic-layer payload: full-shaped params and a 0/1 f32 scalar per
    leaf marking the leaves the client sent (static shapes: every leaf
    rides, the mask says which count)."""

    params: Params
    leaf_mask: Params  # the params' keys, a 0-d 0/1 tensor each


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class SparseMaskPacket:
    """Sparse payload: the params and a dense 0/1 element mask per leaf
    (the reference's COO triples, in a shape that stacks over clients)."""

    params: Params
    element_mask: Params  # the params' shapes, 0/1


def packet_like(params: Params) -> Packet:
    return Packet(params=params, aux=None)


def full_leaf_mask(params: Params) -> Params:
    return {k: torch.ones((), dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def full_element_mask(params: Params) -> Params:
    return {k: torch.ones_like(p, dtype=torch.float32) for k, p in params.items()}
