"""FedPCA, federated principal-component merging (counterpart of
``fl4health_tpu/strategies/fedpca.py``): a one-shot protocol in which
each client sends its top-k principal axes ``U_i`` ``[D, k]`` and
singular values ``S_i`` ``[k]``; the server stacks the ``S_i``-scaled axes
as rows and takes the SVD of the stack, whose leading right-singular
vectors are the merged subspace. Their signs are the solver's choice."""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class PcaPacket:
    components: torch.Tensor  # [D, k], the principal axes as columns
    singular_values: torch.Tensor  # [k]


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedPcaState:
    components: torch.Tensor
    singular_values: torch.Tensor


class FedPCA(Strategy):
    def __init__(self, n_components: int):
        self.n_components = n_components

    def init(self, params) -> FedPcaState:
        # params carries the shapes: {"components": [D, k], "singular_values": [k]}
        return FedPcaState(components=params["components"],
                           singular_values=params["singular_values"])

    def global_params(self, server_state: FedPcaState):
        return {"components": server_state.components,
                "singular_values": server_state.singular_values}

    def aggregate(self, server_state: FedPcaState, results: FitResults,
                  round_idx) -> FedPcaState:
        pk: PcaPacket = results.packets
        # [clients, D, k] * [clients, 1, k]: each client's scaled axes
        scaled = pk.components * pk.singular_values[:, None, :]
        scaled = scaled * results.mask.reshape(-1, 1, 1)
        n, d, k = scaled.shape
        stacked = scaled.permute(0, 2, 1).reshape(n * k, d)  # a row an axis
        _, s, vt = torch.linalg.svd(stacked, full_matrices=False)
        return FedPcaState(components=vt[:self.n_components].T,
                           singular_values=s[:self.n_components])
