"""SCAFFOLD, the server half (counterpart of
``fl4health_tpu/strategies/scaffold.py``; the client is
``clients/scaffold.py``). The payload is the weights and the server's
control variates; the updates, over the round's cohort S of N clients:

    x <- x + server_lr * (mean_i(y_i) - x)      (unweighted)
    c <- c + (|S| / N) * mean_i(delta_c_i)

An empty cohort keeps both.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import ControlVariatesPacket
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ScaffoldState:
    params: Params
    control_variates: Params


class Scaffold(Strategy):
    """Aggregation is unweighted by the algorithm's design."""

    def __init__(self, learning_rate: float = 1.0):
        self.server_lr = learning_rate

    def init(self, params: Params) -> ScaffoldState:
        return ScaffoldState(params=params, control_variates=ptu.tree_zeros_like(params))

    def client_payload(self, server_state: ScaffoldState, round_idx: int):
        return ControlVariatesPacket(params=server_state.params,
                                     control_variates=server_state.control_variates)

    def aggregate(self, server_state: ScaffoldState, results: FitResults,
                  round_idx: int) -> ScaffoldState:
        packets: ControlVariatesPacket = results.packets
        y_bar = agg.aggregate(packets.params, results.sample_counts, results.mask,
                              weighted=False)
        delta_c_bar = agg.aggregate(packets.control_variates, results.sample_counts,
                                    results.mask, weighted=False)
        n_sampled = agg.client_total(results.mask.float())  # |S|, f32 as N below
        any_client = n_sampled > 0
        x, c = server_state.params, server_state.control_variates
        new_params = ptu.tree_axpy(self.server_lr, ptu.tree_sub(y_bar, x), x)
        new_c = ptu.tree_axpy(n_sampled / agg.client_count(results.mask.shape[0]),
                              delta_c_bar, c)
        keep = lambda n, o: torch.where(any_client, n, o)  # noqa: E731
        return ScaffoldState(params=ptu.tree_map(keep, new_params, x),
                             control_variates=ptu.tree_map(keep, new_c, c))
