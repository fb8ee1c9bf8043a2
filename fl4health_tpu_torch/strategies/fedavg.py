"""FedAvg — weighted/unweighted parameter averaging (counterpart of
``fl4health_tpu/strategies/fedavg.py``)."""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedAvgState:
    params: Params


class FedAvg(Strategy):
    def __init__(self, weighted_aggregation: bool = True):
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> FedAvgState:
        return FedAvgState(params=params)

    def aggregate(self, server_state: FedAvgState, results: FitResults,
                  round_idx: int) -> FedAvgState:
        new_params = agg.aggregate(results.packets, results.sample_counts,
                                   mask=results.mask,
                                   weighted=self.weighted_aggregation)
        # an empty cohort (all-zero mask) keeps the previous params
        any_client = agg.client_total(results.mask) > 0
        new_params = {k: torch.where(any_client, v, server_state.params[k])
                      for k, v in new_params.items()}
        return dataclasses.replace(server_state, params=new_params)
