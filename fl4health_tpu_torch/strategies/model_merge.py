"""Model merging, one-shot parameter averaging (counterpart of
``fl4health_tpu/strategies/model_merge.py``): the clients' locally trained
weights averaged once (uniform or weighted), evaluated by
``server/servers.py`` ``ModelMergeServer``."""

from __future__ import annotations

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy
from fl4health_tpu_torch.strategies.fedavg import FedAvgState


class ModelMergeStrategy(Strategy):
    def __init__(self, weighted: bool = False):
        self.weighted_aggregation = weighted

    def init(self, params: Params) -> FedAvgState:
        return FedAvgState(params=params)

    def aggregate(self, server_state: FedAvgState, results: FitResults,
                  round_idx: int) -> FedAvgState:
        merged = agg.aggregate(results.packets, results.sample_counts, results.mask,
                               self.weighted_aggregation)
        any_client = agg.client_total(results.mask) > 0
        return FedAvgState(params={k: torch.where(any_client, v, server_state.params[k])
                                   for k, v in merged.items()})
