"""Strategy abstraction (counterpart of ``fl4health_tpu/strategies/base.py``):
a strategy owns a server state and two functions, ``client_payload`` (what
every client receives) and ``aggregate`` (stacked client packets -> new
server state)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.core.types import Params


@dataclasses.dataclass(frozen=True)
class FitResults:
    """Stacked results of one fit round.

    packets:       client-stacked packets (params, or a logic's packet)
    sample_counts: [clients] train-set sizes
    train_losses:  dict of [clients] losses
    train_metrics: dict of [clients] metric values
    mask:          [clients] 1.0 = participated (and finished finite)
    """

    packets: Any
    sample_counts: torch.Tensor
    train_losses: Any
    train_metrics: Any
    mask: torch.Tensor


class Strategy:
    def bind_client_manager(self, client_manager: Any) -> None:
        """Setup-time hook: the simulation calls it once with its client
        manager, so a strategy can derive or check its sampling assumptions
        (DP-FedAvgM's ``fraction_fit``). Default: nothing."""

    def init(self, params: Params) -> Any:
        raise NotImplementedError

    def global_params(self, server_state: Any) -> Params:
        return server_state.params

    def client_payload(self, server_state: Any, round_idx: int) -> Any:
        return server_state.params

    def aggregate(self, server_state: Any, results: FitResults, round_idx: int) -> Any:
        raise NotImplementedError

    def update_after_eval(self, server_state: Any, eval_losses: Any,
                          eval_metrics: Any, mask: torch.Tensor) -> Any:
        return server_state
