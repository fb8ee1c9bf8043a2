"""FLASH: server-side adaptive optimisation with a drift-aware third
moment (counterpart of ``fl4health_tpu/strategies/flash.py``):

    Delta_t = x_bar - x
    m_t = b1 m + (1 - b1) Delta
    v_t = b2 v + (1 - b2) Delta^2
    b3  = |v_{t-1}| / (|Delta^2 - v_t| + |v_{t-1}|)      (elementwise)
    d_t = b3 d_{t-1} + (1 - b3) (Delta^2 - v_t)
    x  += eta m_t / (sqrt(v_t) - d_t + tau)

An empty cohort keeps the params (the moments still move, as in JAX).
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FlashState:
    params: Params
    m: Params
    v: Params
    d: Params


class Flash(Strategy):
    def __init__(
        self,
        eta: float = 0.1,
        beta_1: float = 0.9,
        beta_2: float = 0.99,
        tau: float = 1e-3,
        weighted_aggregation: bool = True,
    ):
        self.eta = eta
        self.b1 = beta_1
        self.b2 = beta_2
        self.tau = tau
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> FlashState:
        z = ptu.tree_zeros_like(params)
        return FlashState(params=params, m=z, v=z, d=z)

    def aggregate(self, server_state: FlashState, results: FitResults,
                  round_idx: int) -> FlashState:
        x_bar = agg.aggregate(results.packets, results.sample_counts, results.mask,
                              self.weighted_aggregation)
        any_client = agg.client_total(results.mask) > 0
        params, m, v, d = {}, {}, {}, {}
        for k, x in server_state.params.items():
            delta = x_bar[k] - x
            m[k] = self.b1 * server_state.m[k] + (1 - self.b1) * delta
            v[k] = self.b2 * server_state.v[k] + (1 - self.b2) * torch.square(delta)
            gap = torch.square(delta) - v[k]
            v_prev = server_state.v[k].abs()
            b3 = v_prev / (gap.abs() + v_prev + 1e-12)
            d[k] = b3 * server_state.d[k] + (1 - b3) * gap
            x_t = x + self.eta * m[k] / (torch.sqrt(v[k]) - d[k] + self.tau)
            params[k] = torch.where(any_client, x_t, x)
        return FlashState(params=params, m=m, v=v, d=d)
