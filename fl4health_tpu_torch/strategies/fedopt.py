"""FedOpt family: server-side adaptive optimizers (counterpart of
``fl4health_tpu/strategies/fedopt.py``). The weighted client average gives
the pseudo-gradient ``params - avg``, which a server optimizer (any
``optim`` transform) applies to the global params.

The factories build their optimizer through ``optim.inject_hyperparams``,
as JAX does: the server learning rate is a 0-d tensor in
``opt_state.hyperparams["learning_rate"]``, while betas, eps and momentum
stay Python floats (a traced ``1 - b1`` rounds differently).
``state_sharding_spec`` names a ZeRO-sharded server optimizer's vector
leaves (``parallel/zero.py``, wired by ``MeshConfig(zero1=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@ptu.tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedOptState:
    params: Params
    opt_state: Any


class FedOpt(Strategy):
    """Server-optimizer strategy over the pseudo-gradient."""

    def __init__(self, tx: optim.GradientTransformation,
                 weighted_aggregation: bool = True):
        self.tx = tx
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> FedOptState:
        return FedOptState(params=params, opt_state=self.tx.init(params))

    def state_sharding_spec(self, server_state: FedOptState, clients_axis: str):
        """With a ZeRO-1/2 sharded server optimizer the optimizer's
        flat-vector state leaves split over its axis (each replica keeps
        1/N of the momenta); params and scalar counts replicate. Without
        one the whole state replicates (None)."""
        from fl4health_tpu_torch.parallel.mesh import P
        from fl4health_tpu_torch.parallel.zero import (Zero2ShardedOptimizer,
                                                        ZeroShardedOptimizer)

        if not isinstance(self.tx, (ZeroShardedOptimizer, Zero2ShardedOptimizer)):
            return None
        opt_spec = ptu.tree_map(
            lambda leaf: P(self.tx.axis_name) if getattr(leaf, "ndim", 0) >= 1 else P(),
            server_state.opt_state)
        return FedOptState(params=P(), opt_state=opt_spec)

    def aggregate(self, server_state: FedOptState, results: FitResults,
                  round_idx: int) -> FedOptState:
        avg = agg.aggregate(results.packets, results.sample_counts, results.mask,
                            self.weighted_aggregation)
        # pseudo-gradient: the descent direction is x - avg
        pseudo_grad = ptu.tree_sub(server_state.params, avg)
        updates, new_opt = self.tx.update(pseudo_grad, server_state.opt_state,
                                          server_state.params)
        new_params = optim.apply_updates(server_state.params, updates)
        # a round in which no client took part keeps the old state
        any_client = agg.client_total(results.mask) > 0
        new_params, new_opt = ptu.tree_map(
            lambda n, o: torch.where(any_client, n, o),
            (new_params, new_opt), (server_state.params, server_state.opt_state))
        return FedOptState(params=new_params, opt_state=new_opt)


def fed_adam(lr: float = 0.1, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3,
             weighted_aggregation: bool = True) -> FedOpt:
    """FedAdam (Reddi et al.'s defaults: tau = 1e-3)."""
    return FedOpt(optim.inject_hyperparams(optim.adam, static_args=("b1", "b2", "eps",
                                                                     "eps_root"))(
        learning_rate=lr, b1=b1, b2=b2, eps=eps), weighted_aggregation)


def fed_yogi(lr: float = 0.1, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3,
             weighted_aggregation: bool = True) -> FedOpt:
    return FedOpt(optim.inject_hyperparams(optim.yogi, static_args=("b1", "b2", "eps"))(
        learning_rate=lr, b1=b1, b2=b2, eps=eps), weighted_aggregation)


def fed_adagrad(lr: float = 0.1, eps: float = 1e-3,
                weighted_aggregation: bool = True) -> FedOpt:
    return FedOpt(optim.inject_hyperparams(
        optim.adagrad, static_args=("eps", "initial_accumulator_value"))(
        learning_rate=lr, eps=eps), weighted_aggregation)


def fed_avg_m(lr: float = 1.0, momentum: float = 0.9,
              weighted_aggregation: bool = True) -> FedOpt:
    """Server momentum (FedAvgM)."""
    return FedOpt(optim.inject_hyperparams(optim.sgd, static_args=("momentum", "nesterov"))(
        learning_rate=lr, momentum=momentum), weighted_aggregation)
