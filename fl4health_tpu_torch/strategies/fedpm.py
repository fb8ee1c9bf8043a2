"""FedPM: Bayesian aggregation of binary parameter masks (counterpart of
``fl4health_tpu/strategies/fedpm.py``).

Clients train Bernoulli scores over frozen weights and send sampled binary
masks (``clients/fedpm.py``). The server keeps a Beta(alpha, beta)
posterior per parameter:

    alpha += sum_i m_i ;  beta += sum_i (1 - m_i)
    theta  = clip((alpha - 1) / max(alpha + beta - 2, 1e-12), 0, 1)

and broadcasts theta as the new global scores. With ``reset_frequency``
the posteriors return to Beta(1, 1) every that many rounds, after theta is
taken (the reference's ``FedPmServer`` reset). The sums over the masked
clients are sums of 0/1 values, exact in any order; under a mesh they are
the rank's partial sums all-reduced (``parallel/compat.py``
``client_total``).
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core.aggregate import client_total
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedPmState:
    params: Params  # the probability scores (theta)
    alpha: Params
    beta: Params
    rounds_since_reset: torch.Tensor


class FedPm(Strategy):
    def __init__(self, reset_frequency: int | None = None):
        """``reset_frequency``: reset the Beta posteriors to uniform every k
        rounds (the FedPmServer reset); None never resets."""
        self.reset_frequency = reset_frequency

    def init(self, params: Params) -> FedPmState:
        ones = {k: torch.ones_like(v, dtype=torch.float32) for k, v in params.items()}
        device = next(iter(params.values())).device
        return FedPmState(params=params, alpha=ones, beta=dict(ones),
                          rounds_since_reset=torch.zeros((), dtype=torch.int32, device=device))

    def aggregate(self, server_state: FedPmState, results: FitResults,
                  round_idx) -> FedPmState:
        masks, m = results.packets, results.mask

        def weighted(stacked: torch.Tensor) -> torch.Tensor:
            return stacked.to(torch.float32) * m.reshape((-1,) + (1,) * (stacked.ndim - 1))

        alpha = {k: a + client_total(weighted(masks[k]))
                 for k, a in server_state.alpha.items()}
        beta = {k: b + client_total(weighted(1.0 - masks[k].to(torch.float32)))
                for k, b in server_state.beta.items()}
        theta = {k: torch.clamp((alpha[k] - 1.0)
                                / torch.clamp(alpha[k] + beta[k] - 2.0, min=1e-12), 0.0, 1.0)
                 for k in alpha}
        rounds = server_state.rounds_since_reset + 1
        if self.reset_frequency is not None:
            reset = rounds >= self.reset_frequency
            alpha = {k: torch.where(reset, torch.ones_like(a), a) for k, a in alpha.items()}
            beta = {k: torch.where(reset, torch.ones_like(b), b) for k, b in beta.items()}
            rounds = torch.where(reset, torch.zeros_like(rounds), rounds)
        return FedPmState(params=theta, alpha=alpha, beta=beta, rounds_since_reset=rounds)
