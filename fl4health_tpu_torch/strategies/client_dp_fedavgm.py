"""Client-level DP-FedAvg with server momentum and adaptive clipping
(counterpart of ``fl4health_tpu/strategies/client_dp_fedavgm.py``, line for
line). Clients send their clipped update delta and a clipping bit
(``clients/clipping.py``). The server:

    delta_bar = (sum_i delta_i) / |S| + N(0, (z * C / |S|)^2)     [unweighted]
    v         = beta * v + delta_bar                               [momentum]
    x        += v
    b_bar     = (sum_i b_i + N(0, z_b^2)) / |S|                    [noised]
    C        *= exp(-lr_C * (b_bar - target_quantile))             [geometric]

Weighted aggregation (McMahan et al. 1710.06963), with the reference's final
1/|S|:

    w_k       = min(n_k / example_cap, 1)       (cap defaults to sum_k n_k)
    coef_k    = w_k / (q * W),  W = sum_k w_k,  q = fraction_fit
    delta_bar = (sum_{i in S} coef_i delta_i
                 + N(0, (z * C * max_{i in S} w_i / q)^2)) / |S|

Under adaptive clipping the update noise uses z_delta = (z^-2 - (2 z_b)^-2)^-1/2
(``effective_noise_multiplier``), so the accountant's z covers the noised
bit too. Sigma is computed from the pre-round bound C_t, and only then is the
bound updated to C_{t+1}: the JAX package's documented ordering.

The noise is the JAX strategy's stream: the state's key splits into
``(next, k_delta, k_bit)``, and ``k_delta`` draws one normal per leaf
(``dpsgd.gaussian_noise_like``: one key per leaf in JAX's leaf order),
through ``rng.py`` on the device the params live on.

``fraction_fit`` (q) defaults to None, derived from the client manager at
``bind_client_manager``; an explicit value must equal the manager's
fraction under weighted aggregation, since sigma scales with 1/q.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.aggregate import client_max, client_total, expand_clients
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import ClippingBitPacket
from fl4health_tpu_torch.privacy.dpsgd import gaussian_noise_like
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ClientDpFedAvgMState:
    params: Params
    momentum: Params
    clipping_bound: torch.Tensor
    rng: torch.Tensor


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ClippingPayload:
    params: Params
    clipping_bound: torch.Tensor


class ClientLevelDPFedAvgM(Strategy):
    def __init__(
        self,
        noise_multiplier: float = 1.0,
        server_momentum: float = 0.9,
        initial_clipping_bound: float = 0.1,
        adaptive_clipping: bool = False,
        bit_noise_multiplier: float = 1.0,
        clipping_learning_rate: float = 0.2,
        clipping_quantile: float = 0.5,
        weighted_aggregation: bool = False,
        fraction_fit: float | None = None,
        per_client_example_cap: float | None = None,
        seed: int = 0,
    ):
        self.z = noise_multiplier
        self.beta = server_momentum
        self.c0 = initial_clipping_bound
        self.adaptive = adaptive_clipping
        self.z_bit = bit_noise_multiplier
        self.lr_c = clipping_learning_rate
        self.quantile = clipping_quantile
        self.weighted_aggregation = weighted_aggregation
        self.fraction_fit = fraction_fit
        self.example_cap = per_client_example_cap
        self.seed = seed
        self.effective_noise_multiplier()  # fail at construction, not mid-round
        if (weighted_aggregation and fraction_fit is not None
                and not fraction_fit > 0.0):
            raise ValueError(
                f"fraction_fit must be positive, got {fraction_fit}: the "
                "weighted coefficients divide by it")

    def bind_client_manager(self, client_manager) -> None:
        """Derive (or check) the sampling fraction q from the client
        manager: with q < 1, a q of 1 would under-scale sigma by 1/q against
        the logged epsilon."""
        fraction = getattr(client_manager, "fraction", None)
        if self.fraction_fit is None:
            if self.weighted_aggregation and fraction is None:
                raise ValueError(
                    f"{type(client_manager).__name__} exposes no sampling "
                    "fraction; pass fraction_fit explicitly so the weighted "
                    "DP coefficients (and sigma) are scaled by the true q")
            if (self.weighted_aggregation and fraction is not None
                    and not float(fraction) > 0.0):
                raise ValueError(
                    f"client manager sampling fraction {float(fraction)} is "
                    "not positive; the weighted DP coefficients divide by it")
            self.fraction_fit = float(fraction) if fraction is not None else 1.0
        elif (self.weighted_aggregation and fraction is not None
              and not math.isclose(self.fraction_fit, float(fraction),
                                   rel_tol=1e-9, abs_tol=1e-12)):
            raise ValueError(
                f"fraction_fit={self.fraction_fit} does not match the client "
                f"manager's sampling fraction {float(fraction)}; with "
                "weighted_aggregation the coefficients divide by q, so a "
                "mismatch mis-scales sigma by their ratio vs the logged "
                "epsilon (omit fraction_fit to derive it from the manager)")

    @property
    def _q(self) -> float:
        """q in the weighted coefficients; 1.0 when never bound to a manager."""
        return 1.0 if self.fraction_fit is None else self.fraction_fit

    def effective_noise_multiplier(self) -> float:
        """The update-noise multiplier applied to delta_bar:
        z_delta = (z^-2 - (2 z_b)^-2)^(-1/2) under adaptive clipping with
        both multipliers positive, else z."""
        if not (self.adaptive and self.z > 0.0 and self.z_bit > 0.0):
            return self.z
        sqrt_arg = self.z ** -2.0 - (2.0 * self.z_bit) ** -2.0
        if sqrt_arg <= 0.0:
            raise ValueError(
                "noise_multiplier and bit_noise_multiplier are ill-related "
                f"for adaptive clipping: z^-2 - (2 z_b)^-2 = {sqrt_arg:.4g} "
                "<= 0; raise bit_noise_multiplier or lower noise_multiplier")
        return sqrt_arg ** -0.5

    def init(self, params: Params) -> ClientDpFedAvgMState:
        device = next(iter(params.values())).device
        return ClientDpFedAvgMState(
            params=params,
            momentum=ptu.tree_zeros_like(params),
            clipping_bound=torch.tensor(self.c0, dtype=torch.float32, device=device),
            rng=rng.PRNGKey(self.seed, device),
        )

    def client_payload(self, server_state, round_idx):
        return ClippingPayload(params=server_state.params,
                               clipping_bound=server_state.clipping_bound)

    def aggregate(self, server_state: ClientDpFedAvgMState, results: FitResults,
                  round_idx) -> ClientDpFedAvgMState:
        packets: ClippingBitPacket = results.packets
        mask = results.mask
        n_sampled = torch.clamp(client_total(mask), min=1.0)
        next_key, k_delta, k_bit = rng.split(server_state.rng, 3)
        z_eff = self.effective_noise_multiplier()

        if self.weighted_aggregation:
            # coefficients from capped sample counts over the whole
            # federation; noise scaled by the largest sampled coefficient
            counts = results.sample_counts.to(torch.float32)
            cap = (client_total(counts) if self.example_cap is None
                   else torch.tensor(self.example_cap, dtype=torch.float32,
                                     device=counts.device))
            w = torch.clamp(counts / torch.clamp(cap, min=1.0), max=1.0)
            total_w = torch.clamp(client_total(w), min=1e-12)
            coef = w / (self._q * total_w)
            cm = coef * mask
            delta_bar = {k: client_total(v * expand_clients(cm, v)) / n_sampled
                         for k, v in packets.params.items()}
            max_w = client_max(torch.where(mask > 0, w, torch.zeros_like(w)))
            # sensitivity of the coefficient-scaled sum is C max(w) / q; the
            # final 1/|S| applies to the noise too
            sigma = z_eff * server_state.clipping_bound * max_w / self._q / n_sampled
        else:
            delta_bar = {k: client_total(v * expand_clients(mask, v)) / n_sampled
                         for k, v in packets.params.items()}
            # Gaussian mechanism: sensitivity C / |S|
            sigma = z_eff * server_state.clipping_bound / n_sampled
        noise = gaussian_noise_like(k_delta, delta_bar, sigma)
        delta_bar = {k: v + noise[k] for k, v in delta_bar.items()}

        new_momentum = ptu.tree_axpy(self.beta, server_state.momentum, delta_bar)
        new_params = ptu.tree_add(server_state.params, new_momentum)

        any_client = client_total(mask) > 0
        bound = server_state.clipping_bound
        if self.adaptive:
            bit_sum = client_total(packets.clipping_bit * mask)
            b_bar = (bit_sum + self.z_bit * rng.normal(k_bit, ())) / n_sampled
            # an empty cohort's b_bar is pure noise: hold the bound
            bound = torch.where(
                any_client, bound * torch.exp(-self.lr_c * (b_bar - self.quantile)),
                bound)
        new_params, new_momentum = ptu.tree_map(
            lambda n, o: torch.where(any_client, n, o),
            (new_params, new_momentum),
            (server_state.params, server_state.momentum))
        return ClientDpFedAvgMState(params=new_params, momentum=new_momentum,
                                    clipping_bound=bound, rng=next_key)
