"""FL privacy accountants (the port's own copy of
``fl4health_tpu/privacy/accountants.py``): sampling strategies, a moments
accountant that composes one self-composed event or a trajectory of
events, the instance-level accountant (with the full-participation rounds
of DP-SCAFFOLD's warm start) and the two client-level ones. Pure
numpy/scipy on the host.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from math import ceil
from typing import Sequence

import numpy as np

from fl4health_tpu_torch.privacy import rdp as rdp_math


class SamplingStrategy(ABC):
    """How examples or clients enter a batch or round; selects the RDP
    formula."""

    @abstractmethod
    def step_rdp(self, noise_multiplier: float, orders: Sequence[float]) -> np.ndarray:
        ...


class PoissonSampling(SamplingStrategy):
    """Each example (or client) joins a batch (or round) i.i.d. Bernoulli(q)."""

    def __init__(self, sampling_ratio: float):
        if not 0.0 <= sampling_ratio <= 1.0:
            raise ValueError("sampling_ratio must be in [0, 1]")
        self.sampling_ratio = sampling_ratio

    def step_rdp(self, noise_multiplier, orders):
        return rdp_math.rdp_poisson_subsampled_gaussian(
            self.sampling_ratio, noise_multiplier, orders
        )


class FixedSamplingWithoutReplacement(SamplingStrategy):
    """Exactly ``sample_size`` of ``population_size`` drawn per step."""

    def __init__(self, population_size: int, sample_size: int):
        self.population_size = population_size
        self.sample_size = sample_size

    def step_rdp(self, noise_multiplier, orders):
        return rdp_math.rdp_sampled_without_replacement_gaussian(
            self.population_size, self.sample_size, noise_multiplier, orders
        )


class MomentsAccountant:
    """Compose (sampling, sigma, steps) events; answer epsilon/delta
    queries. Scalar arguments are one self-composed event; lists are a
    trajectory composed in sequence (a scalar broadcasts along it)."""

    def __init__(self, moment_orders: Sequence[float] | None = None):
        self.moment_orders = (
            list(moment_orders) if moment_orders is not None
            else rdp_math.default_orders()
        )

    def _total_rdp(
        self,
        sampling: SamplingStrategy | Sequence[SamplingStrategy],
        noise_multiplier: float | Sequence[float],
        updates: int | Sequence[int],
    ) -> np.ndarray:
        if isinstance(sampling, SamplingStrategy):
            sampling = [sampling]
        n = max(
            len(sampling),
            len(noise_multiplier) if not isinstance(noise_multiplier, (int, float)) else 1,
            len(updates) if not isinstance(updates, int) else 1,
        )
        if isinstance(noise_multiplier, (int, float)):
            noise_multiplier = [float(noise_multiplier)] * n
        if isinstance(updates, int):
            updates = [updates] * n
        if len(sampling) == 1 and n > 1:
            sampling = list(sampling) * n
        if not (len(sampling) == len(noise_multiplier) == len(updates)):
            raise ValueError("trajectory lists must have equal length")
        total = np.zeros(len(self.moment_orders), dtype=np.float64)
        for strat, sigma, steps in zip(sampling, noise_multiplier, updates):
            total = total + steps * strat.step_rdp(sigma, self.moment_orders)
        return total

    def get_epsilon(self, sampling, noise_multiplier, updates, delta: float) -> float:
        rdp = self._total_rdp(sampling, noise_multiplier, updates)
        return rdp_math.epsilon_from_rdp(self.moment_orders, rdp, delta)

    def get_delta(self, sampling, noise_multiplier, updates, epsilon: float) -> float:
        rdp = self._total_rdp(sampling, noise_multiplier, updates)
        return rdp_math.delta_from_rdp(self.moment_orders, rdp, epsilon)


class FlInstanceLevelAccountant:
    """Instance-level DP across FL rounds: Poisson sampling at BOTH levels —
    the per-step inclusion probability of a data point on client c is
    client_sampling_rate * (batch_c / dataset_c); total steps = rounds *
    steps_per_round (or epochs_per_round * batches_per_epoch_c); epsilon is
    the max over clients. ``full_participation_rounds`` are rounds in which
    every client touched its data (DP-SCAFFOLD's warm start): they compose
    at rate batch_c / dataset_c, without the client-sampling
    amplification."""

    def __init__(
        self,
        client_sampling_rate: float,
        noise_multiplier: float,
        epochs_per_round: int | None,
        client_batch_sizes: Sequence[int],
        client_dataset_sizes: Sequence[int],
        moment_orders: Sequence[float] | None = None,
        steps_per_round: int | None = None,
    ):
        if len(client_batch_sizes) != len(client_dataset_sizes):
            raise ValueError("batch/dataset size lists must align")
        if (epochs_per_round is None) == (steps_per_round is None):
            raise ValueError("specify exactly one of epochs_per_round / steps_per_round")
        self.noise_multiplier = noise_multiplier
        self.epochs_per_round = epochs_per_round
        self.steps_per_round = steps_per_round
        self.num_batches_per_client = [
            ceil(d / b) for b, d in zip(client_batch_sizes, client_dataset_sizes)
        ]
        self.sampling_per_client = [
            PoissonSampling(client_sampling_rate * b / d)
            for b, d in zip(client_batch_sizes, client_dataset_sizes)
        ]
        self.full_sampling_per_client = [
            PoissonSampling(b / d) for b, d in zip(client_batch_sizes, client_dataset_sizes)
        ]
        self.accountant = MomentsAccountant(moment_orders)

    def _updates_for(self, rounds: int, n_batches: int) -> int:
        if self.steps_per_round is not None:
            return ceil(rounds * self.steps_per_round)
        return ceil(rounds * self.epochs_per_round * n_batches)

    def _per_client(self, fn, server_updates: int, value: float,
                    full_participation_rounds: int = 0) -> float:
        results = []
        for n_batches, sampling, full_sampling in zip(
                self.num_batches_per_client, self.sampling_per_client,
                self.full_sampling_per_client):
            total = self._updates_for(server_updates, n_batches)
            if full_participation_rounds:
                # the subsampled rounds and the full ones, composed as a
                # trajectory (added in RDP space)
                extra = self._updates_for(full_participation_rounds, n_batches)
                results.append(fn([sampling, full_sampling], self.noise_multiplier,
                                  [total, extra], value))
            else:
                results.append(fn(sampling, self.noise_multiplier, total, value))
        return max(results)

    def get_epsilon(self, server_updates: int, delta: float,
                    full_participation_rounds: int = 0) -> float:
        return self._per_client(self.accountant.get_epsilon, server_updates, delta,
                                full_participation_rounds)

    def get_delta(self, server_updates: int, epsilon: float,
                  full_participation_rounds: int = 0) -> float:
        return self._per_client(self.accountant.get_delta, server_updates, epsilon,
                                full_participation_rounds)


class ClientLevelAccountant(ABC):
    """Client-level DP: each round is one subsampled-Gaussian query over the
    client population."""

    def __init__(
        self,
        noise_multiplier: float | Sequence[float],
        moment_orders: Sequence[float] | None = None,
    ):
        self.noise_multiplier = noise_multiplier
        self.accountant = MomentsAccountant(moment_orders)

    @abstractmethod
    def _sampling(self) -> SamplingStrategy | Sequence[SamplingStrategy]:
        ...

    def get_epsilon(self, server_updates: int | Sequence[int], delta: float) -> float:
        return self.accountant.get_epsilon(
            self._sampling(), self.noise_multiplier, server_updates, delta
        )

    def get_delta(self, server_updates: int | Sequence[int], epsilon: float) -> float:
        return self.accountant.get_delta(
            self._sampling(), self.noise_multiplier, server_updates, epsilon
        )


class FlClientLevelAccountantPoissonSampling(ClientLevelAccountant):
    """Clients join each round i.i.d. Bernoulli(q)."""

    def __init__(
        self,
        client_sampling_rate: float | Sequence[float],
        noise_multiplier: float | Sequence[float],
        moment_orders: Sequence[float] | None = None,
    ):
        super().__init__(noise_multiplier, moment_orders)
        self.client_sampling_rate = client_sampling_rate

    def _sampling(self):
        if isinstance(self.client_sampling_rate, (int, float)):
            return PoissonSampling(float(self.client_sampling_rate))
        return [PoissonSampling(float(q)) for q in self.client_sampling_rate]


class FlClientLevelAccountantFixedSamplingNoReplacement(ClientLevelAccountant):
    """Exactly n of N clients sampled per round."""

    def __init__(
        self,
        n_total_clients: int,
        n_clients_sampled: int | Sequence[int],
        noise_multiplier: float | Sequence[float],
        moment_orders: Sequence[float] | None = None,
    ):
        super().__init__(noise_multiplier, moment_orders)
        self.n_total_clients = n_total_clients
        self.n_clients_sampled = n_clients_sampled

    def _sampling(self):
        if isinstance(self.n_clients_sampled, int):
            return FixedSamplingWithoutReplacement(
                self.n_total_clients, self.n_clients_sampled
            )
        return [
            FixedSamplingWithoutReplacement(self.n_total_clients, n)
            for n in self.n_clients_sampled
        ]
