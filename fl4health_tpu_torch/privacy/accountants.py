"""Instance-level FL privacy accountant (the port's own copy of the parts of
``fl4health_tpu/privacy/accountants.py`` that ``FlInstanceLevelAccountant``
uses: ``PoissonSampling`` and ``MomentsAccountant`` for one self-composed
event). Pure numpy/scipy on the host. The client-level accountants, the
trajectory composition and the full-participation rounds (DP-SCAFFOLD's
warm start) wait for the slices that use them.
"""

from __future__ import annotations

from math import ceil
from typing import Sequence

import numpy as np

from fl4health_tpu_torch.privacy import rdp as rdp_math


class PoissonSampling:
    """Each example (or client) joins a batch (or round) i.i.d. Bernoulli(q)."""

    def __init__(self, sampling_ratio: float):
        if not 0.0 <= sampling_ratio <= 1.0:
            raise ValueError("sampling_ratio must be in [0, 1]")
        self.sampling_ratio = sampling_ratio

    def step_rdp(self, noise_multiplier, orders):
        return rdp_math.rdp_poisson_subsampled_gaussian(
            self.sampling_ratio, noise_multiplier, orders
        )


class MomentsAccountant:
    """One (sampling, sigma, steps) event composed with itself; answers
    epsilon/delta queries."""

    def __init__(self, moment_orders: Sequence[float] | None = None):
        self.moment_orders = (
            list(moment_orders) if moment_orders is not None
            else rdp_math.default_orders()
        )

    def _total_rdp(self, sampling: PoissonSampling, noise_multiplier: float,
                   updates: int) -> np.ndarray:
        return updates * sampling.step_rdp(float(noise_multiplier), self.moment_orders)

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
    the max over clients."""

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
        self.accountant = MomentsAccountant(moment_orders)

    def _updates_for(self, rounds: int, n_batches: int) -> int:
        if self.steps_per_round is not None:
            return ceil(rounds * self.steps_per_round)
        return ceil(rounds * self.epochs_per_round * n_batches)

    def _per_client(self, fn, server_updates: int, value: float) -> float:
        return max(
            fn(sampling, self.noise_multiplier,
               self._updates_for(server_updates, n_batches), value)
            for n_batches, sampling in zip(self.num_batches_per_client,
                                           self.sampling_per_client))

    def get_epsilon(self, server_updates: int, delta: float) -> float:
        return self._per_client(self.accountant.get_epsilon, server_updates, delta)

    def get_delta(self, server_updates: int, epsilon: float) -> float:
        return self._per_client(self.accountant.get_delta, server_updates, epsilon)
