"""Servers around the simulation (counterpart of the parts of
``fl4health_tpu/server/servers.py`` the DP slices use): per-client
sample-count polling and the instance- and client-level DP servers, which
configure the matching accountant and return the run's epsilon with its
history.
"""

from __future__ import annotations

import logging

from fl4health_tpu_torch.privacy.accountants import (
    FlClientLevelAccountantFixedSamplingNoReplacement,
    FlClientLevelAccountantPoissonSampling, FlInstanceLevelAccountant)
from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager
from fl4health_tpu_torch.server.simulation import FederatedSimulation

logger = logging.getLogger(__name__)


def poll_sample_counts(sim: FederatedSimulation) -> list[int]:
    """Every client's training-set size (an in-process property lookup)."""
    return [int(d.n_train) for d in sim.datasets]


class InstanceLevelDpServer:
    """Instance-level DP orchestration: polls per-client sample counts,
    configures the FL instance-level accountant, and logs and returns epsilon
    for the run."""

    def __init__(self, sim: FederatedSimulation, noise_multiplier: float,
                 batch_size: int, local_epochs: int | None = None,
                 local_steps: int | None = None, delta: float | None = None):
        self.sim = sim
        self.noise_multiplier = noise_multiplier
        self.batch_size = batch_size
        self.local_epochs = local_epochs if local_epochs is not None else sim.local_epochs
        self.local_steps = local_steps if local_steps is not None else sim.local_steps
        self.delta = delta
        self.accountant: FlInstanceLevelAccountant | None = None

    def setup_accountant(self) -> FlInstanceLevelAccountant:
        counts = poll_sample_counts(self.sim)
        # client sampling ratio: the expected fraction of clients per round
        q_client = getattr(self.sim.client_manager, "fraction", 1.0)
        self.accountant = FlInstanceLevelAccountant(
            client_sampling_rate=q_client,
            noise_multiplier=self.noise_multiplier,
            epochs_per_round=self.local_epochs,
            client_batch_sizes=[self.batch_size] * len(counts),
            client_dataset_sizes=counts,
            steps_per_round=self.local_steps,
        )
        return self.accountant

    def fit(self, n_rounds: int):
        """-> (history, epsilon) for ``n_rounds`` at the run's delta
        (default: 1 / the federation's total training samples, not 1 / the
        largest client's)."""
        accountant = self.setup_accountant()
        delta = self.delta if self.delta is not None else 1.0 / sum(
            poll_sample_counts(self.sim))
        epsilon = accountant.get_epsilon(n_rounds, delta)
        logger.info("Instance-level DP run: epsilon=%.4f at delta=%.2e over %d rounds",
                    epsilon, delta, n_rounds)
        return self.sim.fit(n_rounds), epsilon


class ClientLevelDpFedAvgServer:
    """Client-level DP orchestration: the client-level accountant that
    matches the manager's sampling scheme (Poisson, else fixed-size without
    replacement at ``max(round(fraction * n), 1)`` clients), epsilon at
    delta = 1 / n_clients unless given, logged and returned with the
    history."""

    def __init__(self, sim: FederatedSimulation, noise_multiplier: float,
                 delta: float | None = None):
        self.sim = sim
        self.noise_multiplier = noise_multiplier
        self.delta = delta

    def _accountant(self):
        manager = self.sim.client_manager
        n = self.sim.n_clients
        fraction = getattr(manager, "fraction", 1.0)
        if isinstance(manager, PoissonSamplingManager):
            return FlClientLevelAccountantPoissonSampling(
                client_sampling_rate=fraction, noise_multiplier=self.noise_multiplier)
        return FlClientLevelAccountantFixedSamplingNoReplacement(
            n_total_clients=n, n_clients_sampled=max(int(round(fraction * n)), 1),
            noise_multiplier=self.noise_multiplier)

    def fit(self, n_rounds: int):
        """-> (history, epsilon) for ``n_rounds``."""
        accountant = self._accountant()
        delta = self.delta if self.delta is not None else 1.0 / self.sim.n_clients
        epsilon = accountant.get_epsilon(n_rounds, delta)
        logger.info("Client-level DP run: epsilon=%.4f at delta=%.2e over %d rounds",
                    epsilon, delta, n_rounds)
        return self.sim.fit(n_rounds), epsilon
