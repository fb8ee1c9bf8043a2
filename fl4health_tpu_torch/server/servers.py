"""Servers around the simulation (counterpart of the parts of
``fl4health_tpu/server/servers.py`` the port's slices use): the polling
protocol (``poll_clients``); per-client sample-count polling; SCAFFOLD's
warm start and ``ScaffoldServer``; ``FedPmServer``, ``FedProxServer``,
``DittoServer`` and ``MrMtlServer``; the instance-level, DP-SCAFFOLD and client-level DP
servers, which configure the matching accountant and return the run's
epsilon with its history; and the evaluate-only ``EvaluateServer`` and the
one-shot ``ModelMergeServer``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Mapping, Sequence

import torch

from fl4health_tpu_torch.parallel.compat import client_total
from fl4health_tpu_torch.privacy.accountants import (
    FlClientLevelAccountantFixedSamplingNoReplacement,
    FlClientLevelAccountantPoissonSampling, FlInstanceLevelAccountant)
from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager
from fl4health_tpu_torch.server.pipeline import HostPull
from fl4health_tpu_torch.server.simulation import FederatedSimulation
from fl4health_tpu_torch.strategies.base import replace_global_params
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint
from fl4health_tpu_torch.strategies.scaffold import Scaffold

logger = logging.getLogger(__name__)


def poll_clients(providers: Sequence[Callable[[Mapping[str, Any]], Mapping[str, Any]]],
                 request: Mapping[str, Any]) -> list[dict[str, Any]]:
    """``get_properties`` fan-out: each provider is a client's in-process
    properties handler, asked in turn."""
    return [dict(provider(request)) for provider in providers]


def poll_sample_counts(sim: FederatedSimulation) -> list[int]:
    """Every client's training-set size (an in-process property lookup)."""
    return [int(d.n_train) for d in sim.datasets]


def scaffold_warm_start(sim: FederatedSimulation) -> None:
    """SCAFFOLD's warm start: every client runs one round of local training
    on the round-0 index plan; the trained weights are discarded and the
    variates kept. With ``c = 0`` each client's variate becomes its average
    local gradient ``(x - y_i) / (K lr)``, and the server's ``c`` their mean.

    It calls the simulation's own ``fit_round`` once (the port's round
    function does not donate its inputs, so the pre-round states survive)
    and keeps only the clients' ``extra`` and the server's variates.
    Everything else rolls back: params, optimizer state, the clients' keys
    and step counts. It samples nothing, appends no ``RoundRecord`` and
    stages nothing in a ``RoundPrefetcher``, so round 1 afterwards draws
    the same keys and batches as a cold run's round 1. (JAX's
    ``_keep_warmed_variates`` also rolls back wrapper strategies'
    bookkeeping; the port has no wrapper strategies, so the server keeps
    its warmed state with the original params.)"""
    # the server's own params (under a mesh with tensor parallelism, this
    # rank's shards); the [C] mask, which a sharded round slices
    pre_params = sim.strategy.global_params(sim.server_state)
    mask = torch.ones((sim.n_clients,), dtype=torch.float32, device=sim.device)
    server_state, client_states, _, _, _ = sim._fit_round(
        sim.server_state, sim.client_states, sim._round_batches(0), mask, 0,
        sim._val_batches()[0])
    sim.client_states = dataclasses.replace(sim.client_states, extra=client_states.extra)
    sim.server_state = dataclasses.replace(server_state, params=pre_params)
    logger.info("SCAFFOLD warm start complete: control variates initialized from "
                "average local gradients; model weights unchanged.")


class ScaffoldServer:
    """Runs SCAFFOLD, with the warm start first when asked."""

    def __init__(self, sim: FederatedSimulation, warm_start: bool = False):
        assert isinstance(sim.strategy, Scaffold), (
            "ScaffoldServer requires the Scaffold strategy")
        self.sim = sim
        self.warm_start = warm_start

    def fit(self, n_rounds: int):
        if self.warm_start:
            scaffold_warm_start(self.sim)
        return self.sim.fit(n_rounds)


class FedPmServer:
    """FedPM's orchestration: the periodic Beta reset lives in
    ``strategies.fedpm.FedPm(reset_frequency=...)``; this wrapper asserts
    the pairing, then runs."""

    def __init__(self, sim: FederatedSimulation):
        from fl4health_tpu_torch.strategies.fedpm import FedPm

        assert isinstance(sim.strategy, FedPm), "FedPmServer requires the FedPm strategy"
        self.sim = sim

    def fit(self, n_rounds: int):
        return self.sim.fit(n_rounds)


class FedProxServer:
    """Asserts the adaptive-constraint strategy pairing, then runs."""

    def __init__(self, sim: FederatedSimulation):
        assert isinstance(sim.strategy, FedAvgWithAdaptiveConstraint), (
            "FedProxServer requires FedAvgWithAdaptiveConstraint")
        self.sim = sim

    def fit(self, n_rounds: int):
        return self.sim.fit(n_rounds)


class DittoServer(FedProxServer):
    """Ditto's server: the same adaptive-constraint pairing."""


class MrMtlServer(FedProxServer):
    """MR-MTL's server: the same adaptive-constraint pairing."""


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

    def setup_accountant(self, n_rounds: int | None = None) -> FlInstanceLevelAccountant:
        """The run's accountant; ``n_rounds`` is accepted and ignored, as in
        JAX (``get_epsilon`` takes the rounds)."""
        del n_rounds
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

    def fit(self, n_rounds: int, extra_full_participation_rounds: int = 0):
        """-> (history, epsilon) for ``n_rounds`` at the run's delta
        (default: 1 / the federation's total training samples, not 1 / the
        largest client's). ``extra_full_participation_rounds``: rounds of
        privacy budget in which every client touched its data, composed
        without the client-sampling amplification (DP-SCAFFOLD's warm
        start)."""
        accountant = self.setup_accountant(n_rounds)
        delta = self.delta if self.delta is not None else 1.0 / sum(
            poll_sample_counts(self.sim))
        epsilon = accountant.get_epsilon(
            n_rounds, delta, full_participation_rounds=extra_full_participation_rounds)
        logger.info("Instance-level DP run: epsilon=%.4f at delta=%.2e over %d rounds"
                    " (+%d full-participation)", epsilon, delta, n_rounds,
                    extra_full_participation_rounds)
        return self.sim.fit(n_rounds), epsilon


class DpScaffoldServer(InstanceLevelDpServer):
    """DP-SCAFFOLD: SCAFFOLD's warm start under the DP-SGD client, then
    instance-level DP accounting. The warm-start pass is a full DP-SGD
    sweep over private data whose variates are later exchanged, so it is
    charged as one full-participation round, as in JAX (the reference's
    server leaves it out).

    Known defect, shared with JAX: the warm start rolls the clients' keys
    back, so round 1 draws the warm start's noise again. The warm variates
    and round 1's update then carry the same noise sum, which their
    difference cancels, while the accountant composes the two as
    independent. The returned epsilon is the accountant's arithmetic, not
    a guarantee of a run with ``warm_start=True``, until the warm start
    draws its noise from a key of its own."""

    def __init__(self, sim: FederatedSimulation, noise_multiplier: float,
                 batch_size: int, warm_start: bool = False, **kwargs):
        assert isinstance(sim.strategy, Scaffold), (
            "DpScaffoldServer requires the Scaffold strategy")
        super().__init__(sim, noise_multiplier, batch_size, **kwargs)
        self.warm_start = warm_start

    def fit(self, n_rounds: int):
        if self.warm_start:
            scaffold_warm_start(self.sim)
        return super().fit(n_rounds,
                           extra_full_participation_rounds=1 if self.warm_start else 0)


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


# ---------------------------------------------------------------------------
# Evaluate-only and model-merge servers
# ---------------------------------------------------------------------------

class EvaluateServer:
    """One federated evaluation round: install ``params`` (a checkpoint's
    weights) as the global model, when given, broadcast it, evaluate on
    every client and aggregate. No training round runs."""

    def __init__(self, sim: FederatedSimulation, params=None):
        self.sim = sim
        self.params = params

    def fit(self):
        """-> (aggregated eval losses, aggregated eval metrics) as floats."""
        sim = self.sim
        if self.params is not None:
            # through any strategy wrapper (compression, quarantine)
            sim.server_state = replace_global_params(sim.strategy, sim.server_state,
                                                     self.params)
        val_batches, val_counts = sim._val_batches()
        # the round hands the client stack back with the pulled params
        sim.client_states, losses, metrics, *_ = sim._eval_round(
            sim.server_state, sim.client_states, val_batches, val_counts)
        host = HostPull((losses, metrics)).result()  # one transfer
        return ({k: float(v) for k, v in host[0].items()},
                {k: float(v) for k, v in host[1].items()})


class ModelMergeServer:
    """One-shot parameter merge and federated evaluation: the clients'
    current (locally trained) weights averaged uniformly, the merged model
    evaluated on every client."""

    def __init__(self, sim: FederatedSimulation):
        self.sim = sim

    def fit(self):
        """-> (merged params, eval losses, eval metrics)."""
        sim = self.sim
        n = float(sim.n_clients)
        # a program of the mesh: each rank sums its block, then all ranks'
        merged = sim._program_builder.jit(
            lambda stacked: {k: client_total(s) / n for k, s in stacked.items()})(
                sim.client_states.params)
        losses, metrics = EvaluateServer(sim, params=merged).fit()
        return merged, losses, metrics
