"""Client sampling (counterpart of ``fl4health_tpu/server/client_manager.py``):
a manager maps ``(key, round)`` to a ``[clients]`` f32 0/1 participation
mask on the key's device, drawn through ``rng.py`` exactly as the JAX
manager draws it from the same key.

Each manager exposes ``fraction``, the configured per-round sampling
fraction q, which the DP strategies and servers read at setup so the q they
account for is the q actually sampled. The cohort-slot views
(``sample_indices``, ``draw_cohort``) wait for the cohort execution mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fl4health_tpu_torch import rng


def _fraction_floor(fraction: float, n: int) -> int:
    """``floor(fraction * n)`` with an epsilon guard: ``0.7 * 10`` is
    ``6.999999999999999`` in binary and must floor to 7."""
    return int(math.floor(fraction * n + 1e-9))


def _mask_of(ids: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.float32, device=ids.device)
    mask[ids] = 1.0
    return mask


class ClientManager:
    def __init__(self, n_clients: int):
        self.n_clients = n_clients

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        raise NotImplementedError

    def sample_all(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.ones((self.n_clients,), dtype=torch.float32, device=device)


class FullParticipationManager(ClientManager):
    """Every client every round."""

    fraction = 1.0

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        return self.sample_all(key.device)


class FixedFractionManager(ClientManager):
    """``floor(fraction * n)`` clients (at least ``min_clients``) uniformly
    without replacement, drawn anew each round: the first k of a random
    permutation."""

    def __init__(self, n_clients: int, fraction: float, min_clients: int = 1):
        super().__init__(n_clients)
        if min_clients > n_clients:
            raise ValueError(f"min_clients={min_clients} exceeds n_clients={n_clients}")
        self.fraction = fraction
        self.min_clients = min_clients
        self.k = min(n_clients, max(min_clients, _fraction_floor(fraction, n_clients)))

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        perm = rng.permutation(rng.fold_in(key, round_idx), self.n_clients)
        return _mask_of(perm[: self.k], self.n_clients)


class PoissonSamplingManager(ClientManager):
    """Each client joins i.i.d. Bernoulli(fraction); the cohort may be
    empty. ``min_clients`` > 0 tops it up with the clients of the smallest
    uniform draws (a superset of the Bernoulli successes), which breaks the
    Poisson assumption the DP accountants compose with."""

    def __init__(self, n_clients: int, fraction: float, min_clients: int = 0):
        super().__init__(n_clients)
        if not 0 <= min_clients <= n_clients:
            raise ValueError(f"min_clients must be in [0, {n_clients}]; got {min_clients}")
        self.fraction = fraction
        self.min_clients = min_clients

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        u = rng.uniform(rng.fold_in(key, round_idx), (self.n_clients,))
        # JAX compares the f32 draws with the fraction rounded to f32
        mask = u < float(np.float32(self.fraction))
        if self.min_clients > 0:
            threshold = torch.sort(u).values[self.min_clients - 1]
            mask = mask | (u <= threshold)
        return mask.to(torch.float32)


class FixedSamplingManager(ClientManager):
    """Draw ``max(1, floor(fraction * n))`` clients once, from the first
    key it is given (not folded with the round), and reuse them every round
    until ``reset_sample``."""

    def __init__(self, n_clients: int, fraction: float = 1.0):
        super().__init__(n_clients)
        self.fraction = fraction
        self.k = max(1, _fraction_floor(fraction, n_clients))
        self._cached: torch.Tensor | None = None

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        if self._cached is None:
            perm = rng.permutation(key, self.n_clients)
            self._cached = _mask_of(perm[: self.k], self.n_clients)
        return self._cached

    def reset_sample(self) -> None:
        self._cached = None
