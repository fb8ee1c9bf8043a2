"""Client sampling (counterpart of ``fl4health_tpu/server/client_manager.py``):
a manager maps ``(key, round)`` to a ``[clients]`` f32 0/1 participation
mask on the key's device, drawn through ``rng.py`` exactly as the JAX
manager draws it from the same key.

Each manager exposes ``fraction``, the configured per-round sampling
fraction q, which the DP strategies and servers read at setup so the q they
account for is the q actually sampled.

Cohort-slot execution (``server/registry.py``) adds an index view:
``sample_indices(key, round, slots) -> ([slots] int32 numpy ids, valid)``,
the ascending registry ids of the sampled clients padded to a fixed slot
count with the first valid id, drawn on the key's device and read on the
host. For ``FullParticipationManager``, ``PoissonSamplingManager`` and
``FixedSamplingManager`` its first ``valid`` ids are the mask's nonzeros;
``FixedFractionManager``'s view takes the k clients with the smallest
uniform draws (``np.argpartition``), its own stream, as in JAX. The first
three of those also have ``draw_cohort(key, round, slots) -> ([slots]
int32 ids, int32 valid)``, the same draw as tensor ops on the key's device
with no host copy (the chunked cohort route's in-graph draw), equal to
``sample_indices`` unless a tie of uniform draws falls on
``FixedFractionManager``'s k-th place (``argsort`` is stable there, the
host's ``argpartition`` is not); the chunked route checks the two agree.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fl4health_tpu_torch import rng


class CohortOverflowError(ValueError):
    """A draw selected more clients than the cohort's slots hold
    (``CohortConfig(slots=K)``): raised rather than truncating the cohort,
    which would bias the trajectory and the DP accounting."""


def _fraction_floor(fraction: float, n: int) -> int:
    """``floor(fraction * n)`` with an epsilon guard: ``0.7 * 10`` is
    ``6.999999999999999`` in binary and must floor to 7."""
    return int(math.floor(fraction * n + 1e-9))


def _mask_of(ids: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.float32, device=ids.device)
    mask[ids] = 1.0
    return mask


def _pack_ids_in_graph(ids_sorted: torch.Tensor, valid: torch.Tensor,
                       slots: int) -> torch.Tensor:
    """``_pack_indices``' padding as tensor ops: keep the first ``valid``
    ascending ids, pad the rest with the first valid id (0 for an empty
    draw). ``valid`` is a tensor, so an overflow cannot raise here: the
    host view, which stages every round's data, raises, and the chunked
    route checks that both draws agree."""
    ids_sorted = ids_sorted.to(torch.int32)
    first = torch.where(valid > 0, ids_sorted[0], 0).to(torch.int32)
    if ids_sorted.shape[0] < slots:
        ids_sorted = torch.cat([ids_sorted, ids_sorted.new_zeros(slots - ids_sorted.shape[0])])
    keep = torch.arange(slots, dtype=torch.int32, device=ids_sorted.device) < valid
    return torch.where(keep, ids_sorted[:slots], first)


def _pack_indices(chosen: np.ndarray, slots: int, scheme: str) -> tuple[np.ndarray, int]:
    """A drawn id set as the fixed ``[slots]`` plan: ascending ids first,
    the rest padded with the first valid id (the pad slots carry
    participation weight 0); an empty draw pads with id 0."""
    chosen = np.asarray(chosen)
    valid = int(chosen.shape[0])
    if valid > slots:
        raise CohortOverflowError(
            f"{scheme} drew {valid} clients but the cohort has only "
            f"{slots} slots; raise CohortConfig(slots=...) above the "
            "scheme's worst-case draw (or lower its fraction)")
    out = np.zeros((slots,), np.int32)
    out[:valid] = np.sort(chosen).astype(np.int32)
    if 0 < valid < slots:
        out[valid:] = out[0]
    return out, valid


def _host_uniform(key: torch.Tensor, round_idx: int, n: int) -> np.ndarray:
    return rng.uniform(rng.fold_in(key, round_idx), (n,)).cpu().numpy()


class ClientManager:
    def __init__(self, n_clients: int):
        self.n_clients = n_clients

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        raise NotImplementedError

    def sample_indices(self, key: torch.Tensor, round_idx: int,
                       slots: int) -> tuple[np.ndarray, int]:
        """The cohort-slot plan ``([slots] int32 registry ids, valid)``: the
        mask's nonzeros, ascending, padded with the first; more than
        ``slots`` raises ``CohortOverflowError``."""
        mask = self.sample(key, round_idx).cpu().numpy()
        return _pack_indices(np.nonzero(mask > 0)[0], slots, type(self).__name__)

    # A manager whose draw is pure tensor code of (key, round) also defines
    # ``draw_cohort(key, round_idx, slots) -> ([slots] int32 ids, int32
    # valid)``, equal to ``sample_indices``; the base class does not, so a
    # cohort run under any other manager takes the pipelined route.

    def sample_all(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.ones((self.n_clients,), dtype=torch.float32, device=device)


class FullParticipationManager(ClientManager):
    """Every client every round."""

    fraction = 1.0

    def sample(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        return self.sample_all(key.device)

    def sample_indices(self, key, round_idx, slots):
        return _pack_indices(np.arange(self.n_clients, dtype=np.int32), slots,
                             type(self).__name__)

    def draw_cohort(self, key, round_idx, slots):
        # no draw: the overflow is known from the shapes alone
        if self.n_clients > slots:
            raise CohortOverflowError(
                f"FullParticipationManager needs slots >= n_clients "
                f"({self.n_clients}); got slots={slots}")
        sl = torch.arange(slots, dtype=torch.int32, device=key.device)
        ids = torch.where(sl < self.n_clients, sl, 0)
        return ids, torch.tensor(self.n_clients, dtype=torch.int32, device=key.device)


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

    def sample_indices(self, key, round_idx, slots):
        # the k clients with the smallest uniform draws: the same
        # distribution as the mask's permutation, not the same subset
        u = _host_uniform(key, round_idx, self.n_clients)
        if self.k >= self.n_clients:
            chosen = np.arange(self.n_clients)
        else:
            chosen = np.argpartition(u, self.k)[: self.k]
        return _pack_indices(chosen, slots, type(self).__name__)

    def draw_cohort(self, key, round_idx, slots):
        # the k smallest of the same uniform draws, through a stable
        # argsort (jnp.argsort's order): equal to the host view's
        # argpartition set unless a tie falls on the k-th place
        if self.k > slots:
            raise CohortOverflowError(
                f"FixedFractionManager draws k={self.k} clients but the "
                f"cohort has only {slots} slots")
        k = torch.tensor(self.k, dtype=torch.int32, device=key.device)
        if self.k >= self.n_clients:
            chosen = torch.arange(self.n_clients, dtype=torch.int32, device=key.device)
        else:
            u = rng.uniform(rng.fold_in(key, round_idx), (self.n_clients,))
            chosen = torch.sort(torch.argsort(u, stable=True)[: self.k]).values
        return _pack_ids_in_graph(chosen, k, slots), k


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

    def sample_indices(self, key, round_idx, slots):
        # the mask's own uniform draws, read on the host
        u = _host_uniform(key, round_idx, self.n_clients)
        mask = u < np.float32(self.fraction)
        if self.min_clients > 0:
            threshold = np.sort(u)[self.min_clients - 1]
            mask = mask | (u <= threshold)
        return _pack_indices(np.nonzero(mask)[0], slots, type(self).__name__)

    def draw_cohort(self, key, round_idx, slots):
        # the selected ids sorted to the front through a sentinel key; an
        # overflow clamps ``valid`` here (the host view raises first)
        n = self.n_clients
        mask = self.sample(key, round_idx) > 0
        ids = torch.arange(n, dtype=torch.int32, device=key.device)
        ids_sorted = torch.sort(torch.where(mask, ids, n)).values
        valid = torch.clamp(mask.sum().to(torch.int32), max=slots)
        return _pack_ids_in_graph(ids_sorted, valid, slots), valid


class FixedSamplingManager(ClientManager):
    """Draw ``max(1, floor(fraction * n))`` clients once, from the first
    key it is given (not folded with the round), and reuse them every round
    until ``reset_sample``. The first call of either view (``sample`` or the
    inherited ``sample_indices``) fixes the sample."""

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
