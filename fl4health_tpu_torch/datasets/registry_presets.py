"""Large-N non-IID registry presets (counterpart of
``fl4health_tpu/datasets/registry_presets.py``, the same numpy code, so
both packages give the same index arrays): the label-Dirichlet
heterogeneity of ``DirichletLabelBasedAllocation`` as an
``IndexedPoolSource``, one shared example pool and per-client index arrays
that are views into one owner-sorted permutation. A registry of 10^5
clients costs the pool once plus N index rows; a client's shard is copied
out only when the cohort samples it.

Usage::

    source = cifar_dirichlet_registry(100_000, pool_size=50_000, beta=0.5)
    sim = FederatedSimulation(..., datasets=source,
                              cohort=CohortConfig(slots=64),
                              client_manager=FixedFractionManager(100_000, 64 / 100_000))
"""

from __future__ import annotations

import numpy as np

from fl4health_tpu_torch.datasets import vision
from fl4health_tpu_torch.server.registry import IndexedPoolSource


def dirichlet_registry_source(
    x: np.ndarray,
    y: np.ndarray,
    n_clients: int,
    *,
    beta: float = 0.5,
    val_fraction: float = 0.2,
    seed: int = 0,
    min_train: int = 1,
    min_val: int = 1,
) -> IndexedPoolSource:
    """Label-Dirichlet allocation of a pooled ``(x, y)`` dataset over
    ``n_clients`` registry clients, WITHOUT densifying the shards.

    Per label, a Dirichlet(``beta``) draw over clients sets that label's
    allocation and each of its rows is assigned to a client by one
    vectorized categorical draw — the
    ``DirichletLabelBasedAllocation`` heterogeneity model, re-expressed
    as an ownership vector instead of N materialized partitions. Clients
    too small to hold ``min_train + min_val`` rows are topped up with
    uniformly-drawn pool rows (shared, view-only duplicates — with
    ``n_clients`` approaching or exceeding the pool size some sharing is
    unavoidable and is disclosed here rather than failing).

    Deterministic in ``seed``. Returns an :class:`IndexedPoolSource`
    whose index arrays are views into one owner-sorted permutation."""
    x, y = np.asarray(x), np.asarray(y)
    n = y.shape[0]
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1; got {n_clients}")
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(
            f"val_fraction must be in (0, 1); got {val_fraction}"
        )
    rng = np.random.default_rng(seed)
    owner = np.empty((n,), np.int64)
    for label in np.unique(y):
        rows = np.nonzero(y == label)[0]
        # one Dirichlet draw per label = that label's client allocation;
        # one vectorized categorical draw assigns its rows
        p = rng.dirichlet(np.full((n_clients,), float(beta)))
        owner[rows] = rng.choice(n_clients, size=rows.size, p=p)
    order = np.argsort(owner, kind="stable")
    sorted_owner = owner[order]
    client_range = np.arange(n_clients)
    starts = np.searchsorted(sorted_owner, client_range, side="left")
    ends = np.searchsorted(sorted_owner, client_range, side="right")
    need = min_train + min_val
    train_idx: list[np.ndarray] = []
    val_idx: list[np.ndarray] = []
    for c in range(n_clients):
        seg = order[starts[c]:ends[c]]  # a VIEW into the one permutation
        if seg.size < need:
            seg = np.concatenate(
                [seg, rng.integers(0, n, size=need - seg.size)]
            )
        n_val = min(max(min_val, int(round(seg.size * val_fraction))),
                    seg.size - min_train)
        val_idx.append(seg[:n_val])
        train_idx.append(seg[n_val:])
    return IndexedPoolSource((x, y), (x, y), train_idx, val_idx)


def cifar_dirichlet_registry(
    n_clients: int,
    *,
    beta: float = 0.5,
    pool_size: int = 4096,
    data_dir=None,
    seed: int = 0,
    val_fraction: float = 0.2,
) -> IndexedPoolSource:
    """CIFAR-shaped Dirichlet registry: real CIFAR-10 arrays when
    ``data_dir`` holds them, the deterministic synthetic stand-in
    otherwise (the zero-egress convention of ``datasets/vision.py``)."""
    if data_dir is not None:
        x, y = vision.load_cifar10_arrays(data_dir, train=True)
    else:
        x, y = vision.synthetic_cifar_arrays(pool_size, seed=seed)
    return dirichlet_registry_source(
        x, y, n_clients, beta=beta, seed=seed, val_fraction=val_fraction
    )


def mnist_dirichlet_registry(
    n_clients: int,
    *,
    beta: float = 0.5,
    pool_size: int = 4096,
    data_dir=None,
    seed: int = 0,
    val_fraction: float = 0.2,
) -> IndexedPoolSource:
    """MNIST-shaped Dirichlet registry (see
    :func:`cifar_dirichlet_registry`)."""
    if data_dir is not None:
        x, y = vision.load_mnist_arrays(data_dir, train=True)
    else:
        x, y = vision.synthetic_mnist_arrays(pool_size, seed=seed)
    return dirichlet_registry_source(
        x, y, n_clients, beta=beta, seed=seed, val_fraction=val_fraction
    )
