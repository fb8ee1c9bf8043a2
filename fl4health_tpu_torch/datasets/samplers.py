"""Label-based non-IID subsampling, host-side (the port's own copy of
``fl4health_tpu/datasets/samplers.py``, unchanged in its numpy draws):
datasets are (x, y) array pairs.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np


class LabelBasedSampler:
    """Common surface: ``subsample(x, y) -> (x, y)``."""

    def __init__(self, unique_labels: Sequence[Any]):
        self.unique_labels = list(unique_labels)
        self.num_classes = len(self.unique_labels)

    def subsample(self, x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class MinorityLabelBasedSampler(LabelBasedSampler):
    """Downsample the specified minority labels to ``downsampling_ratio``:
    a label with 10 examples and ratio 0.2 keeps 2."""

    def __init__(
        self,
        unique_labels: Sequence[Any],
        downsampling_ratio: float,
        minority_labels: set,
        hash_key: int | None = None,
    ):
        super().__init__(unique_labels)
        self.downsampling_ratio = downsampling_ratio
        self.minority_labels = set(minority_labels)
        self.rng = np.random.default_rng(hash_key)

    def subsample(self, x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        selected: list[np.ndarray] = []
        for label in self.unique_labels:
            idx = np.nonzero(np.asarray(y) == label)[0]
            if label in self.minority_labels:
                size = int(idx.shape[0] * self.downsampling_ratio)
                perm = self.rng.permutation(idx.shape[0])
                idx = idx[perm[:size]]
            selected.append(idx)
        sel = np.concatenate(selected)
        return np.asarray(x)[sel], np.asarray(y)[sel]


class DirichletLabelBasedSampler(LabelBasedSampler):
    """Subsample so the label marginal follows a Dirichlet(beta) draw.
    Large beta -> near-uniform; small beta -> heterogeneous.
    ``sample_percentage`` sets the size of the subsampled dataset. Sampling is
    with replacement per class, and the final count is trimmed to exactly
    ``sample_percentage * len(dataset)``.
    """

    def __init__(
        self,
        unique_labels: Sequence[Any],
        hash_key: int | None = None,
        sample_percentage: float = 0.5,
        beta: float = 100,
    ):
        super().__init__(unique_labels)
        self.rng = np.random.default_rng(hash_key)
        self.probabilities = self.rng.dirichlet(np.repeat(beta, self.num_classes))
        self.sample_percentage = sample_percentage

    def subsample(self, x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        y = np.asarray(y)
        assert self.sample_percentage <= 1.0
        total = int(y.shape[0] * self.sample_percentage)
        per_class = [math.ceil(p * total) for p in self.probabilities]
        chosen: list[np.ndarray] = []
        for label, n_samples in zip(self.unique_labels, per_class):
            idx = np.nonzero(y == label)[0]
            if idx.shape[0] == 0 or n_samples == 0:
                continue
            chosen.append(self.rng.choice(idx, size=n_samples, replace=True))
        sel = np.concatenate(chosen) if chosen else np.zeros((0,), np.int64)
        # ceil() overshoots; uniformly trim to the exact requested count.
        if sel.shape[0] > total:
            sel = sel[self.rng.permutation(sel.shape[0])[:total]]
        return np.asarray(x)[sel], y[sel]
