"""Dirichlet label-based dataset partitioning across clients (the port's
own copy of ``fl4health_tpu/datasets/partitioners.py``, unchanged in its
numpy draws, so both packages cut the same partitions from the same
``hash_key``): per-label Dirichlet allocation across N partitions with a
min-examples retry loop, and optional reuse of a prior allocation (so a test
set can be partitioned like its train set).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class DirichletLabelBasedAllocation:
    def __init__(
        self,
        number_of_partitions: int,
        unique_labels: Sequence[Any],
        min_label_examples: int | None = None,
        beta: float | None = None,
        prior_distribution: dict | None = None,
        hash_key: int | None = None,
    ):
        assert (beta is not None) ^ (prior_distribution is not None), (
            "Either beta or a prior distribution must be provided, but not both."
        )
        self.number_of_partitions = number_of_partitions
        self.unique_labels = list(unique_labels)
        self.beta = beta
        self.min_label_examples = min_label_examples or 0
        self.prior_distribution = prior_distribution
        self.rng = np.random.default_rng(hash_key)
        if prior_distribution is not None:
            assert len(prior_distribution) == len(self.unique_labels), (
                "The length of the prior must match the number of labels"
            )

    def partition_label_indices(
        self, label: Any, label_indices: np.ndarray
    ) -> tuple[list[np.ndarray], int, np.ndarray]:
        """Allocate one label's indices over the partitions. Returns
        (per-partition indices, min count, allocation distribution)."""
        if self.prior_distribution is not None:
            allocation = np.asarray(self.prior_distribution[label], np.float64)
            allocation = allocation / allocation.sum()
        else:
            allocation = self.rng.dirichlet(
                np.repeat(self.beta, self.number_of_partitions)
            )
        total = label_indices.shape[0]
        counts = [math.floor(p * total) for p in allocation]
        min_samples = min(counts)
        shuffled = label_indices[self.rng.permutation(total)]
        # rounding slack goes to a final "fill" partition that is discarded
        out = []
        start = 0
        for c in counts:
            out.append(shuffled[start : start + c])
            start += c
        return out, min_samples, allocation

    def partition_dataset(
        self,
        x: np.ndarray,
        y: np.ndarray,
        max_retries: int | None = 5,
    ) -> tuple[list[tuple[np.ndarray, np.ndarray]], dict]:
        """-> (list of (x_i, y_i) partitions, per-label allocation dists).

        Retries a label's Dirichlet draw while any partition receives fewer
        than ``min_label_examples`` points of that label, up to ``max_retries``
        (raising when exhausted).
        """
        x, y = np.asarray(x), np.asarray(y)
        partitioned_indices: list[list[np.ndarray]] = [
            [] for _ in range(self.number_of_partitions)
        ]
        attempts = 0
        probabilities: dict = {}
        for label in self.unique_labels:
            label_indices = np.nonzero(y == label)[0]
            while True:
                parts, min_selected, allocation = self.partition_label_indices(
                    label, label_indices
                )
                if self.prior_distribution is not None or min_selected >= self.min_label_examples:
                    probabilities[label] = allocation
                    for i, p in enumerate(parts):
                        partitioned_indices[i].append(p)
                    break
                attempts += 1
                logger.info(
                    "Too few datapoints in a partition (%d < %d). Resampling...",
                    min_selected, self.min_label_examples,
                )
                if max_retries is not None and attempts >= max_retries:
                    raise ValueError(
                        f"Exhausted {max_retries} retries without satisfying "
                        f"min_label_examples={self.min_label_examples}"
                    )
        partitions = []
        for chunks in partitioned_indices:
            idx = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)
            idx = self.rng.permutation(idx)  # mix label blocks within a client
            partitions.append((x[idx], y[idx]))
        return partitions, probabilities
