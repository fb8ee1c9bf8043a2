"""Aggregation over the clients axis (counterpart of
``fl4health_tpu/core/aggregate.py``): a masked weighted mean along axis 0 of
client-stacked params, with the same empty-cohort and NaN-row guarantees.
"""

from __future__ import annotations

import torch

from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.core.types import PyTree, StackedParams


def _expand(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape [clients] weights to broadcast against a [clients, ...] leaf."""
    return w.reshape((-1,) + (1,) * (leaf.ndim - 1))


def effective_weights(
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> torch.Tensor:
    """Normalized weights: ``n_i / sum(n)`` (weighted) or ``1 / |S|``.
    An empty cohort (all-zero mask) gives all-zero weights, not NaN."""
    counts = torch.as_tensor(sample_counts, dtype=torch.float32)
    m = (torch.ones_like(counts) if mask is None
         else torch.as_tensor(mask, dtype=torch.float32, device=counts.device))
    raw = counts * m if weighted else m
    total = raw.sum()
    return torch.where(total > 0, raw / torch.clamp(total, min=1e-12),
                       torch.zeros_like(raw))


def weighted_mean(stacked: StackedParams, weights: torch.Tensor) -> PyTree:
    """``sum_i w_i * leaf_i`` over the clients axis, accumulated in f32, with
    weight-0 rows hard-zeroed so a NaN in an unsampled row cannot leak in."""

    def _agg(leaf: torch.Tensor) -> torch.Tensor:
        w = _expand(weights.to(device=leaf.device, dtype=torch.float32), leaf)
        contrib = torch.where(w > 0, leaf.float(), torch.zeros((), device=leaf.device)) * w
        return contrib.sum(dim=0).to(leaf.dtype)

    return tree_map(_agg, stacked)


def aggregate(
    stacked: StackedParams,
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> PyTree:
    return weighted_mean(stacked, effective_weights(sample_counts, mask, weighted))


def aggregate_losses(
    losses: torch.Tensor,
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> torch.Tensor:
    w = effective_weights(sample_counts, mask, weighted)
    return (torch.as_tensor(losses, dtype=torch.float32) * w).sum()
