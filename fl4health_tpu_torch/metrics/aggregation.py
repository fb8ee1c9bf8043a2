"""Server-side metric aggregation (counterpart of
``fl4health_tpu/metrics/aggregation.py``): sample-weighted or uniform
averages of per-client metrics, and the split of a metrics dict into its
validation and ``"test -"`` halves."""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from fl4health_tpu_torch.core.aggregate import client_sum, effective_weights


def aggregate_metrics(client_metrics: Mapping[str, torch.Tensor],
                      sample_counts: torch.Tensor,
                      mask: torch.Tensor | None = None,
                      weighted: bool = True) -> dict[str, torch.Tensor]:
    """Stacked [clients] metric values -> one weighted scalar per key
    (summed by ``client_sum``)."""
    w = effective_weights(sample_counts, mask, weighted)
    return {k: client_sum(torch.as_tensor(v, dtype=torch.float32) * w)
            for k, v in client_metrics.items()}


def aggregate_metrics_list(per_client: Sequence[Mapping[str, torch.Tensor]],
                           sample_counts: Sequence[float],
                           weighted: bool = True) -> dict[str, float]:
    """A host list of per-client metric dicts -> aggregated floats."""
    if not per_client:
        return {}
    stacked = {k: torch.tensor([float(m[k]) for m in per_client], dtype=torch.float32)
               for k in per_client[0].keys()}
    counts = torch.tensor([float(c) for c in sample_counts], dtype=torch.float32)
    return {k: float(v) for k, v in aggregate_metrics(stacked, counts,
                                                      weighted=weighted).items()}


def prefix_test_metrics(metrics: Mapping[str, float]) -> tuple[dict, dict]:
    """(val, test): the keys without and with the ``"test -"`` prefix."""
    val = {k: v for k, v in metrics.items() if not k.startswith("test -")}
    test = {k: v for k, v in metrics.items() if k.startswith("test -")}
    return val, test
