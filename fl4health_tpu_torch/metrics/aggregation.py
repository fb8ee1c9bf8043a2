"""Server-side metric aggregation (counterpart of
``fl4health_tpu/metrics/aggregation.py``: ``aggregate_metrics``)."""

from __future__ import annotations

from typing import Mapping

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
