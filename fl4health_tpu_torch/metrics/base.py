"""Metrics as pure (init, update, compute) triples over state tensors
(counterpart of ``fl4health_tpu/metrics/base.py``: ``Metric`` and
``MetricManager``). Every update takes an example-validity mask, so padded
rows never count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Metric:
    """init(device) -> state; update(state, preds, targets, mask) -> state;
    compute(state) -> scalar tensor."""

    name: str
    init: Callable[[torch.device], torch.Tensor]
    update: Callable[..., torch.Tensor]
    compute: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MetricManager:
    """Fixed collection of metrics updated together; state is name -> state."""

    metrics: tuple[Metric, ...]

    def init(self, device: torch.device | str = "cpu") -> dict:
        return {m.name: m.init(torch.device(device)) for m in self.metrics}

    def update(self, state: dict, preds: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor | None = None) -> dict:
        if mask is None:
            mask = torch.ones((preds.shape[0],), dtype=torch.float32,
                              device=preds.device)
        return {m.name: m.update(state[m.name], preds, targets, mask)
                for m in self.metrics}

    def compute(self, state: dict) -> dict:
        return {m.name: m.compute(state[m.name]) for m in self.metrics}
