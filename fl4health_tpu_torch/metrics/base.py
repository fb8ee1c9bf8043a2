"""Metrics as pure (init, update, compute) triples over state tensors
(counterpart of ``fl4health_tpu/metrics/base.py``): ``Metric``,
``MetricManager`` with its ``prefix``, and the compound ``ema_metric`` and
``transforms_metric``. Every update takes an example-validity mask, so
padded rows never count.
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
    """Fixed collection of metrics updated together; state is name -> state.
    A ``prefix`` names the computed values ``"<prefix> - <name>"``."""

    metrics: tuple[Metric, ...]
    prefix: str = ""

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
        key = (self.prefix + " - ") if self.prefix else ""
        return {f"{key}{m.name}": m.compute(state[m.name]) for m in self.metrics}


def ema_metric(inner: Metric, smoothing_factor: float = 0.1, name: str | None = None) -> Metric:
    """Exponential moving average of ``inner``'s value a batch: each update
    computes ``inner`` on that batch alone and folds it in (the first value
    taken as is). State: ``{"inner", "ema", "started"}``."""

    def init(device):
        return {"inner": inner.init(device),
                "ema": torch.zeros((), dtype=torch.float32, device=device),
                "started": torch.zeros((), dtype=torch.bool, device=device)}

    def update(state, preds, targets, mask):
        fresh = inner.update(inner.init(preds.device), preds, targets, mask)
        val = inner.compute(fresh).float()
        new_ema = torch.where(state["started"],
                              smoothing_factor * val + (1.0 - smoothing_factor) * state["ema"],
                              val)
        return {"inner": state["inner"], "ema": new_ema,
                "started": torch.ones_like(state["started"])}

    def compute(state):
        return state["ema"]

    return Metric(name=name or f"ema_{inner.name}", init=init, update=update, compute=compute)


def transforms_metric(
    inner: Metric,
    pred_transforms: tuple[Callable[[torch.Tensor], torch.Tensor], ...] = (),
    target_transforms: tuple[Callable[[torch.Tensor], torch.Tensor], ...] = (),
    name: str | None = None,
) -> Metric:
    """``inner`` on transformed predictions and targets."""

    def update(state, preds, targets, mask):
        for t in pred_transforms:
            preds = t(preds)
        for t in target_transforms:
            targets = t(targets)
        return inner.update(state, preds, targets, mask)

    return Metric(name=name or inner.name, init=inner.init, update=update,
                  compute=inner.compute)
