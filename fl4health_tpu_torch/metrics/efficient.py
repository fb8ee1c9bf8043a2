"""Count-based classification metrics (counterpart of
``fl4health_tpu/metrics/efficient.py``; ``accuracy`` only)."""

from __future__ import annotations

import torch

from fl4health_tpu_torch.metrics.base import Metric


def _as_probs(preds: torch.Tensor) -> torch.Tensor:
    """Map logits to probabilities when needed (idempotent on probs)."""
    outside = (preds.min() < 0.0) | (preds.max() > 1.0)
    return torch.where(outside, torch.sigmoid(preds), preds)


def accuracy(name: str = "accuracy") -> Metric:
    """Top-1 accuracy for [B, C] logits or binary [B] scores."""

    def init(device):
        return torch.zeros((2,), dtype=torch.float32, device=device)  # correct, total

    def update(state, preds, targets, mask):
        m = mask.float()
        if preds.ndim >= 2 and preds.shape[-1] > 1:
            pred_cls = preds.argmax(dim=-1)
            t = targets.argmax(dim=-1) if targets.ndim == preds.ndim else targets
        else:
            pred_cls = (_as_probs(preds.reshape(preds.shape[0])) >= 0.5).long()
            t = targets.reshape(targets.shape[0])
        correct = ((pred_cls == t).float() * m).sum()
        return state + torch.stack([correct, m.sum()])

    def compute(state):
        return state[0] / torch.clamp(state[1], min=1.0)

    return Metric(name, init, update, compute)
