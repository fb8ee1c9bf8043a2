"""Count-based metrics (counterpart of ``fl4health_tpu/metrics/efficient.py``:
``accuracy`` and the segmentation metrics ``binary_soft_dice``,
``multiclass_dice`` and ``segmentation_dice``). One-hot encodings compare
against an ``arange`` so they batch under the client vmap."""

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


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    return (labels[..., None] == torch.arange(n_classes, device=labels.device)).float()


def binary_soft_dice(epsilon: float = 1e-7, name: str = "dice") -> Metric:
    """Soft Dice with probability intersections, accumulated as (2 *
    intersection, denominator): the dataset's Dice, not a mean of images'."""

    def init(device):
        return torch.zeros((2,), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        p = _as_probs(preds.float())
        t = targets.float()
        m = mask.float().reshape((-1,) + (1,) * (p.ndim - 1))
        inter = (p * t * m).sum()
        denom = (p * m).sum() + (t * m).sum()
        return state + torch.stack([2.0 * inter, denom])

    def compute(state):
        return (state[0] + epsilon) / (state[1] + epsilon)

    return Metric(name, init, update, compute)


def multiclass_dice(n_classes: int, name: str = "multiclass_dice") -> Metric:
    """Mean per-class hard Dice of ``[B, C]`` scores against ``[B]`` labels
    (or one-hot targets), streamed as (tp, fp, fn, tn) counts; classes with
    no true or predicted example are left out of the mean."""

    def init(device):
        return torch.zeros((n_classes, 4), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        pred_1h = _one_hot(preds.argmax(dim=-1), n_classes)
        t = targets.argmax(dim=-1) if targets.ndim == preds.ndim else targets
        targ_1h = _one_hot(t, n_classes)
        m = mask.float()[:, None]
        counts = [(pred_1h * targ_1h * m).sum(0), (pred_1h * (1 - targ_1h) * m).sum(0),
                  ((1 - pred_1h) * targ_1h * m).sum(0),
                  ((1 - pred_1h) * (1 - targ_1h) * m).sum(0)]
        return state + torch.stack(counts, dim=-1)

    def compute(state):
        tp, fp, fn = state[:, 0], state[:, 1], state[:, 2]
        dice = 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)
        present = (tp + fn > 0).float()
        return (dice * present).sum() / torch.clamp(present.sum(), min=1.0)

    return Metric(name, init, update, compute)


def segmentation_dice(n_classes: int, ignore_label: int | None = None,
                      name: str = "seg_dice") -> Metric:
    """Hard per-class Dice of dense maps (``[B, *S, C]`` logits, ``[B, *S]``
    labels, a ``[B]`` mask), streamed as (tp, fp, fn) a class; the mean
    leaves out the background and absent classes, and ``ignore_label``
    voxels count nowhere."""

    def init(device):
        return torch.zeros((n_classes, 3), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        t = targets.long()
        m = mask.float().reshape((-1,) + (1,) * (t.ndim - 1)).expand(t.shape)
        if ignore_label is not None:
            m = m * (t != ignore_label).float()
        pred_oh = _one_hot(preds.argmax(dim=-1), n_classes)
        true_oh = _one_hot(t, n_classes)
        m = m[..., None]
        axes = tuple(range(t.ndim))
        tp = (pred_oh * true_oh * m).sum(axes)
        fp = (pred_oh * (1 - true_oh) * m).sum(axes)
        fn = ((1 - pred_oh) * true_oh * m).sum(axes)
        return state + torch.stack([tp, fp, fn], dim=-1)

    def compute(state):
        tp, fp, fn = state[:, 0], state[:, 1], state[:, 2]
        dice = 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)
        present = (tp + fn > 0).float()
        if n_classes > 1:
            dice, present = dice[1:], present[1:]
        return (dice * present).sum() / torch.clamp(present.sum(), min=1.0)

    return Metric(name, init, update, compute)
