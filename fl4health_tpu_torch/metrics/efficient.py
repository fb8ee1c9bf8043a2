"""Count-based metrics (counterpart of ``fl4health_tpu/metrics/efficient.py``):
fixed-size count states updated a batch, on the caller's device.

- Binary metrics take probabilities or logits ``[B]`` or ``[B, 1]``
  (sigmoid when values fall outside [0, 1]) or hard {0, 1} labels.
- Multiclass metrics take scores ``[B, C]`` and integer targets ``[B]`` (or
  one-hot ``[B, C]``).
- ``mask`` is ``[B]`` example validity: padded rows count nowhere.

One-hot encodings compare against an ``arange`` so they batch under the
client vmap."""

from __future__ import annotations

import numpy as np
import torch

from fl4health_tpu_torch.metrics.base import Metric


def _as_probs(preds: torch.Tensor) -> torch.Tensor:
    """Map logits to probabilities when needed (idempotent on probs)."""
    outside = (preds.min() < 0.0) | (preds.max() > 1.0)
    return torch.where(outside, torch.sigmoid(preds), preds)


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    return (labels[..., None] == torch.arange(n_classes, device=labels.device)).float()


def _binary_counts(preds, targets, mask, threshold=0.5):
    """(tp, fp, fn, tn) of thresholded binary scores."""
    p = _as_probs(preds.reshape(preds.shape[0], -1)[:, 0].float())
    t = targets.reshape(targets.shape[0], -1)[:, 0].float()
    m = mask.float()
    p = (p >= threshold).float()
    return torch.stack([(p * t * m).sum(), (p * (1 - t) * m).sum(),
                        ((1 - p) * t * m).sum(), ((1 - p) * (1 - t) * m).sum()])


def _multiclass_counts(preds, targets, mask, n_classes):
    """Per-class ``[C, 4]`` (tp, fp, fn, tn) of ``[B, C]`` scores against
    ``[B]`` labels (or one-hot targets)."""
    pred_1h = _one_hot(preds.argmax(dim=-1), n_classes)
    t = targets.argmax(dim=-1) if targets.ndim == preds.ndim else targets
    targ_1h = _one_hot(t, n_classes)
    m = mask.float()[:, None]
    return torch.stack([(pred_1h * targ_1h * m).sum(0), (pred_1h * (1 - targ_1h) * m).sum(0),
                        ((1 - pred_1h) * targ_1h * m).sum(0),
                        ((1 - pred_1h) * (1 - targ_1h) * m).sum(0)], dim=-1)


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


def balanced_accuracy(n_classes: int, name: str = "balanced_accuracy") -> Metric:
    """Mean recall over the classes present in the targets."""

    def init(device):
        return torch.zeros((n_classes, 4), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        return state + _multiclass_counts(preds, targets, mask, n_classes)

    def compute(state):
        tp, fn = state[:, 0], state[:, 2]
        support = tp + fn
        recall = tp / torch.clamp(support, min=1.0)
        present = (support > 0).float()
        return (recall * present).sum() / torch.clamp(present.sum(), min=1.0)

    return Metric(name, init, update, compute)


def f1(n_classes: int, average: str = "weighted", name: str = "f1") -> Metric:
    """F1 averaged ``weighted`` (by support, the default), ``macro`` (over
    the classes present) or ``micro``."""

    def init(device):
        return torch.zeros((n_classes, 4), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        return state + _multiclass_counts(preds, targets, mask, n_classes)

    def compute(state):
        tp, fp, fn = state[:, 0], state[:, 1], state[:, 2]
        if average == "micro":
            return 2 * tp.sum() / torch.clamp(2 * tp.sum() + fp.sum() + fn.sum(), min=1.0)
        per_class = 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)
        support = tp + fn
        if average == "weighted":
            return (per_class * support).sum() / torch.clamp(support.sum(), min=1.0)
        present = (support > 0).float()
        return (per_class * present).sum() / torch.clamp(present.sum(), min=1.0)

    return Metric(name, init, update, compute)


def binary_classification_metric(stat: str, threshold: float = 0.5,
                                 name: str | None = None) -> Metric:
    """Binary ``precision``, ``recall``, ``specificity``, ``npv``, ``f1`` or
    (any other ``stat``) accuracy from streamed (tp, fp, fn, tn)."""

    def init(device):
        return torch.zeros((4,), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        return state + _binary_counts(preds, targets, mask, threshold)

    def compute(state):
        tp, fp, fn, tn = state[0], state[1], state[2], state[3]
        if stat == "precision":
            return tp / torch.clamp(tp + fp, min=1.0)
        if stat == "recall":
            return tp / torch.clamp(tp + fn, min=1.0)
        if stat == "specificity":
            return tn / torch.clamp(tn + fp, min=1.0)
        if stat == "npv":
            return tn / torch.clamp(tn + fn, min=1.0)
        if stat == "f1":
            return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)
        return (tp + tn) / torch.clamp(tp + fp + fn + tn, min=1.0)

    return Metric(name or f"binary_{stat}", init, update, compute)


def auc_thresholds(n_thresholds: int) -> np.ndarray:
    """``jnp.linspace(0, 1, n)`` in f32 as JAX computes it: ``i * (1 / (n -
    1))`` with the step rounded to f32 first, the last entry exactly 1."""
    if n_thresholds == 1:
        return np.zeros((1,), np.float32)
    out = np.arange(n_thresholds, dtype=np.float32) * (np.float32(1.0)
                                                      / np.float32(n_thresholds - 1))
    out[-1] = 1.0
    return out


def binned_auc(n_thresholds: int = 200, name: str = "roc_auc") -> Metric:
    """Streaming ROC-AUC over fixed thresholds: ``[T, 4]`` counts at ``T``
    thresholds, a score at a threshold counting as positive (``>=``), the
    ROC integrated by trapezoids; error O(1/T)."""
    thresholds = torch.from_numpy(auc_thresholds(n_thresholds))

    def init(device):
        return torch.zeros((n_thresholds, 4), dtype=torch.float32, device=device)

    def update(state, preds, targets, mask):
        p = _as_probs(preds.reshape(preds.shape[0], -1)[:, 0].float())
        t = targets.reshape(targets.shape[0], -1)[:, 0].float()
        m = mask.float()
        pred_pos = (p[None, :] >= thresholds.to(p.device)[:, None]).float()  # [T, B]
        tp = (pred_pos * t[None] * m[None]).sum(1)
        fp = (pred_pos * (1 - t[None]) * m[None]).sum(1)
        fn = ((1 - pred_pos) * t[None] * m[None]).sum(1)
        tn = ((1 - pred_pos) * (1 - t[None]) * m[None]).sum(1)
        return state + torch.stack([tp, fp, fn, tn], dim=-1)

    def compute(state):
        tp, fp, fn, tn = state[:, 0], state[:, 1], state[:, 2], state[:, 3]
        tpr = tp / torch.clamp(tp + fn, min=1.0)
        fpr = fp / torch.clamp(fp + tn, min=1.0)
        # thresholds ascend, so fpr and tpr descend: |dx| * mean(y)
        return ((fpr[:-1] - fpr[1:]) * 0.5 * (tpr[:-1] + tpr[1:])).sum()

    return Metric(name, init, update, compute)


def binary_soft_dice(epsilon: float = 1e-7, spatial_dims: tuple[int, ...] | None = None,
                     name: str = "dice") -> Metric:
    """Soft Dice with probability intersections, accumulated as (2 *
    intersection, denominator): the dataset's Dice, not a mean of images'.
    ``spatial_dims`` is accepted and ignored, as in JAX (the sums run over
    every axis)."""
    del spatial_dims

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
        return state + _multiclass_counts(preds, targets, mask, n_classes)

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
