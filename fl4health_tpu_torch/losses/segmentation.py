"""Segmentation losses: masked soft Dice + CE with deep supervision
(counterpart of ``fl4health_tpu/losses/segmentation.py``).

Everything is mask arithmetic on fixed shapes: the ignore label becomes a
per-voxel weight, deep-supervision targets come from strided slicing (exact
nearest-neighbour when the strides are the pooling factors), and Dice is
the batch formulation (one numerator and denominator a class, background
excluded). Logits are channels-last ``[B, *S, C]``, targets ``[B, *S]``
integers, as in the JAX package. One-hot encodings compare against an
``arange`` so they batch under ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, n_classes: int, dtype: torch.dtype) -> torch.Tensor:
    return (labels[..., None] == torch.arange(n_classes, device=labels.device)).to(dtype)


def _voxel_weights(target: torch.Tensor, example_mask: torch.Tensor,
                   ignore_label: int | None) -> torch.Tensor:
    """[B, *S] weights: 0 on padded examples and ignore-labelled voxels."""
    w = example_mask.reshape((-1,) + (1,) * (target.ndim - 1)).expand(target.shape).float()
    if ignore_label is not None:
        w = w * (target != ignore_label).float()
    return w


def masked_soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                          include_background: bool = False,
                          smooth: float = 1e-5) -> torch.Tensor:
    """Batch soft Dice loss: 1 - the mean over classes of the batch's Dice
    (nnU-Net's ``batch_dice=True``); background excluded unless asked for."""
    n_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(torch.clamp(target, 0, n_classes - 1), n_classes, probs.dtype)
    w = weights[..., None]
    axes = tuple(range(probs.ndim - 1))  # batch and spatial
    inter = (probs * onehot * w).sum(axes)
    denom = (probs * w).sum(axes) + (onehot * w).sum(axes)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    if not include_background and n_classes > 1:
        dice = dice[1:]
    return 1.0 - dice.mean()


def masked_voxel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid voxels."""
    n_classes = logits.shape[-1]
    labels = torch.clamp(target, 0, n_classes - 1).long()
    per = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def masked_dice_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                        example_mask: torch.Tensor, ignore_label: int | None = None,
                        dice_weight: float = 1.0, ce_weight: float = 1.0):
    """-> (total, dice term, ce term): Dice + CE with the ignore label folded
    into the voxel weights."""
    w = _voxel_weights(target, example_mask, ignore_label)
    dice = masked_soft_dice_loss(logits, target, w)
    ce = masked_voxel_cross_entropy(logits, target, w)
    return dice_weight * dice + ce_weight * ce, dice, ce


def downsample_target(target: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour pool of an integer map by strided slicing; exact
    for factors that divide the extent (the planner sees to it)."""
    return target[(slice(None),) + tuple(slice(None, None, int(f)) for f in factor)]


def deep_supervision_weights(n_outputs: int) -> list[float]:
    """Per-scale weights 1, 1/2, 1/4, ... with the lowest resolution zeroed
    (where there is more than one output), normalised to sum to 1."""
    w = [1.0 / (2.0**i) for i in range(n_outputs)]
    if n_outputs > 1:
        w[-1] = 0.0
    total = sum(w)
    return [x / total for x in w]


def deep_supervision_loss(preds: dict, target: torch.Tensor, example_mask: torch.Tensor,
                          ds_strides: Sequence[Sequence[int]],
                          ignore_label: int | None = None):
    """Weighted multi-scale Dice + CE over ``{"prediction", "ds_1", ...}``;
    ``ds_strides[i - 1]`` is ``ds_i``'s cumulative downsampling. Returns
    (total, dice, ce), the last two the full-resolution terms."""
    weights = deep_supervision_weights(1 + len(ds_strides))
    total, full_dice, full_ce = masked_dice_ce_loss(preds["prediction"], target,
                                                    example_mask, ignore_label)
    loss = weights[0] * total
    for i, factor in enumerate(ds_strides, start=1):
        if weights[i] == 0.0:
            continue
        term, _, _ = masked_dice_ce_loss(preds[f"ds_{i}"], downsample_target(target, factor),
                                         example_mask, ignore_label)
        loss = loss + weights[i] * term
    return loss, full_dice, full_ce
