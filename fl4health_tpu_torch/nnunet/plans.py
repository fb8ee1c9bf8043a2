"""nnU-Net experiment planning: fingerprint, plans, polyLR (counterpart of
``fl4health_tpu/nnunet/plans.py``).

The planner is pure numpy, copied from the JAX package so both packages plan
the same network from the same fingerprint; plans travel as JSON bytes,
never pickle. The heuristics: target spacing the per-axis median of the
dataset's spacings; patch the median resampled shape shrunk to a voxel
budget and rounded so every axis divides by its pooling factor; an axis
halved a stage while it stays at least twice the minimum extent, up to
``max_stages``; features ``base * 2^stage`` capped (320 for 3-D, 512 for
2-D); batch at least 2 and at most 5% of the dataset's voxels; z-score
normalisation clipped at the foreground's 0.5/99.5 percentiles.

``poly_lr_schedule`` and ``nnunet_optimizer`` build the nnU-Net recipe from
the port's ``optim.py``: global-norm clip 12, weight decay 3e-5, SGD with
Nesterov momentum 0.99 under the polyLR schedule.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np
import torch

from fl4health_tpu_torch import optim

DEFAULT_MAX_FEATURES_3D = 320
DEFAULT_MAX_FEATURES_2D = 512
DEFAULT_BASE_FEATURES = 32


# ---------------------------------------------------------------------------
# Fingerprint
# ---------------------------------------------------------------------------

def extract_fingerprint(
    volumes: Sequence[np.ndarray],
    spacings: Sequence[Sequence[float]],
    segmentations: Sequence[np.ndarray] | None = None,
    foreground_label_threshold: int = 1,
) -> dict[str, Any]:
    """Dataset fingerprint (the nnU-Net ``dataset_fingerprint.json``
    equivalent, nnunet_client.py:521): per-case spatial shapes + spacings and
    foreground intensity statistics per channel.

    ``volumes`` are channels-last arrays ``[*spatial, C]``; ``segmentations``
    (optional) are integer maps ``[*spatial]`` used to restrict intensity
    stats to foreground voxels (labels >= ``foreground_label_threshold``).
    Without segmentations, nonzero-intensity voxels stand in for foreground.
    """
    if not volumes:
        raise ValueError("fingerprint needs at least one volume")
    n_channels = int(volumes[0].shape[-1])
    ndim = volumes[0].ndim - 1
    shapes = [tuple(int(s) for s in v.shape[:-1]) for v in volumes]
    spacings_out = [tuple(float(s) for s in sp) for sp in spacings]
    if any(len(sp) != ndim for sp in spacings_out):
        raise ValueError("spacing rank must match volume spatial rank")

    per_channel: dict[str, dict[str, float]] = {}
    for c in range(n_channels):
        samples = []
        for i, v in enumerate(volumes):
            chan = np.asarray(v[..., c], np.float64)
            if segmentations is not None:
                fg = np.asarray(segmentations[i]) >= foreground_label_threshold
            else:
                fg = chan != 0
            vals = chan[fg]
            if vals.size:
                samples.append(vals)
        allv = np.concatenate(samples) if samples else np.zeros((1,))
        per_channel[str(c)] = {
            "mean": float(allv.mean()),
            "std": float(allv.std() + 1e-8),
            "min": float(allv.min()),
            "max": float(allv.max()),
            "percentile_00_5": float(np.percentile(allv, 0.5)),
            "percentile_99_5": float(np.percentile(allv, 99.5)),
        }
    return {
        "shapes": [list(s) for s in shapes],
        "spacings": [list(s) for s in spacings_out],
        "num_channels": n_channels,
        "num_cases": len(volumes),
        "foreground_intensity_properties_per_channel": per_channel,
    }


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def _pooling_per_axis(
    patch: np.ndarray, max_stages: int, min_axis_extent: int = 4
) -> list[list[int]]:
    """Per-stage stride vectors: halve every axis that can still afford it.

    Stage 0 has stride 1 (no pooling before the first conv block), matching
    the plain-conv U-Net convention; subsequent stages carry per-axis stride
    2 while the running extent stays >= 2*min_axis_extent.
    """
    extents = patch.astype(np.float64).copy()
    strides = [[1] * len(patch)]
    for _ in range(max_stages - 1):
        stride = []
        for a in range(len(patch)):
            if extents[a] >= 2 * min_axis_extent:
                stride.append(2)
                extents[a] /= 2
            else:
                stride.append(1)
        if all(s == 1 for s in stride):
            break
        strides.append(stride)
    return strides


def _round_to_divisible(patch: np.ndarray, strides: list[list[int]]) -> np.ndarray:
    """Shrink each axis to the largest multiple of its total pooling factor."""
    factor = np.prod(np.asarray(strides), axis=0)
    rounded = (patch // factor) * factor
    return np.maximum(rounded, factor)


def generate_plans(
    fingerprint: dict[str, Any],
    dataset_name: str = "Dataset000",
    plans_name: str = "fl4health_tpu_plans",
    configuration: str | None = None,
    max_patch_voxels: int | None = None,
    max_stages: int = 6,
    base_features: int = DEFAULT_BASE_FEATURES,
    batch_size_cap_fraction: float = 0.05,
) -> dict[str, Any]:
    """Build a plans dict from a fingerprint (ExperimentPlanner equivalent).

    ``configuration`` defaults to "3d_fullres" for 3-D data and "2d" for 2-D.
    ``max_patch_voxels`` bounds patch memory (default: 128^3 for 3-D, 512^2
    for 2-D — the published nnU-Net defaults' order of magnitude).
    """
    shapes = np.asarray(fingerprint["shapes"], np.float64)
    spacings = np.asarray(fingerprint["spacings"], np.float64)
    ndim = shapes.shape[1]
    if configuration is None:
        configuration = "3d_fullres" if ndim == 3 else "2d"
    if max_patch_voxels is None:
        max_patch_voxels = 128**3 if ndim == 3 else 512**2

    target_spacing = np.median(spacings, axis=0)
    # Shapes resampled into the target spacing grid.
    resampled = shapes * spacings / target_spacing
    median_resampled = np.median(resampled, axis=0)

    patch = np.maximum(np.round(median_resampled).astype(np.int64), 4)
    # Shrink the largest axis until the voxel budget holds (keeps aspect
    # close to the median shape, the nnU-Net approach to memory budgeting).
    while np.prod(patch) > max_patch_voxels:
        patch[np.argmax(patch)] = int(patch[np.argmax(patch)] * 0.9)
    strides = _pooling_per_axis(patch, max_stages)
    patch = _round_to_divisible(patch, strides)
    n_stages = len(strides)

    max_features = DEFAULT_MAX_FEATURES_3D if ndim == 3 else DEFAULT_MAX_FEATURES_2D
    features = [min(base_features * (2**i), max_features) for i in range(n_stages)]
    kernel_sizes = [[3] * ndim for _ in range(n_stages)]

    # Batch cannot exceed `batch_size_cap_fraction` of the dataset's voxels
    # (nnunet_client.py:455 "a batch cannot contain more than 5% of the
    # voxels in the dataset").
    dataset_voxels = float(np.prod(np.median(resampled, axis=0))) * max(
        int(fingerprint.get("num_cases", 1)), 1
    )
    patch_voxels = float(np.prod(patch))
    batch_size = max(2, int(dataset_voxels * batch_size_cap_fraction / patch_voxels))
    batch_size = min(batch_size, 32)

    return {
        "plans_name": plans_name,
        "dataset_name": dataset_name,
        "original_median_shape_after_transp": [int(round(s)) for s in np.median(shapes, axis=0)],
        "original_median_spacing_after_transp": [float(s) for s in np.median(spacings, axis=0)],
        "foreground_intensity_properties_per_channel": fingerprint[
            "foreground_intensity_properties_per_channel"
        ],
        "configurations": {
            configuration: {
                "data_identifier": f"{plans_name}_{configuration}",
                "spacing": [float(s) for s in target_spacing],
                "patch_size": [int(p) for p in patch],
                "batch_size": int(batch_size),
                "median_image_size_in_voxels": [float(s) for s in median_resampled],
                "n_stages": n_stages,
                "features_per_stage": features,
                "strides": [list(map(int, s)) for s in strides],
                "kernel_sizes": kernel_sizes,
                "n_conv_per_stage": 2,
                "normalization_schemes": ["ZScoreClipped"]
                * int(fingerprint["num_channels"]),
            }
        },
    }


def localize_plans(
    plans: dict[str, Any],
    fingerprint: dict[str, Any],
    dataset_name: str,
    configuration: str | None = None,
) -> dict[str, Any]:
    """Client-side plans adaptation (``create_plans``, nnunet_client.py:388):
    keep the *global* architecture/patch/spacing decisions, swap in the LOCAL
    dataset's identity, median shape/spacing, and foreground intensity stats
    so normalization reflects the client's own distribution."""
    out = json.loads(json.dumps(plans))  # deep copy via round-trip
    out["source_plans_name"] = plans["plans_name"]
    out["plans_name"] = f"FL-{plans['plans_name']}-{dataset_name}"
    out["dataset_name"] = dataset_name
    shapes = np.asarray(fingerprint["shapes"], np.float64)
    spacings = np.asarray(fingerprint["spacings"], np.float64)
    out["original_median_shape_after_transp"] = [
        int(round(s)) for s in np.median(shapes, axis=0)
    ]
    out["original_median_spacing_after_transp"] = [
        float(s) for s in np.median(spacings, axis=0)
    ]
    out["foreground_intensity_properties_per_channel"] = fingerprint[
        "foreground_intensity_properties_per_channel"
    ]
    if configuration is None:
        configuration = default_configuration(out)
    cfg = out["configurations"][configuration]
    cfg["data_identifier"] = out["plans_name"]
    return out


def default_configuration(plans: dict[str, Any]) -> str:
    """Pick the configuration a plans dict describes, preferring 3d_fullres
    (the reference's fullres-first rule, nnunet_client.py:446)."""
    configs = plans["configurations"]
    if "3d_fullres" in configs:
        return "3d_fullres"
    return next(iter(configs))


# ---------------------------------------------------------------------------
# Wire format — JSON bytes, never pickle
# ---------------------------------------------------------------------------

def plans_to_bytes(plans: dict[str, Any]) -> bytes:
    return json.dumps(plans, sort_keys=True).encode("utf-8")


def plans_from_bytes(data: bytes) -> dict[str, Any]:
    return json.loads(data.decode("utf-8"))


# ---------------------------------------------------------------------------
# PolyLR
# ---------------------------------------------------------------------------

def poly_lr_schedule(initial_lr: float, max_steps: int, exponent: float = 0.9):
    """``lr(step) = initial * (1 - step / max_steps) ** exponent``, the
    fraction clipped to [0, 1]: the nnU-Net default schedule, a function of
    the optimizer's int32 step count (``optim.scale_by_schedule``)."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step / max_steps, 0.0, 1.0)
        return initial_lr * (1.0 - frac) ** exponent

    return schedule


def nnunet_optimizer(initial_lr: float = 1e-2, max_steps: int = 1000,
                     momentum: float = 0.99, weight_decay: float = 3e-5,
                     grad_clip_norm: float = 12.0) -> optim.GradientTransformation:
    """The nnU-Net training recipe as one chain: global-norm clip, weight
    decay, SGD with Nesterov momentum under polyLR."""
    return optim.chain(
        optim.clip_by_global_norm(grad_clip_norm),
        optim.add_decayed_weights(weight_decay),
        optim.sgd(learning_rate=poly_lr_schedule(initial_lr, max_steps),
                  momentum=momentum, nesterov=True),
    )
