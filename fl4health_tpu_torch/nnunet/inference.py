"""Sliding-window inference (counterpart of ``fl4health_tpu/nnunet/inference.py``):
nnU-Net's full-volume prediction.

A volume is tiled with patches at ``step_fraction`` overlap, and the
patches' logits are blended under a Gaussian importance map (sigma =
patch / 8, nnU-Net's constant), so overlapping windows join smoothly
instead of seaming. JAX unrolls the windows inside one ``jit`` and caches
the program per geometry; here the windows run one forward each under
``torch.inference_mode()``, in JAX's corner order (``itertools.product`` of
each axis's starts), accumulating the weighted logits and the weight canvas
in f32, then dividing by ``max(norm, 1e-8)``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fl4health_tpu_torch import rng as trng


def _window_starts(size: int, patch: int, step_fraction: float) -> list[int]:
    """nnU-Net's window starts along one axis: the count from the target
    stride (patch * step_fraction), then spread evenly over
    [0, size - patch], so the first and last windows touch the edges."""
    if size <= patch:
        return [0]
    target = max(patch * step_fraction, 1.0)
    n = int(np.ceil((size - patch) / target)) + 1
    span = size - patch
    if n == 1:
        return [0]
    actual = span / (n - 1)
    return sorted({int(round(actual * i)) for i in range(n)})


def gaussian_importance_map(patch_size: Sequence[int],
                            sigma_scale: float = 1.0 / 8.0) -> np.ndarray:
    """Separable Gaussian centred in the patch, max 1: border voxels count
    less than central ones. Zeros take the smallest positive value, so a
    voxel one window covers still divides."""
    axes = []
    for p in patch_size:
        coords = np.arange(p, dtype=np.float64) - (p - 1) / 2.0
        sigma = max(p * sigma_scale, 1e-8)
        axes.append(np.exp(-0.5 * (coords / sigma) ** 2))
    out = np.ones((), np.float64)
    for a in axes:
        out = np.multiply.outer(out, a)
    out = out / out.max()
    out[out == 0] = np.min(out[out > 0])
    return out.astype(np.float32)


def sliding_window_predict(
    apply_fn: Callable[..., Any],
    params,
    model_state,
    volume: torch.Tensor,
    patch_size: Sequence[int],
    step_fraction: float = 0.5,
    gaussian: bool = True,
    rng: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full-volume logits ``[*spatial, n_classes]`` (f32) from patch-wise
    forwards.

    ``apply_fn`` is a ``ModelDef.apply`` (``(params, x[B, *patch, C], train,
    rng) -> (preds, features)``); ``volume`` is ``[*spatial, C]`` on the
    device the model runs on. ``model_state`` is JAX's model state argument,
    kept so a call reads as JAX's; the port's models keep none, and it is
    not used. A spatial axis smaller than the patch is zero-padded at its
    end and cropped back."""
    patch_size = tuple(int(p) for p in patch_size)
    spatial = tuple(volume.shape[:-1])
    assert len(spatial) == len(patch_size), (
        f"volume spatial rank {len(spatial)} != patch rank {len(patch_size)}")
    pads = [max(p - s, 0) for s, p in zip(spatial, patch_size)]
    # F.pad lists the last axis first: the channels, then the spatial axes
    padded = F.pad(volume, [0, 0] + [v for p in reversed(pads) for v in (0, p)])
    pspatial = tuple(padded.shape[:-1])
    weight = torch.as_tensor(gaussian_importance_map(patch_size) if gaussian
                             else np.ones(patch_size, np.float32), device=volume.device)
    starts = [_window_starts(s, p, step_fraction) for s, p in zip(pspatial, patch_size)]
    if rng is None:
        rng = trng.PRNGKey(0, volume.device)
    logits = None
    norm = torch.zeros(pspatial + (1,), dtype=torch.float32, device=volume.device)
    with torch.inference_mode():
        for corner in itertools.product(*starts):
            window = tuple(slice(c, c + p) for c, p in zip(corner, patch_size))
            preds, _ = apply_fn(params, padded[window][None], train=False, rng=rng)
            contrib = preds["prediction"][0].float() * weight[..., None]
            if logits is None:  # the canvas's classes are known after a forward
                logits = torch.zeros(pspatial + (contrib.shape[-1],), dtype=torch.float32,
                                     device=volume.device)
            logits[window] = logits[window] + contrib
            norm[window] = norm[window] + weight[..., None]
        out = logits / torch.clamp(norm, min=1e-8)
    return out[tuple(slice(0, s) for s in spatial)]
