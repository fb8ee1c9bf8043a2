"""nnU-Net data: normalisation and foreground-oversampled patches
(counterpart of ``fl4health_tpu/nnunet/data.py``).

Host-side numpy, copied from the JAX package so both packages cut the same
patches from the same volumes and seed: clip to the fingerprint's
foreground percentiles and z-score, pad volumes smaller than the patch,
and crop ``[N, *patch, C]`` patches, every third centred on a random
foreground voxel (nnU-Net's oversampling rule). ``make_patch_resampler``
is a ``train_data_provider`` that cuts fresh banks between rounds.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from fl4health_tpu_torch.nnunet.plans import default_configuration


def normalize_volume(
    volume: np.ndarray, intensity_props: dict[str, dict[str, float]]
) -> np.ndarray:
    """Per-channel clipped z-score (the "ZScoreClipped" scheme the planner
    records): clip to the foreground 0.5/99.5 percentiles, subtract the
    foreground mean, divide by the foreground std."""
    out = np.empty_like(volume, dtype=np.float32)
    for c in range(volume.shape[-1]):
        props = intensity_props[str(c)]
        chan = np.asarray(volume[..., c], np.float32)
        chan = np.clip(chan, props["percentile_00_5"], props["percentile_99_5"])
        out[..., c] = (chan - props["mean"]) / max(props["std"], 1e-8)
    return out


def _random_patch_corner(
    rng: np.random.Generator,
    shape: Sequence[int],
    patch: Sequence[int],
    fg_coords: np.ndarray | None,
    force_foreground: bool,
) -> tuple[int, ...]:
    """Crop corner; when forcing foreground, center the patch on a random
    foreground voxel (clamped to bounds) — nnU-Net's oversampling rule.
    ``fg_coords`` is the case's precomputed [N_fg, ndim] foreground index
    table (computed once per case, not per patch)."""
    max_corner = [max(s - p, 0) for s, p in zip(shape, patch)]
    if force_foreground and fg_coords is not None and len(fg_coords):
        center = fg_coords[rng.integers(len(fg_coords))]
        return tuple(
            int(np.clip(c - p // 2, 0, m))
            for c, p, m in zip(center, patch, max_corner)
        )
    return tuple(int(rng.integers(m + 1)) for m in max_corner)


def extract_patch_dataset(
    volumes: Sequence[np.ndarray],
    segmentations: Sequence[np.ndarray],
    plans: dict[str, Any],
    n_patches: int,
    seed: int = 0,
    configuration: str | None = None,
    oversample_foreground: float = 1.0 / 3.0,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (x [N, *patch, C] float32 normalized, y [N, *patch] int32).

    Volumes are channels-last; shorter-than-patch axes are zero-padded (the
    nnU-Net pad-to-patch behavior). Every ~third patch is forced to contain
    foreground.
    """
    if configuration is None:
        configuration = default_configuration(plans)
    cfg = plans["configurations"][configuration]
    patch = [int(p) for p in cfg["patch_size"]]
    props = plans["foreground_intensity_properties_per_channel"]
    rng = np.random.default_rng(seed)

    normed = [normalize_volume(v, props) for v in volumes]
    # Pad any volume smaller than the patch in some axis.
    padded_v, padded_s = [], []
    for v, s in zip(normed, segmentations):
        pads = [(0, max(p - sh, 0)) for p, sh in zip(patch, v.shape[:-1])]
        padded_v.append(np.pad(v, pads + [(0, 0)]))
        padded_s.append(np.pad(np.asarray(s), pads))

    # Foreground coordinate tables, once per case (not per patch).
    fg_tables = [np.argwhere(s >= 1) for s in padded_s]

    n_channels = padded_v[0].shape[-1]
    xs = np.empty((n_patches, *patch, n_channels), np.float32)
    ys = np.empty((n_patches, *patch), np.int32)
    for i in range(n_patches):
        case = int(rng.integers(len(padded_v)))
        force_fg = (i % max(int(round(1.0 / oversample_foreground)), 1)) == 0
        corner = _random_patch_corner(
            rng, padded_v[case].shape[:-1], patch, fg_tables[case], force_fg
        )
        sl = tuple(slice(c, c + p) for c, p in zip(corner, patch))
        xs[i] = padded_v[case][sl]
        ys[i] = padded_s[case][sl]
    return xs, ys


def make_patch_resampler(
    volumes_per_client: Sequence[Sequence[np.ndarray]],
    segmentations_per_client: Sequence[Sequence[np.ndarray]],
    plans: dict[str, Any],
    n_patches: int,
    base_seed: int = 0,
    every: int = 1,
    **extract_kwargs: Any,
) -> Any:
    """-> ``train_data_provider`` for ``FederatedSimulation``: fresh patch
    banks per round (the sampling half of nnU-Net's per-iteration random
    crops — the reference's loaders draw new crops every batch; here the bank
    refreshes every ``every`` rounds and the index plans shuffle within
    it). Each client's stream is seeded by (base_seed, client, round) so runs
    are reproducible and clients decorrelated."""

    def provider(round_idx: int):
        if (round_idx - 1) % every != 0 or round_idx == 1:
            # round 1 keeps the construction-time bank (seeded identically),
            # so resampling only changes data from round `1+every` on.
            return None
        xs, ys = [], []
        for ci, (v, s) in enumerate(
            zip(volumes_per_client, segmentations_per_client)
        ):
            x, y = extract_patch_dataset(
                v, s, plans, n_patches,
                seed=base_seed + 100_003 * ci + round_idx,
                **extract_kwargs,
            )
            xs.append(x)
            ys.append(y)
        return xs, ys

    return provider
