"""nnU-Net federated segmentation client (counterpart of
``fl4health_tpu/clients/nnunet.py``): the deep-supervision Dice + CE loss
with ignore-label masking, on-device augmentation in the engine's
``augment`` hook (on by default, as in JAX), and the client half of the
plans handshake (``make_nnunet_properties_provider``). The optimizer recipe
is ``nnunet.plans.nnunet_optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, ModelDef
from fl4health_tpu_torch.losses.segmentation import deep_supervision_loss, masked_dice_ce_loss
from fl4health_tpu_torch.nnunet.plans import extract_fingerprint, generate_plans, plans_to_bytes


class NnunetClientLogic(ClientLogic):
    """Deep-supervision segmentation on the shared engine."""

    extra_loss_keys = ("dice", "ce")
    eval_loss_keys = ("dice", "ce")

    def __init__(self, model: ModelDef, ds_strides: Sequence[Sequence[int]],
                 ignore_label: int | None = None, augment: bool = True):
        super().__init__(model, criterion=None)
        self.ds_strides = tuple(tuple(int(f) for f in s) for s in ds_strides)
        self.ignore_label = ignore_label
        self.augment_enabled = augment

    def augment(self, batch: Batch, rng_key, ctx):
        """nnU-Net's augmentation of the step's patches
        (``nnunet/augment.py``), keyed by the step; ``augment=False`` trains
        on the raw patches."""
        if not self.augment_enabled:
            return batch
        from fl4health_tpu_torch.nnunet.augment import augment_patch_batch

        x, y = augment_patch_batch(batch.x, batch.y, rng_key)
        return dataclasses.replace(batch, x=x, y=y)

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, dice, ce = deep_supervision_loss(preds, batch.y, batch.example_mask,
                                                self.ds_strides, self.ignore_label)
        return total, {"dice": dice, "ce": ce}

    def eval_loss(self, preds, features, batch: Batch, params, state, ctx):
        total, dice, ce = masked_dice_ce_loss(preds["prediction"], batch.y,
                                              batch.example_mask, self.ignore_label)
        return total, {"dice": dice, "ce": ce}


def make_nnunet_properties_provider(
    volumes: Sequence[np.ndarray],
    spacings: Sequence[Sequence[float]],
    segmentations: Sequence[np.ndarray],
    num_classes: int | None = None,
    dataset_name: str = "client_dataset",
    configuration: str | None = None,
    max_patch_voxels: int | None = None,
    ignore_label: int | None = None,
) -> Callable[[Mapping[str, Any]], dict[str, Any]]:
    """The client half of the plans handshake (``get_properties``): on
    request, the local fingerprint and plans (computed once, on the first
    request), returned as ``{nnunet_plans, num_input_channels,
    num_segmentation_heads}``. Without ``num_classes`` the heads are the
    highest real label + 1 (the ignore label is not a class)."""
    cache: dict[str, Any] = {}

    def provider(request: Mapping[str, Any]) -> dict[str, Any]:
        if "plans" not in cache:
            fingerprint = extract_fingerprint(volumes, spacings, segmentations)
            cache["fingerprint"] = fingerprint
            cache["plans"] = generate_plans(fingerprint, dataset_name=dataset_name,
                                            configuration=configuration,
                                            max_patch_voxels=max_patch_voxels)
        n_classes = num_classes
        if n_classes is None:
            labels = np.unique(np.concatenate([np.unique(s) for s in segmentations]))
            if ignore_label is not None:
                labels = labels[labels != ignore_label]
            n_classes = int(labels.max()) + 1
        return {"nnunet_plans": plans_to_bytes(cache["plans"]),
                "num_input_channels": int(cache["fingerprint"]["num_channels"]),
                "num_segmentation_heads": n_classes}

    return provider
