"""nnU-Net federated 3-D segmentation (counterpart of
``fl4health_tpu/nnunet``): the numpy planner and fingerprint
(``plans.py``), normalisation and patching (``data.py``) and on-device
augmentation (``augment.py``); the model is ``models/unet.py``, the losses
``losses/segmentation.py``, the handshake ``clients/nnunet.py`` and
``server/nnunet.py``; a trained model predicts whole volumes through
sliding-window inference (``inference.py``).
"""

from fl4health_tpu_torch.nnunet.augment import augment_patch_batch
from fl4health_tpu_torch.nnunet.data import (extract_patch_dataset, make_patch_resampler,
                                             normalize_volume)
from fl4health_tpu_torch.nnunet.inference import (gaussian_importance_map,
                                                  sliding_window_predict)
from fl4health_tpu_torch.nnunet.plans import (default_configuration, extract_fingerprint,
                                              generate_plans, localize_plans,
                                              nnunet_optimizer, plans_from_bytes,
                                              plans_to_bytes, poly_lr_schedule)

__all__ = [
    "default_configuration",
    "extract_fingerprint",
    "generate_plans",
    "localize_plans",
    "nnunet_optimizer",
    "plans_from_bytes",
    "plans_to_bytes",
    "poly_lr_schedule",
    "augment_patch_batch",
    "extract_patch_dataset",
    "make_patch_resampler",
    "normalize_volume",
    "gaussian_importance_map",
    "sliding_window_predict",
]
