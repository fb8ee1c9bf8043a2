"""Differential privacy (counterpart of ``fl4health_tpu/privacy/``): RDP
accounting (``rdp``, ``accountants``) and the DP-SGD primitives
(``dpsgd``: per-example clipping and noising)."""

from fl4health_tpu_torch.privacy.accountants import (
    FixedSamplingWithoutReplacement,
    FlClientLevelAccountantFixedSamplingNoReplacement,
    FlClientLevelAccountantPoissonSampling,
    FlInstanceLevelAccountant,
    MomentsAccountant,
    PoissonSampling,
)
from fl4health_tpu_torch.privacy.dpsgd import (
    clip_per_example,
    gaussian_noise_like,
    noisy_clipped_mean_grads,
    validate_dp_safe_model_state,
)

__all__ = [
    "FixedSamplingWithoutReplacement",
    "FlClientLevelAccountantFixedSamplingNoReplacement",
    "FlClientLevelAccountantPoissonSampling",
    "FlInstanceLevelAccountant",
    "MomentsAccountant",
    "PoissonSampling",
    "clip_per_example",
    "gaussian_noise_like",
    "noisy_clipped_mean_grads",
    "validate_dp_safe_model_state",
]
