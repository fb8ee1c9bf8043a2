"""Hand-written Hopper kernels for the hot ops (counterpart of
``fl4health_tpu/kernels/``): the DP clip kernels K1-K2 and the three
flash-attention kernels K3-K5, each behind a wrapper that launches its CUDA
kernel on a card tensor and runs its plain PyTorch version on a CPU one.
Importing this package builds nothing: an extension is built at its first
launch (``kernels/build.py``)."""

from fl4health_tpu_torch.kernels.dp_clip import (
    fused_clipped_masked_sum,
    per_example_sq_norms,
    scaled_masked_sum,
)
from fl4health_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_lse,
)

__all__ = [
    "fused_clipped_masked_sum",
    "per_example_sq_norms",
    "scaled_masked_sum",
    "flash_attention",
    "flash_attention_lse",
]
