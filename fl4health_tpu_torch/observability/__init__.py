"""Observability (counterpart of ``fl4health_tpu/observability``): only the
run manifest's ``config_hash`` so far, which state checkpoints bind to."""

from fl4health_tpu_torch.observability.manifest import config_hash

__all__ = ["config_hash"]
