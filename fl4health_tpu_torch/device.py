"""Device selection for the port's entry points.

The port runs on an NVIDIA card. An entry point takes ``device`` (default
``"cuda"``) and resolves it here: asking for CUDA on a machine without it
raises instead of quietly training on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fl4health_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
