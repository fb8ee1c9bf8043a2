"""Loss meters (counterpart of ``LossMeter`` in
``fl4health_tpu/losses/containers.py``)."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class LossMeter:
    """Running weighted sums of loss dicts, averaged by ``compute`` (the
    JAX meter's AVERAGE type). ``weight`` masks padded steps."""

    sums: Mapping[str, torch.Tensor]
    count: torch.Tensor

    @classmethod
    def create(cls, keys: tuple[str, ...],
               device: torch.device | str = "cpu") -> "LossMeter":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(sums={k: zero for k in keys}, count=zero)

    def update(self, losses: Mapping[str, torch.Tensor], weight=1.0) -> "LossMeter":
        w = torch.as_tensor(weight, dtype=torch.float32, device=self.count.device)
        sums = {k: self.sums[k] + w * torch.as_tensor(losses[k], dtype=torch.float32)
                for k in self.sums}
        return LossMeter(sums, self.count + w)

    def compute(self) -> dict:
        c = torch.clamp(self.count, min=1.0)
        return {k: v / c for k, v in self.sums.items()}
