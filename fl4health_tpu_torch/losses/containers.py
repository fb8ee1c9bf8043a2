"""Loss containers and meters (counterpart of
``fl4health_tpu/losses/containers.py``): ``TrainingLosses`` and
``EvaluationLosses`` (the differentiated or checkpoint loss beside named
additional losses), and ``LossMeter`` with the AVERAGE and ACCUMULATION
types."""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import torch

from fl4health_tpu_torch.core.pytree import tree_dataclass


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class TrainingLosses:
    backward: torch.Tensor  # the loss that was differentiated
    additional: Mapping[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"backward": self.backward, **dict(self.additional)}


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class EvaluationLosses:
    checkpoint: torch.Tensor  # the loss checkpoints select on
    additional: Mapping[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"checkpoint": self.checkpoint, **dict(self.additional)}


class LossMeterType(enum.Enum):
    AVERAGE = "AVERAGE"
    ACCUMULATION = "ACCUMULATION"


@dataclasses.dataclass(frozen=True)
class LossMeter:
    """Running weighted sums of loss dicts: ``compute`` divides by the
    summed weight (AVERAGE) or hands the sums back (ACCUMULATION).
    ``weight`` masks padded steps."""

    sums: Mapping[str, torch.Tensor]
    count: torch.Tensor
    meter_type: str = "AVERAGE"

    @classmethod
    def create(cls, keys: tuple[str, ...], meter_type: str = "AVERAGE",
               device: torch.device | str = "cpu") -> "LossMeter":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(sums={k: zero for k in keys}, count=zero, meter_type=meter_type)

    def update(self, losses: Mapping[str, torch.Tensor], weight=1.0) -> "LossMeter":
        w = torch.as_tensor(weight, dtype=torch.float32, device=self.count.device)
        sums = {k: self.sums[k] + w * torch.as_tensor(losses[k], dtype=torch.float32)
                for k in self.sums}
        return dataclasses.replace(self, sums=sums, count=self.count + w)

    def compute(self) -> dict:
        if self.meter_type == "ACCUMULATION":
            return dict(self.sums)
        c = torch.clamp(self.count, min=1.0)
        return {k: v / c for k, v in self.sums.items()}
