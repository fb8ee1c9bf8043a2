"""PEFT / LoRA parameter filtering (counterpart of
``fl4health_tpu/utils/peft.py``). The adapters are ordinary params named
``lora_a``/``lora_b`` (``models/transformer.py`` ``LoraDense``), so PEFT is
two filters over the same ``Params`` dict: what crosses the wire
(``lora_exchanger``) and what trains (``lora_trainable_mask`` with
``masked_optimizer``). Markers match whole dotted path segments.
"""

from __future__ import annotations

from typing import Sequence

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger

# The path segments of PEFT-trainable leaves: the LoRA factors and the task
# head (peft's ``modules_to_save=["classifier"]``).
LORA_MARKERS: tuple[str, ...] = ("lora_a", "lora_b", "classifier")


def _has_marker(markers: tuple[str, ...]):
    return lambda path: any(m in path.split(".") for m in markers)


def peft_parameter_paths(params: Params, markers: Sequence[str] = LORA_MARKERS) -> list[str]:
    """Dotted paths of every PEFT parameter, in JAX's leaf order."""
    has = _has_marker(tuple(markers))
    return [p for p in ptu.leaf_paths(params) if has(p)]


def lora_exchanger(markers: Sequence[str] = LORA_MARKERS) -> FixedLayerExchanger:
    """Only the adapters and the head cross the wire."""
    return FixedLayerExchanger(include=_has_marker(tuple(markers)))


def lora_trainable_mask(params: Params, markers: Sequence[str] = LORA_MARKERS) -> dict[str, bool]:
    """True where the leaf trains (adapters and head)."""
    return ptu.select_by_path(params, _has_marker(tuple(markers)))


def masked_optimizer(tx: optim.GradientTransformation,
                     trainable_mask: dict[str, bool]) -> optim.GradientTransformation:
    """Freeze the untrainable leaves: ``tx`` where the mask is True,
    ``set_to_zero`` elsewhere (``multi_transform`` over the mask)."""
    labels = {k: "train" if t else "freeze" for k, t in trainable_mask.items()}
    return optim.multi_transform({"train": tx, "freeze": optim.set_to_zero()}, labels)
