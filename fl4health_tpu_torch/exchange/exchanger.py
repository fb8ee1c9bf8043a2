"""Parameter exchangers (counterpart of ``fl4health_tpu/exchange/exchanger.py``:
``FullExchanger`` and ``FixedLayerExchanger`` with its factories).

An exchanger is a pair of functions over ``Params`` dicts: ``push(params,
initial_params)`` gives what a client sends, ``pull(payload, local)``
merges what it receives into its own params. A partial exchange selects
leaves by their dotted path (``"layer_0.attn.q_proj.lora_a"``) with a
static mask, so under the client vmap a pull is a dict of picks, never a
branch on a tensor. ``DynamicLayerExchanger`` and ``SparseExchanger`` are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import Params


class FullExchanger:
    """Exchange every leaf: ``push`` sends the params, ``pull`` takes the
    payload whole."""

    def push(self, params: Params, initial_params: Params | None = None) -> Params:
        del initial_params
        return params

    def pull(self, payload: Params, local: Params) -> Params:
        del local
        return payload


@dataclasses.dataclass(frozen=True)
class FixedLayerExchanger:
    """Exchange only the leaves whose dotted path satisfies ``include``
    (FedBN's exclusions are the negated predicate).

    ``push`` sends zeros for the leaves it does not exchange, so the stacked
    packets keep every leaf's shape; ``pull`` never reads them. A strategy
    that reads the whole packet (FedOpt's pseudo-gradient ``params - avg``)
    sees those zeros as the clients' values, as in JAX: a known defect of
    the reference, mirrored here."""

    include: Callable[[str], bool]

    def mask(self, params: Params) -> dict[str, bool]:
        return ptu.select_by_path(params, self.include)

    def push(self, params: Params, initial_params: Params | None = None) -> Params:
        del initial_params
        mask = self.mask(params)
        return {k: p if mask[k] else torch.zeros_like(p) for k, p in params.items()}

    def pull(self, payload: Params, local: Params) -> Params:
        return ptu.merge_by_mask(self.mask(local), payload, local)


def fixed_exchanger_excluding(excluded: Sequence[str]) -> FixedLayerExchanger:
    """Exchange every leaf except those whose path contains an excluded
    marker (a substring, as in JAX)."""
    excluded = tuple(excluded)
    return FixedLayerExchanger(include=lambda path: not any(s in path for s in excluded))


def fixed_exchanger_including(included: Sequence[str]) -> FixedLayerExchanger:
    """Exchange only the leaves whose path contains one of the markers."""
    included = tuple(included)
    return FixedLayerExchanger(include=lambda path: any(s in path for s in included))


_NORM_SEGMENTS = {"bn", "norm", "batch_stats", "batchnorm", "layernorm", "groupnorm"}
_NORM_PREFIXES = ("BatchNorm", "LayerNorm", "GroupNorm", "bn_", "norm_")


def _is_norm_segment(seg: str) -> bool:
    return seg.lower() in _NORM_SEGMENTS or seg.startswith(_NORM_PREFIXES)


def norm_exclusion_exchanger() -> FixedLayerExchanger:
    """FedBN: exchange everything except normalization layers. Matches whole
    path segments, not substrings: ``subnet.kernel`` is exchanged although
    ``bn`` appears inside ``subnet``."""
    return FixedLayerExchanger(
        include=lambda path: not any(_is_norm_segment(s) for s in path.split(".")))
