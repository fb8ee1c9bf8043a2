"""Parameter exchangers (counterpart of ``fl4health_tpu/exchange/exchanger.py``:
``FullExchanger`` and ``FixedLayerExchanger`` with its factories).

An exchanger is a pair of functions over ``Params`` dicts: ``push(params,
initial_params)`` gives what a client sends, ``pull(payload, local)``
merges what it receives into its own params. A partial exchange selects
leaves by their dotted path (``"layer_0.attn.q_proj.lora_a"``) with a
static mask, so under the client vmap a pull is a dict of picks, never a
branch on a tensor. ``DynamicLayerExchanger`` (whole leaves by drift norm)
and ``SparseExchanger`` (a global top-k of elements) choose on the device:
their masks are 0/1 tensors, chosen by a stable sort, so ties go to the
lower index as JAX's stable ``argsort`` and ``lax.top_k`` send them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import LayerMaskPacket, SparseMaskPacket


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


def _mask_top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 f32 over ``scores`` marking its ``k`` largest, ties to the lower
    index (a stable descending sort)."""
    top = torch.sort(scores, descending=True, stable=True).indices[:k]
    return torch.zeros_like(scores, dtype=torch.float32).scatter(
        0, top, torch.ones(k, dtype=torch.float32, device=scores.device))


def _blend(mask: Params, server: Params, local: Params) -> Params:
    """``m * server + (1 - m) * local`` leaf by leaf, in the local dtype."""
    return {k: (mask[k] * server[k] + (1.0 - mask[k]) * v).to(v.dtype)
            for k, v in local.items()}


@dataclasses.dataclass(frozen=True)
class DynamicLayerExchanger:
    """Per-round leaf selection by drift norm ``||local - initial||_2``
    (over ``sqrt(size)`` when ``normalized``): ``"threshold"`` sends the
    leaves above ``threshold``, ``"topk"`` the ``ceil(exchange_fraction *
    n_leaves)`` largest. ``push`` gives a ``LayerMaskPacket``
    (``FedAvgDynamicLayer`` averages each leaf over its senders); ``pull``
    replaces only the leaves the payload's mask marks refreshed."""

    mode: str = "threshold"  # "threshold" | "topk"
    threshold: float = 0.1
    exchange_fraction: float = 0.5
    normalized: bool = True
    # the simulation hands pull() the strategy's whole payload (the packet
    # with the refreshed-leaf mask), not just its params
    wants_packet_payload = True

    def __post_init__(self):
        if self.mode not in ("threshold", "topk"):
            raise ValueError(f"mode must be 'threshold' or 'topk', got {self.mode!r}")

    def push(self, params: Params, initial_params: Params | None = None) -> LayerMaskPacket:
        if initial_params is None:
            raise ValueError("DynamicLayerExchanger.push needs initial_params "
                             "(drift is measured against the round's received params)")
        order = ptu.flax_leaf_order(params)

        def norm(k):
            d = (params[k] - initial_params[k]).reshape(-1)
            n = torch.linalg.vector_norm(d)
            return n / math.sqrt(float(d.numel())) if self.normalized else n

        scores = torch.stack([norm(k) for k in order])
        if self.mode == "threshold":
            sel = (scores > self.threshold).to(torch.float32)
        else:
            # the epsilon keeps an integral product (0.1 * 30) from rounding
            # up one leaf more
            k = max(1, math.ceil(self.exchange_fraction * len(order) - 1e-9))
            sel = _mask_top(scores, k)
        index = {k: i for i, k in enumerate(order)}
        leaf_mask = {k: sel[index[k]] for k in params}
        masked = {k: (leaf_mask[k] * p).to(p.dtype) for k, p in params.items()}
        return LayerMaskPacket(params=masked, leaf_mask=leaf_mask)

    def pull(self, payload: LayerMaskPacket | Params, local: Params) -> Params:
        # the mask marks the server leaves aggregation refreshed: only those
        # replace local weights; bare params (a restore) replace everything
        if not isinstance(payload, LayerMaskPacket):
            return {k: payload[k].to(v.dtype) for k, v in local.items()}
        return _blend(payload.leaf_mask, payload.params, local)


@dataclasses.dataclass(frozen=True)
class SparseExchanger:
    """Scored element-subset exchange: ``score_fn(params, initial_params)``
    (default ``|params|``, the largest final magnitudes) and the top
    ``sparsity_level`` fraction of ALL elements sent, a global top-k over
    the flat vector in JAX's leaf order (``core/pytree.py`` ``ravel``)."""

    sparsity_level: float = 0.1
    score_fn: Callable[[Params, Params], Params] = None  # type: ignore[assignment]
    wants_packet_payload = True

    def _scores(self, params: Params, initial: Params) -> Params:
        if self.score_fn is not None:
            return self.score_fn(params, initial)
        return {k: p.abs() for k, p in params.items()}

    def push(self, params: Params, initial_params: Params | None = None) -> SparseMaskPacket:
        if initial_params is None and self.score_fn is not None:
            raise ValueError("SparseExchanger.push needs initial_params when a "
                             "drift-based score_fn is set")
        flat, unravel = ptu.ravel(self._scores(params, initial_params))
        n = flat.shape[0]
        k = max(1, min(n, int(round(self.sparsity_level * n))))
        # an exact top-k: a >= threshold test would over-select on ties
        # (mostly-zero weights would degrade to a full exchange)
        mask = unravel(_mask_top(flat, k))
        mask = {key: mask[key].to(torch.float32) for key in mask}
        masked = {key: (mask[key] * p).to(p.dtype) for key, p in params.items()}
        return SparseMaskPacket(params=masked, element_mask=mask)

    def pull(self, payload: SparseMaskPacket | Params, local: Params) -> Params:
        if not isinstance(payload, SparseMaskPacket):
            return {k: payload[k].to(v.dtype) for k, v in local.items()}
        return _blend(payload.element_mask, payload.params, local)
