"""Aggregation of partial payloads (counterpart of
``fl4health_tpu/strategies/dynamic_layer.py``): ``FedAvgDynamicLayer``
averages each leaf over the clients that sent it, ``FedAvgSparse`` each
element. The payloads are full-shaped with 0/1 masks
(``LayerMaskPacket``, ``SparseMaskPacket``), so "over the senders" is a
masked weighted sum over the sender weight; a leaf or element nobody sent
keeps its previous global value. The state's ``updated`` marks what the
last aggregation refreshed, and rides the client payload so a pull
replaces only that. Every sum over clients is ``client_total``, so under
a mesh each rank sums all ranks' blocks."""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.core import aggregate as agg
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.exchange.packer import LayerMaskPacket, SparseMaskPacket
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MaskedAvgState:
    params: Params
    updated: Params  # what the last aggregation refreshed (0/1 f32)


def _cohort(results: FitResults, weighted: bool) -> torch.Tensor:
    counts = (results.sample_counts if weighted
              else torch.ones_like(results.sample_counts))
    return results.mask * counts  # [clients]


class FedAvgDynamicLayer(Strategy):
    """Per-leaf sender-averaged aggregation, weighted by sample counts
    among the senders."""

    def __init__(self, weighted_aggregation: bool = True):
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> MaskedAvgState:
        # nothing aggregated yet: round 1's pulls keep the client-local
        # weights (the server's broadcast at init)
        return MaskedAvgState(params=params, updated={
            k: torch.zeros((), dtype=torch.float32, device=p.device)
            for k, p in params.items()})

    def client_payload(self, server_state: MaskedAvgState, round_idx):
        return LayerMaskPacket(params=server_state.params, leaf_mask=server_state.updated)

    def aggregate(self, server_state: MaskedAvgState, results: FitResults,
                  round_idx) -> MaskedAvgState:
        packets: LayerMaskPacket = results.packets
        cohort = _cohort(results, self.weighted_aggregation)
        params, updated = {}, {}
        for k, prev in server_state.params.items():
            w = cohort * packets.leaf_mask[k]  # [clients]
            total = agg.client_total(w)
            wn = torch.where(total > 0, w / torch.clamp(total, min=1e-12), w)
            vals = packets.params[k].to(torch.float32)
            avg = agg.client_total(vals * agg.expand_clients(wn, vals))
            params[k] = torch.where(total > 0, avg, prev.to(torch.float32)).to(prev.dtype)
            updated[k] = (total > 0).to(torch.float32)
        return MaskedAvgState(params=params, updated=updated)


class FedAvgSparse(Strategy):
    """Element-granular sender-averaged aggregation (the reference's sparse
    COO semantics)."""

    def __init__(self, weighted_aggregation: bool = True):
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> MaskedAvgState:
        # f32 masks in every round, as aggregate returns them
        return MaskedAvgState(params=params, updated={
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})

    def client_payload(self, server_state: MaskedAvgState, round_idx):
        return SparseMaskPacket(params=server_state.params,
                                element_mask=server_state.updated)

    def aggregate(self, server_state: MaskedAvgState, results: FitResults,
                  round_idx) -> MaskedAvgState:
        packets: SparseMaskPacket = results.packets
        cohort = _cohort(results, self.weighted_aggregation)
        params, updated = {}, {}
        for k, prev in server_state.params.items():
            sel = packets.element_mask[k].to(torch.float32)
            w = sel * agg.expand_clients(cohort, sel)  # [clients, ...]
            total = agg.client_total(w)  # a sender weight per element
            s = agg.client_total(packets.params[k].to(torch.float32) * w)
            avg = s / torch.clamp(total, min=1e-12)
            params[k] = torch.where(total > 0, avg, prev.to(torch.float32)).to(prev.dtype)
            updated[k] = (total > 0).to(torch.float32)
        return MaskedAvgState(params=params, updated=updated)
