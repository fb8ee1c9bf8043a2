"""Ensemble client logic (counterpart of ``fl4health_tpu/clients/ensemble.py``):
every member trains on each batch, one gradient of the summed member
losses (the members' params are disjoint, so it is each member's own
step); metrics read the members' mean (``models.bases.EnsembleModel``).
"""

from __future__ import annotations

from fl4health_tpu_torch.clients.engine import Batch, ClientLogic


class EnsembleClientLogic(ClientLogic):
    """Pair with ``models.bases.EnsembleModel`` and a ``FullExchanger``."""

    def __init__(self, model, criterion, n_members: int):
        super().__init__(model, criterion)
        self.n_members = n_members
        self.extra_loss_keys = tuple(f"member_{i}" for i in range(n_members))

    def training_loss(self, preds, features, batch: Batch, params, state, ctx):
        member_losses = {
            f"member_{i}": self.criterion(preds[f"ensemble-pred-{i}"], batch.y,
                                          batch.example_mask)
            for i in range(self.n_members)}
        return sum(member_losses.values()), member_losses
