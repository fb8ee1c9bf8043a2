"""FedSimCLR client logic, federated self-supervised contrastive
pretraining (counterpart of ``fl4health_tpu/clients/fedsimclr.py``).

A batch carries the two views as ``(x, y)``, as the reference's
``SslTensorDataset`` pairs them; both go through the same model and
NT-Xent ties each projection to its pair's. The fine-tuning stage is
plain classification (``ClientLogic`` over ``FedSimClrModel(pretrain=
False)``).
"""

from __future__ import annotations

from fl4health_tpu_torch import rng as rng_mod
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.losses.contrastive import ntxent_loss


class FedSimClrClientLogic(ClientLogic):
    """NT-Xent between the projections of the two views; pair with
    ``models.bases.FedSimClrModel(pretrain=True)``."""

    def __init__(self, model, temperature: float = 0.5):
        super().__init__(model, criterion=None)
        self.temperature = temperature

    def predict(self, params, model_state, batch: Batch, rng=None, train: bool = False,
                extra=None, ctx=None):
        keyed = self.model.takes_rng
        (preds, features), new_state = self.model.apply(
            params, model_state, batch.x, train=train, **({"rng": rng} if keyed else {}))
        # the second view through the same model (on the first's new state,
        # as in JAX), its noise decorrelated from the first's (a model that
        # draws at apply time)
        view = {}
        if keyed:
            view["rng"] = None if rng is None else rng_mod.fold_in(rng, 1)
        (t_preds, _), new_state = self.model.apply(params, new_state, batch.y,
                                                   train=train, **view)
        return ({**preds, "transformed": t_preds["prediction"]}, features), new_state

    def _ntxent(self, preds, batch: Batch):
        return ntxent_loss(preds["prediction"], preds["transformed"],
                           temperature=self.temperature, mask=batch.example_mask)

    def training_loss(self, preds, features, batch: Batch, params, state: TrainState,
                      ctx):
        return self._ntxent(preds, batch), {}

    def eval_loss(self, preds, features, batch: Batch, params, state: TrainState, ctx):
        return self._ntxent(preds, batch), {}
