"""FedPM client (counterpart of ``fl4health_tpu/clients/fedpm.py``): trains
Bernoulli scores over frozen weights and ships sampled binary masks.

Training is the plain engine loop over a model of ``models/masked.py``
layers (the scores are the params, the frozen weights the ``frozen``
collection of ``TrainState.model_state``), the mask draws inside the
layers keyed by the step key's ``mask`` stream. The wire packet is one
sampled binary mask per score tensor; the server's Beta-posterior
``theta`` comes back through the plain ``FullExchanger`` straight into the
scores (the reference's score/probability aliasing).
"""

from __future__ import annotations

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients.engine import ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import flax_leaf_order
from fl4health_tpu_torch.core.types import Params


def sample_masks(scores: Params, key: torch.Tensor) -> Params:
    """Binary masks ~ Bernoulli(sigmoid(scores)), leaf by leaf: the key
    split into one a leaf in JAX's flatten order of the score tree."""
    order = flax_leaf_order(scores)
    keys = rng.split(key, len(order))
    masks = {name: rng.bernoulli(keys[i], torch.sigmoid(scores[name])).to(torch.float32)
             for i, name in enumerate(order)}
    return {name: masks[name] for name in scores}


class FedPmClientLogic(ClientLogic):
    """The engine's training over a masked model; the packet is a mask
    per score tensor, drawn from ``fold_in(state.rng, state.step)``."""

    def pack(self, state: TrainState, pushed_params: Params, train_losses: dict):
        return sample_masks(pushed_params, rng.fold_in_many(state.rng, state.step))
