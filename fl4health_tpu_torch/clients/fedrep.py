"""FedPer, FedRep and FedBN client logics, personalisation by the
exchange boundary (counterpart of ``fl4health_tpu/clients/fedrep.py``).

- FedPer: a shared feature extractor and a private head, a plain logic
  over ``FixedLayerExchanger(SequentiallySplitModel.exchange_features_only)``.
- FedBN: every layer but the normalisation layers exchanged, a plain logic
  over ``exchange.norm_exclusion_exchanger()``; the batch statistics stay
  local because ``TrainState.model_state`` is never exchanged.
- FedRep: FedPer's split, but each round first trains the head alone for
  ``head_steps`` local steps, then the representation alone. The freezing
  is a gradient mask keyed on the step within the round
  (``transform_gradients``), one program for both phases.
"""

from __future__ import annotations

import dataclasses

import torch

from fl4health_tpu_torch.clients.engine import ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import select_by_path, tree_dataclass
from fl4health_tpu_torch.core.types import Params

# FedPer and FedBN need no logic subclass, only an exchanger
FedPerClientLogic = ClientLogic
FedBnClientLogic = ClientLogic


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class FedRepContext:
    round_start_step: torch.Tensor  # state.step when the round began


class FedRepClientLogic(ClientLogic):
    """Pair with ``models.bases.FedRepModel`` and
    ``FixedLayerExchanger(SequentiallySplitModel.exchange_features_only)``;
    ``head_steps`` head-only steps start every round, the rest train the
    representation only."""

    def __init__(self, model, criterion, head_steps: int, head_predicate=None):
        super().__init__(model, criterion)
        self.head_steps = head_steps
        self.head_predicate = head_predicate or (lambda path: path.startswith("head_module"))

    def init_round_context(self, state: TrainState, payload) -> FedRepContext:
        return FedRepContext(round_start_step=state.step)

    def transform_gradients(self, grads: Params, state: TrainState,
                            ctx: FedRepContext) -> Params:
        head_phase = ((state.step - ctx.round_start_step) < self.head_steps).float()
        is_head = select_by_path(grads, self.head_predicate)
        return {k: g * (head_phase if is_head[k] else 1.0 - head_phase)
                for k, g in grads.items()}
