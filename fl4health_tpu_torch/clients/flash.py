"""The Flash client's local training (counterpart of
``fl4health_tpu/clients/flash.py``): epoch-wise training that validates
after every local epoch and stops once the validation loss improves by
less than ``gamma / (epoch + 1)``. There is no best-state restore: the
client returns the state it stopped at.

The stop is a per-client flag (``stopped``), never a host branch: a
stopped client runs every later epoch's steps with its step masks zeroed
(full no-ops, as padding steps are), and its epoch counter and previous
loss stand still, so under the client vmap every client walks the same
steps, as JAX's scan of epochs does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.losses.containers import LossMeter
from fl4health_tpu_torch.metrics.base import MetricManager


@dataclasses.dataclass(frozen=True)
class FlashEarlyStopConfig:
    """``gamma``: the improvement threshold; None disables the stop rule
    (every epoch runs). ``n_epochs`` must equal the simulation's
    ``local_epochs``: the rule is defined per epoch, and with uneven client
    data the epochs' boundaries follow the cohort-padded step count."""

    gamma: float | None
    n_epochs: int


def make_flash_local_train(
    logic: ClientLogic,
    tx,
    metric_manager: MetricManager,
    config: FlashEarlyStopConfig,
    loss_keys: tuple[str, ...] = ("backward",),
    precision=None,
):
    """train(state, ctx, batches, val_batches) -> (state, loss_dict,
    metric_dict, n_steps), the engine's outputs; ``n_steps`` counts the
    steps that ran unmasked. ``precision`` reaches the train steps; the
    gamma rule's validation scores the f32 master weights."""
    step_fn = engine.make_train_step(logic, tx, precision=precision)
    evaluate = engine.make_local_eval(logic, metric_manager)
    n_epochs = config.n_epochs

    def train(state: TrainState, ctx: Any, batches: Batch, val_batches: Batch):
        device = batches.step_mask.device
        total = batches.step_mask.shape[0]
        steps_per_epoch = total // n_epochs
        if steps_per_epoch * n_epochs != total:
            raise ValueError(
                f"batch stream ({total} steps) must divide into n_epochs={n_epochs}")
        meter = LossMeter.create(loss_keys, device=device)
        mstate = metric_manager.init(device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        prev_loss = torch.full((), float("inf"), dtype=torch.float32, device=device)
        stopped, epochs_run, executed = zero, zero, zero
        for e in range(n_epochs):
            for s in range(e * steps_per_epoch, (e + 1) * steps_per_epoch):
                batch = tree_map(lambda a: a[s], batches)
                batch = dataclasses.replace(batch,
                                            step_mask=batch.step_mask * (1.0 - stopped))
                state, out = step_fn(state, ctx, batch)
                meter = meter.update(out.losses, weight=out.step_mask)
                mstate = metric_manager.update(mstate, out.preds, out.targets,
                                               out.example_mask)
                executed = executed + out.step_mask
            current = evaluate(state, ctx, val_batches)[0]["checkpoint"]
            live = stopped < 0.5
            if config.gamma is not None:
                # the threshold's denominator: this live epoch's 0-based
                # index + 1
                threshold = config.gamma / (epochs_run + 1.0)
                should_stop = ((prev_loss - current) < threshold) & live
                stopped = torch.maximum(stopped, should_stop.to(torch.float32))
            prev_loss = torch.where(live, current, prev_loss)
            epochs_run = epochs_run + live.to(torch.float32)
        state = logic.finalize_round(state, ctx, executed)
        return state, meter.compute(), metric_manager.compute(mstate), executed

    return train
