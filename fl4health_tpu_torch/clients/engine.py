"""Client training engine (counterpart of ``fl4health_tpu/clients/engine.py``).

One local-training phase is a loop of train steps over a ``[steps, B, ...]``
stack of batches. Ragged data is handled as in the JAX engine: padding rows
carry ``example_mask`` 0 and padding steps ``step_mask`` 0, and a padding
step moves nothing (params, optimizer state and meters are selected back).
The index plans are the JAX engine's numpy code, copied unchanged, so both
packages draw the same batches from the same entropy.

Randomness: the JAX engine splits ``state.rng`` once per step. Here each
step gets a ``torch.Generator`` on the data's device, seeded from the
client's round entropy (the index plans' ``[0, seed, 1000 + round,
client]``) and the step index, so every client and step draws its own
reproducible stream; ``value_and_grads`` receives it, and a logic that draws
nothing (the plain ``ClientLogic``) ignores it.

Left out here: the precision (loss scaling), ZeRO-2 microbatching,
telemetry and early-stopping branches; and the algorithm hooks no
ported logic overrides yet (``init_extra``/``TrainState.extra``,
``transform_gradients``, ``update_before_step``/``update_after_step``,
``finalize_round``, ``augment``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.losses.containers import LossMeter
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.optim import GradientTransformation, apply_updates


# ---------------------------------------------------------------------------
# Data containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Batch:
    """One step's data; a leading [steps] (and [clients]) axis when stacked.
    example_mask: [B] validity; step_mask: scalar 0/1."""

    x: torch.Tensor
    y: torch.Tensor
    example_mask: torch.Tensor
    step_mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Params
    opt_state: Any
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepOutput:
    losses: dict
    preds: torch.Tensor
    targets: torch.Tensor
    example_mask: torch.Tensor
    step_mask: torch.Tensor


# ---------------------------------------------------------------------------
# Model definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelDef:
    """init(generator) -> params; apply(params, x, train) -> (preds, features).
    ``preds`` holds at least ``"prediction"``; ``module`` is the wrapped
    module, for checks of its structure (DP's BatchNorm check)."""

    init: Callable[[torch.Generator], Params]
    apply: Callable[..., tuple[dict, dict]]
    module: torch.nn.Module | None = None


def from_module(module: torch.nn.Module) -> ModelDef:
    """Wrap a module with ``init_params(generator)`` whose forward returns
    ``(preds_dict, features_dict)``; params are applied functionally, keyed
    by flax path."""

    def init(generator: torch.Generator) -> Params:
        return module.init_params(generator)

    def apply(params: Params, x: torch.Tensor, train: bool = True):
        named = {k.replace("/", "."): v for k, v in params.items()}
        return functional_call(module, named, (x,))

    return ModelDef(init=init, apply=apply, module=module)


# ---------------------------------------------------------------------------
# Client logic
# ---------------------------------------------------------------------------

class ClientLogic:
    """The hooks of the JAX ``ClientLogic`` that the port's path uses;
    ``ctx`` is the per-round context from ``init_round_context``."""

    def __init__(self, model: ModelDef, criterion: Callable):
        self.model = model
        self.criterion = criterion  # (logits, targets, example_mask) -> scalar

    def init_round_context(self, state: TrainState, server_payload: Any) -> Any:
        return None

    def predict(self, params: Params, batch: Batch, train: bool, ctx=None):
        del ctx
        return self.model.apply(params, batch.x, train=train)

    def training_loss(self, preds: dict, features: dict, batch: Batch,
                      params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def eval_loss(self, preds: dict, features: dict, batch: Batch,
                  params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def value_and_grads(self, state: TrainState, ctx: Any, batch: Batch,
                        generator: torch.Generator):
        """-> ((backward, (preds, additional)), grads) by whole-batch autograd.
        ``generator`` is the step's random stream; nothing here draws."""
        del generator
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        with torch.enable_grad():
            preds, features = self.predict(params, batch, train=True, ctx=ctx)
            backward, additional = self.training_loss(preds, features, batch,
                                                      params, state, ctx)
            grads = torch.autograd.grad(backward, list(params.values()))
        preds = tree_map(torch.Tensor.detach, preds)
        return ((backward.detach(), (preds, additional)),
                dict(zip(params.keys(), grads)))

    def pack(self, state: TrainState, pushed_params: Params, train_losses: dict) -> Any:
        return pushed_params


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid examples; integer or one-hot targets."""
    if targets.ndim == logits.ndim:
        per = -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    else:
        per = F.cross_entropy(logits, targets.long(), reduction="none")
    m = mask.float()
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Train / eval phases
# ---------------------------------------------------------------------------

def create_train_state(logic: ClientLogic, tx: GradientTransformation,
                       generator: torch.Generator,
                       device: torch.device) -> TrainState:
    params = {k: v.to(device) for k, v in logic.model.init(generator).items()}
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _mask_tree(new, old, keep: torch.Tensor):
    """new where keep > 0 (a real step) else old (a padding step)."""
    return tree_map(lambda n, o: torch.where(keep > 0, n, o), new, old)


def step_generator(entropy: list[int], step: int,
                   device: torch.device) -> torch.Generator:
    """The random stream of one local step: a generator on ``device`` seeded
    from the client's round entropy, with the step as the spawn key (so it is
    never the stream of an index plan drawn from ``[*entropy, e]``)."""
    seed = np.random.SeedSequence(entropy, spawn_key=(step,)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def make_train_step(logic: ClientLogic, tx: GradientTransformation):
    """step(state, ctx, batch, generator) -> (state, StepOutput)."""

    def step(state: TrainState, ctx: Any, batch: Batch,
             generator: torch.Generator):
        (backward, (preds, additional)), grads = logic.value_and_grads(
            state, ctx, batch, generator)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        keep = batch.step_mask  # padding steps must not move anything
        new_state = dataclasses.replace(
            state,
            params=_mask_tree(new_params, state.params, keep),
            opt_state=_mask_tree(new_opt_state, state.opt_state, keep),
            step=state.step + keep.to(torch.int32),
        )
        out = StepOutput(
            losses={"backward": backward, **additional},
            preds=preds["prediction"],
            targets=batch.y,
            example_mask=batch.example_mask * keep,
            step_mask=keep,
        )
        return new_state, out

    return step


def _step_slice(batches: Batch, s: int) -> Batch:
    return Batch(batches.x[s], batches.y[s], batches.example_mask[s],
                 batches.step_mask[s])


def make_local_train(logic: ClientLogic, tx: GradientTransformation,
                     metric_manager: MetricManager,
                     loss_keys: tuple[str, ...] = ("backward",)):
    """train(state, ctx, batches, entropy) -> (state, loss_dict, metric_dict,
    n_steps); ``batches`` carries a leading [steps] axis and ``entropy`` is
    the client's round entropy, which seeds each step's generator."""
    step_fn = make_train_step(logic, tx)

    def train(state: TrainState, ctx: Any, batches: Batch, entropy: list[int]):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device)
        mstate = metric_manager.init(device)
        for s in range(batches.step_mask.shape[0]):
            state, out = step_fn(state, ctx, _step_slice(batches, s),
                                 step_generator(entropy, s, device))
            meter = meter.update(out.losses, weight=out.step_mask)
            mstate = metric_manager.update(mstate, out.preds, out.targets,
                                           out.example_mask)
        n_steps = batches.step_mask.sum()
        return state, meter.compute(), metric_manager.compute(mstate), n_steps

    return train


def make_local_eval(logic: ClientLogic, metric_manager: MetricManager,
                    loss_keys: tuple[str, ...] = ("checkpoint",)):
    """evaluate(state, ctx, batches) -> (loss_dict, metric_dict)."""

    @torch.no_grad()
    def evaluate(state: TrainState, ctx: Any, batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device)
        mstate = metric_manager.init(device)
        for s in range(batches.step_mask.shape[0]):
            batch = _step_slice(batches, s)
            preds, features = logic.predict(state.params, batch, train=False, ctx=ctx)
            loss, additional = logic.eval_loss(preds, features, batch,
                                               state.params, state, ctx)
            meter = meter.update(
                {"checkpoint": loss,
                 **{k: additional[k] for k in meter.sums if k != "checkpoint"}},
                weight=batch.step_mask)
            mstate = metric_manager.update(mstate, preds["prediction"], batch.y,
                                           batch.example_mask * batch.step_mask)
        return meter.compute(), metric_manager.compute(mstate)

    return evaluate


# ---------------------------------------------------------------------------
# Host-side batching: index plans (numpy, copied from the JAX engine)
# ---------------------------------------------------------------------------

def epoch_index_plan(
    entropy: list[int],
    n: int,
    batch_size: int,
    n_steps: int | None = None,
    shuffle: bool = True,
    drop_last: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized batch-index plan: (idx [S,B] i32, example_mask [S,B] f32,
    step_mask [S] f32), all numpy.

    Semantics match the reference loader: one epoch (or exactly n_steps,
    wrapping with a fresh shuffle at each epoch boundary — train_by_steps
    cycles its loader, basic_client.py:699); ragged final batch rows get
    example_mask 0.
    """
    steps_per_epoch = max(1, n // batch_size if drop_last else -(-n // batch_size))
    total = n_steps if n_steps is not None else steps_per_epoch
    n_epochs = -(-total // steps_per_epoch)

    rng = np.random.default_rng(np.random.SeedSequence(entropy))
    if shuffle:
        orders = rng.permuted(
            np.tile(np.arange(n, dtype=np.int32), (n_epochs, 1)), axis=1
        )
    else:
        orders = np.tile(np.arange(n, dtype=np.int32), (n_epochs, 1))

    padded_len = steps_per_epoch * batch_size
    if padded_len <= n:
        epoch_idx = orders[:, :padded_len]
        epoch_mask = np.ones((padded_len,), np.float32)
    else:
        pad = padded_len - n
        epoch_idx = np.concatenate(
            [orders, np.zeros((n_epochs, pad), np.int32)], axis=1
        )
        epoch_mask = np.concatenate(
            [np.ones((n,), np.float32), np.zeros((pad,), np.float32)]
        )

    idx = epoch_idx.reshape(n_epochs * steps_per_epoch, batch_size)[:total]
    example_mask = np.tile(
        epoch_mask.reshape(steps_per_epoch, batch_size), (n_epochs, 1)
    )[:total]
    # A step with zero valid examples (e.g. an empty client dataset) is a full
    # no-op: the engine gates optimizer/meter updates on step_mask.
    step_mask = (example_mask.sum(axis=1) > 0).astype(np.float32)
    return idx, example_mask, step_mask


def multi_client_index_plans(
    entropies: list[list[int]],
    ns: list[int],
    batch_size: int,
    n_steps: int | None = None,
    local_epochs: int | None = None,
    shuffle: bool = True,
    pad_steps: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cohort-wide batch plan: (idx [C,S,B], example_mask [C,S,B],
    step_mask [C,S]) numpy arrays, padded to the cohort's max step count.

    ``pad_steps`` pins the step axis to a FIXED length instead of the
    cohort's max (extra steps carry step_mask 0, full no-ops). Raises if any
    client's plan exceeds it.
    """
    plans = []
    for ent, n in zip(entropies, ns):
        if local_epochs is not None:
            parts = [
                epoch_index_plan([*ent, e], n, batch_size, None, shuffle)
                for e in range(local_epochs)
            ]
            idx = np.concatenate([p[0] for p in parts], axis=0)
            em = np.concatenate([p[1] for p in parts], axis=0)
            sm = np.concatenate([p[2] for p in parts], axis=0)
        else:
            idx, em, sm = epoch_index_plan(ent, n, batch_size, n_steps, shuffle)
        plans.append((idx, em, sm))
    n_clients = len(plans)
    max_steps = max(p[0].shape[0] for p in plans)
    if pad_steps is not None:
        if max_steps > pad_steps:
            raise ValueError(
                f"pad_steps={pad_steps} is smaller than the largest "
                f"client plan ({max_steps} steps); the fixed step budget "
                "must cover every client in the registry"
            )
        max_steps = pad_steps
    idx_all = np.zeros((n_clients, max_steps, batch_size), np.int32)
    em_all = np.zeros((n_clients, max_steps, batch_size), np.float32)
    sm_all = np.zeros((n_clients, max_steps), np.float32)
    for c, (idx, em, sm) in enumerate(plans):
        s = idx.shape[0]
        idx_all[c, :s] = idx
        em_all[c, :s] = em
        sm_all[c, :s] = sm
    return idx_all, em_all, sm_all


def pad_and_stack_data(arrays: list, name: str,
                       device: torch.device) -> torch.Tensor:
    """Zero-pad per-client arrays along axis 0 to the longest and stack them
    -> one [C, max_n, ...] tensor on ``device`` (one transfer). Every client
    must share the example shape and dtype."""
    host = [np.asarray(a) for a in arrays]
    base = host[0].shape[1:]
    for i, a in enumerate(host):
        if a.shape[1:] != base or a.dtype != host[0].dtype:
            raise ValueError(
                f"client {i}'s {name} is {a.dtype} {a.shape[1:]} per example "
                f"but client 0's is {host[0].dtype} {base}; all clients must "
                "share one example shape and dtype")
    stack = np.zeros((len(host), max(a.shape[0] for a in host), *base),
                     host[0].dtype)
    for i, a in enumerate(host):
        stack[i, : a.shape[0]] = a
    return torch.from_numpy(stack).to(device)


def gather_batches(x_stack: torch.Tensor, y_stack: torch.Tensor,
                   idx: np.ndarray, example_mask: np.ndarray,
                   step_mask: np.ndarray) -> Batch:
    """One device-side gather from pre-stacked data -> [C,S,B,...] Batch."""
    device = x_stack.device
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
    c = torch.arange(idx_t.shape[0], device=device)[:, None, None]
    return Batch(
        x=x_stack[c, idx_t],
        y=y_stack[c, idx_t],
        example_mask=torch.from_numpy(np.asarray(example_mask)).to(device),
        step_mask=torch.from_numpy(np.asarray(step_mask)).to(device),
    )
