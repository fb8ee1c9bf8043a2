"""Client training engine (counterpart of ``fl4health_tpu/clients/engine.py``).

One local-training phase is a loop of train steps over a ``[steps, B, ...]``
stack of batches. Ragged data is handled as in the JAX engine: padding rows
carry ``example_mask`` 0 and padding steps ``step_mask`` 0, and a padding
step moves nothing (params, optimizer state and meters are selected back).
The index plans are the JAX engine's numpy code, copied unchanged, so both
packages draw the same batches from the same entropy.

Randomness, as in the JAX engine: ``TrainState.rng`` is a threefry key
(``rng.py``) and each step splits it, ``rng, step_rng = split(state.rng)``;
``value_and_grads`` receives ``step_rng`` (the DP client draws its noise
from it, the plain ``ClientLogic`` draws nothing). Every phase is pure
tensor code over one client, with a static Python loop over the step axis
(JAX's ``scan``), so the simulation runs all clients at once under
``torch.func.vmap``; gradients come from ``torch.func.grad_and_value``,
which composes with that vmap.

A train step first hands its batch to ``ClientLogic.augment`` with the key
``fold_in(step_rng, 0xA6)``, right after the step's key split, as in JAX:
the default returns the batch unchanged, so no other stream moves; the
nnU-Net logic augments its patches there.

A step's gradients pass through ``ClientLogic.transform_gradients`` after
``value_and_grads`` and before the optimizer, as in JAX: SCAFFOLD's
correction ``g - c_i + c`` lands there, and under DP on the clipped and
noised mean, once a step.

The step key also reaches the model, as flax's ``rngs["dropout"]``: a model
whose ``forward`` takes ``train`` and ``rng`` (``TransformerClassifier``)
draws its dropout masks from it on train calls.

Precision (``precision/policy.py``), as in JAX's ``make_train_step``: a
low-precision compute dtype wraps the logic's model so float params and
inputs are cast on train calls; under loss scaling (fp16) the backward is
seeded with the scale through ``torch.func.vjp``, the gradients are
unscaled in f32, a non-finite gradient skips the optimizer step (``keep *
finite``) and the scaler state in ``TrainState.loss_scale`` advances on
real steps only. A logic that computes its own gradients (DP) is refused
under scaling. Left out here: ZeRO-2 microbatching and telemetry; and the
algorithm hooks no ported logic overrides yet
(``update_before_step``/``update_after_step``).

Data may be a tree: ``x`` (or ``y``) a dict of arrays that share axis 0
(multi-input models, the reference's ``DictionaryDataset``); the stacking,
the index plans' gathers and the step slices go leaf by leaf, and the model
receives the structure it was given.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.core.pytree import tree_dataclass, tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.losses.containers import LossMeter
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.optim import GradientTransformation, apply_updates
from fl4health_tpu_torch.precision import policy as precision_policy


# ---------------------------------------------------------------------------
# Data containers
# ---------------------------------------------------------------------------

@tree_dataclass
@dataclasses.dataclass(frozen=True)
class Batch:
    """One step's data; a leading [steps] (and [clients]) axis when stacked.
    example_mask: [B] validity; step_mask: scalar 0/1."""

    x: torch.Tensor
    y: torch.Tensor
    example_mask: torch.Tensor
    step_mask: torch.Tensor


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Params
    opt_state: Any
    rng: torch.Tensor  # [2] int64 threefry key, split once a step
    step: torch.Tensor
    extra: Any = None  # a logic's persistent state (``init_extra``); None: empty
    # the loss-scale state {"scale", "growth", "skipped"} where the precision
    # policy scales (fp16); None otherwise
    loss_scale: Any = None


@tree_dataclass
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
    """init(generator) -> params; apply(params, x, train) -> (preds,
    features). ``preds`` holds at least ``"prediction"``; ``module`` is the
    wrapped module, for checks of its structure (DP's BatchNorm check).
    Where ``takes_rng``, apply also takes ``rng=``, the step's key (flax's
    ``rngs["dropout"]``)."""

    init: Callable[[torch.Generator], Params]
    apply: Callable[..., tuple[dict, dict]]
    module: torch.nn.Module | None = None
    takes_rng: bool = False


def from_module(module: torch.nn.Module) -> ModelDef:
    """Wrap a module with ``init_params(generator)`` whose forward returns
    ``(preds_dict, features_dict)``; params are applied functionally, keyed
    by flax path. A forward that takes ``train`` and ``rng`` gets them."""
    takes = inspect.signature(module.forward).parameters
    stochastic = "train" in takes and "rng" in takes

    def init(generator: torch.Generator) -> Params:
        return module.init_params(generator)

    def apply(params: Params, x: torch.Tensor, train: bool = True, rng=None):
        named = {k.replace("/", "."): v for k, v in params.items()}
        kwargs = {"train": train, "rng": rng} if stochastic else {}
        return functional_call(module, named, (x,), kwargs)

    return ModelDef(init=init, apply=apply, module=module, takes_rng=stochastic)


# ---------------------------------------------------------------------------
# Client logic
# ---------------------------------------------------------------------------

class ClientLogic:
    """The hooks of the JAX ``ClientLogic`` that the port's path uses;
    ``ctx`` is the per-round context from ``init_round_context``."""

    def __init__(self, model: ModelDef, criterion: Callable):
        self.model = model
        self.criterion = criterion  # (logits, targets, example_mask) -> scalar

    def init_extra(self, params: Params) -> Any:
        """Persistent algorithm state, created with the client's state."""
        return None

    def init_round_context(self, state: TrainState, server_payload: Any) -> Any:
        return None

    def finalize_round(self, state: TrainState, ctx: Any,
                       local_steps: torch.Tensor) -> TrainState:
        """Runs after the round's last local step (e.g. client-level DP
        clips the round's update here)."""
        return state

    def predict(self, params: Params, batch: Batch, train: bool, ctx=None, rng=None):
        del ctx
        kwargs = {"rng": rng} if self.model.takes_rng else {}
        return self.model.apply(params, batch.x, train=train, **kwargs)

    def training_loss(self, preds: dict, features: dict, batch: Batch,
                      params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def eval_loss(self, preds: dict, features: dict, batch: Batch,
                  params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def _loss_fn(self, state: TrainState, ctx: Any, batch: Batch,
                 step_rng: torch.Tensor):
        """The differentiated closure params -> (backward, (preds,
        additional)), shared by ``value_and_grads`` and the engine's loss
        scaling. ``step_rng`` is the model's dropout key."""

        def loss(params):
            preds, features = self.predict(params, batch, train=True, ctx=ctx,
                                           rng=step_rng)
            backward, additional = self.training_loss(preds, features, batch,
                                                      params, state, ctx)
            return backward, (preds, additional)

        return loss

    def value_and_grads(self, state: TrainState, ctx: Any, batch: Batch,
                        step_rng: torch.Tensor):
        """-> ((backward, (preds, additional)), grads) by whole-batch
        ``torch.func.grad_and_value``."""
        grads, (backward, aux) = torch.func.grad_and_value(
            self._loss_fn(state, ctx, batch, step_rng), has_aux=True)(state.params)
        return (backward, aux), grads

    def transform_gradients(self, grads: Params, state: TrainState, ctx: Any) -> Params:
        """The step's gradients before the optimizer sees them (SCAFFOLD's
        variate correction)."""
        return grads

    def augment(self, batch: Batch, rng_key: torch.Tensor, ctx: Any) -> Batch:
        """Train-time augmentation of one step's batch, keyed by
        ``fold_in(step_rng, 0xA6)``; the default leaves it as it is."""
        del rng_key, ctx
        return batch

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
                       key: torch.Tensor, generator: torch.Generator,
                       device: torch.device, precision: Any = None) -> TrainState:
    """A fresh state on ``device`` whose random stream is ``key``; the params
    are the model's init drawn from ``generator`` (not flax's init: tests
    install converted flax params). The params and the optimizer state are
    f32 masters whatever ``precision`` says; a scaling policy adds the
    loss-scale state."""
    params = {k: v.to(device) for k, v in logic.model.init(generator).items()}
    return TrainState(params=params, opt_state=tx.init(params), rng=key.to(device),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      extra=logic.init_extra(params),
                      loss_scale=precision_policy.loss_scale_init(precision, device))


def _mask_tree(new, old, keep: torch.Tensor):
    """new where keep > 0 (a real step) else old (a padding step)."""
    return tree_map(lambda n, o: torch.where(keep > 0, n, o), new, old)


def make_train_step(logic: ClientLogic, tx: GradientTransformation,
                    precision: Any = None):
    """step(state, ctx, batch) -> (state, StepOutput). ``precision`` (a
    ``PrecisionConfig`` or None) is the mixed-precision policy; None or an
    inactive config builds the step without it."""
    precision = precision_policy.resolve(precision)
    if precision is not None and precision.casts_compute:
        logic = precision_policy.wrap_logic_compute(logic, precision.compute_torch_dtype)
    scaling = precision is not None and precision.scaling_active
    if scaling and type(logic).value_and_grads is not ClientLogic.value_and_grads:
        # the logic's own mechanism (DP's clip and noise) would see scaled
        # gradients: its bound and noise would be mis-calibrated
        raise TypeError(
            f"in-graph loss scaling wraps the engine's default gradient path only: "
            f"{type(logic).__name__} overrides value_and_grads (e.g. DP per-example "
            "gradients), whose clip/noise calibration breaks under a scaled backward; "
            "use compute_dtype='bfloat16' with loss_scale='none'")

    def step(state: TrainState, ctx: Any, batch: Batch):
        next_key, step_key = rng.split(state.rng)
        batch = logic.augment(batch, rng.fold_in(step_key, 0xA6), ctx)
        finite = None
        if scaling:
            ls = state.loss_scale
            if ls is None:
                raise ValueError("loss scaling needs the carried scaler state: build the "
                                 "TrainState with create_train_state(..., precision=...)")
            # the backward seeded with the scale as the loss's cotangent; the
            # primal loss stays unscaled
            backward, vjp_fn, (preds, additional) = torch.func.vjp(
                logic._loss_fn(state, ctx, batch, step_key), state.params, has_aux=True)
            grads = vjp_fn(ls["scale"].to(backward.dtype))[0]
            # unscaled in f32; the finite screen reads the unscaled gradient
            inv = 1.0 / ls["scale"]
            grads = {k: g * inv for k, g in grads.items()}
            finite = precision_policy.tree_all_finite(grads)
        else:
            (backward, (preds, additional)), grads = logic.value_and_grads(
                state, ctx, batch, step_key)
        grads = logic.transform_gradients(grads, state, ctx)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        keep = batch.step_mask  # padding steps must not move anything
        # a non-finite scaled gradient also skips the optimizer step
        keep_update = keep if finite is None else keep * finite
        new_state = dataclasses.replace(
            state,
            params=_mask_tree(new_params, state.params, keep_update),
            opt_state=_mask_tree(new_opt_state, state.opt_state, keep_update),
            rng=next_key,  # every step splits, padding steps too, as in JAX
            step=state.step + keep_update.to(torch.int32),
        )
        if scaling:
            # the scaler advances on real steps only, skipped ones included
            new_ls = precision_policy.loss_scale_step(state.loss_scale, finite, precision)
            new_state = dataclasses.replace(
                new_state, loss_scale=_mask_tree(new_ls, state.loss_scale, keep))
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
    return tree_map(lambda a: a[s], batches)


def make_local_train(logic: ClientLogic, tx: GradientTransformation,
                     metric_manager: MetricManager,
                     loss_keys: tuple[str, ...] = ("backward",),
                     precision: Any = None):
    """train(state, ctx, batches) -> (state, loss_dict, metric_dict, n_steps);
    ``batches`` carries a leading [steps] axis, walked by a Python loop.
    ``precision`` reaches every step."""
    step_fn = make_train_step(logic, tx, precision)

    def train(state: TrainState, ctx: Any, batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device)
        mstate = metric_manager.init(device)
        for s in range(batches.step_mask.shape[0]):
            state, out = step_fn(state, ctx, _step_slice(batches, s))
            meter = meter.update(out.losses, weight=out.step_mask)
            mstate = metric_manager.update(mstate, out.preds, out.targets,
                                           out.example_mask)
        n_steps = batches.step_mask.sum()
        state = logic.finalize_round(state, ctx, n_steps)
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


@dataclasses.dataclass(frozen=True)
class EarlyStoppingConfig:
    """Snapshot the best state every ``interval_steps`` local steps; stop
    when validation has not improved for ``patience`` consecutive checks;
    restore the best snapshot (the reference's ``EarlyStopper``)."""

    interval_steps: int
    patience: int


def make_local_train_with_early_stopping(
    logic: ClientLogic,
    tx: GradientTransformation,
    metric_manager: MetricManager,
    config: EarlyStoppingConfig,
    loss_keys: tuple[str, ...] = ("backward",),
    precision: Any = None,
):
    """Early-stopped local training (the JAX engine's
    ``make_local_train_with_early_stopping``).

    The steps run in chunks of ``interval_steps`` (the last chunk padded
    with full no-op steps). After each chunk the client validates, keeps
    the best full-state snapshot, and raises a ``stopped`` flag once
    ``patience`` checks passed without improvement; a stopped client's
    later steps have ``step_mask`` 0, so they run and move nothing, as
    padding steps do, and every step splits the key whether or not it
    moved. Then the best snapshot is restored with the advanced key, and
    ``finalize_round`` runs on it. ``stopped``, ``bad`` and ``best_score``
    are per-client tensors under the client vmap: every branch on them is
    a ``torch.where``.

    Returns train(state, ctx, batches, val_batches) with the outputs of
    ``make_local_train``; ``n_steps`` counts the steps that ran unmasked.
    ``precision`` reaches the train steps only."""
    step_fn = make_train_step(logic, tx, precision)
    evaluate = make_local_eval(logic, metric_manager)
    interval, patience = config.interval_steps, config.patience

    def train(state: TrainState, ctx: Any, batches: Batch, val_batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device)
        mstate = metric_manager.init(device)
        total = batches.step_mask.shape[0]
        n_chunks = -(-total // interval)
        no_op = (tree_map(lambda x: torch.zeros_like(x[0]), batches)
                 if n_chunks * interval > total else None)
        best_state = state
        best_score = torch.full((), float("inf"), device=device)
        bad = torch.zeros((), dtype=torch.int32, device=device)
        stopped = torch.zeros((), device=device)
        executed = torch.zeros((), device=device)
        for c in range(n_chunks):
            for s in range(c * interval, (c + 1) * interval):
                batch = _step_slice(batches, s) if s < total else no_op
                batch = dataclasses.replace(
                    batch, step_mask=batch.step_mask * (1.0 - stopped))
                state, out = step_fn(state, ctx, batch)
                meter = meter.update(out.losses, weight=out.step_mask)
                mstate = metric_manager.update(mstate, out.preds, out.targets,
                                               out.example_mask)
                executed = executed + out.step_mask
            score = evaluate(state, ctx, val_batches)[0]["checkpoint"]
            live = stopped < 0.5
            improved = (score < best_score) & live
            best_state = _mask_tree(state, best_state, improved)
            best_score = torch.where(improved, score, best_score)
            bad = torch.where(live, torch.where(improved, 0, bad + 1), bad)
            stopped = torch.maximum(stopped, (bad >= patience).to(stopped.dtype))
        # the FULL best snapshot (params, optimizer state, extra) with the
        # advanced key: randomness is never replayed
        state = dataclasses.replace(best_state, rng=state.rng)
        state = logic.finalize_round(state, ctx, executed)
        return state, meter.compute(), metric_manager.compute(mstate), executed

    return train


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


def data_rows(tree) -> int:
    """Example count of a data tree (axis 0 of its first leaf), for arrays
    and dicts of arrays alike."""
    return int(tree_leaves(tree)[0].shape[0])


def leaves_with_paths(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted), the
    paths written as ``jax.tree_util.keystr`` writes them (``"['a']"``)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree) for pair in
                leaves_with_paths(t, f"{path}[{i}]")]
    return [(path, tree)]


def data_structure(tree) -> str:
    """A data tree's structure, its leaves written ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {data_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(data_structure(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def pad_and_stack_data(arrays: list, name: str, device: torch.device):
    """Zero-pad per-client data along axis 0 to the longest and stack it ->
    ``[C, max_n, ...]`` on ``device`` (one transfer a leaf), leaf by leaf
    over a data tree (an array, or a dict of arrays). Every client must
    give the same structure, and within a client every leaf the same row
    count; every client must share each leaf's example shape and dtype."""
    structure = data_structure(arrays[0])
    for i, a in enumerate(arrays):
        if data_structure(a) != structure:
            raise ValueError(
                f"client {i}'s {name} pytree structure {data_structure(a)} differs from "
                f"client 0's {structure}; every client must provide the same input keys.")
    for i, a in enumerate(arrays):
        ns = {path: leaf.shape[0] for path, leaf in leaves_with_paths(a)}
        if len(set(ns.values())) > 1:
            raise ValueError(f"client {i}'s {name} leaves disagree on example count: {ns}")
    return _stack_tree(arrays, name, device)


def _stack_tree(trees: list, name: str, device: torch.device):
    """The clients' trees stacked leaf by leaf, ``name`` the leaf's path."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], f"{name}[{k!r}]", device)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree([t[i] for t in trees], f"{name}[{i}]", device)
                           for i in range(len(first)))
    return _pad_and_stack_leaf(trees, name, device)


def _pad_and_stack_leaf(arrays: list, name: str, device: torch.device) -> torch.Tensor:
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
    return host_to_device(stack, device)


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``. To a card, the copy goes from pinned memory
    without blocking the host: a blocking copy would wait for every kernel
    already enqueued on the stream, and the round pipeline's threads must
    not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def gather_batches(x_stack, y_stack, idx: np.ndarray, example_mask: np.ndarray,
                   step_mask: np.ndarray) -> Batch:
    """One device-side gather from pre-stacked data -> [C,S,B,...] Batch;
    the same index plan gathers every leaf of a data tree. The plan is
    numpy (copied over here) or already on the stacks' device."""
    device = tree_leaves(x_stack)[0].device
    idx_t, example_mask, step_mask = (
        a if isinstance(a, torch.Tensor) else host_to_device(np.asarray(a, dtype), device)
        for a, dtype in ((idx, np.int64), (example_mask, np.float32),
                         (step_mask, np.float32)))
    c = torch.arange(idx_t.shape[0], device=device)[:, None, None]
    gather = lambda s: s[c, idx_t]  # noqa: E731
    return Batch(x=tree_map(gather, x_stack), y=tree_map(gather, y_stack),
                 example_mask=example_mask, step_mask=step_mask)


def epoch_batches(key: torch.Tensor, x, y, batch_size: int, n_steps: int | None = None,
                  shuffle: bool = True, drop_last: bool = False) -> Batch:
    """A ``[steps, B, ...]`` Batch stack for one epoch (or exactly
    ``n_steps``, wrapping with a fresh shuffle) of one client's data, its
    plan drawn from the key's words as JAX's ``epoch_batches`` draws it.
    ``x``/``y`` are tensors or trees of tensors sharing axis 0."""
    ns = {leaf.shape[0] for tree in (x, y) for leaf in tree_leaves(tree)}
    if len(ns) > 1:
        raise ValueError(
            f"epoch_batches: x/y leaves disagree on example count: {sorted(ns)}")
    entropy = [int(w) for w in rng.key_data(key)]
    idx, example_mask, step_mask = epoch_index_plan(
        entropy, data_rows(x), batch_size, n_steps, shuffle, drop_last)
    device = tree_leaves(x)[0].device
    idx_t = host_to_device(np.asarray(idx, np.int64), device)
    take = lambda a: a[idx_t]  # noqa: E731
    return Batch(x=tree_map(take, x), y=tree_map(take, y),
                 example_mask=host_to_device(example_mask, device),
                 step_mask=host_to_device(step_mask, device))


def pad_batch_stacks(stacks: list[Batch]) -> Batch:
    """Pad per-client Batch stacks to a common ``[steps]`` length (padding
    steps all zeros, ``step_mask`` 0) and stack them along a new leading
    clients axis -> ``[clients, steps, B, ...]``."""
    max_steps = max(b.step_mask.shape[0] for b in stacks)

    def pad_one(b: Batch) -> Batch:
        pad = max_steps - b.step_mask.shape[0]
        if pad == 0:
            return b
        return tree_map(lambda a: torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]), b)

    return tree_map(lambda *xs: torch.stack(xs, dim=0), *[pad_one(b) for b in stacks])
