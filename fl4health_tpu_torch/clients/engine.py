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
under scaling. Left out here: ZeRO-2 microbatching.

The algorithm step hooks run in JAX's order: ``update_before_step`` first,
its changes selected back on a padding step (``step_mask`` 0), then the key
split, the gradient and the optimizer, then ``update_after_step`` on the
new state with the step's predictions, unmasked (a hook that must not move
on padding steps masks itself, as APFL's alpha does). A leaf a hook hands
back unchanged (the same tensor) is not selected, so the default hooks add
no operation to a step. ``predict`` gets the logic's persistent state
(``extra``, APFL's alpha) on train and eval calls alike.

Telemetry (``collect_telemetry``, JAX's): each step also returns the global
norm of the gradient the optimizer reads (``StepOutput.grad_norm``), and the
train phases accumulate the executed steps' loss min/max and grad-norm
sum/max (``telemetry_acc_*``) into a fifth output. The norm only reads the
gradient, so a telemetry build trains bit for bit as the plain one.

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
from fl4health_tpu_torch.core.pytree import global_norm, tree_dataclass, tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.losses.containers import LossMeter
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.observability import stages as stage_attr
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
    # the model's non-param collections (flax's ``batch_stats``, the masked
    # layers' ``frozen``), nested as flax nests them; ``{}`` for a model
    # that keeps none
    model_state: Any
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
    # the optimizer's gradient's global norm, on a telemetry build only
    grad_norm: Any = None


# ---------------------------------------------------------------------------
# Model definition
# ---------------------------------------------------------------------------

def _no_state(generator: torch.Generator | None = None) -> dict:
    return {}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """init(generator) -> params; init_state(generator) -> model_state;
    apply(params, model_state, x, train, rng) -> ((preds, features),
    model_state), JAX's ``apply``. ``preds`` holds at least
    ``"prediction"``; ``module`` is the wrapped module, for checks of its
    structure (DP's BatchNorm check). Where ``takes_rng``, apply also takes
    ``rng=``, the step's key (flax's ``rngs["dropout"]``).

    ``model_state`` holds the non-param collections (BatchNorm's
    ``batch_stats``, the masked layers' ``frozen``), ``{}`` for a model
    that keeps none. The new state is computed (never written in place) on
    train calls with a non-empty state; every other call hands the given
    state back."""

    init: Callable[[torch.Generator], Params]
    apply: Callable[..., tuple[tuple[dict, dict], Any]]
    module: torch.nn.Module | None = None
    takes_rng: bool = False
    init_state: Callable[[torch.Generator], dict] = _no_state


def from_module(module: torch.nn.Module) -> ModelDef:
    """Wrap a module with ``init_params(generator)`` whose forward returns
    ``(preds_dict, features_dict)``; params are applied functionally, keyed
    by flax path. A forward that takes ``train`` and ``rng`` gets them.

    A module with ``init_state(generator)`` keeps model state: its forward
    takes ``train`` and ``state=`` (the nested collections) and returns
    ``((preds, features), new_state)``. As JAX's ``from_flax`` takes
    ``mutable=`` only on train calls with a non-empty state, the new state
    is kept only then."""
    takes = inspect.signature(module.forward).parameters
    stochastic = "train" in takes and "rng" in takes
    stateful = callable(getattr(module, "init_state", None))

    def init(generator: torch.Generator) -> Params:
        return module.init_params(generator)

    def apply(params: Params, model_state, x, train: bool = True, rng=None, **kwargs):
        # extra keyword arguments (APFL's alpha, GPFL's conditional inputs)
        # reach the module's forward, as JAX's from_flax forwards them
        named = {k.replace("/", "."): v for k, v in params.items()}
        if stochastic:
            kwargs = {"train": train, "rng": rng, **kwargs}
        elif stateful:
            kwargs = {"train": train, **kwargs}
        if not stateful:
            return functional_call(module, named, (x,), kwargs), model_state
        out, new_state = functional_call(module, named, (x,), {"state": model_state, **kwargs})
        return out, (new_state if train and model_state else model_state)

    return ModelDef(init=init, apply=apply, module=module, takes_rng=stochastic,
                    init_state=module.init_state if stateful else _no_state)


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

    def predict(self, params: Params, model_state, batch: Batch, rng=None,
                train: bool = False, extra=None, ctx=None):
        """-> ((preds, features), new_model_state). ``extra`` is the
        persistent algorithm state (APFL's alpha), ``ctx`` the round's
        context (GPFL's conditional inputs), for logics whose forward reads
        them."""
        del extra, ctx
        kwargs = {"rng": rng} if self.model.takes_rng else {}
        return self.model.apply(params, model_state, batch.x, train=train, **kwargs)

    def training_loss(self, preds: dict, features: dict, batch: Batch,
                      params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def eval_loss(self, preds: dict, features: dict, batch: Batch,
                  params: Params, state: TrainState, ctx: Any):
        return self.criterion(preds["prediction"], batch.y, batch.example_mask), {}

    def _loss_fn(self, state: TrainState, ctx: Any, batch: Batch,
                 step_rng: torch.Tensor):
        """The differentiated closure params -> (backward, (preds,
        additional, new_model_state)), shared by ``value_and_grads`` and the
        engine's loss scaling. ``step_rng`` is the model's dropout key."""

        def loss(params):
            (preds, features), new_model_state = self.predict(
                params, state.model_state, batch, step_rng, train=True,
                extra=state.extra, ctx=ctx)
            backward, additional = self.training_loss(preds, features, batch,
                                                      params, state, ctx)
            return backward, (preds, additional, new_model_state)

        return loss

    def value_and_grads(self, state: TrainState, ctx: Any, batch: Batch,
                        step_rng: torch.Tensor):
        """-> ((backward, (preds, additional, new_model_state)), grads) by
        whole-batch ``torch.func.grad_and_value``."""
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

    def update_before_step(self, state: TrainState, ctx: Any, batch: Batch) -> TrainState:
        """Runs before the step's key split and gradient; the engine selects
        its changes back on padding steps."""
        return state

    def update_after_step(self, state: TrainState, ctx: Any, batch: Batch,
                          preds: dict | None = None) -> TrainState:
        """Runs on the stepped state with the step's predictions (APFL's
        alpha step), on padding steps too: unmasked by the engine."""
        return state

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


def masked_mse(preds: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid examples of each example's mean squared error."""
    per = torch.square(preds - targets).reshape(preds.shape[0], -1).mean(dim=-1)
    m = mask.float()
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid examples of each example's mean binary cross
    entropy on logits, as optax's ``sigmoid_binary_cross_entropy`` writes
    it (``-z log s(x) - (1 - z) log s(-x)``)."""
    logits = logits.reshape(logits.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1).to(torch.float32)
    per = (-targets * F.logsigmoid(logits)
           - (1.0 - targets) * F.logsigmoid(-logits)).mean(dim=-1)
    m = mask.float()
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Train / eval phases
# ---------------------------------------------------------------------------

def create_train_state(logic: ClientLogic, tx: GradientTransformation,
                       key: torch.Tensor, generator: torch.Generator,
                       device: torch.device, precision: Any = None) -> TrainState:
    """A fresh state on ``device`` whose random stream is ``key``; the params,
    then the model state, are the model's init drawn from ``generator`` (not
    flax's init: tests install converted flax variables). The params and the optimizer state are
    f32 masters whatever ``precision`` says; a scaling policy adds the
    loss-scale state."""
    params = {k: v.to(device) for k, v in logic.model.init(generator).items()}
    model_state = tree_map(lambda v: v.to(device), logic.model.init_state(generator))
    return TrainState(params=params, opt_state=tx.init(params), model_state=model_state,
                      rng=key.to(device),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      extra=logic.init_extra(params),
                      loss_scale=precision_policy.loss_scale_init(precision, device))


def _mask_tree(new, old, keep: torch.Tensor):
    """new where keep > 0 (a real step) else old (a padding step)."""
    return tree_map(lambda n, o: torch.where(keep > 0, n, o), new, old)


def _mask_changed(new, old, keep: torch.Tensor):
    """``_mask_tree`` over the leaves a hook replaced; a leaf handed back
    as it was (the same tensor) is kept without a select."""
    return tree_map(lambda n, o: n if n is o else torch.where(keep > 0, n, o), new, old)


def _microbatched_value_and_grads(logic: ClientLogic, tx: Any, state: TrainState,
                                  ctx: Any, batch: Batch, step_key: torch.Tensor):
    """The ZeRO-2 gradient path (JAX's): the batch split into
    ``tx.n_shards`` microbatches, each one's gradient (after
    ``transform_gradients``) computed on its own key ``fold_in(step_key,
    k)``, and the UNREDUCED ``[n_shards]``-leading stack handed to
    ``tx.update``, whose ``psum_scatter`` reduces it
    (``parallel/zero.py``). Microbatch ``k``'s gradient is pre-scaled by
    ``n M_k / M_total`` (``M_k`` its valid examples), so the optimizer's
    uniform mean is the full batch's masked-mean gradient; the loss and
    the additional losses recombine with the weights ``M_k / M_total``.
    Exact for masked example-mean losses and affine gradient transforms,
    as in JAX; batch-coupled losses change under microbatching, and the
    model state (batch statistics) is the LAST microbatch's, as in JAX."""
    n = tx.n_shards
    b = batch.example_mask.shape[0]
    if b % n != 0:
        raise ValueError(
            f"ZeRO-2 engine path needs batch size divisible by n_shards: "
            f"batch={b}, n_shards={n}")
    m = b // n

    def micro(k: int) -> Batch:
        cut = lambda a: a[k * m:(k + 1) * m]  # noqa: E731
        return Batch(x=tree_map(cut, batch.x), y=tree_map(cut, batch.y),
                     example_mask=cut(batch.example_mask), step_mask=batch.step_mask)

    outs = []
    for k in range(n):
        mb = micro(k)
        (bw, (preds, additional, new_model_state)), g = logic.value_and_grads(
            state, ctx, mb, rng.fold_in(step_key, k))
        outs.append((bw, preds, additional, logic.transform_gradients(g, state, ctx),
                     mb.example_mask.to(torch.float32).sum()))
    m_k = torch.stack([o[4] for o in outs])
    m_tot = torch.clamp(m_k.sum(), min=1.0)
    w = n * m_k / m_tot  # the uniform mean of w_k g_k is the masked-mean grad
    grads = {key: torch.stack([o[3][key] for o in outs])
             * w.reshape((n,) + (1,) * outs[0][3][key].ndim) for key in outs[0][3]}

    def recombine(values):  # sum_k (M_k / M_tot) v_k
        return ((w / n) * torch.stack(values)).sum()

    backward = recombine([o[0] for o in outs])
    additional = {key: recombine([o[2][key] for o in outs]) for key in outs[0][2]}
    preds = tree_map(lambda *ps: torch.cat(ps, dim=0), *[o[1] for o in outs])
    return backward, preds, additional, new_model_state, grads


def make_train_step(logic: ClientLogic, tx: GradientTransformation,
                    collect_telemetry: bool = False, precision: Any = None):
    """step(state, ctx, batch) -> (state, StepOutput). ``precision`` (a
    ``PrecisionConfig`` or None) is the mixed-precision policy; None or an
    inactive config builds the step without it. ``collect_telemetry`` fills
    ``StepOutput.grad_norm`` with the global norm of the gradient after
    ``transform_gradients`` (what the optimizer reads), in JAX's leaf
    order; nothing reads it back."""
    precision = precision_policy.resolve(precision)
    if precision is not None and precision.casts_compute:
        logic = precision_policy.wrap_logic_compute(logic, precision.compute_torch_dtype)
    scaling = precision is not None and precision.scaling_active
    unreduced = getattr(tx, "expects_unreduced_grads", False)
    if scaling and unreduced:
        raise ValueError(
            "loss scaling cannot compose with the ZeRO-2 microbatched "
            "gradient path (expects_unreduced_grads): the per-microbatch "
            "finite screen would skip shards independently and the "
            "pre-scaled recombination no longer holds — use bf16 (no "
            "scaling) with ZeRO-2")
    if unreduced:
        # the microbatch weighting is calibrated for a uniform mean
        if getattr(tx, "reduce", "mean") != "mean":
            raise ValueError(
                "expects_unreduced_grads optimizers must use reduce='mean' "
                f"through the engine (got {tx.reduce!r}) — the microbatch "
                "weighting is calibrated for a uniform mean")
        if type(logic).value_and_grads is not ClientLogic.value_and_grads:
            raise TypeError(
                f"ZeRO-2 microbatching cannot wrap {type(logic).__name__}: "
                "it overrides value_and_grads (e.g. DP per-example "
                "gradients), whose semantics change under microbatching")
    if scaling and type(logic).value_and_grads is not ClientLogic.value_and_grads:
        # the logic's own mechanism (DP's clip and noise) would see scaled
        # gradients: its bound and noise would be mis-calibrated
        raise TypeError(
            f"in-graph loss scaling wraps the engine's default gradient path only: "
            f"{type(logic).__name__} overrides value_and_grads (e.g. DP per-example "
            "gradients), whose clip/noise calibration breaks under a scaled backward; "
            "use compute_dtype='bfloat16' with loss_scale='none'")

    def step(state: TrainState, ctx: Any, batch: Batch):
        state = _mask_changed(logic.update_before_step(state, ctx, batch), state,
                              batch.step_mask)
        next_key, step_key = rng.split(state.rng)
        batch = logic.augment(batch, rng.fold_in(step_key, 0xA6), ctx)
        finite = None
        if unreduced:
            backward, preds, additional, new_model_state, grads = (
                _microbatched_value_and_grads(logic, tx, state, ctx, batch, step_key))
        elif scaling:
            ls = state.loss_scale
            if ls is None:
                raise ValueError("loss scaling needs the carried scaler state: build the "
                                 "TrainState with create_train_state(..., precision=...)")
            # the backward seeded with the scale as the loss's cotangent; the
            # primal loss stays unscaled
            backward, vjp_fn, (preds, additional, new_model_state) = torch.func.vjp(
                logic._loss_fn(state, ctx, batch, step_key), state.params, has_aux=True)
            grads = vjp_fn(ls["scale"].to(backward.dtype))[0]
            # unscaled in f32; the finite screen reads the unscaled gradient
            inv = 1.0 / ls["scale"]
            grads = {k: g * inv for k, g in grads.items()}
            finite = precision_policy.tree_all_finite(grads)
        else:
            (backward, (preds, additional, new_model_state)), grads = (
                logic.value_and_grads(state, ctx, batch, step_key))
        if not unreduced:  # the microbatched path transformed each microbatch's
            grads = logic.transform_gradients(grads, state, ctx)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        keep = batch.step_mask  # padding steps must not move anything
        # a non-finite scaled gradient also skips the optimizer step (and
        # keeps the batch statistics)
        keep_update = keep if finite is None else keep * finite
        new_state = dataclasses.replace(
            state,
            params=_mask_tree(new_params, state.params, keep_update),
            opt_state=_mask_tree(new_opt_state, state.opt_state, keep_update),
            model_state=_mask_changed(new_model_state, state.model_state, keep_update),
            rng=next_key,  # every step splits, padding steps too, as in JAX
            step=state.step + keep_update.to(torch.int32),
        )
        if scaling:
            # the scaler advances on real steps only, skipped ones included
            new_ls = precision_policy.loss_scale_step(state.loss_scale, finite, precision)
            new_state = dataclasses.replace(
                new_state, loss_scale=_mask_tree(new_ls, state.loss_scale, keep))
        new_state = logic.update_after_step(new_state, ctx, batch, preds=preds)
        out = StepOutput(
            losses={"backward": backward, **additional},
            preds=preds["prediction"],
            targets=batch.y,
            example_mask=batch.example_mask * keep,
            step_mask=keep,
            grad_norm=global_norm(grads) if collect_telemetry else None,
        )
        return new_state, out

    return step


def _step_slice(batches: Batch, s: int) -> Batch:
    return tree_map(lambda a: a[s], batches)


# -- telemetry accumulation over the local steps (observability/telemetry.py) --

def telemetry_acc_init(device: torch.device) -> dict:
    """The accumulator of a client's loss min/max and grad-norm sum/max.
    A NaN loss propagates through min/max: a poisoned step must show."""
    inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss_min": inf, "loss_max": -inf, "gn_sum": zero, "gn_max": zero}


def telemetry_acc_update(acc: dict, out: StepOutput) -> dict:
    loss = out.losses["backward"].to(torch.float32)
    gn = out.grad_norm.to(torch.float32)
    live = out.step_mask > 0  # padding steps must not move the stats
    inf = torch.full_like(loss, float("inf"))
    return {
        "loss_min": torch.minimum(acc["loss_min"], torch.where(live, loss, inf)),
        "loss_max": torch.maximum(acc["loss_max"], torch.where(live, loss, -inf)),
        "gn_sum": acc["gn_sum"] + torch.where(live, gn, torch.zeros_like(gn)),
        "gn_max": torch.maximum(acc["gn_max"], torch.where(live, gn, torch.zeros_like(gn))),
    }


def telemetry_acc_finalize(acc: dict, n_steps: torch.Tensor) -> dict:
    """The engine's share of a ``RoundTelemetry`` row; a client that ran no
    step reports NaN, not the init sentinels."""
    ran = n_steps > 0
    nan = torch.full_like(acc["loss_min"], float("nan"))
    return {
        "train_loss_min": torch.where(ran, acc["loss_min"], nan),
        "train_loss_max": torch.where(ran, acc["loss_max"], nan),
        "grad_norm_mean": torch.where(
            ran, acc["gn_sum"] / torch.clamp(n_steps, min=1.0), nan),
        "grad_norm_max": torch.where(ran, acc["gn_max"], nan),
    }


def make_local_train(logic: ClientLogic, tx: GradientTransformation,
                     metric_manager: MetricManager,
                     loss_keys: tuple[str, ...] = ("backward",),
                     collect_telemetry: bool = False, precision: Any = None):
    """train(state, ctx, batches) -> (state, loss_dict, metric_dict, n_steps);
    ``batches`` carries a leading [steps] axis, walked by a Python loop.
    ``precision`` reaches every step. ``collect_telemetry`` appends a fifth
    output, the engine's telemetry (``telemetry_acc_finalize``). Runs as
    spine stage ``local_train`` (``observability/stages.py``)."""
    step_fn = make_train_step(logic, tx, collect_telemetry, precision)

    def _train(state: TrainState, ctx: Any, batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device=device)
        mstate = metric_manager.init(device)
        acc = telemetry_acc_init(device) if collect_telemetry else None
        for s in range(batches.step_mask.shape[0]):
            state, out = step_fn(state, ctx, _step_slice(batches, s))
            meter = meter.update(out.losses, weight=out.step_mask)
            mstate = metric_manager.update(mstate, out.preds, out.targets,
                                           out.example_mask)
            if collect_telemetry:
                acc = telemetry_acc_update(acc, out)
        n_steps = batches.step_mask.sum()
        state = logic.finalize_round(state, ctx, n_steps)
        outs = (state, meter.compute(), metric_manager.compute(mstate), n_steps)
        if collect_telemetry:
            return (*outs, telemetry_acc_finalize(acc, n_steps))
        return outs

    def train(state: TrainState, ctx: Any, batches: Batch):
        with stage_attr.stage("local_train"):
            return _train(state, ctx, batches)

    return train


def make_local_eval(logic: ClientLogic, metric_manager: MetricManager,
                    loss_keys: tuple[str, ...] = ("checkpoint",)):
    """evaluate(state, ctx, batches) -> (loss_dict, metric_dict). ``predict``
    reads the state's ``extra`` and the round's context, as in JAX. JAX's
    evaluate splits a step key off the state's key each step; a model that
    takes ``rng`` gets it here too, and other models (which draw nothing
    at apply time) get None, so the split's integer ops are not paid for a
    key nothing reads."""
    keyed = logic.model.takes_rng

    @torch.no_grad()
    def evaluate(state: TrainState, ctx: Any, batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device=device)
        mstate = metric_manager.init(device)
        key, step_key = state.rng, None
        for s in range(batches.step_mask.shape[0]):
            batch = _step_slice(batches, s)
            if keyed:
                key, step_key = rng.split(key)
            (preds, features), _ = logic.predict(state.params, state.model_state, batch,
                                                 step_key, train=False,
                                                 extra=state.extra, ctx=ctx)
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
    collect_telemetry: bool = False,
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
    ``make_local_train`` (the telemetry too, over the executed steps: a
    stopped client's masked steps never touch it); ``n_steps`` counts the
    steps that ran unmasked. ``precision`` reaches the train steps only."""
    step_fn = make_train_step(logic, tx, collect_telemetry, precision)
    evaluate = make_local_eval(logic, metric_manager)
    interval, patience = config.interval_steps, config.patience

    def train(state: TrainState, ctx: Any, batches: Batch, val_batches: Batch):
        device = batches.step_mask.device
        meter = LossMeter.create(loss_keys, device=device)
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
        acc = telemetry_acc_init(device) if collect_telemetry else None
        for c in range(n_chunks):
            for s in range(c * interval, (c + 1) * interval):
                batch = _step_slice(batches, s) if s < total else no_op
                batch = dataclasses.replace(
                    batch, step_mask=batch.step_mask * (1.0 - stopped))
                state, out = step_fn(state, ctx, batch)
                meter = meter.update(out.losses, weight=out.step_mask)
                mstate = metric_manager.update(mstate, out.preds, out.targets,
                                               out.example_mask)
                if collect_telemetry:
                    acc = telemetry_acc_update(acc, out)
                executed = executed + out.step_mask
            score = evaluate(state, ctx, val_batches)[0]["checkpoint"]
            live = stopped < 0.5
            improved = (score < best_score) & live
            best_state = _mask_tree(state, best_state, improved)
            best_score = torch.where(improved, score, best_score)
            bad = torch.where(live, torch.where(improved, 0, bad + 1), bad)
            stopped = torch.maximum(stopped, (bad >= patience).to(stopped.dtype))
        # the FULL best snapshot (params, optimizer state, model state,
        # extra) with the advanced key: randomness is never replayed
        state = dataclasses.replace(best_state, rng=state.rng)
        state = logic.finalize_round(state, ctx, executed)
        outs = (state, meter.compute(), metric_manager.compute(mstate), executed)
        if collect_telemetry:
            return (*outs, telemetry_acc_finalize(acc, executed))
        return outs

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
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted, a
    dataclass's fields in order), the paths written as
    ``jax.tree_util.keystr`` writes them (``"['a']"``, ``".field"``)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree) for pair in
                leaves_with_paths(t, f"{path}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree) for pair in
                leaves_with_paths(getattr(tree, f.name), f"{path}.{f.name}")]
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
