"""Functional optimizers in optax's order (counterpart of the optax
transforms the JAX package uses). ``torch.optim`` applies updates in another
order, so the port keeps optax's ``init``/``update`` + ``apply_updates``.

Each transform is optax's update rule and state, read from optax's source
(``optax/_src/transform.py``, ``alias.py``, ``combine.py``,
``clipping.py``, ``transforms/_masking.py``, ``schedules/_inject.py``):

- ``scale_by_adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 +
  b2 nu``, bias correction ``1 - b^count`` from an int32 ``count``
  incremented first, then ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``;
- ``scale_by_yogi``: moments start at ``initial_accumulator_value``,
  ``nu = nu - (1 - b2) sign(nu - g^2) g^2``;
- ``scale_by_rss`` (adagrad): the sum of squares starts at
  ``initial_accumulator_value``, and the scale is ``rsqrt(s + eps)`` where
  ``s > 0``, else 0;
- ``trace`` (sgd's momentum): ``t = g + decay t``, and ``g + decay t``
  again under Nesterov;
- ``add_decayed_weights``: ``g + wd p``; ``scale_by_learning_rate``:
  ``-lr g``; ``clip_by_global_norm``; ``set_to_zero``;
- ``chain`` (a tuple of states), ``masked`` and ``multi_transform`` over a
  label per param path. A leaf outside a mask has no state, as optax's
  ``MaskedNode``: the masked transform sees the sub-dict of its leaves;
- ``inject_hyperparams``: the numeric arguments that are not static become
  0-d tensors of the params' dtype in ``state.hyperparams``; the static ones
  stay Python floats, since optax folds ``1 - b1`` in double precision for a
  constant and in f32 for a traced one.

A transform over a ``Params`` dict walks the dict's keys; ``global_norm``
sums the leaves in JAX's sorted order. States are ``tree_dataclass``es,
tuples and dicts of tensors, so they stack over the client axis and pass
through ``torch.func.vmap``; optax's ``EmptyState`` is ``()``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Mapping

import torch

from fl4health_tpu_torch.core.pytree import flax_leaf_order, tree_dataclass
from fl4health_tpu_torch.core.types import Params

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ScaleByAdamState:
    count: torch.Tensor  # int32 scalar
    mu: Params
    nu: Params


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class ScaleByRssState:
    sum_of_squares: Params


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class TraceState:
    trace: Params


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MaskedState:
    inner_state: Any


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class MultiTransformState:
    inner_states: dict  # label -> MaskedState


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class InjectHyperparamsState:
    count: torch.Tensor  # int32 scalar
    hyperparams: dict  # name -> 0-d tensor
    inner_state: Any


def _empty_init(params: Params):
    return ()


def _count0(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: ``count + 1``, held at int32's max."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_correction(moment: Params, decay: float, count: torch.Tensor) -> Params:
    """``moment / (1 - decay ** count)``, the power taken in f32."""
    correction = 1 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=count.device),
                               count.to(torch.float32))
    return {k: t / correction.to(t.dtype) for k, t in moment.items()}


def identity() -> GradientTransformation:
    return GradientTransformation(_empty_init, lambda u, s, params=None: (u, s))


def scale(step_size) -> GradientTransformation:
    """``step_size * g`` (a float, or a 0-d tensor under
    ``inject_hyperparams``)."""

    def update(updates: Params, state, params: Params | None = None):
        return {k: step_size * g for k, g in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    return scale(-1 * learning_rate)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params: Params):
        return ScaleByAdamState(
            count=_count0(params),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates: Params, state: ScaleByAdamState, params: Params | None = None):
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in updates.items()}
        count = safe_increment(state.count)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        out = {k: mu_hat[k] / (torch.sqrt(nu_hat[k] + eps_root) + eps) for k in mu}
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
                  eps_root: float = 0.0,
                  initial_accumulator_value: float = 1e-6) -> GradientTransformation:
    def init(params: Params):
        full = {k: torch.full_like(p, initial_accumulator_value) for k, p in params.items()}
        return ScaleByAdamState(count=_count0(params), mu=full, nu=dict(full))

    def update(updates: Params, state: ScaleByAdamState, params: Params | None = None):
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
        nu = {}
        for k, g in updates.items():
            v, g2 = state.nu[k], g * g
            nu[k] = v - (1 - b2) * torch.sign(v - g2) * g2
        count = safe_increment(state.count)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        out = {k: mu_hat[k] / (torch.sqrt(nu_hat[k] + eps_root) + eps) for k in mu}
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    def init(params: Params):
        return ScaleByRssState({k: torch.full_like(p, initial_accumulator_value)
                                for k, p in params.items()})

    def update(updates: Params, state: ScaleByRssState, params: Params | None = None):
        sos = {k: g * g + state.sum_of_squares[k] for k, g in updates.items()}
        out = {k: torch.where(sos[k] > 0, torch.rsqrt(sos[k] + eps),
                              torch.zeros((), dtype=g.dtype, device=g.device)) * g
               for k, g in updates.items()}
        return out, ScaleByRssState(sos)

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def init(params: Params):
        return TraceState({k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates: Params, state: TraceState, params: Params | None = None):
        new = {k: g + decay * state.trace[k] for k, g in updates.items()}
        out = {k: g + decay * new[k] for k, g in updates.items()} if nesterov else new
        return out, TraceState(new)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0,
                        mask: Mapping[str, bool] | None = None) -> GradientTransformation:
    def update(updates: Params, state, params: Params | None = None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {k: g + weight_decay * params[k] for k, g in updates.items()}, state

    tx = GradientTransformation(_empty_init, update)
    return masked(tx, mask) if mask is not None else tx


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates: Params, state, params: Params | None = None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return {k: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)
                for k, t in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def set_to_zero() -> GradientTransformation:
    return GradientTransformation(
        _empty_init, lambda u, s, params=None: ({k: torch.zeros_like(g)
                                                  for k, g in u.items()}, s))


def global_norm(updates: Params) -> torch.Tensor:
    """optax's ``global_norm``: the squares summed in JAX's leaf order."""
    return torch.sqrt(sum(torch.sum(updates[k] * updates[k])
                          for k in flax_leaf_order(updates)))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params: Params):
        return tuple(t.init(params) for t in transforms)

    def update(updates: Params, state: tuple, params: Params | None = None):
        if len(state) != len(transforms):
            raise ValueError("chain: one state per transform; call init first")
        new_state = []
        for s, t in zip(state, transforms):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def _select(tree: Params | None, keys: list[str]) -> Params | None:
    return None if tree is None else {k: tree[k] for k in keys}


def masked(inner: GradientTransformation, mask: Mapping[str, bool]) -> GradientTransformation:
    """optax's ``masked``: ``inner`` over the leaves whose mask is True; the
    rest pass through unchanged and have no state."""

    def keys_of(tree: Params) -> list[str]:
        return [k for k in tree if mask[k]]

    def init(params: Params):
        return MaskedState(inner.init(_select(params, keys_of(params))))

    def update(updates: Params, state: MaskedState, params: Params | None = None):
        keys = keys_of(updates)
        new, inner_state = inner.update(_select(updates, keys), state.inner_state,
                                        _select(params, keys))
        return {k: new[k] if mask[k] else u for k, u in updates.items()}, MaskedState(inner_state)

    return GradientTransformation(init, update)


def multi_transform(transforms: Mapping[str, GradientTransformation],
                    param_labels: Mapping[str, str]) -> GradientTransformation:
    """optax's ``multi_transform`` (``partition``): each label's transform
    over its leaves, ``masked`` by ``label == group``."""
    missing = set(param_labels.values()) - set(transforms)
    if missing:
        raise ValueError(f"labels without a transform: {sorted(missing)}")
    groups = {g: masked(tx, {k: lab == g for k, lab in param_labels.items()})
              for g, tx in transforms.items()}

    def init(params: Params):
        return MultiTransformState({g: tx.init(params) for g, tx in groups.items()})

    def update(updates: Params, state: MultiTransformState, params: Params | None = None):
        new_states = {}
        for g, tx in groups.items():
            updates, new_states[g] = tx.update(updates, state.inner_states[g], params)
        return updates, MultiTransformState(new_states)

    return GradientTransformation(init, update)


def inject_hyperparams(factory: Callable[..., GradientTransformation],
                       static_args: tuple[str, ...] = ()) -> Callable[..., GradientTransformation]:
    """optax's ``inject_hyperparams``: ``factory``'s numeric arguments that
    are not in ``static_args`` (nor bools) live in ``state.hyperparams`` as
    0-d tensors of the params' dtype, and the transform is rebuilt from them
    on every update."""
    signature = inspect.signature(factory)
    static_args = set(static_args)
    if not static_args <= set(signature.parameters):
        raise ValueError(f"static_args {static_args} are not all parameters of "
                         f"{factory.__name__}")

    def wrapped(*args, **kwargs) -> GradientTransformation:
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        numeric, other = {}, {}
        for name, value in bound.arguments.items():
            if (name not in static_args and not isinstance(value, bool)
                    and isinstance(value, (int, float, torch.Tensor))):
                numeric[name] = value
            else:
                other[name] = value

        def init(params: Params):
            leaf = next(iter(params.values()))
            hyper = {k: torch.as_tensor(v, dtype=leaf.dtype, device=leaf.device)
                     for k, v in numeric.items()}
            return InjectHyperparamsState(count=_count0(params), hyperparams=hyper,
                                          inner_state=factory(**other, **hyper).init(params))

        def update(updates: Params, state: InjectHyperparamsState,
                   params: Params | None = None):
            leaf = next(iter(updates.values()))
            hyper = {k: v.to(leaf.dtype) for k, v in state.hyperparams.items()}
            updates, inner_state = factory(**other, **hyper).update(
                updates, state.inner_state, params)
            return updates, InjectHyperparamsState(count=safe_increment(state.count),
                                                   hyperparams=hyper,
                                                   inner_state=inner_state)

        return GradientTransformation(init, update)

    return wrapped


# ---------------------------------------------------------------------------
# Aliases (optax/_src/alias.py)
# ---------------------------------------------------------------------------

def sgd(learning_rate, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd``: ``trace`` when there is momentum, then ``-lr g``."""
    return chain(trace(momentum, nesterov) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4,
          mask: Mapping[str, bool] | None = None) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


def yogi(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-3) -> GradientTransformation:
    return chain(scale_by_yogi(b1=b1, b2=b2, eps=eps),
                 scale_by_learning_rate(learning_rate))


def adagrad(learning_rate, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` in the param's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
