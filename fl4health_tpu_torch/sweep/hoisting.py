"""Scalar hyperparameter hoisting (counterpart of
``fl4health_tpu/sweep/hoisting.py``): a registry of the hyperparameters a
run may rebind without rebuilding anything, and the two ways to rebind
them.

- **state leaves**: scalars that live in the carried server state
  (FedProx's ``drift_penalty_weight``; the FedOpt family's server lr,
  the ``optim.inject_hyperparams`` leaf ``opt_state.hyperparams
  ["learning_rate"]``, a 0-d tensor of the params' dtype). Rebinding is
  state surgery (:func:`apply_state_scalars`): every later round reads the
  new value as an input. The recovery supervisor's server-lr cool-down
  goes through it.
- **attr injection**: scalars read off a strategy attribute when a round
  runs (``RobustFedAvg.trim_fraction``/``max_update_norm``,
  ``FedBuff.staleness_exponent``, ``CompressingStrategy``'s top-k schedule
  endpoints). :func:`bind_traced_scalars` sets the attributes for the
  duration of a ``with`` block and restores them on exit. Under eager
  torch a round reads the attribute when it runs, so the values may be
  plain floats or 0-d tensors; a sweep cell (``sweep/runner.py``) binds
  the entries of its ``hvec``, one f32 tensor on the device, and the
  readers take them as 0-d tensors without reading them on the host.

Shape-affecting knobs stay static and are not registered here:
``CompressionConfig.topk_fraction``, ``quant_bits``,
``AsyncConfig.buffer_size``/``max_staleness``, Krum's ``num_byzantine``
and ``multi_krum_m``.

The binding table, the validators and their messages are JAX's word for
word: the supervisor (and, later, the operations plane) surface them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch


def wrapper_chain(strategy) -> list:
    """``[strategy, strategy.inner, ...]`` down to the innermost."""
    chain = [strategy]
    while hasattr(chain[-1], "inner"):
        chain.append(chain[-1].inner)
    return chain


def _find_owner(strategy, owner_type):
    for s in wrapper_chain(strategy):
        if isinstance(s, owner_type):
            return s
    return None


def _replace_owned_state(strategy, state, owner_type, fn):
    """Apply ``fn(owner_strategy, owner_state) -> new_owner_state`` at the
    wrapper-chain level owning the scalar, rebuilding wrapper states above
    it. Wrappers whose state is the inner state (RobustFedAvg, FedBuff)
    have no ``.inner`` state level and pass straight through."""
    if isinstance(strategy, owner_type):
        return fn(strategy, state)
    if not hasattr(strategy, "inner"):
        raise KeyError(f"no {owner_type.__name__} in the strategy chain")
    if hasattr(state, "inner"):
        return dataclasses.replace(state, inner=_replace_owned_state(
            strategy.inner, state.inner, owner_type, fn))
    return _replace_owned_state(strategy.inner, state, owner_type, fn)


@dataclasses.dataclass(frozen=True)
class ScalarBinding:
    """One hoistable scalar hyperparameter.

    ``kind="attr"``: read off ``owner().attr`` when a round runs;
    :func:`bind_traced_scalars` sets it. ``kind="state"``: a leaf of the
    carried server state; ``set_state(owner, owner_state, value)`` rebinds
    it. ``owner`` is a zero-arg callable returning the owning strategy
    type (a lazy import keeps this module cycle-free)."""

    name: str
    kind: str  # "attr" | "state"
    owner: Callable[[], type]
    attr: str = ""
    set_state: Callable[[Any, Any, float], Any] | None = None
    validate: Callable[[float], None] | None = None
    #: owner-aware validation (a schedule endpoint against its config's
    #: static ceiling), run wherever a concrete value is bound
    validate_owner: Callable[[Any, float], None] | None = None
    doc: str = ""

    def find(self, strategy):
        return _find_owner(strategy, self.owner())

    def check(self, strategy, value: float) -> None:
        """Validate a concrete value for this knob on this strategy chain."""
        if self.validate is not None:
            self.validate(float(value))
        if self.validate_owner is not None:
            owner = self.find(strategy)
            if owner is not None:
                self.validate_owner(owner, float(value))

    def applies(self, strategy) -> bool:
        owner = self.find(strategy)
        if owner is None:
            return False
        if self.kind == "attr":
            # an attr whose default is None encodes "feature not enabled"
            # (no topk_schedule configured): not sweepable then
            return getattr(owner, self.attr, None) is not None
        return True

    def default(self, strategy) -> float:
        owner = self.find(strategy)
        if self.kind == "attr":
            return float(getattr(owner, self.attr))
        return float(self._state_default(owner))

    def _state_default(self, owner) -> float:
        raise NotImplementedError  # overridden per binding below


def _validate_fraction_half(v: float) -> None:
    if not 0.0 <= v < 0.5:
        raise ValueError(f"trim_fraction must be in [0, 0.5); got {v}")


def _validate_positive(name: str):
    def check(v: float) -> None:
        if v <= 0:
            raise ValueError(f"{name} must be positive; got {v}")
    return check


def _validate_nonnegative(name: str):
    def check(v: float) -> None:
        if v < 0:
            raise ValueError(f"{name} must be >= 0; got {v}")
    return check


def _validate_unit(name: str):
    def check(v: float) -> None:
        if not 0.0 < v <= 1.0:
            raise ValueError(f"{name} must be in (0, 1]; got {v}")
    return check


def _validate_under_topk_ceiling(name: str):
    """Schedule endpoints above the static ``topk_fraction`` ceiling would
    be clamped silently: two cells would run the same config. Refused at
    bind time, as ``CompressionConfig.__post_init__`` refuses a static
    schedule above it."""
    def check(owner, v: float) -> None:
        ceiling = owner.config.topk_fraction
        if ceiling is not None and v > float(ceiling):
            raise ValueError(
                f"{name}={v} exceeds the static topk_fraction ceiling "
                f"{ceiling} — the effective fraction would clamp to the "
                "ceiling and the cell would silently duplicate the "
                f"ceiling config; sweep values <= {ceiling}, or raise "
                "topk_fraction"
            )
    return check


# -- state-kind setters -----------------------------------------------------

def _injected_hyperparams(opt_state) -> dict:
    """The ``inject_hyperparams`` leaf dict of a FedOpt opt_state, or an
    error naming the factories that provide it."""
    hp = getattr(opt_state, "hyperparams", None)
    if hp is None or "learning_rate" not in hp:
        raise ValueError(
            "server_lr hoisting needs the server optimizer built through "
            "optax.inject_hyperparams (the fed_adam/fed_yogi/fed_adagrad/"
            "fed_avg_m factories do this); this FedOpt's opt_state has no "
            "hyperparams['learning_rate'] leaf to rebind"
        )
    return hp


def _set_server_lr(owner, owner_state, value: float):
    opt_state = owner_state.opt_state
    hp = _injected_hyperparams(opt_state)
    lr = hp["learning_rate"]
    new_hp = dict(hp)
    new_hp["learning_rate"] = torch.as_tensor(value, dtype=lr.dtype, device=lr.device)
    return dataclasses.replace(owner_state,
                               opt_state=dataclasses.replace(opt_state, hyperparams=new_hp))


def _set_proximal_weight(owner, owner_state, value: float):
    mu = owner_state.drift_penalty_weight
    return dataclasses.replace(
        owner_state,
        drift_penalty_weight=torch.as_tensor(value, dtype=mu.dtype, device=mu.device))


# -- the registry -----------------------------------------------------------

def _fedopt_type():
    from fl4health_tpu_torch.strategies.fedopt import FedOpt
    return FedOpt


def _adaptive_constraint_type():
    from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint
    return FedAvgWithAdaptiveConstraint


def _robust_type():
    from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg
    return RobustFedAvg


def _fedbuff_type():
    from fl4health_tpu_torch.strategies.fedbuff import FedBuff
    return FedBuff


def _compressing_type():
    from fl4health_tpu_torch.compression.strategy import CompressingStrategy
    return CompressingStrategy


class _ServerLrBinding(ScalarBinding):
    def _state_default(self, owner) -> float:
        # the factory-time value lives in the (not yet initialised)
        # transform: read it from a throwaway init on a scalar template
        state = owner.tx.init({"w": torch.zeros((1,), dtype=torch.float32)})
        return float(_injected_hyperparams(state)["learning_rate"])


class _MuBinding(ScalarBinding):
    def _state_default(self, owner) -> float:
        return float(owner.mu0)


SCALAR_BINDINGS: dict[str, ScalarBinding] = {
    b.name: b
    for b in (
        _ServerLrBinding(
            name="server_lr", kind="state", owner=_fedopt_type,
            set_state=_set_server_lr,
            validate=_validate_positive("server_lr"),
            doc="FedOpt-family server learning rate "
                "(opt_state.hyperparams['learning_rate'] leaf)",
        ),
        _MuBinding(
            name="proximal_weight", kind="state",
            owner=_adaptive_constraint_type,
            set_state=_set_proximal_weight,
            validate=_validate_nonnegative("proximal_weight"),
            doc="FedProx drift-penalty weight mu "
                "(AdaptiveConstraintState.drift_penalty_weight leaf, "
                "broadcast to clients in the payload)",
        ),
        ScalarBinding(
            name="trim_fraction", kind="attr", owner=_robust_type,
            attr="trim_fraction", validate=_validate_fraction_half,
            doc="RobustFedAvg trimmed-mean per-end trim fraction "
                "(rank weights over the sorted clients axis)",
        ),
        ScalarBinding(
            name="max_update_norm", kind="attr", owner=_robust_type,
            attr="max_update_norm",
            validate=_validate_positive("max_update_norm"),
            doc="RobustFedAvg norm-bounded-mean clip bound on each "
                "client's update norm",
        ),
        ScalarBinding(
            name="staleness_exponent", kind="attr", owner=_fedbuff_type,
            attr="staleness_exponent",
            validate=_validate_nonnegative("staleness_exponent"),
            doc="FedBuff staleness discount exponent 1/(1+s)^e (async "
                "round programs feed it as a live dispatch input)",
        ),
        ScalarBinding(
            name="topk_f_start", kind="attr", owner=_compressing_type,
            attr="topk_f_start", validate=_validate_unit("topk_f_start"),
            validate_owner=_validate_under_topk_ceiling("topk_f_start"),
            doc="CompressingStrategy adaptive top-k schedule start "
                "fraction (requires CompressionConfig.topk_schedule)",
        ),
        ScalarBinding(
            name="topk_f_end", kind="attr", owner=_compressing_type,
            attr="topk_f_end", validate=_validate_unit("topk_f_end"),
            validate_owner=_validate_under_topk_ceiling("topk_f_end"),
            doc="CompressingStrategy adaptive top-k schedule end "
                "fraction (requires CompressionConfig.topk_schedule)",
        ),
    )
}


def binding(name: str) -> ScalarBinding:
    try:
        return SCALAR_BINDINGS[name]
    except KeyError:
        raise KeyError(
            f"unknown sweep scalar {name!r}; registered hoistable scalars: "
            f"{sorted(SCALAR_BINDINGS)}"
        ) from None


def applicable_scalars(strategy) -> list[str]:
    """Registered scalar names the given strategy chain can rebind, in
    registry order."""
    return [n for n, b in SCALAR_BINDINGS.items() if b.applies(strategy)]


#: attr-kind scalars that standalone rounds already read as live dispatch
#: inputs: FedBuff's staleness exponent, which the async routes feed per
#: event
LIVE_ATTR_SCALARS = ("staleness_exponent",)


def live_rebind_kind(strategy, name: str, *, async_active: bool = False) -> str:
    """How (whether) a live run can rebind ``name``, JAX's answer:

    - ``"state"``: a server-state leaf; ``apply_state_scalars`` rebinds it
      at a round boundary;
    - ``"live_attr"``: an attr the async rounds take as a dispatch input;
      a plain ``setattr`` lands at the next dispatch;
    - ``"static"``: an attr-kind scalar outside a sweep cell;
    - ``"inapplicable"``: no owner in this strategy chain.

    Unknown names raise ``KeyError`` (via :func:`binding`).
    """
    b = binding(name)
    if not b.applies(strategy):
        return "inapplicable"
    if b.kind == "state":
        return "state"
    if name in LIVE_ATTR_SCALARS and async_active:
        return "live_attr"
    return "static"


def apply_state_scalars(strategy, server_state, values: dict[str, float]):
    """Rebind state-kind scalars on a server state: state surgery that
    leaves every other leaf as it was. Values are validated; unknown names
    raise."""
    for name, value in values.items():
        b = binding(name)
        if b.kind != "state":
            raise ValueError(
                f"{name} is an attr-kind scalar; it rebinds through "
                "bind_traced_scalars / the cell program's hvec input"
            )
        b.check(strategy, value)
        server_state = _replace_owned_state(
            strategy, server_state, b.owner(),
            lambda owner, st: b.set_state(owner, st, float(value)),
        )
    return server_state


@contextlib.contextmanager
def bind_traced_scalars(strategy, values: dict[str, Any]):
    """Set attr-kind scalars on their owning strategy objects for the
    duration of the block (plain floats or 0-d tensors: an eager round
    reads the attribute when it runs). Restores the original attributes on
    exit, also on error, so the strategy object is unchanged afterwards."""
    saved: list[tuple[Any, str, Any]] = []
    try:
        for name, value in values.items():
            b = binding(name)
            if b.kind != "attr":
                raise ValueError(
                    f"{name} is a state-kind scalar; rebind it with "
                    "apply_state_scalars on the cell's server state"
                )
            owner = b.find(strategy)
            if owner is None:
                raise ValueError(
                    f"scalar {name!r} does not apply to this strategy "
                    f"chain ({'/'.join(type(s).__name__ for s in wrapper_chain(strategy))})"
                )
            saved.append((owner, b.attr, getattr(owner, b.attr)))
            setattr(owner, b.attr, value)
        yield
    finally:
        for owner, attr, old in reversed(saved):
            setattr(owner, attr, old)
