"""flax params <-> the port's ``Params`` (flax path -> tensor).

The port keeps flax names and layouts (Dense kernels ``[in, out]``, embedding
``[vocab, d]``), so conversion is flattening the nested flax dict into
``"a/b/c"`` keys and back; no transposes. Nested modules flatten the same
way: a ``MoonModel``'s tree ``{"base_module": {"Dense_0": {...}},
"head_module": {...}}`` becomes ``base_module/Dense_0/kernel``, ...
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.core.types import Params


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def flax_to_torch(params: Mapping[str, Any],
                  device: str | torch.device = "cpu") -> Params:
    """Nested (or already path-keyed) flax params of numpy arrays -> Params.
    Keys come out sorted, the order flax flattens a dict in."""
    flat = _flatten(params)
    return {k: torch.tensor(np.asarray(flat[k]), device=device)
            for k in sorted(flat)}


def torch_to_flax(params: Params) -> dict[str, Any]:
    """Params -> the nested flax dict of numpy arrays."""
    out: dict[str, Any] = {}
    for path, val in params.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    return out


def _flat_moments(tree: Any, device) -> dict[str, torch.Tensor]:
    """A param-shaped flax tree of numpy arrays -> a path-keyed dict; the
    leaves a mask left out (optax's ``MaskedNode``) have no entry."""
    flat = _flatten(tree)
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in sorted(flat.items())
            if type(v).__name__ != "MaskedNode"}


def optax_state_to_torch(state: Any, device: str | torch.device = "cpu") -> Any:
    """An optax optimizer state (its arrays as numpy) -> the matching
    ``optim`` state, so both packages can start from the same state
    mid-run: ``ScaleByAdamState`` (adam, yogi), ``ScaleByRssState``,
    ``TraceState``, ``EmptyState`` (-> ``()``), a chain's tuple,
    ``MaskedState``, ``PartitionState``/``MultiTransformState`` and
    ``InjectHyperparamsState``/``InjectStatefulHyperparamsState``. The
    states are read by their optax class names; optax is not imported."""
    from fl4health_tpu_torch import optim

    kind = type(state).__name__
    scalar = lambda x, dtype: torch.tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    if kind == "ScaleByAdamState":
        return optim.ScaleByAdamState(count=scalar(state.count, torch.int32),
                                      mu=_flat_moments(state.mu, device),
                                      nu=_flat_moments(state.nu, device))
    if kind == "ScaleByRssState":
        return optim.ScaleByRssState(_flat_moments(state.sum_of_squares, device))
    if kind == "TraceState":
        return optim.TraceState(_flat_moments(state.trace, device))
    if kind == "EmptyState":
        return ()
    if kind == "MaskedState":
        return optim.MaskedState(optax_state_to_torch(state.inner_state, device))
    if kind in ("PartitionState", "MultiTransformState"):
        return optim.MultiTransformState({g: optax_state_to_torch(s, device)
                                          for g, s in state.inner_states.items()})
    if kind in ("InjectHyperparamsState", "InjectStatefulHyperparamsState"):
        return optim.InjectHyperparamsState(
            count=scalar(state.count, torch.int32),
            hyperparams={k: scalar(v, torch.float32) for k, v in state.hyperparams.items()},
            inner_state=optax_state_to_torch(state.inner_state, device))
    if isinstance(state, tuple) and not hasattr(state, "_fields"):  # a chain
        return tuple(optax_state_to_torch(s, device) for s in state)
    raise TypeError(f"no conversion for an optax state of type {kind}")
