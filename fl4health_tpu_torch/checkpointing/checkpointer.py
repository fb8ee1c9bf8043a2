"""Model-artifact checkpointing (counterpart of
``fl4health_tpu/checkpointing/checkpointer.py``): latest, best-loss,
best-metric and score-function policies, and the pre- and
post-aggregation modes.

A model is a ``Params`` dict (flax path ``"a/b/c"`` -> tensor); its
artifact is flax's msgpack bytes of the nested flax dict, nested the way
``models/convert.py`` ``torch_to_flax`` nests it, each level in sorted key
order (the order JAX's round programs hold a params dict in, since
``jax.tree_util`` rebuilds dicts with sorted keys). So the port's
``save_params`` of a model's params writes the bytes JAX's ``save_params``
writes for the same params, and a file from either package loads into the
other: weights cross between them as files. A tree that is not a flat
``Params`` dict (a stacked pre-aggregation tree is one too) is nested the
same way. Loading needs a template of the same structure.
"""

from __future__ import annotations

import enum
import os
from abc import ABC, abstractmethod
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.checkpointing import serialization
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.convert import _flatten


class CheckpointMode(enum.Enum):
    """When a checkpointer fires: on the clients' trained params before
    aggregation, or on the aggregated global params after it."""

    PRE_AGGREGATION = "pre_aggregation"
    POST_AGGREGATION = "post_aggregation"


def nest_params(params: Mapping[str, Any]) -> dict[str, Any]:
    """A params tree (flat ``"a/b/c"`` keys or nested dicts) as the nested
    flax dict, every level's keys sorted, leaves on the host."""
    flat = _flatten(params)
    out: dict[str, Any] = {}
    for path in sorted(flat, key=lambda p: tuple(p.split("/"))):
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = serialization.host_leaf(flat[path])
    return out


def save_params(path: str, params: Params) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(nest_params(params)))


def load_params(path: str, template: Params) -> Params:
    """The params stored at ``path``, in the template's structure (flat or
    nested), dtypes and device."""
    with open(path, "rb") as f:
        stored = _flatten(serialization.msgpack_restore(f.read()))

    def rebuild(tree, prefix=""):
        out = {}
        for k, ref in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(ref, Mapping):
                out[k] = rebuild(ref, key)
                continue
            if key not in stored:
                raise ValueError(f"load_params: {path} has no entry {key}")
            val = stored[key]
            if isinstance(ref, torch.Tensor):
                val = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val))
                if tuple(val.shape) != tuple(ref.shape):
                    raise ValueError(f"load_params: {key} has shape {tuple(val.shape)}, the "
                                     f"template {tuple(ref.shape)}")
                val = val.to(device=ref.device, dtype=ref.dtype)
            out[k] = val
        return out

    return rebuild(template)


class ParamsCheckpointer(ABC):
    """Decides per call whether the given params are worth persisting.

    ``async_writer`` (an ``AsyncCheckpointWriter`` or None) routes the
    persist off-thread: the decision stays where ``maybe_checkpoint`` runs
    (in round order, on the round consumer under the pipelined route), only
    the serialize and write move. The pipelined ``fit`` attaches its writer
    for the run; standalone use stays synchronous."""

    def __init__(self, path: str):
        self.path = path
        self.async_writer = None

    @abstractmethod
    def maybe_checkpoint(self, params: Params, loss: float | None,
                         metrics: Mapping[str, Any]) -> bool:
        ...

    def _persist(self, params: Params) -> None:
        """Write now, or hand off to the attached writer. Params handed to a
        writer must already be host data (the round's pull)."""
        if self.async_writer is not None:
            self.async_writer.submit_save(self.path, params)
        else:
            save_params(self.path, params)

    def load(self, template: Params) -> Params:
        return load_params(self.path, template)


class FunctionCheckpointer(ParamsCheckpointer):
    """Keep the checkpoint whenever ``score_fn(loss, metrics)`` improves
    (``maximize``: larger is better); a NaN score never saves."""

    def __init__(self, path: str, score_fn: Callable[[float | None, Mapping[str, Any]], float],
                 maximize: bool = False, name: str | None = None):
        super().__init__(path)
        self.score_fn = score_fn
        self.maximize = maximize
        self.name = name or score_fn.__name__
        self.best_score: float | None = None

    def maybe_checkpoint(self, params, loss, metrics) -> bool:
        score = float(self.score_fn(loss, metrics))
        if np.isnan(score):
            return False
        improved = (self.best_score is None
                    or (score > self.best_score if self.maximize else score < self.best_score))
        if improved:
            self.best_score = score
            self._persist(params)
        return improved


class LatestCheckpointer(ParamsCheckpointer):
    """Overwrite on every call."""

    def maybe_checkpoint(self, params, loss, metrics) -> bool:
        self._persist(params)
        return True


class BestLossCheckpointer(FunctionCheckpointer):
    """Keep the lowest loss seen."""

    def __init__(self, path: str):
        super().__init__(path, lambda loss, _m: float("inf") if loss is None else loss,
                         maximize=False, name="loss")


class BestMetricCheckpointer(FunctionCheckpointer):
    """Track one metric key."""

    def __init__(self, path: str, metric_key: str, maximize: bool = True):
        def score(_loss, metrics):
            if metric_key not in metrics:
                raise KeyError(f"metric '{metric_key}' not present in {sorted(metrics)}")
            return float(metrics[metric_key])

        super().__init__(path, score, maximize=maximize, name=metric_key)
