"""Round telemetry (counterpart of ``fl4health_tpu/observability/telemetry.py``):
training-health statistics that ride the round programs' outputs.

Every field is computed from values a round already holds (losses,
gradients, parameter stacks) and is returned beside the round's results,
never fed back into the training math: a telemetry-on run's trajectory is
bit-identical to a telemetry-off run's on every route. On the pipelined
routes the :class:`RoundTelemetry` tree rides the round's one ``HostPull``;
on the chunked routes it stacks ``[k]`` with the chunk's outputs and rides
the chunk's one pull. So telemetry adds no pull and no host sync.

Field provenance (JAX's):

- ``train_loss`` / ``train_loss_min`` / ``train_loss_max`` — per-client
  backward-loss mean over local steps (the meter value) and the min/max
  over the executed steps, accumulated by ``clients/engine.py``;
- ``grad_norm_mean`` / ``grad_norm_max`` — per-client global norm of the
  gradient the optimizer reads (after ``transform_gradients``: under DP the
  clipped and noised mean, not a per-example norm);
- ``update_norm`` — ``||params after finalize - pulled globals||`` per
  client;
- ``clip_fraction`` — the DP logic's share of clipped examples (its
  ``telemetry_loss_keys``); NaN without DP clipping;
- ``nonfinite_params`` / ``nonfinite_loss`` — per-client counts of
  non-finite entries in the post-fit parameter stack and the per-client
  training losses;
- ``divergence`` — each client stack's l2 distance from the strategy's
  ``divergence_reference`` after aggregation;
- ``nonfinite_eval_loss`` — per-client count of non-finite evaluation
  losses, filled in by the eval round;
- ``loss_scale_skips`` — the fp16 loss scaler's cumulative skipped steps a
  client, present only where the precision policy scales.

Dtypes are JAX's: the counts are f32 sums (``loss_scale_skips`` is the
scaler's int32 count), the norms f32. The global norms sum their leaves in
JAX's (flax's sorted) leaf order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.core.pytree import flax_leaf_order, tree_dataclass, tree_leaves

# the per-client [C] fields a RoundTelemetry always carries, in JAX's order
# (the JSONL ``telemetry`` event and the host summaries iterate this)
TELEMETRY_FIELDS = (
    "train_loss",
    "train_loss_min",
    "train_loss_max",
    "grad_norm_mean",
    "grad_norm_max",
    "update_norm",
    "clip_fraction",
    "nonfinite_params",
    "nonfinite_loss",
    "divergence",
    "nonfinite_eval_loss",
)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class RoundTelemetry:
    """Per-client ([clients]-shaped) training-health metrics for one round.
    A statistic a training path cannot produce is NaN, never absent.
    ``loss_scale_skips`` is None (an empty tree) without loss scaling."""

    train_loss: torch.Tensor
    train_loss_min: torch.Tensor
    train_loss_max: torch.Tensor
    grad_norm_mean: torch.Tensor
    grad_norm_max: torch.Tensor
    update_norm: torch.Tensor
    clip_fraction: torch.Tensor
    nonfinite_params: torch.Tensor
    nonfinite_loss: torch.Tensor
    divergence: torch.Tensor
    nonfinite_eval_loss: torch.Tensor
    loss_scale_skips: Any = None

    def replace(self, **fields) -> "RoundTelemetry":
        return dataclasses.replace(self, **fields)

    def as_dict(self) -> dict[str, Any]:
        d = {k: getattr(self, k) for k in TELEMETRY_FIELDS}
        if self.loss_scale_skips is not None:
            d["loss_scale_skips"] = self.loss_scale_skips
        return d


def telemetry_from_dict(d: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A pulled telemetry tree (a ``RoundTelemetry`` or its dict) as the host
    dict of numpy arrays the watchdog, the ledger and the records read."""
    if isinstance(d, RoundTelemetry):
        d = d.as_dict()
    return {k: np.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# Device helpers (called from the round programs)
# ---------------------------------------------------------------------------

def _ordered_leaves(tree: Any) -> list:
    """A tree's leaves, a ``Params`` dict's in flax's sorted leaf order."""
    if isinstance(tree, dict) and all(isinstance(k, str) for k in tree):
        return [leaf for k in flax_leaf_order(tree) for leaf in tree_leaves(tree[k])]
    return tree_leaves(tree)


def per_client_nonfinite(stacked_tree: Any) -> torch.Tensor:
    """[C]-leading tree -> [C] f32 count of non-finite entries; integer and
    bool leaves cannot be non-finite and are skipped."""
    total = None
    for leaf in _ordered_leaves(stacked_tree):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        bad = (~torch.isfinite(leaf)).reshape(leaf.shape[0], -1).to(torch.float32).sum(dim=1)
        total = bad if total is None else total + bad
    if total is None:
        raise ValueError("per_client_nonfinite: tree has no floating leaves")
    return total


def nonfinite_in_losses(losses: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Dict of [C] loss tensors -> [C] f32 count of non-finite values."""
    vals = [torch.as_tensor(v).to(torch.float32) for v in losses.values()]
    stacked = torch.stack(vals) if vals else torch.zeros((1, 1))
    return (~torch.isfinite(stacked)).to(torch.float32).sum(dim=0)


def per_client_divergence(stacked_params: Any, ref_params: Any) -> torch.Tensor:
    """[C]-leading client param stack against an unstacked reference ->
    [C] global l2 distance (non-float leaves cast to f32)."""
    total = None
    for leaf, ref in zip(_ordered_leaves(stacked_params), _ordered_leaves(ref_params)):
        d = leaf.to(torch.float32) - ref.to(torch.float32)[None]
        sq = torch.square(d).reshape(d.shape[0], -1).sum(dim=1)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def global_norm_diff(a: Any, b: Any) -> torch.Tensor:
    """||a - b|| over two same-structure trees (a scalar); per client, inside
    the client vmap."""
    total = None
    for la, lb in zip(_ordered_leaves(a), _ordered_leaves(b)):
        sq = torch.square(la.to(torch.float32) - lb.to(torch.float32)).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def nan_engine_telemetry(device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """The engine's share of a telemetry row as structure-stable NaNs, for a
    train path that cannot accumulate it."""
    nan = torch.full((), float("nan"), dtype=torch.float32, device=device)
    return {"train_loss_min": nan, "train_loss_max": nan,
            "grad_norm_mean": nan, "grad_norm_max": nan}


# ---------------------------------------------------------------------------
# Host summaries (the consumer thread / the chunked epilogue; pure numpy)
# ---------------------------------------------------------------------------

def _participating(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    v = np.asarray(values, np.float64)
    return v[np.asarray(mask) > 0]


def _nan_stat(fn, values: np.ndarray) -> float:
    """Reduce ignoring NaN; empty or all-NaN -> nan (never a numpy warning)."""
    v = values[np.isfinite(values)]
    return float(fn(v)) if v.size else float("nan")


def summarize_host(telemetry: Mapping[str, np.ndarray], mask) -> dict[str, float]:
    """Scalar summary of a host telemetry dict over the PARTICIPATING
    clients: the fields merged into the JSONL ``round`` event. JAX's code,
    in f64, so both packages summarise the same vectors to the same
    floats."""
    t = {k: _participating(np.asarray(v), mask) for k, v in telemetry.items()}
    nonfinite = (float(np.sum(t["nonfinite_params"]))
                 + float(np.sum(t["nonfinite_loss"]))
                 + float(np.sum(t["nonfinite_eval_loss"])))
    out = {
        "train_loss_min": _nan_stat(np.min, t["train_loss_min"]),
        "train_loss_max": _nan_stat(np.max, t["train_loss_max"]),
        "grad_norm_mean": _nan_stat(np.mean, t["grad_norm_mean"]),
        "grad_norm_max": _nan_stat(np.max, t["grad_norm_max"]),
        "update_norm_mean": _nan_stat(np.mean, t["update_norm"]),
        "update_norm_min": _nan_stat(np.min, t["update_norm"]),
        "clip_fraction": _nan_stat(np.mean, t["clip_fraction"]),
        "nonfinite": nonfinite,
        "divergence_mean": _nan_stat(np.mean, t["divergence"]),
        "divergence_max": _nan_stat(np.max, t["divergence"]),
    }
    if "loss_scale_skips" in telemetry:
        # summed over ALL clients: the per-client counters are cumulative,
        # so the all-client sum is the run-wide skipped-step total
        out["loss_scale_skips"] = float(np.sum(
            np.asarray(telemetry["loss_scale_skips"], np.float64)))
    return out
