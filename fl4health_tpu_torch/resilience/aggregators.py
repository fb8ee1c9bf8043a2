"""Byzantine-robust aggregation (counterpart of
``fl4health_tpu/resilience/aggregators.py``): statically shaped, mask-driven
reductions over the clients axis.

Every combinator takes the client-stacked packets (a leading ``[clients]``
axis on every leaf) and a ``[clients]`` participation mask, and treats a
non-finite submission from a participating client as adversarial: it
sorts to the top and is out-voted or trimmed, never propagated. Shapes
never change with the mask, on either route.

- :func:`coordinate_median`: coordinate-wise median over the participants;
- :func:`trimmed_mean`: coordinate-wise mean after trimming
  ``floor(trim_fraction * k)`` values from each end;
- :func:`norm_bounded_mean`: weighted mean after clipping each client's
  update norm against a reference (the only one that honours sample
  counts);
- :func:`krum_weights`: Krum / multi-Krum selection (Blanchard et al.).

:class:`RobustFedAvg` packages them as a ``Strategy`` whose state is the
plain ``FedAvgState``. Median, trimmed mean and Krum are unweighted: in
the Byzantine model the sample counts are the attacker's to set.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fl4health_tpu_torch.core.aggregate import (client_all, effective_weights, expand_clients,
                                                 weighted_mean)
from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params, PyTree, StackedParams
from fl4health_tpu_torch.observability import stages as stage_attr
from fl4health_tpu_torch.parallel.compat import client_axis
from fl4health_tpu_torch.strategies.base import FitResults, Strategy
from fl4health_tpu_torch.strategies.fedavg import FedAvgState

ROBUST_METHODS = ("median", "trimmed_mean", "norm_bounded", "krum", "multi_krum")


def _sanitized(leaf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 copy with masked-out rows and non-finite entries set to +inf, so
    an ascending sort pushes both past every honest value (a NaN would sort
    after +inf and break the "first k rows are the participants" rule)."""
    v = leaf.float()
    keep = expand_clients(mask > 0, v) & torch.isfinite(v)
    return torch.where(keep, v, torch.full_like(v, float("inf")))


def coordinate_median(stacked: StackedParams, mask: torch.Tensor) -> PyTree:
    """Masked coordinate-wise median over the clients axis: the mean of the
    sorted participants' middle pair (an empty cohort yields +inf, which
    :class:`RobustFedAvg` guards)."""
    # k, and so the middle ranks, stay on the device: no host sync
    k = (mask > 0).sum()
    lo = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(k, 2, rounding_mode="floor"), min=0)

    def med(leaf):
        s = torch.sort(_sanitized(leaf, mask), dim=0).values
        return 0.5 * (s[lo] + s[hi])

    return tree_map(med, stacked)


def trimmed_mean(stacked: StackedParams, mask: torch.Tensor,
                 trim_fraction: float = 0.2) -> PyTree:
    """Masked coordinate-wise trimmed mean: drop ``floor(trim_fraction * k)``
    values from each end of the sorted participants (clamped so at least
    the median survives) and average the middle. Non-finite submissions
    sort to the top and are removed whenever the trim budget covers the
    attackers.

    ``trim_fraction`` may be a float or a 0-d tensor (a sweep cell's hoisted
    scalar): a tensor is not read on the host; JAX's traced path clamps it
    into [0, 0.4999] in f32 where a float is checked."""
    if isinstance(trim_fraction, torch.Tensor):
        fraction = torch.clamp(trim_fraction.to(torch.float32), 0.0, 0.4999)
    else:
        trim_fraction = float(trim_fraction)
        if not 0.0 <= trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5); got {trim_fraction} "
                "(trimming half or more from each end leaves nothing)")
        fraction = float(np.float32(trim_fraction))
    n = mask.shape[0]
    k = (mask > 0).sum()
    # floor of the f32 product, as JAX computes it, on the device
    t = torch.floor(fraction * k.to(torch.float32)).to(torch.int64)
    t = torch.minimum(torch.clamp(t, min=0),
                      torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), min=0))
    pos = torch.arange(n, device=mask.device)
    w = ((pos >= t) & (pos < k - t)).to(torch.float32)  # sorted-rank weights
    denom = torch.clamp(w.sum(), min=1.0)

    def tm(leaf):
        s = torch.sort(_sanitized(leaf, mask), dim=0).values
        ww = expand_clients(w, s)
        # where() then multiply: an untrimmed +inf flows through (real
        # breakdown), a trimmed one must not poison the sum (inf * 0 = nan)
        return (torch.where(ww > 0, s, torch.zeros_like(s)) * ww).sum(dim=0) / denom

    return tree_map(tm, stacked)


def _per_client_nonfinite_flag(stacked: StackedParams) -> torch.Tensor:
    """[C] bool: the client's row holds a NaN or Inf in a float leaf."""
    bad = None
    for leaf in tree_leaves(stacked):
        if not leaf.is_floating_point():
            continue
        row = (~torch.isfinite(leaf.reshape(leaf.shape[0], -1))).any(dim=1)
        bad = row if bad is None else bad | row
    if bad is None:
        first = tree_leaves(stacked)[0]
        return torch.zeros((first.shape[0],), dtype=torch.bool, device=first.device)
    return bad


def norm_bounded_mean(stacked: StackedParams, reference: Params,
                      sample_counts: torch.Tensor, mask: torch.Tensor,
                      max_norm: float, weighted: bool = True) -> PyTree:
    """Weighted mean after clipping each client's update norm ``||packet -
    reference||`` to ``max_norm``; non-finite coordinates count as a zero
    delta, so a NaN-poisoned client degrades to re-sending the reference.
    ``max_norm`` may be a 0-d tensor (a sweep cell's hoisted scalar), read
    on the device: the f32 division JAX's traced path makes."""
    n2 = None
    for leaf, ref in zip(tree_leaves(stacked), tree_leaves(reference)):
        d = leaf.float() - ref.float()[None]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        s = torch.square(d).reshape(d.shape[0], -1).sum(dim=1)
        n2 = s if n2 is None else n2 + s
    norm = torch.sqrt(n2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)

    def clip(leaf, ref):
        r = ref.float()[None]
        d = leaf.float() - r
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        return r + expand_clients(scale, d) * d

    clipped = tree_map(clip, stacked, reference)
    out = weighted_mean(clipped, effective_weights(sample_counts, mask, weighted))
    return tree_map(lambda o, ref: o.to(ref.dtype), out, reference)


def krum_weights(stacked: StackedParams, mask: torch.Tensor, num_byzantine: int,
                 multi_m: int = 1) -> torch.Tensor:
    """Krum / multi-Krum selection as [C] normalised weights: each
    participant is scored by the sum of its squared distances to its ``n -
    f - 2`` closest participating peers, and the ``multi_m`` lowest scores
    are averaged (``multi_m=1``: Krum). Non-finite, masked-out, and +inf
    selections get weight 0."""
    n_clients = mask.shape[0]
    if not 1 <= multi_m <= n_clients:
        raise ValueError(f"multi_m must be in [1, {n_clients}]; got {multi_m}")
    part = mask > 0
    n = part.sum()
    bad = _per_client_nonfinite_flag(stacked)
    d2 = torch.zeros((n_clients, n_clients), dtype=torch.float32, device=mask.device)
    for leaf in tree_leaves(stacked):
        v = leaf.float().reshape(n_clients, -1)
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        sq = torch.square(v).sum(dim=1)
        d2 = d2 + (sq[:, None] + sq[None, :] - 2.0 * (v @ v.T))
    d2 = torch.clamp(d2, min=0.0)  # round-off can dip tiny negatives
    inf = torch.full_like(d2, float("inf"))
    unusable = ~part | bad
    d2 = torch.where(unusable[:, None] | unusable[None, :], inf, d2)
    d2 = torch.where(torch.eye(n_clients, dtype=torch.bool, device=d2.device), inf, d2)
    # the closest c = n - f - 2 neighbours, clamped for tiny cohorts
    c = torch.clamp(n - num_byzantine - 2, min=1, max=n_clients - 1)
    csum = torch.cumsum(torch.sort(d2, dim=1).values, dim=1)  # an inf neighbour poisons it
    score = torch.where(part & ~bad, csum[:, c - 1], torch.full_like(csum[:, 0], float("inf")))
    # lax.top_k(-score, m): the m largest, ties to the lower index
    order = torch.sort(-score, descending=True, stable=True)
    neg_vals, idx = order.values[:multi_m], order.indices[:multi_m]
    sel = torch.zeros((n_clients,), dtype=torch.float32, device=mask.device)
    sel = sel.index_add(0, idx, torch.isfinite(neg_vals).to(torch.float32))
    total = sel.sum()
    return torch.where(total > 0, sel / torch.clamp(total, min=1.0), sel)


class RobustFedAvg(Strategy):
    """FedAvg with a Byzantine-robust reduction, a drop-in ``Strategy``
    whose state is ``FedAvgState``. ``method``: ``"median"``,
    ``"trimmed_mean"``, ``"norm_bounded"``, ``"krum"`` or ``"multi_krum"``.
    An effectively empty cohort (all weights zero) keeps the previous
    params, as FedAvg does."""

    def __init__(self, method: str = "median", *, trim_fraction: float = 0.2,
                 max_update_norm: float = 10.0, num_byzantine: int = 1,
                 multi_krum_m: int = 3, weighted_aggregation: bool = True):
        if method not in ROBUST_METHODS:
            raise ValueError(f"method must be one of {ROBUST_METHODS}; got {method!r}")
        if max_update_norm <= 0:
            raise ValueError("max_update_norm must be positive")
        if num_byzantine < 0:
            raise ValueError("num_byzantine must be >= 0")
        self.method = method
        self.trim_fraction = trim_fraction
        self.max_update_norm = max_update_norm
        self.num_byzantine = num_byzantine
        self.multi_krum_m = multi_krum_m
        # honoured by norm_bounded only; the order statistics are unweighted
        self.weighted_aggregation = weighted_aggregation

    def init(self, params: Params) -> FedAvgState:
        return FedAvgState(params=params)

    def aggregate(self, server_state: FedAvgState, results: FitResults,
                  round_idx: int) -> FedAvgState:
        with stage_attr.stage("robust_aggregate"):
            # order statistics read every client's row: under a mesh the
            # stacks are gathered (as XLA gathers a sharded sort's operand)
            # and the rule runs on them whole, the clients axis left
            stacked, mask = tree_map(client_all, results.packets), client_all(results.mask)
            counts = client_all(results.sample_counts)
            with client_axis(None):
                return self._aggregate_whole(server_state, stacked, mask, counts)

    def _aggregate_whole(self, server_state: FedAvgState, stacked, mask,
                         sample_counts) -> FedAvgState:
        if self.method == "median":
            new, ok = coordinate_median(stacked, mask), mask.sum() > 0
        elif self.method == "trimmed_mean":
            new, ok = trimmed_mean(stacked, mask, self.trim_fraction), mask.sum() > 0
        elif self.method == "norm_bounded":
            new = norm_bounded_mean(stacked, server_state.params,
                                    sample_counts, mask, self.max_update_norm,
                                    self.weighted_aggregation)
            ok = mask.sum() > 0
        else:  # krum / multi_krum
            m = 1 if self.method == "krum" else self.multi_krum_m
            w = krum_weights(stacked, mask, self.num_byzantine, m)
            new, ok = weighted_mean(stacked, w), w.sum() > 0
        params = tree_map(lambda n, o: torch.where(ok, n.to(o.dtype), o),
                          new, server_state.params)
        return dataclasses.replace(server_state, params=params)
