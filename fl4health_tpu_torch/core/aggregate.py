"""Aggregation over the clients axis (counterpart of
``fl4health_tpu/core/aggregate.py``): a masked weighted mean along axis 0 of
client-stacked params, with the same empty-cohort and NaN-row guarantees.
"""

from __future__ import annotations

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
from fl4health_tpu_torch.core.types import PyTree, StackedParams


def expand_clients(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape [clients] weights to broadcast against a [clients, ...] leaf."""
    return w.reshape((-1,) + (1,) * (leaf.ndim - 1))


def effective_weights(
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> torch.Tensor:
    """Normalized weights: ``n_i / sum(n)`` (weighted) or ``1 / |S|``.
    An empty cohort (all-zero mask) gives all-zero weights, not NaN."""
    counts = torch.as_tensor(sample_counts, dtype=torch.float32)
    m = (torch.ones_like(counts) if mask is None
         else torch.as_tensor(mask, dtype=torch.float32, device=counts.device))
    raw = counts * m if weighted else m
    total = raw.sum()
    return torch.where(total > 0, raw / torch.clamp(total, min=1e-12),
                       torch.zeros_like(raw))


# Up to this many clients XLA compiles JAX's masked weighted sum into one
# fused multiply-add a client, in client order (checked on the CPU); beyond,
# into windows of this many rows (``_windowed_sum``).
FMA_CHAIN_MAX_CLIENTS = 32


def _windowed_sum(products: torch.Tensor) -> torch.Tensor:
    """XLA's order for a sum over more than ``FMA_CHAIN_MAX_CLIENTS`` rows of
    ``[n, E]`` f32 products: the rows zero-padded to a multiple of 32, half
    the padding (rounded down) before them, each window of 32 rows summed in
    order, then the windows' partial sums added in order; every add an f32
    add, as explicit adds (``torch.sum`` promises no order)."""
    n, width = products.shape
    windows = -(-n // FMA_CHAIN_MAX_CLIENTS)
    pad = windows * FMA_CHAIN_MAX_CLIENTS - n
    padded = torch.nn.functional.pad(products, (0, 0, pad // 2, pad - pad // 2))
    rows = padded.view(windows, FMA_CHAIN_MAX_CLIENTS, width)
    acc = rows[:, 0]
    for j in range(1, FMA_CHAIN_MAX_CLIENTS):
        acc = acc + rows[:, j]
    out = acc[0]
    for i in range(1, windows):
        out = out + acc[i]
    return out


def weighted_mean(stacked: StackedParams, weights: torch.Tensor) -> PyTree:
    """``sum_i w_i * leaf_i`` over the clients axis, accumulated in f32, with
    weight-0 rows hard-zeroed so a NaN in an unsampled row cannot leak in.

    Every leaf goes into one ``[clients, elements]`` buffer, so the sum is a
    few ops for the whole tree, in the order XLA compiles JAX's sum, bit for
    bit: a server optimizer that normalises its input (FedOpt's Adam) turns
    the last bit of a pseudo-gradient that should be zero into a full step.
    Up to ``FMA_CHAIN_MAX_CLIENTS`` clients it runs client by client as one
    fused multiply-add each, ``acc = fma(leaf_i, w_i, acc)``, rounded to f32
    once a step (the product of two f32 is exact in f64, so the f64
    multiply-add rounds once, as an fma does); with more, each product is
    rounded to f32 on its own and summed by ``_windowed_sum``."""
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked
    n, device = leaves[0].shape[0], leaves[0].device
    w = weights.to(device=device, dtype=torch.float32)
    flat = torch.cat([x.reshape(n, -1).float() for x in leaves], dim=1)
    zero = torch.zeros((), device=device)
    if n > FMA_CHAIN_MAX_CLIENTS:
        out = _windowed_sum(torch.where(w[:, None] > 0, flat, zero) * w[:, None])
    else:
        acc = torch.zeros(flat.shape[1], dtype=torch.float64, device=device)
        for i in range(n):
            row = torch.where(w[i] > 0, flat[i], zero).double()
            acc = torch.addcmul(acc, row, w[i].double()).float().double()
        out = acc.float()
    pieces = iter(torch.split(out, [x[0].numel() for x in leaves]))
    return tree_map(lambda x: next(pieces).view(x.shape[1:]).to(x.dtype), stacked)


def aggregate(
    stacked: StackedParams,
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> PyTree:
    return weighted_mean(stacked, effective_weights(sample_counts, mask, weighted))


def aggregate_losses(
    losses: torch.Tensor,
    sample_counts: torch.Tensor,
    mask: torch.Tensor | None = None,
    weighted: bool = True,
) -> torch.Tensor:
    w = effective_weights(sample_counts, mask, weighted)
    return (torch.as_tensor(losses, dtype=torch.float32) * w).sum()
