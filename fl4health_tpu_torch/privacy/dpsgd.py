"""Per-example DP-SGD primitives (counterpart of
``fl4health_tpu/privacy/dpsgd.py``): per-example gradients by
``torch.func.vmap(grad)``, a flat per-example clip, a masked sum and one
Gaussian draw per parameter leaf.

The noise is JAX's stream: a threefry key splits into one key per leaf in
JAX's flatten order (``flax_leaf_order``), and each leaf draws one
``rng.normal`` on its device; the draws equal JAX's within ``normal``'s 2
ulp. All of it is pure tensor code, so it runs under the client vmap.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.core.pytree import flax_leaf_order, tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params


def clip_per_example(per_example_grads: Params, bound: float
                     ) -> tuple[Params, torch.Tensor]:
    """Flat-clip each example's gradient tree to l2 norm <= bound.

    ``per_example_grads`` has a leading [B] axis on every leaf. Returns the
    clipped tree and the pre-clip per-example norms [B] (in the leaves'
    dtype, as the JAX function computes them)."""
    sq = sum(torch.square(g).reshape(g.shape[0], -1).sum(-1)
             for g in tree_leaves(per_example_grads))
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    factor = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)

    def scale(g):
        return g * factor.reshape((-1,) + (1,) * (g.ndim - 1))

    return tree_map(scale, per_example_grads), norms


def gaussian_noise_like(key: torch.Tensor, tree: Params, stddev) -> Params:
    """One independent standard-normal draw per leaf of a ``Params`` dict,
    times ``stddev``: ``split(key, n_leaves)`` in JAX's leaf order, each
    leaf drawn in f32 and cast to its dtype."""
    order = flax_leaf_order(tree)
    keys = dict(zip(order, rng.split(key, len(order))))
    return {k: rng.normal(keys[k], leaf.shape).to(leaf.dtype) * stddev
            for k, leaf in tree.items()}


def noisy_clipped_mean_grads(
    per_example_grads: Params,
    example_mask: torch.Tensor,
    key: torch.Tensor,
    clipping_bound: float,
    noise_multiplier: float,
    use_fused_kernel: bool = False,
    return_clip_fraction: bool = False,
):
    """DP-SGD gradient: clip each example to C, masked-sum, add
    N(0, (sigma C)^2) per coordinate (drawn from ``key``), divide by the
    number of real examples.

    ``use_fused_kernel`` routes the clip and the sum through the kernels of
    ``kernels/dp_clip.py`` (two passes over the [B, D] per-example tensor, no
    clipped intermediate); the other route is plain tensor code.
    ``return_clip_fraction`` appends the fraction of real examples whose
    pre-clip norm exceeded C, from the norms both routes already have."""
    m = example_mask.to(torch.float32)
    if use_fused_kernel:
        from fl4health_tpu_torch.kernels.dp_clip import fused_clipped_masked_sum

        summed, norms = fused_clipped_masked_sum(
            per_example_grads, m, clipping_bound, return_norms=True)
    else:
        clipped, norms = clip_per_example(per_example_grads, clipping_bound)
        summed = tree_map(
            lambda g: (g * m.reshape((-1,) + (1,) * (g.ndim - 1))).sum(0), clipped)
    noise = gaussian_noise_like(key, summed, noise_multiplier * clipping_bound)
    denom = torch.clamp(m.sum(), min=1.0)
    grads = tree_map(lambda s, n: (s + n) / denom, summed, noise)
    if return_clip_fraction:
        clip_fraction = ((norms > clipping_bound) * m).sum() / denom
        return grads, clip_fraction
    return grads


def make_per_example_grads(single_example_loss: Callable[[Params, Any], torch.Tensor]):
    """vmap(grad) over a batch: single_example_loss(params, example) -> scalar."""
    return torch.func.vmap(torch.func.grad(single_example_loss), in_dims=(None, 0))


def validate_dp_safe_model_state(module: torch.nn.Module | None) -> None:
    """Per-example gradients need per-example independence: batch statistics
    mix examples, so a module holding BatchNorm (torch's, or a layer that
    keeps ``batch_stats`` in the model state: ``models/norm.py``,
    ``models/masked.py``) is rejected, as the JAX function rejects a
    ``batch_stats`` collection. Build DP models with GroupNorm/LayerNorm."""
    if module is None:
        return
    bad = [name or type(module).__name__ for name, sub in module.named_modules()
           if isinstance(sub, torch.nn.modules.batchnorm._BatchNorm)
           or getattr(sub, "keeps_batch_stats", False)]
    if bad:
        raise ValueError(
            "DP-SGD with per-example gradients is incompatible with "
            f"BatchNorm (found at {bad}). Use GroupNorm/LayerNorm in DP models, "
            "as the reference's Opacus module validator enforces."
        )
