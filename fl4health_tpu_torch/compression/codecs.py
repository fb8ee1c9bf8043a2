"""The compressed exchange's codecs (counterpart of
``fl4health_tpu/compression/codecs.py``): encode and decode of one client's
update as tensor ops, run inside each round's aggregate, every stochastic
draw a ``fold_in`` of (seed, round, client, leaf), so the pipelined and
chunked routes draw the same codes.

Per client, on the update ``packet - broadcast reference``:

1. add the client's error-feedback residual (the mass earlier rounds did
   not send), when enabled;
2. optionally rotate each leaf: a Rademacher sign flip, then an
   orthonormal fast Walsh-Hadamard transform (JAX's butterfly order);
3. optionally keep the global top-k magnitudes of the flat update, ties to
   the lowest index (``lax.top_k``'s order, from a stable descending sort);
4. optionally quantize the kept values stochastically to a symmetric
   int8/int4 grid with one scale a leaf (unbiased given the scale);
5. decode at once (dequantize, rotate back): the aggregate reads what a
   wire's receiver would reconstruct;
6. the new residual is ``(update + old residual) - decoded``.

A ``Params`` dict's leaves are walked in JAX's flatten order
(``flax_leaf_order``): the top-k's concatenation, each leaf's quantization
key ``fold_in(key, i)`` and rotation signs follow it. The codecs are plain
tensor ops in both packages (no Pallas kernel); the JAX package's
``stage_attr`` spans around them are not ported.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.compression.config import QUANT_LEVELS, CompressionConfig
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.observability import stages as stage_attr


# ---------------------------------------------------------------------------
# Randomized Hadamard rotation
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh-Hadamard transform of a length-2^m vector, in
    JAX's butterfly order (``(-1, 2, h)`` blocks, ``[a + b, a - b]``), then
    scaled by ``1 / sqrt(n)``: an involution up to rounding. XLA compiles
    JAX's division by the constant ``sqrt(float32(n))`` into a multiply by
    its f32 reciprocal, and the simulations run it compiled, so the port
    multiplies by that reciprocal."""
    n = x.shape[0]
    h = 1
    while h < n:
        x = x.reshape(-1, 2, h)
        a, b = x[:, 0, :], x[:, 1, :]
        x = torch.stack([a + b, a - b], dim=1).reshape(-1)
        h *= 2
    return x * float(np.float32(1.0) / np.sqrt(np.float32(n)))


def _rotation_signs(seed: int, leaf_idx: int, n_pad: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """One leaf's Rademacher diagonal: a fixed draw from (seed, leaf index),
    the same for encoder and decoder."""
    key = rng.fold_in(rng.PRNGKey(seed, device), leaf_idx)
    return rng.rademacher(key, (n_pad,), torch.float32)


def rotate_leaf(flat: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """A flat leaf -> its rotated, zero-padded vector (length
    ``next_pow2(n)``)."""
    padded = torch.nn.functional.pad(flat.to(torch.float32),
                                     (0, signs.shape[0] - flat.shape[0]))
    return _fwht(padded * signs)


def unrotate_leaf(rotated: torch.Tensor, signs: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``rotate_leaf``, the padding cut off."""
    return (signs * _fwht(rotated))[:n]


# ---------------------------------------------------------------------------
# Top-k selection
# ---------------------------------------------------------------------------

def topk_count(n_total: int, fraction: float) -> int:
    """The static k of a global top-k over ``n_total`` coordinates."""
    return max(1, min(n_total, int(round(fraction * n_total))))


def topk_mask(flat: torch.Tensor, k: int, k_effective: int | None = None) -> torch.Tensor:
    """A 0/1 f32 mask of the ``k`` largest magnitudes, ties to the lowest
    index as ``lax.top_k`` breaks them (a stable descending sort keeps
    equal magnitudes in index order; ``torch.topk`` promises no order).
    ``k_effective`` keeps only the first ``k_effective`` of those ``k``
    (``CompressionConfig.topk_schedule``'s fraction of the round)."""
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    keep = torch.ones((k,), dtype=torch.float32, device=flat.device)
    if k_effective is not None:
        keep = (torch.arange(k, device=flat.device) < k_effective).to(torch.float32)
    return torch.zeros_like(flat, dtype=torch.float32).scatter(0, idx, keep)


# ---------------------------------------------------------------------------
# Stochastic uniform quantization
# ---------------------------------------------------------------------------

def stochastic_quantize_leaf(flat: torch.Tensor, bits: int,
                             key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(quantized integers as f32, scale) of one leaf's flat values: the
    symmetric grid ``{-L..L}`` with ``scale = max|v| / L``, rounded up with
    probability the fraction (``rng.bernoulli``). An all-zero leaf keeps
    scale 0 and quantizes to 0; a leaf holding NaN or Inf quantizes to NaN,
    so a poisoned update stays visibly poisoned. The scale is ``max|v|``
    times the f32 reciprocal of ``L``, as XLA compiles JAX's division by
    the constant."""
    if flat.numel() == 0:
        return flat.to(torch.float32), torch.zeros((), dtype=torch.float32, device=flat.device)
    levels = QUANT_LEVELS[bits]
    vmax = flat.abs().max()
    scale = vmax * float(np.float32(1.0) / np.float32(levels))
    safe = torch.where(scale > 0, scale, 1.0)
    y = flat / safe
    lower = torch.floor(y)
    frac = y - lower
    q = lower + rng.bernoulli(key, torch.clamp(frac, 0.0, 1.0)).to(torch.float32)
    q = torch.clamp(q, -levels, levels)
    q = torch.where(scale > 0, q, 0.0)
    return torch.where(torch.isfinite(vmax), q, math.nan), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q * scale


# ---------------------------------------------------------------------------
# The encode -> decode round trip of one client's update
# ---------------------------------------------------------------------------

def compress_update(update: dict, residual: dict | None, key: torch.Tensor,
                    config: CompressionConfig,
                    topk_fraction_eff: float | None = None) -> tuple[dict, dict | None]:
    """The lossy channel's round trip for ONE client's update (a ``Params``
    dict): ``(decoded_update, new_residual)``, the residual None when none
    came in; the identity with no lossy stage. ``topk_fraction_eff`` is the
    round's kept fraction under ``config.topk_schedule`` (an f32 value, or
    a 0-d f32 tensor):
    its count is clamped into ``[1, k]`` and kept from the static top-k
    selection. Runs under ``torch.func.vmap`` over the clients."""
    if not config.enabled:
        return update, residual
    keys = ptu.flax_leaf_order(update)
    leaves = [update[k] for k in keys]
    res_leaves = [residual[k] for k in keys] if residual is not None else [None] * len(keys)
    sizes = [leaf.numel() for leaf in leaves]
    n_total = sum(sizes)
    if n_total == 0:
        return update, residual

    # 1. flat f32 working vectors (+ error feedback)
    flats = []
    for leaf, res in zip(leaves, res_leaves):
        v = leaf.to(torch.float32).reshape(-1)
        if res is not None:
            v = v + res.to(torch.float32).reshape(-1)
        flats.append(v)
    carried = flats  # the residual is accounted before the rotation

    # 2. rotation (per leaf, fixed seeded signs, orthonormal FWHT)
    signs = None
    if config.rotation:
        with stage_attr.stage("rotation"):
            device = flats[0].device
            signs = [_rotation_signs(config.seed, i, _next_pow2(sizes[i]), device)
                     for i in range(len(flats))]
            flats = [rotate_leaf(v, s) for v, s in zip(flats, signs)]

    # 3. global magnitude top-k over the concatenated update
    if config.topk_fraction is not None:
        with stage_attr.stage("topk"):
            n_sel = sum(v.shape[0] for v in flats)  # padded under rotation
            k = topk_count(n_total, config.topk_fraction)
            k_eff = None
            if isinstance(topk_fraction_eff, torch.Tensor):
                # a 0-d tensor, counted on its device: not read on the host
                k_eff = torch.clamp(torch.round(topk_fraction_eff * float(np.float32(n_total))),
                                    1, min(k, n_sel)).to(torch.int64)
            elif topk_fraction_eff is not None:
                # JAX's in-graph count: round half to even in f32, clamped
                k_eff = int(np.clip(np.round(np.float32(topk_fraction_eff)
                                             * np.float32(n_total)), 1, min(k, n_sel)))
            mask = topk_mask(torch.cat(flats), min(k, n_sel), k_eff)
            out, off = [], 0
            for v in flats:
                out.append(v * mask[off: off + v.shape[0]])
                off += v.shape[0]
            flats = out

    # 4. stochastic quantization, one scale a leaf
    quantized = None
    if config.quant_bits is not None:
        with stage_attr.stage("quantize"):
            quantized = [stochastic_quantize_leaf(v, config.quant_bits, rng.fold_in(key, i))
                         for i, v in enumerate(flats)]
            flats = [dequantize_leaf(q, scale) for q, scale in quantized]

    # 5. back to the original domain
    if config.rotation:
        with stage_attr.stage("rotation"):
            flats = [unrotate_leaf(v, s, n) for v, s, n in zip(flats, signs, sizes)]

    # integer leaves round (half to even, as jnp.rint); the residual below
    # accounts the rounding too
    flats = [torch.round(v) if not leaf.is_floating_point() else v
             for v, leaf in zip(flats, leaves)]
    decoded = {k: v.reshape(leaf.shape).to(leaf.dtype)
               for k, v, leaf in zip(keys, flats, leaves)}

    # 6. error feedback: the mass this round did not send; a non-finite
    # entry resets to 0, so a poisoned update does not persist
    new_residual = residual
    if residual is not None:
        new_residual = {}
        for i, (k, v_pre, dec, res) in enumerate(zip(keys, carried, flats, res_leaves)):
            if quantized is not None and not config.rotation and leaves[i].is_floating_point():
                # XLA fuses the dequantize's multiply into this subtraction
                # (one rounding), as compiled JAX computes it
                q, scale = quantized[i]
                dec = None
                r = rng._fma(-q, scale, v_pre)
            else:
                r = v_pre - dec
            r = r.to(res.dtype).reshape(res.shape)
            new_residual[k] = torch.where(torch.isfinite(r), r, 0.0)
        new_residual = {k: new_residual[k] for k in residual}
    return {k: decoded[k] for k in update}, new_residual


# ---------------------------------------------------------------------------
# Wire-byte arithmetic
# ---------------------------------------------------------------------------

def estimate_wire_nbytes(tree: Any, config: CompressionConfig) -> int:
    """Estimated compressed client->server payload bytes of one client's
    update under ``config``: a gap-encoded uint16 index a kept coordinate,
    int8/int4/f32 values, one f32 scale a leaf (no header); from shapes
    only."""
    sizes = [math.prod(leaf.shape) for leaf in ptu.tree_leaves(tree)]
    n_total = int(sum(sizes))
    if not config.enabled or n_total == 0:
        return 4 * n_total
    if config.topk_fraction is not None:
        nnz = topk_count(n_total, config.topk_fraction)
        index_bytes = 2 * nnz
    else:
        nnz, index_bytes = n_total, 0
    if config.quant_bits is not None:
        value_bytes = math.ceil(nnz * config.quant_bits / 8)
        scale_bytes = 4 * len(sizes)
    else:
        value_bytes, scale_bytes = 4 * nnz, 0
    return index_bytes + value_bytes + scale_bytes


def logical_nbytes(tree: Any) -> int:
    """The same update's dense byte footprint."""
    return ptu.tree_nbytes(tree)
