"""Ring attention: the sequence axis split over a mesh axis (counterpart
of ``fl4health_tpu/parallel/ring_attention.py``).

Blockwise ring attention (Liu et al.): each rank holds one query block and
the key/value blocks travel around the ring (``ring_shift``, JAX's
``ppermute``); each hop's exact partial attention ``(out, lse)`` merges
into the running result through the logsumexp identity, so the whole is
exact softmax attention.

The contract is JAX's: global ``[B, T, H, D]`` tensors in and out (T
divisible by the axis size). The op enters with ``scatter_to_block`` and
leaves with ``gather_from_blocks`` along T, so a model that is replicated
over the ring's ranks around it computes what JAX's GSPMD computes, and
the gradients flow back through the same collectives. The body
(``_ring_body``) is JAX's: the local block first, then n - 1 hops of
rotate-then-compute, in f32, one cast at the end. With one rank there is
no hop and the merge divides by exactly 1.

``ring_flash_attention``'s local block is the port's
``flash_attention_lse`` (``kernels/flash_attention.py``): the forward
kernel (K3) runs on every hop, and the backward kernels (K4, K5) on every
hop's backward, with the merge's ``lse`` cotangent carried by autograd as
JAX's custom VJP carries it. Under the client ``vmap`` the kernels and the
collectives batch through their rules.
"""

from __future__ import annotations

import math

import torch

from fl4health_tpu_torch.parallel.compat import (Axis, gather_from_blocks, ring_shift,
                                                 scatter_to_block)
from fl4health_tpu_torch.parallel.mesh import Mesh, NamedSharding, P

NEG_INF = -1e30


def _dense_attention(q, k, v, pad_mask=None):
    """Dense softmax attention (the yardstick): q, k, v ``[B, T, H, D]``,
    ``pad_mask`` ``[B, T]`` with 1 = real token."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if pad_mask is not None:
        scores = torch.where(pad_mask[:, None, None, :] > 0, scores,
                             torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _dense_local_lse(q_blk, k_blk, v_blk, mask_blk):
    """One block's exact partial attention ``(out f32, lse)``; an all-masked
    row's lse is a large finite negative, never -inf."""
    d = q_blk.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k_blk.float()) / math.sqrt(d)
    valid = mask_blk[:, None, None, :] > 0
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    denom = torch.clamp(p.sum(dim=-1), min=1e-20)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    lse = m + torch.log(denom)
    return o / denom.transpose(1, 2)[..., None], lse


def _ring_body(q_blk, k_blk, v_blk, mask_blk, local_fn, axis: Axis):
    """The ring driver: the local block first, then ``n - 1`` hops of
    rotate-then-compute, merged through the logsumexp statistic (running
    max ``m``, normaliser ``s``, weighted numerator ``acc``)."""
    o0, lse0 = local_fn(q_blk, k_blk, v_blk, mask_blk)
    m, s, acc = lse0, torch.ones_like(lse0), o0.float()
    k_cur, v_cur, mask_cur = k_blk, v_blk, mask_blk
    for _ in range(axis.size - 1):
        k_cur = ring_shift(k_cur, axis)
        v_cur = ring_shift(v_cur, axis)
        mask_cur = ring_shift(mask_cur, axis)
        o_j, lse_j = local_fn(q_blk, k_cur, v_cur, mask_cur)
        m_new = torch.maximum(m, lse_j)
        c = torch.exp(m - m_new)      # rescale the old accumulators
        w = torch.exp(lse_j - m_new)  # this hop's weight
        s = s * c + w
        acc = acc * c.transpose(1, 2)[..., None] + w.transpose(1, 2)[..., None] * o_j.float()
        m = m_new
    denom = torch.clamp(s.transpose(1, 2)[..., None], min=1e-20)
    return (acc / denom).to(q_blk.dtype)


def _ring(local_fn, mesh: Mesh, axis_name: str, q, k, v, pad_mask):
    axis = mesh.axis(axis_name)
    if q.shape[1] % axis.size:
        raise ValueError(f"ring attention: T={q.shape[1]} must divide over the "
                         f"{axis.size} ranks of mesh axis {axis_name!r}")
    if pad_mask is None:
        pad_mask = torch.ones(q.shape[:2], dtype=torch.float32, device=q.device)
    q_blk, k_blk, v_blk = (scatter_to_block(x, axis, 1) for x in (q, k, v))
    mask_blk = scatter_to_block(pad_mask.detach().to(torch.float32), axis, 1)
    out = _ring_body(q_blk, k_blk, v_blk, mask_blk, local_fn, axis)
    return gather_from_blocks(out, axis, 1)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                        axis_name: str = "seq",
                        pad_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact softmax attention with the sequence axis split over
    ``axis_name``, each hop's block dense. q, k, v ``[B, T, H, D]``;
    ``pad_mask`` ``[B, T]`` (1 = token)."""
    return _ring(_dense_local_lse, mesh, axis_name, q, k, v, pad_mask)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                         axis_name: str = "seq", pad_mask: torch.Tensor | None = None,
                         block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Ring attention whose local block is the flash kernel pair
    (``flash_attention_lse``): K3 forward and K4/K5 backward on every hop.

    Same contract as :func:`ring_self_attention`. The port's kernels choose
    their own tiles, so ``block_q``/``block_k`` only feed JAX's check: each
    block shrinks to ``gcd(T / N, block)``, and a shrink below 8 on a
    shard of 8 or more raises rather than running a degenerate tile."""
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention_lse

    n = mesh.axis(axis_name).size
    t_local = q.shape[1] // n
    bq, bk = math.gcd(t_local, block_q), math.gcd(t_local, block_k)
    if min(bq, bk) < 8 and t_local >= 8:
        raise ValueError(
            f"ring_flash_attention: local length {t_local} is incompatible "
            f"with block sizes ({block_q}, {block_k}) — the divisor shrink "
            f"degenerates to ({bq}, {bk}); choose T/N divisible by the "
            "block sizes"
        )
    return _ring(flash_attention_lse, mesh, axis_name, q, k, v, pad_mask)


def sequence_parallel_sharding(mesh: Mesh, axis_name: str = "seq") -> NamedSharding:
    """``[B, T, ...]`` activations with T over the seq axis: the placement
    companion for feeding ring attention."""
    return NamedSharding(mesh, P(None, axis_name))
