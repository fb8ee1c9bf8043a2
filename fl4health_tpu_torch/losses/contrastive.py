"""Contrastive losses (counterpart of ``fl4health_tpu/losses/contrastive.py``:
``cosine_similarity`` and MOON's ``moon_contrastive_loss``; NT-Xent and
PerFCL's losses wait for the personalisation slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity along ``dim``, each side normalised by its norm
    floored at ``eps``."""
    a_n = a / torch.clamp(torch.linalg.vector_norm(a, dim=dim, keepdim=True), min=eps)
    b_n = b / torch.clamp(torch.linalg.vector_norm(b, dim=dim, keepdim=True), min=eps)
    return (a_n * b_n).sum(dim=dim)


def moon_contrastive_loss(
    features: torch.Tensor,
    positive_pairs: torch.Tensor,
    negative_pairs: torch.Tensor,
    temperature: float = 0.5,
    mask: torch.Tensor | None = None,
    negative_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """MOON's model-contrastive loss.

    features ``[B, D]`` (the local model's), positive_pairs ``[P, B, D]``
    (the global model's), negative_pairs ``[N, B, D]`` (old local models');
    ``negative_mask`` ``[N]`` 0/1 drops negative rows (empty buffer slots);
    ``mask`` ``[B]`` averages over the valid examples only.
    loss = -log(sum_p e^{cos(z, z_p)/t} / (sum_p e^{cos(z, z_p)/t}
    + sum_n e^{cos(z, z_n)/t}))."""
    pos = cosine_similarity(features[None], positive_pairs) / temperature  # [P, B]
    neg = cosine_similarity(features[None], negative_pairs) / temperature  # [N, B]
    if negative_mask is not None:
        neg = torch.where(negative_mask[:, None] > 0, neg, torch.full_like(neg, -1e9))
    logits = torch.cat([pos, neg], dim=0).T  # [B, P + N]
    n_pos = positive_pairs.shape[0]
    log_prob = F.log_softmax(logits, dim=-1)
    per_example = (-torch.logsumexp(log_prob[:, :n_pos], dim=-1) if n_pos > 1
                   else -log_prob[:, 0])
    if mask is not None:
        m = mask.float()
        return (per_example * m).sum() / torch.clamp(m.sum(), min=1.0)
    return per_example.mean()
