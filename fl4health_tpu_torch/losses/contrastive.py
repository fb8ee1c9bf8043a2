"""Contrastive losses (counterpart of ``fl4health_tpu/losses/contrastive.py``):
``cosine_similarity``, MOON's ``moon_contrastive_loss``, SimCLR's
``ntxent_loss``, ``cosine_similarity_loss`` and PerFCL's ``perfcl_loss``;
each takes an optional ``[B]`` example mask, as JAX's do."""

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


def _masked_mean(per: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return per.mean()
    m = mask.float()
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def ntxent_loss(
    features: torch.Tensor,
    transformed_features: torch.Tensor,
    temperature: float = 0.5,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """NT-Xent (SimCLR) over ``[B, D]`` paired views: for each of the 2B
    anchors the positive is its pair, the negatives every other valid row.
    Self-similarity and padded columns are set to the dtype's lowest
    value; the mean runs over the valid anchors of both views."""
    b = features.shape[0]
    z = torch.cat([features, transformed_features], dim=0)  # [2B, D]
    sim = cosine_similarity(z[:, None, :], z[None, :, :]) / temperature  # [2B, 2B]
    valid = (torch.ones((b,), dtype=torch.float32, device=z.device) if mask is None
             else mask.float())
    valid2 = torch.cat([valid, valid])
    diag = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = torch.where(diag | (valid2[None, :] < 0.5),
                      torch.full_like(sim, torch.finfo(sim.dtype).min), sim)
    rows = torch.arange(2 * b, device=z.device)
    pos_idx = torch.cat([rows[:b] + b, rows[:b]])
    per_anchor = -F.log_softmax(sim, dim=-1)[rows, pos_idx]
    return (per_anchor * valid2).sum() / torch.clamp(valid2.sum(), min=1.0)


def cosine_similarity_loss(features: torch.Tensor, reference_features: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """The mean |cos| of each row against its reference row, minimised to
    push the two apart."""
    return _masked_mean(cosine_similarity(features, reference_features).abs(), mask)


def perfcl_loss(
    local_features: torch.Tensor,
    old_local_features: torch.Tensor,
    global_features: torch.Tensor,
    old_global_features: torch.Tensor,
    initial_global_features: torch.Tensor,
    temperature: float = 0.5,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PerFCL's two contrastive terms, (global, local): the global stream
    pulled toward the received (aggregated) model's global features and
    away from last round's; the local stream pulled toward last round's
    local features and away from the received global features."""
    g = moon_contrastive_loss(global_features, initial_global_features[None],
                              old_global_features[None], temperature, mask)
    loc = moon_contrastive_loss(local_features, old_local_features[None],
                                initial_global_features[None], temperature, mask)
    return g, loc
