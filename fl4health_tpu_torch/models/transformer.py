"""Transformer encoder classifier (counterpart of
``fl4health_tpu/models/transformer.py``).

Submodules and parameters carry the flax names (``layer_0/attn/q_proj/kernel``,
``ff_in``, ``ln_attn``, ``tok_embed/embedding``, ``pos_embed``, ...) so
``param_dict`` keys are the flax paths. Dense kernels keep the flax layout
``[in, out]`` (``y = x @ kernel + bias``). ``dtype`` is the compute dtype:
each ``LoraDense`` casts its input and weights to it, as the flax module does,
while params stay f32. Layer norms compute in f32 with flax's ``epsilon=1e-6``
and return f32; GELU is the tanh form (flax ``nn.gelu``); the masked dense
core fills padded keys with ``finfo(f32).min``; mean-pool, ``ln_final`` and
the classifier run in f32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fl4health_tpu_torch.core.types import Params

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal(shape, generator, device):
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in, where
    fan_in is every axis but the last (a Dense ``[in, out]`` or a conv
    kernel ``[*spatial, in, out]``)."""
    t = torch.empty(shape, device=device)
    std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _normal(shape, std, generator, device):
    return torch.empty(shape, device=device).normal_(0.0, std,
                                                     generator=generator)


class LoraDense(nn.Module):
    """Dense with an additive low-rank adapter: ``y = xW + s (x A) B``;
    ``lora_b`` starts at zero so the adapted model starts at the base model."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        if rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(rank, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(self.kernel.shape, generator,
                                            self.kernel.device))
            self.bias.zero_()
            if self.rank > 0:
                self.lora_a.copy_(_normal(self.lora_a.shape, 1.0 / self.rank,
                                          generator, self.lora_a.device))
                self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd = x.to(self.dtype)
        y = xd @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)
        if self.rank > 0:
            scale = self.alpha / self.rank
            y = y + scale * ((xd @ self.lora_a.to(self.dtype))
                             @ self.lora_b.to(self.dtype))
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: params ``scale``/``bias``, eps 1e-6, computed
    in f32 (flax promotes a bf16 input with the f32 params)."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias,
                            self.epsilon)


class Embed(nn.Module):
    """flax ``nn.Embed``: one ``embedding`` table [vocab, features]."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            std = 1.0 / math.sqrt(self.embedding.shape[1])
            self.embedding.copy_(_normal(self.embedding.shape, std, generator,
                                         self.embedding.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x.long(), self.embedding)


AttentionFn = Callable[..., torch.Tensor]


class MultiHeadSelfAttention(nn.Module):
    """``attention_fn(q, k, v, pad_mask=mask) -> out`` (all ``[B, T, H, D]``)
    replaces the dense score/softmax/value core, e.g. ``flash_attention``."""

    def __init__(self, d_model: int, n_heads: int, lora_rank: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: AttentionFn | None = None):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model={d_model} must divide by n_heads={n_heads}")
        self.d_model, self.n_heads, self.dtype = d_model, n_heads, dtype
        self.attention_fn = attention_fn
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, LoraDense(d_model, d_model, lora_rank, dtype=dtype))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        head_dim = self.d_model // self.n_heads

        def split(t):
            return t.reshape(*t.shape[:-1], self.n_heads, head_dim)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, pad_mask=pad_mask)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
                torch.tensor(head_dim, dtype=self.dtype, device=q.device))
            neg = torch.tensor(torch.finfo(torch.float32).min,
                               dtype=scores.dtype, device=q.device)
            scores = torch.where(pad_mask[:, None, None, :] > 0, scores, neg)
            attn = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = out.reshape(*out.shape[:-2], self.d_model)
        return self.o_proj(out)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: x + attn(ln(x)), then x + mlp(ln(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 lora_rank: int = 0, dtype: torch.dtype = torch.float32,
                 attention_fn: AttentionFn | None = None):
        super().__init__()
        self.ln_attn = LayerNorm(d_model)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, lora_rank, dtype,
                                           attention_fn)
        self.ln_mlp = LayerNorm(d_model)
        self.ff_in = LoraDense(d_model, d_ff, lora_rank, dtype=dtype)
        self.ff_out = LoraDense(d_ff, d_model, lora_rank, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), pad_mask)
        h = F.gelu(self.ff_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.ff_out(h)


class TransformerClassifier(nn.Module):
    """Encoder + mean-pool + classifier head. Input: token ids ``[B, T]``,
    id 0 is PAD (the pad mask is ``x > 0``). Returns
    ``({"prediction": logits f32}, {"features": pooled})``."""

    def __init__(self, vocab_size: int, n_classes: int, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256,
                 max_len: int = 128, lora_rank: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: AttentionFn | None = None,
                 remat: bool = False):
        super().__init__()
        self.n_layers, self.remat = n_layers, remat
        self.tok_embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.dtype = dtype
        for i in range(n_layers):
            setattr(self, f"layer_{i}", EncoderBlock(
                d_model, n_heads, d_ff, lora_rank, dtype, attention_fn))
        self.ln_final = LayerNorm(d_model)
        self.classifier = LoraDense(d_model, n_classes)  # flax nn.Dense, f32
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        """Fresh params drawn from ``generator``, keyed by flax path."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)
        with torch.no_grad():
            self.pos_embed.copy_(_normal(self.pos_embed.shape, 0.02, generator,
                                         self.pos_embed.device))
        return param_dict(self)

    def forward(self, x: torch.Tensor):
        pad_mask = (x > 0).to(torch.float32)
        h = (self.tok_embed(x) + self.pos_embed[None, : x.shape[1]]).to(self.dtype)
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                # recompute the block on the backward pass: one layer's
                # activations live at a time (flax nn.remat). The block's
                # current tensors go in as arguments, so the recompute uses
                # the params the forward used, also under functional_call
                names, tensors = zip(*block.named_parameters())
                h = checkpoint(_call_block, block, names, h, pad_mask, *tensors,
                               use_reentrant=False)
            else:
                h = block(h, pad_mask)
        h = self.ln_final(h.float())
        denom = torch.clamp(pad_mask.sum(dim=1, keepdim=True), min=1.0)
        pooled = (h * pad_mask[..., None]).sum(dim=1) / denom
        logits = self.classifier(pooled)
        return {"prediction": logits.float()}, {"features": pooled}


def _call_block(block, names, h, pad_mask, *tensors):
    return functional_call(block, dict(zip(names, tensors)), (h, pad_mask))


def param_dict(module: nn.Module) -> Params:
    """The module's parameters, detached, keyed by flax path."""
    return {name.replace(".", "/"): p.detach().clone()
            for name, p in module.named_parameters()}
