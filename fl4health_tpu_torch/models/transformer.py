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
the classifier run in f32. ``LoraDense(dtype=None)`` is flax's ``nn.Dense``
with ``dtype=None``: it computes in the promoted dtype of its input and
params (the classifier head, and the small models of ``cnn.py``).

Dropout (``dropout_rate``) is flax's ``nn.Dropout`` where the flax module
applies it, on train calls only: on the attention probabilities in the
dense core (an ``attention_fn`` skips it, as JAX's does), after the
attention block and after the MLP. A mask is ``uniform(key) < 1 - rate``
through ``rng.py`` and the kept values are divided by ``1 - rate``. The key
of each ``Dropout`` is flax's: the model's ``rng`` (the engine's step key,
flax's ``rngs["dropout"]``) folded with the SHA-1 hash of the module path
and the scope's call counter (``flax/core/scope.py`` ``_fold_in_static``),
e.g. ``("layer_0", "attn", "Dropout_0", 1)``. Under remat the recompute
draws the same mask from the same key.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fl4health_tpu_torch import rng as jrng
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.kernels.fold import fold_vmapped
from fl4health_tpu_torch.precision.policy import conv_compute_dtype

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
    ``lora_b`` starts at zero so the adapted model starts at the base model.
    ``dtype`` is the compute dtype; None computes in the promoted dtype of
    the input, kernel and bias (flax ``nn.Dense(dtype=None)``).

    Under tensor parallelism (``parallel/tp.py`` ``enable_tensor_parallel``
    sets ``tp_role`` and ``tp_axis``) the params are this rank's Megatron
    shards: a ``"column"`` layer takes ``f`` on its input (all-reduce of
    the input's gradient) and on ``x A``, a ``"row"`` layer's partial
    ``x W`` and ``x A`` take ``g`` (all-reduce) before the replicated bias
    and ``B``."""

    tp_role: str | None = None
    tp_axis = None

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, dtype: torch.dtype | None = torch.float32):
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
        dtype = (self.dtype if self.dtype is not None
                 else conv_compute_dtype(x.dtype, self.kernel.dtype, self.bias.dtype))
        xd = x.to(dtype)
        if self.tp_role is not None:
            return self._forward_tp(xd, dtype)
        y = xd @ self.kernel.to(dtype) + self.bias.to(dtype)
        if self.rank > 0:
            scale = self.alpha / self.rank
            y = y + scale * ((xd @ self.lora_a.to(dtype)) @ self.lora_b.to(dtype))
        return y

    def _forward_tp(self, xd: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        from fl4health_tpu_torch.parallel.compat import copy_to_axis, reduce_from_axis

        axis, scale = self.tp_axis, self.alpha / max(self.rank, 1)
        if self.tp_role == "column":
            y = copy_to_axis(xd, axis) @ self.kernel.to(dtype) + self.bias.to(dtype)
            if self.rank > 0:
                xa = copy_to_axis(xd @ self.lora_a.to(dtype), axis)
                y = y + scale * (xa @ self.lora_b.to(dtype))
            return y
        y = reduce_from_axis(xd @ self.kernel.to(dtype), axis)
        if self.rank > 0:
            xa = reduce_from_axis(xd @ self.lora_a.to(dtype), axis)
            y = y + scale * (xa @ self.lora_b.to(dtype))
        return y + self.bias.to(dtype)


# ---------------------------------------------------------------------------
# Dropout (flax nn.Dropout, keyed as flax's Scope.make_rng keys it)
# ---------------------------------------------------------------------------

def flax_scope_hash(path: tuple) -> int:
    """The 32-bit word flax folds into a key for a scope path of strings and
    ints: the first 4 bytes of the SHA-1 of the segments, without
    separators (``config.flax_fix_rng_separator`` off, its default)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def dropout_key(key: torch.Tensor, path: tuple[str, ...]) -> torch.Tensor:
    """The key the ``Dropout`` at ``path`` draws from: its scope's first
    ``make_rng("dropout")`` (counter 1) under the model's ``rng``."""
    return jrng.fold_in(key, flax_scope_hash((*path, 1)))


def dropout_mask(key: torch.Tensor, shape: tuple[int, ...], rate: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, 1 - rate, shape)``: ``uniform(key, shape)
    < 1 - rate`` in f32."""
    keep = torch.tensor(1.0 - rate, dtype=torch.float32, device=key.device)
    return jrng.uniform(key, shape) < keep


def dropout(x: torch.Tensor, rate: float, key: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dropout``: the kept values divided by ``1 - rate`` (in
    ``x``'s dtype, as JAX's weak scalar is), the rest zero."""
    if rate == 1.0:
        return torch.zeros_like(x)
    mask = dropout_mask(key, tuple(x.shape), rate)
    return torch.where(mask, x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Layer norm with a client-vmap rule
# ---------------------------------------------------------------------------
#
# Under the simulation's client vmap a block's layer norm sees per-client
# ``scale``/``bias``. Left to itself, vmap decomposes layer norm's backward
# with batched weights into broadcast elementwise passes over the f32
# activations. Where there is a backward (grad mode on), the Functions below
# batch it themselves instead, as the kernels' Functions do: the vmapped
# axis joins a leading client axis N of ``x [N, ..., D]`` and of
# ``scale``/``bias [N, D]``, and each of the N clients runs the fused
# ``native_layer_norm`` and its backward with its own weights. Where there
# is none (evaluation, the remat's forward), the weight-less layer norm and
# one ``addcmul`` are as few passes and cost the host no Function call,
# whose dispatch under the transforms costs far more than the op.

def layer_norm_clients_forward(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, eps: float):
    """``(y, mean, rstd)`` of ``x [N, ..., D]`` under client ``n``'s
    ``scale[n]``/``bias[n]``; ``mean``/``rstd`` are ``[N, ..., 1]``."""
    d = (x.shape[-1],)
    outs = [torch.native_layer_norm(x[n], d, scale[n], bias[n], eps)
            for n in range(x.shape[0])]
    if len(outs) == 1:  # one client: its own tensors, no copy
        return tuple(t.unsqueeze(0) for t in outs[0])
    return tuple(torch.stack(ts) for ts in zip(*outs))


def layer_norm_clients_backward(dy: torch.Tensor, x: torch.Tensor,
                                mean: torch.Tensor, rstd: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor):
    """``(dx, dscale, dbias)`` of ``layer_norm_clients_forward``."""
    d = (x.shape[-1],)
    outs = [torch.ops.aten.native_layer_norm_backward(
        dy[n], x[n], d, mean[n], rstd[n], scale[n], bias[n], [True, True, True])
        for n in range(x.shape[0])]
    if len(outs) == 1:
        return tuple(t.unsqueeze(0) for t in outs[0])
    return tuple(torch.stack(ts) for ts in zip(*outs))


def _unfold_clients(t: torch.Tensor, size: int) -> torch.Tensor:
    return t.view(size, t.shape[0] // size, *t.shape[1:])


class _LayerNorm(torch.autograd.Function):
    """``(y, mean, rstd)`` of ``x [N, ..., D]`` under per-client weights
    ``[N, D]``; ``mean``/``rstd`` are outputs (not differentiable) so that
    the backward, at any transform level, reads the statistics of the
    forward it belongs to."""

    @staticmethod
    def forward(x, scale, bias, eps):
        return layer_norm_clients_forward(x, scale, bias, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, _ = inputs
        _, mean, rstd = output
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, scale, bias, mean, rstd)

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        return (*_LayerNormGrads.apply(dy, x, mean, rstd, scale, bias), None)

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, eps):
        n = info.batch_size
        outs = _LayerNorm.apply(*(fold_vmapped(t, d, n)[0] for t, d in
                                  zip((x, scale, bias), in_dims)), eps)
        return tuple(_unfold_clients(t, n) for t in outs), (0, 0, 0)


class _LayerNormGrads(torch.autograd.Function):
    """``(dx, dscale, dbias)`` of ``_LayerNorm``: a Function of its own so
    that the backward, which receives vmapped cotangents under the client
    vmap, batches through a ``vmap`` rule too."""

    @staticmethod
    def forward(dy, x, mean, rstd, scale, bias):
        return layer_norm_clients_backward(dy, x, mean, rstd, scale, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass  # never differentiated: the gradients are first order

    @staticmethod
    def vmap(info, in_dims, *args):
        n = info.batch_size
        grads = _LayerNormGrads.apply(*(fold_vmapped(t, d, n)[0]
                                        for t, d in zip(args, in_dims)))
        return tuple(_unfold_clients(g, n) for g in grads), (0, 0, 0)


def layer_norm_clients(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Client-batched layer norm: ``x [K, ..., D]`` normalised over its last
    axis, then scaled and shifted by client ``k``'s ``scale[k]``/``bias[k]``
    ``[K, D]``. The dtype is ``x``'s (the model passes f32)."""
    return _LayerNorm.apply(x, scale, bias, eps)[0]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """``F.layer_norm(x, scale.shape, scale, bias, eps)`` for one client. With
    grad mode on, as one client of ``layer_norm_clients``: under the client
    vmap the clients fold into its client axis instead of vmap's
    decomposition. Without, the weight-less layer norm and the affine as one
    ``addcmul``, which vmap batches as they are."""
    if not torch.is_grad_enabled():
        return torch.addcmul(bias, F.layer_norm(x, scale.shape, None, None, eps), scale)
    return layer_norm_clients(x[None], scale[None], bias[None], eps)[0]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: params ``scale``/``bias``, eps 1e-6, computed
    in f32 (flax promotes a bf16 input with the f32 params), through
    ``layer_norm`` and its client-vmap rule."""

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
        return layer_norm(x.float(), self.scale, self.bias, self.epsilon)


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
                 attention_fn: AttentionFn | None = None, dropout_rate: float = 0.0):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model={d_model} must divide by n_heads={n_heads}")
        self.d_model, self.n_heads, self.dtype = d_model, n_heads, dtype
        self.attention_fn, self.dropout_rate = attention_fn, dropout_rate
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, LoraDense(d_model, d_model, lora_rank, dtype=dtype))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                drop_key: torch.Tensor | None = None) -> torch.Tensor:
        """``drop_key``: the key of the probabilities' ``Dropout`` on a train
        call with dropout, else None."""
        head_dim = self.d_model // self.n_heads

        def split(t):
            # the heads this rank holds: all of them, or its tensor-parallel
            # shard's n_heads / model
            return t.reshape(*t.shape[:-1], t.shape[-1] // head_dim, head_dim)

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
            if drop_key is not None:
                attn = dropout(attn, self.dropout_rate, drop_key)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = out.reshape(*out.shape[:-2], out.shape[-2] * head_dim)
        return self.o_proj(out)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: x + attn(ln(x)), then x + mlp(ln(x)); ``name``
    is its flax scope (``layer_i``), which keys its dropout masks."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 lora_rank: int = 0, dtype: torch.dtype = torch.float32,
                 attention_fn: AttentionFn | None = None, dropout_rate: float = 0.0,
                 name: str = "layer_0"):
        super().__init__()
        self.name, self.dropout_rate = name, dropout_rate
        self.ln_attn = LayerNorm(d_model)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, lora_rank, dtype,
                                           attention_fn, dropout_rate)
        self.ln_mlp = LayerNorm(d_model)
        self.ff_in = LoraDense(d_model, d_ff, lora_rank, dtype=dtype)
        self.ff_out = LoraDense(d_ff, d_model, lora_rank, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                rng: torch.Tensor | None = None) -> torch.Tensor:
        """``rng``: the model's dropout key on a train call with dropout,
        else None (no dropout)."""
        def key(*path):
            return dropout_key(rng, (self.name, *path))

        # the dense core drops attention probabilities; an attention_fn does not
        attn_key = (key("attn", "Dropout_0")
                    if rng is not None and self.attn.attention_fn is None else None)
        h = self.attn(self.ln_attn(x), pad_mask, attn_key)
        if rng is not None:
            h = dropout(h, self.dropout_rate, key("Dropout_0"))
        x = x + h
        h = self.ff_out(F.gelu(self.ff_in(self.ln_mlp(x)), approximate="tanh"))
        if rng is not None:
            h = dropout(h, self.dropout_rate, key("Dropout_1"))
        return x + h


class TransformerClassifier(nn.Module):
    """Encoder + mean-pool + classifier head. Input: token ids ``[B, T]``,
    id 0 is PAD (the pad mask is ``x > 0``). Returns
    ``({"prediction": logits f32}, {"features": pooled})``."""

    def __init__(self, vocab_size: int, n_classes: int, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256,
                 max_len: int = 128, lora_rank: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: AttentionFn | None = None,
                 remat: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.n_layers, self.remat, self.dropout_rate = n_layers, remat, dropout_rate
        self.tok_embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.dtype = dtype
        for i in range(n_layers):
            setattr(self, f"layer_{i}", EncoderBlock(
                d_model, n_heads, d_ff, lora_rank, dtype, attention_fn, dropout_rate,
                name=f"layer_{i}"))
        self.ln_final = LayerNorm(d_model)
        self.classifier = LoraDense(d_model, n_classes, dtype=None)  # flax nn.Dense
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

    def forward(self, x: torch.Tensor, train: bool = True,
                rng: torch.Tensor | None = None):
        """``rng``: the dropout key (flax's ``rngs["dropout"]``); dropout
        runs on train calls that have one."""
        pad_mask = (x > 0).to(torch.float32)
        drop_rng = rng if train and self.dropout_rate > 0 else None
        if self.dropout_rate > 0 and train and rng is None:
            raise ValueError("dropout on a train call needs the model's rng")
        h = (self.tok_embed(x) + self.pos_embed[None, : x.shape[1]]).to(self.dtype)
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                # recompute the block on the backward pass: one layer's
                # activations live at a time (flax nn.remat). The block's
                # current tensors go in as arguments, so the recompute uses
                # the params (and the dropout key) the forward used, also
                # under functional_call
                names, tensors = zip(*block.named_parameters())
                h = _Remat.apply(block, names, h, pad_mask, drop_rng, *tensors)
            else:
                h = block(h, pad_mask, drop_rng)
        h = self.ln_final(h.float())
        denom = torch.clamp(pad_mask.sum(dim=1, keepdim=True), min=1.0)
        pooled = (h * pad_mask[..., None]).sum(dim=1) / denom
        logits = self.classifier(pooled)
        return {"prediction": logits.float()}, {"features": pooled}


def _call_block(block, names, h, pad_mask, rng, *tensors):
    return functional_call(block, dict(zip(names, tensors)), (h, pad_mask, rng))


class _Remat(torch.autograd.Function):
    """flax ``nn.remat`` of one encoder block. The forward runs the block
    without keeping its activations and saves only its inputs: ``h``, the
    pad mask and the block's params. The backward recomputes the block under
    ``torch.func.vjp`` and pulls the cotangent through it.
    (``torch.utils.checkpoint``'s saved-tensor hooks raise under
    ``torch.func.grad``.) The vmap rule is generated: under the client vmap
    both passes run batched, and the attention Functions inside them reach
    their own rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, names, h, pad_mask, rng, *tensors):
        with torch.no_grad():
            return _call_block(block, names, h, pad_mask, rng, *tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, names, h, pad_mask, rng, *tensors = inputs
        ctx.block, ctx.names = block, names
        ctx.save_for_backward(h, pad_mask, rng, *tensors)

    @staticmethod
    def backward(ctx, dout):
        h, pad_mask, rng, *tensors = ctx.saved_tensors

        def block_fn(h, *tensors):
            return _call_block(ctx.block, ctx.names, h, pad_mask, rng, *tensors)

        # torch.func.grad differentiates with create_graph=True: a graph
        # recorded here would keep this block's recomputed activations alive
        # to the end of the backward, every block's at once. Under no_grad
        # the vjp still runs (its own transform level) and records nothing.
        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(block_fn, h, *tensors)
            dh, *dtensors = vjp_fn(dout)
        return (None, None, dh, None, None, *dtensors)


def param_dict(module: nn.Module) -> Params:
    """The module's parameters, detached, keyed by flax path."""
    return {name.replace(".", "/"): p.detach().clone()
            for name, p in module.named_parameters()}
