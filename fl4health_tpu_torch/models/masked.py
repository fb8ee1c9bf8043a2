"""Masked layers for FedPM (counterpart of ``fl4health_tpu/models/masked.py``).

The layer's weight and bias are FROZEN and live in the model state's
``frozen`` collection (``TrainState.model_state``, never touched by the
optimizer); the trainable params are the ``<name>_scores`` tensors (flax
names: ``MaskedDense_0/kernel_scores``). A forward turns the scores into
probabilities ``sigmoid(scores)``, draws a binary mask and applies
``mask * weight``; the gradient reaches the scores through the
straight-through estimator (:func:`bernoulli_ste`: backward ``probs * g``).

Keys, as flax derives them: on train calls the model's ``rng`` (the step
key) gives the ``mask`` stream ``fold_in(rng, 1)`` (JAX's ``from_flax``),
and each ``make_rng("mask")`` of a layer at scope ``path`` folds in the
SHA-1 word of ``(*path, counter)`` (``transformer.flax_scope_hash``, the
dropout keys' derivation): counter 1 for the kernel's mask, 2 for the
bias's. Without a key (eval) a layer applies the expectation ``probs``.

Layouts are flax's: Dense kernels ``[in, out]``, conv kernels ``[*k, in,
out]`` (1-D to 3-D, SAME or VALID padding, channel-last activations),
transposed convolutions as ``lax.conv_transpose`` with an unflipped kernel.
``MaskedLayerNorm`` and ``MaskedBatchNorm`` take the variance as
``jnp.var`` does (two passes); ``MaskedBatchNorm`` decays its running
statistics by 0.9 (the reference's torch momentum 0.1).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fl4health_tpu_torch import rng as jrng
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.transformer import _lecun_normal, flax_scope_hash, param_dict


class _BernoulliSTE(torch.autograd.Function):
    """``u < probs`` as ``probs``' dtype; the gradient ``probs * g`` reaches
    ``probs`` straight through (none reaches ``u``)."""

    @staticmethod
    def forward(probs, u):
        return (u < probs).to(probs.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (probs,) = ctx.saved_tensors
        return probs * g, None

    @staticmethod
    def vmap(info, in_dims, probs, u):
        n = info.batch_size

        def front(t, d):
            return t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)

        return _BernoulliSTE.apply(front(probs, in_dims[0]), front(u, in_dims[1])), 0


def bernoulli_ste(probs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """A Bernoulli(``probs``) sample, ``uniform(key, probs.shape) < probs``
    (``jax.random.bernoulli``), with the straight-through gradient ``probs *
    g`` (the reference's ``BernoulliSample``)."""
    return _BernoulliSTE.apply(probs, jrng.uniform(key, tuple(probs.shape)))


def mask_key(mask_rng: torch.Tensor, path: tuple, counter: int) -> torch.Tensor:
    """The key of the ``counter``-th ``make_rng("mask")`` at scope ``path``."""
    return jrng.fold_in(mask_rng, flax_scope_hash((*path, counter)))


class _Masked(nn.Module):
    """Score params, frozen values and the mask draw shared by every masked
    layer. ``path`` is the layer's flax scope path (its parent sets it)."""

    path: tuple = ()

    def _score(self, name: str, shape) -> None:
        setattr(self, f"{name}_scores", nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's nn.initializers.normal(1.0)
        with torch.no_grad():
            for _, p in self.named_parameters(recurse=False):
                p.copy_(torch.empty(p.shape).normal_(0.0, 1.0, generator=generator))

    def _masked(self, name: str, value: torch.Tensor, mask_rng, counter: int) -> torch.Tensor:
        probs = torch.sigmoid(getattr(self, f"{name}_scores"))
        if mask_rng is None:  # the expectation (eval)
            return probs * value
        return bernoulli_ste(probs, mask_key(mask_rng, self.path, counter)) * value


class MaskedDense(_Masked):
    """Masked linear layer: frozen ``kernel`` ``[in, out]`` (lecun normal)
    and ``bias`` (zeros)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.in_features, self.features, self.use_bias = in_features, features, use_bias
        self._score("kernel", (in_features, features))
        if use_bias:
            self._score("bias", (features,))

    def init_frozen(self, generator: torch.Generator) -> dict:
        out = {"kernel": _lecun_normal((self.in_features, self.features), generator, "cpu")}
        if self.use_bias:
            out["bias"] = torch.zeros(self.features)
        return out

    def forward(self, x: torch.Tensor, frozen: dict, mask_rng=None) -> torch.Tensor:
        y = x @ self._masked("kernel", frozen["kernel"], mask_rng, 1)
        if self.use_bias:
            y = y + self._masked("bias", frozen["bias"], mask_rng, 2)
        return y


def _same_pads(sizes, ksize, strides) -> list[tuple[int, int]]:
    """``lax``'s SAME padding of a strided convolution, per spatial axis."""
    out = []
    for n, k, s in zip(sizes, ksize, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_spatial(x: torch.Tensor, pads) -> torch.Tensor:
    """Pad the spatial axes of a channel-first tensor (F.pad lists the last
    axis first)."""
    return F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _correlate(x: torch.Tensor, kernel: torch.Tensor, strides) -> torch.Tensor:
    """Channel-last ``x`` ``[N, *sp, in]`` correlated with a flax kernel
    ``[*k, in, out]`` (already padded), channel-last out."""
    nd = kernel.ndim - 2
    w = kernel.permute(nd + 1, nd, *range(nd))  # -> [out, in, *k]
    y = _CONV[nd](x.movedim(-1, 1), w, stride=tuple(strides))
    return y.movedim(1, -1)


class MaskedConv(_Masked):
    """Masked N-D convolution (``len(kernel_size)`` spatial axes): frozen
    ``kernel`` ``[*k, in, out]`` and ``bias``."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] | None = None, padding: str = "SAME",
                 use_bias: bool = True):
        super().__init__()
        self.ksize = tuple(kernel_size)
        self.strides = tuple(strides) if strides else (1,) * len(self.ksize)
        self.padding, self.use_bias = padding, use_bias
        self.in_features, self.features = in_features, features
        self._score("kernel", (*self.ksize, in_features, features))
        if use_bias:
            self._score("bias", (features,))

    def init_frozen(self, generator: torch.Generator) -> dict:
        out = {"kernel": _lecun_normal((*self.ksize, self.in_features, self.features),
                                       generator, "cpu")}
        if self.use_bias:
            out["bias"] = torch.zeros(self.features)
        return out

    def forward(self, x: torch.Tensor, frozen: dict, mask_rng=None) -> torch.Tensor:
        kernel = self._masked("kernel", frozen["kernel"], mask_rng, 1)
        if self.padding == "SAME":
            pads = _same_pads(x.shape[1:-1], self.ksize, self.strides)
            x = _pad_spatial(x.movedim(-1, 1), pads).movedim(1, -1)
        y = _correlate(x, kernel, self.strides)
        if self.use_bias:
            y = y + self._masked("bias", frozen["bias"], mask_rng, 2)
        return y


def _dilate(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """``s - 1`` zeros between the entries of ``x`` along ``axis``."""
    if s == 1:
        return x
    n = x.shape[axis]
    y = torch.stack([x] + [torch.zeros_like(x)] * (s - 1), dim=axis + 1)
    y = y.reshape(*x.shape[:axis], n * s, *x.shape[axis + 1:])
    return y.narrow(axis, 0, (n - 1) * s + 1)


def _transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """``lax.conv_transpose``'s padding of the dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


class MaskedConvTranspose(MaskedConv):
    """Masked N-D transposed convolution, ``lax.conv_transpose`` with an
    unflipped kernel: the input dilated by the strides, padded and
    correlated at stride 1."""

    def forward(self, x: torch.Tensor, frozen: dict, mask_rng=None) -> torch.Tensor:
        kernel = self._masked("kernel", frozen["kernel"], mask_rng, 1)
        for i, s in enumerate(self.strides):
            x = _dilate(x, 1 + i, s)
        pads = [_transpose_pads(k, s, self.padding) for k, s in zip(self.ksize, self.strides)]
        x = _pad_spatial(x.movedim(-1, 1), pads).movedim(1, -1)
        y = _correlate(x, kernel, (1,) * len(self.ksize))
        if self.use_bias:
            y = y + self._masked("bias", frozen["bias"], mask_rng, 2)
        return y


class MaskedLayerNorm(_Masked):
    """Layer norm over the last axis with a masked frozen affine (``scale``
    ones, ``bias`` zeros), epsilon 1e-6."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.features, self.epsilon = features, epsilon
        self._score("scale", (features,))
        self._score("bias", (features,))

    def init_frozen(self, generator: torch.Generator) -> dict:
        return {"scale": torch.ones(self.features), "bias": torch.zeros(self.features)}

    def forward(self, x: torch.Tensor, frozen: dict, mask_rng=None) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return (y * self._masked("scale", frozen["scale"], mask_rng, 1)
                + self._masked("bias", frozen["bias"], mask_rng, 2))


class MaskedBatchNorm(_Masked):
    """Batch norm with a masked frozen affine; its running statistics are
    the ``batch_stats`` collection (``mean`` zeros, ``var`` ones), decayed
    by ``momentum`` 0.9 where the batch's statistics are used."""

    keeps_batch_stats = True

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.features, self.momentum, self.epsilon = features, momentum, epsilon
        self._score("scale", (features,))
        self._score("bias", (features,))

    def init_frozen(self, generator: torch.Generator) -> dict:
        return {"scale": torch.ones(self.features), "bias": torch.zeros(self.features)}

    def init_stats(self) -> dict:
        return {"mean": torch.zeros(self.features), "var": torch.ones(self.features)}

    def forward(self, x: torch.Tensor, frozen: dict, stats: dict, mask_rng=None,
                use_running_average: bool = False):
        """-> (y, new_stats)."""
        if use_running_average:
            mean, var, new = stats["mean"], stats["var"], stats
        else:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = ((x - mean) ** 2).mean(dim=axes)
            m = self.momentum
            new = {"mean": m * stats["mean"] + (1 - m) * mean,
                   "var": m * stats["var"] + (1 - m) * var}
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return (y * self._masked("scale", frozen["scale"], mask_rng, 1)
                + self._masked("bias", frozen["bias"], mask_rng, 2)), new


# ---------------------------------------------------------------------------
# Ready-made masked architectures and the dense-weight transplant
# ---------------------------------------------------------------------------

class _MaskedModel(nn.Module):
    """A model of masked layers: params are the scores, the model state
    ``{"frozen": {<layer>: ...}}``; ``forward(x, train, rng, state)`` draws
    the masks from ``fold_in(rng, 1)`` on train calls with a key."""

    def _name(self, layer: _Masked, name: str) -> _Masked:
        layer.path = (name,)
        setattr(self, name, layer)
        return layer

    def init_params(self, generator: torch.Generator) -> Params:
        for mod in self.modules():
            if isinstance(mod, _Masked):
                mod.reset_parameters(generator)
        return param_dict(self)

    def init_state(self, generator: torch.Generator) -> dict:
        """The frozen values, drawn from ``generator`` after the params (not
        flax's init: tests install converted flax state)."""
        return {"frozen": {name: mod.init_frozen(generator)
                           for name, mod in self.named_children() if isinstance(mod, _Masked)}}

    @staticmethod
    def _mask_rng(train: bool, rng):
        return jrng.fold_in(rng, 1) if train and rng is not None else None


class MaskedMlp(_MaskedModel):
    """The masked counterpart of ``models.cnn.Mlp``: flatten, a relu
    ``MaskedDense`` per entry of ``features``, the output ``MaskedDense``.
    ``in_features`` is one example's flattened width."""

    def __init__(self, in_features: int, features: Sequence[int] = (64, 32),
                 n_outputs: int = 2):
        super().__init__()
        widths = [in_features, *features, n_outputs]
        self.n_layers = len(widths) - 1
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            self._name(MaskedDense(a, b), f"MaskedDense_{i}")

    def forward(self, x: torch.Tensor, train: bool = True, rng=None, state=None):
        frozen, mask_rng = state["frozen"], self._mask_rng(train, rng)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers - 1):
            name = f"MaskedDense_{i}"
            x = F.relu(getattr(self, name)(x, frozen[name], mask_rng))
        name = f"MaskedDense_{self.n_layers - 1}"
        logits = getattr(self, name)(x, frozen[name], mask_rng)
        return ({"prediction": logits}, {"features": x}), state


class MaskedCnn(_MaskedModel):
    """A small masked conv net: per entry of ``channels`` a relu 3x3
    ``MaskedConv`` and a 2x2 max-pool, then the output ``MaskedDense``.
    ``input_shape`` is one example's HWC shape."""

    def __init__(self, channels: Sequence[int] = (8, 16), n_outputs: int = 10,
                 input_shape: tuple[int, int, int] = (28, 28, 1)):
        super().__init__()
        h, w, c = input_shape
        for i, ch in enumerate(channels):
            self._name(MaskedConv(c, ch, (3, 3)), f"MaskedConv_{i}")
            c, h, w = ch, h // 2, w // 2
        self.n_convs = len(channels)
        self._name(MaskedDense(h * w * c, n_outputs), "MaskedDense_0")

    def forward(self, x: torch.Tensor, train: bool = True, rng=None, state=None):
        frozen, mask_rng = state["frozen"], self._mask_rng(train, rng)
        for i in range(self.n_convs):
            name = f"MaskedConv_{i}"
            x = F.relu(getattr(self, name)(x, frozen[name], mask_rng))
            x = F.max_pool2d(x.movedim(-1, 1), 2).movedim(1, -1)
        x = x.reshape(x.shape[0], -1)
        logits = self.MaskedDense_0(x, frozen["MaskedDense_0"], mask_rng)
        return ({"prediction": logits}, {"features": x}), state


def _normalized(path: Sequence[str]) -> tuple:
    """flax module-class prefixes stripped: ``Name_3`` segments become
    ``3``, so ``Dense_0/kernel`` and ``MaskedDense_0/kernel`` coincide."""
    out = []
    for seg in path:
        head, _, tail = str(seg).rpartition("_")
        out.append(tail if head and tail.isdigit() else str(seg))
    return tuple(out)


def transplant_dense_weights(dense_params: Params, frozen: dict) -> dict:
    """A trained dense model's params (path-keyed) copied into a masked
    model's ``frozen`` collection (nested), matched by module index and
    parameter name with the class prefix stripped; a leaf is copied only
    where the shapes agree (the reference's ``from_pretrained``)."""
    flat = {_normalized(path.split("/")): leaf for path, leaf in dense_params.items()}

    def replace(node, prefix):
        if isinstance(node, dict):
            return {k: replace(v, (*prefix, k)) for k, v in node.items()}
        cand = flat.get(_normalized(prefix))
        return cand if cand is not None and tuple(cand.shape) == tuple(node.shape) else node

    return replace(frozen, ())
