"""Plain-conv U-Net with deep supervision (counterpart of
``fl4health_tpu/models/unet.py``), for 2-D and 3-D data.

The model keeps the JAX package's contract at its edges: the input is
channels-last ``[B, *spatial, C]``, and the output is a dict
``{"prediction", "ds_1", ...}`` of channels-last logits, so the
segmentation losses read it as they read the flax model's. Inside, the
activations are channels-first (``[B, C, *spatial]``) for cuDNN, permuted
once on the way in and once a head on the way out.

Params carry the flax names and layouts (``StackedConvs_0/ConvBlock_0/
Conv_0/kernel`` ``[*k, in, out]``, ``InstanceNorm_0/scale``,
``ConvTranspose_0/kernel`` ``[*k, in, out]``, the heads ``Conv_i``), so
``models/convert.py`` converts them by flattening; the forward permutes a
kernel to torch's layout, and flips a transposed convolution's kernel
(``convert.conv_transpose_weight``): flax applies it unflipped.

- A convolution pads as flax's ``SAME``: ``(out - 1) * stride + k - in`` in
  all, the smaller half before. A stride-2, 3-tap convolution on an even
  extent pads ``(0, 1)``, where ``padding=1`` would pad ``(1, 1)`` and move
  every window by a voxel; so the pad is explicit and the convolution
  pads nothing.
- Instance norm is flax's ``InstanceNorm(epsilon=1e-5)``, written from
  tensor ops: the statistics in f32, the variance the fast way,
  ``max(E[x^2] - E[x]^2, 0)``, then ``(x - mean) * (scale * rsqrt(var +
  eps)) + bias``.
- Under the client vmap every convolution has its client's weights, which
  ``torch.func.vmap`` runs as one grouped convolution over the clients.

``conv_impl`` is accepted for the JAX signature; only ``"lax"`` (the plain
convolution) exists here: the JAX package's ``"mxu"`` im2col lowering is
there for XLA's partitioner, and cuDNN runs the plain convolution.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.convert import conv_transpose_weight, conv_weight
from fl4health_tpu_torch.models.transformer import _lecun_normal
from fl4health_tpu_torch.precision.policy import conv_compute_dtype

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def same_pads(spatial: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> list[int]:
    """flax ``SAME`` padding in ``F.pad``'s order (last axis first): a total
    of ``(ceil(in / s) - 1) * s + k - in`` an axis, ``total // 2`` before."""
    pads: list[int] = []
    for size, k, s in zip(reversed(spatial), reversed(kernel), reversed(strides)):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Conv(nn.Module):
    """flax ``nn.Conv`` (``SAME``, a stride) on channels-first
    activations; ``kernel`` ``[*k, in, out]``, ``bias`` ``[out]``."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] | None = None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides) if strides else (1,) * len(kernel_size)
        self.kernel = nn.Parameter(torch.empty(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(self.kernel.shape, generator, self.kernel.device))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = conv_compute_dtype(x.dtype, self.kernel.dtype, self.bias.dtype)
        x = x.to(dtype)
        pads = same_pads(x.shape[2:], self.kernel_size, self.strides)
        if any(pads):
            x = F.pad(x, pads)
        return _CONV[len(self.kernel_size)](x, conv_weight(self.kernel).to(dtype),
                                            self.bias.to(dtype), stride=self.strides)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with ``VALID`` padding and kernel = stride
    (the U-Net's upsampling), on channels-first activations."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int]):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.kernel = nn.Parameter(torch.empty(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(self.kernel.shape, generator, self.kernel.device))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = conv_compute_dtype(x.dtype, self.kernel.dtype, self.bias.dtype)
        return _CONV_T[len(self.kernel_size)](
            x.to(dtype), conv_transpose_weight(self.kernel).to(dtype), self.bias.to(dtype),
            stride=self.kernel_size)


class InstanceNorm(nn.Module):
    """flax ``nn.InstanceNorm(epsilon=1e-5)`` over the spatial axes of
    channels-first activations, with a learnable ``scale`` and ``bias``."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(2, x.ndim))
        xf = x.float()
        mean = xf.mean(dims, keepdim=True)
        mean2 = (xf * xf).mean(dims, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (-1,) + (1,) * len(dims)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(shape)
        out = (xf - mean) * mul + self.bias.view(shape)
        return out.to(torch.promote_types(x.dtype, self.scale.dtype))


class ConvBlock(nn.Module):
    """Conv -> InstanceNorm -> LeakyReLU(0.01), the nnU-Net basic block."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] | None = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel_size, strides)
        self.InstanceNorm_0 = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.InstanceNorm_0(self.Conv_0(x)), negative_slope=0.01)


class StackedConvs(nn.Module):
    """``n_convs`` ConvBlocks, the first with ``first_stride``."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 n_convs: int, first_stride: Sequence[int] | None = None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            setattr(self, f"ConvBlock_{i}", ConvBlock(
                in_features if i == 0 else features, features, kernel_size,
                strides=first_stride if i == 0 else None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"ConvBlock_{i}")(x)
        return x


class PlainConvUNet(nn.Module):
    """N-dimensional U-Net assembled from plan numbers, as flax's: an
    encoder stage a ``features_per_stage`` entry (stage 0 at full
    resolution, each later one strided by ``strides[s]``), a decoder that
    upsamples by a transposed convolution, concatenates the skip and runs
    a conv stack, and a 1x1 head at every decoder scale (only the last
    without deep supervision). ``in_channels`` is given at construction
    (flax infers it at init)."""

    def __init__(self, in_channels: int, features_per_stage: Sequence[int],
                 strides: Sequence[Sequence[int]], kernel_sizes: Sequence[Sequence[int]],
                 n_classes: int, n_conv_per_stage: int = 2, deep_supervision: bool = True,
                 conv_impl: str = "lax"):
        super().__init__()
        if conv_impl != "lax":
            raise ValueError(f"conv_impl={conv_impl!r}: the port runs the plain convolution "
                             "only (conv_impl='lax')")
        self.features = [int(f) for f in features_per_stage]
        self.strides = [tuple(int(v) for v in s) for s in strides]
        self.ndim = len(kernel_sizes[0])
        self.deep_supervision = deep_supervision
        n = len(self.features)
        self.n_stages = n
        # flax numbers submodules of a class in creation order: the encoder's
        # stacks, then the decoder's (its transposed convs and heads beside)
        for s in range(n):
            setattr(self, f"StackedConvs_{s}", StackedConvs(
                in_channels if s == 0 else self.features[s - 1], self.features[s],
                kernel_sizes[s], n_conv_per_stage,
                first_stride=self.strides[s] if s > 0 else None))
        heads = 0
        for i, s in enumerate(range(n - 2, -1, -1)):
            setattr(self, f"ConvTranspose_{i}", ConvTranspose(
                self.features[s + 1], self.features[s], self.strides[s + 1]))
            setattr(self, f"StackedConvs_{n + i}", StackedConvs(
                2 * self.features[s], self.features[s], kernel_sizes[s], n_conv_per_stage))
            if deep_supervision or s == 0:
                setattr(self, f"Conv_{heads}", Conv(self.features[s], n_classes,
                                                    (1,) * self.ndim))
                heads += 1
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        """Fresh params drawn from ``generator``, keyed by flax path."""
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        if x.ndim != self.ndim + 2:
            raise ValueError(f"expected [B, *spatial({self.ndim}), C] input, got shape "
                             f"{tuple(x.shape)}")
        to_last = (0, *range(2, self.ndim + 2), 1)
        x = x.permute(0, self.ndim + 1, *range(1, self.ndim + 1))
        n = self.n_stages
        skips = []
        for s in range(n):
            x = getattr(self, f"StackedConvs_{s}")(x)
            skips.append(x)
        heads = []
        for i, s in enumerate(range(n - 2, -1, -1)):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = torch.cat([x, skips[s]], dim=1)
            x = getattr(self, f"StackedConvs_{n + i}")(x)
            if self.deep_supervision or s == 0:
                heads.append(getattr(self, f"Conv_{len(heads)}")(x).permute(to_last))
        preds = {"prediction": heads[-1]}
        if self.deep_supervision:
            for i, logits in enumerate(reversed(heads[:-1]), start=1):
                preds[f"ds_{i}"] = logits
        return preds, {}


def unet_from_plans(plans: dict[str, Any], num_input_channels: int, num_classes: int,
                    configuration: str | None = None, deep_supervision: bool = True,
                    conv_impl: str = "lax") -> PlainConvUNet:
    """The network a plans dict describes (``build_network_architecture``);
    ``num_input_channels`` sizes the first convolution."""
    if configuration is None:
        from fl4health_tpu_torch.nnunet.plans import default_configuration

        configuration = default_configuration(plans)
    cfg = plans["configurations"][configuration]
    return PlainConvUNet(
        in_channels=int(num_input_channels),
        features_per_stage=tuple(cfg["features_per_stage"]),
        strides=tuple(tuple(s) for s in cfg["strides"]),
        kernel_sizes=tuple(tuple(k) for k in cfg["kernel_sizes"]),
        n_classes=num_classes,
        n_conv_per_stage=int(cfg.get("n_conv_per_stage", 2)),
        deep_supervision=deep_supervision,
        conv_impl=conv_impl,
    )


def deep_supervision_strides(plans: dict[str, Any], configuration: str | None = None):
    """Cumulative per-axis downsampling factor of each deep-supervision
    output, in the prediction dict's order: index 0 is ``"ds_1"`` (half the
    scale of ``"prediction"``), and so on; the bottleneck has no head."""
    if configuration is None:
        from fl4health_tpu_torch.nnunet.plans import default_configuration

        configuration = default_configuration(plans)
    strides = plans["configurations"][configuration]["strides"]
    cumulative = []
    running = [1] * len(strides[0])
    for s in strides[1:]:
        running = [r * si for r, si in zip(running, s)]
        cumulative.append(tuple(running))
    return cumulative[:-1]
