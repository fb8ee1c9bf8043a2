"""Example CNNs and small dense models (counterpart of
``fl4health_tpu/models/cnn.py``): ``MnistNet``, ``CifarNet``, ``Mlp`` and
``LogisticRegression``.

Parameters carry the flax names (``Conv_0/kernel``, ``Dense_1/bias``, ...) and
the flax layouts: conv kernels HWIO ``[kh, kw, in, out]``, Dense kernels
``[in, out]``, so ``models/convert.py`` needs no transposes. Inputs are NHWC
as in the JAX package; ``forward`` permutes to NCHW once for ``F.conv2d``
(OIHW kernels, a permuted view) and back to NHWC before the flatten, so the
first Dense sees the flax HWC feature order. flax ``SAME`` padding of an odd
kernel is ``kernel // 2`` on each side; ``nn.max_pool`` 2x2 is VALID.

flax infers a Dense's input width at init; here the models take the input
shape (or width) at construction. The JAX ``MxuConv``/``conv_impl`` switch
(an im2col lowering for XLA's sharded grouped-conv partitioner) has no
counterpart: cuDNN runs the plain convolution.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.transformer import LoraDense, _lecun_normal, param_dict


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding and stride 1 on NCHW activations:
    ``kernel`` HWIO, ``bias`` [out]; computes in ``dtype`` (input, kernel and
    bias cast to it, as flax's ``dtype`` does)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding is symmetric only for odd kernels")
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size,
                                               in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(self.kernel.shape, generator,
                                            self.kernel.device))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(x.to(self.dtype), w, self.bias.to(self.dtype),
                        padding=self.kernel.shape[0] // 2)


def _init_params(module: nn.Module, generator: torch.Generator) -> Params:
    for mod in module.modules():
        if mod is not module and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return param_dict(module)


def _conv_block(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(F.relu(conv(x)), 2)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [N, H*W*C] in the flax (NHWC) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _ConvNet(nn.Module):
    """Two conv(5x5, SAME) + relu + 2x2 max-pool blocks, then a relu Dense
    and the classifier Dense."""

    def __init__(self, channels: tuple[int, int], hidden: int, n_classes: int,
                 input_shape: tuple[int, int, int], dtype: torch.dtype):
        super().__init__()
        h, w, c = input_shape
        self.dtype = dtype
        self.Conv_0 = Conv(c, channels[0], 5, dtype)
        self.Conv_1 = Conv(channels[0], channels[1], 5, dtype)
        self.Dense_0 = LoraDense((h // 4) * (w // 4) * channels[1], hidden, dtype=dtype)
        self.Dense_1 = LoraDense(hidden, n_classes, dtype=dtype)
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        """Fresh params drawn from ``generator``, keyed by flax path."""
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = _conv_block(self.Conv_1, _conv_block(self.Conv_0, x))
        features = F.relu(self.Dense_0(_flatten_hwc(x)))
        return {"prediction": self.Dense_1(features).float()}, {"features": features}


class MnistNet(_ConvNet):
    """Small MNIST CNN: conv 16 and conv 32 blocks, Dense ``hidden``, Dense
    ``n_classes``; f32. ``input_shape`` is one example's HWC shape."""

    def __init__(self, n_classes: int = 10, hidden: int = 120,
                 input_shape: tuple[int, int, int] = (28, 28, 1)):
        super().__init__((16, 32), hidden, n_classes, input_shape, torch.float32)


class CifarNet(_ConvNet):
    """CIFAR-10 CNN: conv 32 and conv 64 blocks, Dense 128, Dense
    ``n_classes``. ``dtype`` is the compute dtype (params stay f32; logits
    come out f32)."""

    def __init__(self, n_classes: int = 10, dtype: torch.dtype = torch.float32,
                 input_shape: tuple[int, int, int] = (32, 32, 3)):
        super().__init__((32, 64), 128, n_classes, input_shape, dtype)


class Mlp(nn.Module):
    """Generic MLP: flatten, relu Dense per entry of ``features``, then the
    output Dense. ``in_features`` is one example's flattened width."""

    def __init__(self, in_features: int, features: Sequence[int] = (64, 32),
                 n_outputs: int = 2):
        super().__init__()
        widths = [in_features, *features]
        self.n_hidden = len(features)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", LoraDense(a, b))
        setattr(self, f"Dense_{self.n_hidden}", LoraDense(widths[-1], n_outputs))
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{self.n_hidden}")(x)
        return {"prediction": logits}, {"features": x}


class LogisticRegression(nn.Module):
    """One Dense over the flattened input."""

    def __init__(self, in_features: int, n_outputs: int = 2):
        super().__init__()
        self.Dense_0 = LoraDense(in_features, n_outputs)
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        return {"prediction": self.Dense_0(x.reshape(x.shape[0], -1))}, {}
