"""Synthetic data (counterpart of ``fl4health_tpu/datasets/synthetic.py``;
``synthetic_text_classification`` and ``synthetic_classification``)."""

from __future__ import annotations

import torch


def synthetic_text_classification(
    generator: torch.Generator,
    n: int,
    vocab_size: int = 512,
    seq_len: int = 32,
    n_classes: int = 4,
    class_sep: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """AG-News-shaped token sequences: each class has its own token
    distribution (a softmax over the vocab at temperature ``class_sep``),
    sequences have ragged lengths in ``[seq_len // 2, seq_len]``, token 0 is
    PAD. Draws tokens by inverse CDF, as the JAX function does for large
    configs: the same distribution, not the same draws. Returns CPU int32
    tensors ``x [n, seq_len]`` and ``y [n]``."""
    class_logits = torch.randn((n_classes, vocab_size - 1),
                               generator=generator) * class_sep
    y = torch.randint(0, n_classes, (n,), generator=generator)
    cdf = torch.cumsum(torch.softmax(class_logits, dim=-1), dim=-1)
    u = torch.rand((n, seq_len), generator=generator)
    # an f32 cumsum can end slightly below 1.0; a u above cdf[-1] would index
    # one past the support — clamp to the last real token
    toks = torch.clamp(torch.searchsorted(cdf[y].contiguous(), u),
                       max=vocab_size - 2) + 1  # reserve 0 for PAD
    lengths = torch.randint(seq_len // 2, seq_len + 1, (n,), generator=generator)
    mask = torch.arange(seq_len)[None, :] < lengths[:, None]
    x = torch.where(mask, toks, torch.zeros_like(toks))
    return x.to(torch.int32), y.to(torch.int32)


def synthetic_classification(
    generator: torch.Generator,
    n: int,
    input_shape: tuple[int, ...],
    n_classes: int,
    class_sep: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian class blobs flattened into ``input_shape`` images: class means
    ``N(0, class_sep^2)`` per pixel, unit noise, then one global
    standardization (population std), as the JAX function draws them: the
    same distribution, not the same draws. Returns CPU ``x [n, *input_shape]``
    f32 and ``y [n]`` int32."""
    dim = 1
    for s in input_shape:
        dim *= s
    mus = torch.randn((n_classes, dim), generator=generator) * class_sep
    y = torch.randint(0, n_classes, (n,), generator=generator)
    x = mus[y] + torch.randn((n, dim), generator=generator)
    # standardize: separability is unchanged, conditioning is image-like
    x = (x - x.mean()) / torch.clamp(x.std(correction=0), min=1e-6)
    return x.reshape((n, *input_shape)).to(torch.float32), y.to(torch.int32)
