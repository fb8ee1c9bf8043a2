"""Synthetic data (counterpart of ``fl4health_tpu/datasets/synthetic.py``;
``synthetic_text_classification`` and ``synthetic_classification``).

Both draw through ``rng.py`` from a threefry key, as the JAX functions draw
from theirs: the same key gives the same labels, token ids and lengths, and
images within ``normal``'s 2 ulp. The arrays live on the key's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fl4health_tpu_torch import rng


def _prefix_sums(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive prefix sums over the last axis in f32, associated as XLA
    associates ``jnp.cumsum``'s reduce-window (its rewrite into blocks of
    ``base``): sequential sums within each block, the blocks' totals summed
    the same way one level up and added on. ``torch.cumsum`` accumulates in
    f64 on the CPU, which moves an inverse-CDF token wherever a draw falls
    within the few ulps between the two sums."""
    def sequential(v):
        cols = [v[..., 0]]
        for k in range(1, v.shape[-1]):
            cols.append(cols[-1] + v[..., k])
        return torch.stack(cols, dim=-1)

    n = x.shape[-1]
    if n <= base:
        return sequential(x)
    m = -(-n // base)
    inner = sequential(F.pad(x, (0, m * base - n)).reshape(*x.shape[:-1], m, base))
    before = F.pad(_prefix_sums(inner[..., -1], base)[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], m * base)[..., :n]


def synthetic_text_classification(
    key: torch.Tensor,
    n: int,
    vocab_size: int = 512,
    seq_len: int = 32,
    n_classes: int = 4,
    class_sep: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """AG-News-shaped token sequences: each class has its own token
    distribution (a softmax over the vocab at temperature ``class_sep``),
    sequences have ragged lengths in ``[seq_len // 2, seq_len]``, token 0 is
    PAD. Up to ``2^28`` draws (``n * seq_len * vocab_size``) the tokens are
    ``categorical`` samples; above, where the Gumbel noise would not fit,
    the same distribution by inverse CDF, as the JAX function switches.
    Returns int32 ``x [n, seq_len]`` and ``y [n]``."""
    k_logits, k_y, k_tok, k_len = rng.split(key, 4)
    class_logits = rng.normal(k_logits, (n_classes, vocab_size - 1)) * class_sep
    y = rng.randint(k_y, (n,), 0, n_classes)
    if n * seq_len * vocab_size <= 1 << 28:
        toks = rng.categorical(k_tok, class_logits[y.long()], shape=(seq_len, n)).T
    else:
        cdf = _prefix_sums(torch.softmax(class_logits, dim=-1))
        u = rng.uniform(k_tok, (n, seq_len))
        # an f32 cumsum can end slightly below 1.0; a u above cdf[-1] would
        # index one past the support: clamp to the last real token
        toks = torch.clamp(torch.searchsorted(cdf[y.long()].contiguous(), u),
                           max=vocab_size - 2)
    toks = toks + 1  # reserve 0 for PAD
    lengths = rng.randint(k_len, (n,), seq_len // 2, seq_len + 1)
    mask = torch.arange(seq_len, device=key.device)[None, :] < lengths[:, None]
    x = torch.where(mask, toks, torch.zeros_like(toks))
    return x.to(torch.int32), y


def synthetic_classification(
    key: torch.Tensor,
    n: int,
    input_shape: tuple[int, ...],
    n_classes: int,
    class_sep: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian class blobs flattened into ``input_shape`` images: class means
    ``N(0, class_sep^2)`` per pixel, unit noise, then one global
    standardization (population std). Returns ``x [n, *input_shape]`` f32 and
    ``y [n]`` int32."""
    k_mu, k_x, k_y = rng.split(key, 3)
    dim = math.prod(input_shape)
    mus = rng.normal(k_mu, (n_classes, dim)) * class_sep
    y = rng.randint(k_y, (n,), 0, n_classes)
    x = mus[y.long()] + rng.normal(k_x, (n, dim))
    # standardize: separability is unchanged, conditioning is image-like
    x = (x - x.mean()) / torch.clamp(x.std(correction=0), min=1e-6)
    return x.reshape((n, *input_shape)), y
