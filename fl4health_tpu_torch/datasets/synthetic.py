"""Synthetic data (counterpart of ``fl4health_tpu/datasets/synthetic.py``):
``synthetic_text_classification``, ``synthetic_classification``, FedProx's
heterogeneous generator ``fedprox_synthetic`` and the label-skew
``dirichlet_partition``.

The generators draw through ``rng.py`` from a threefry key, as the JAX
functions draw from theirs: the same key gives the same labels, token ids
and lengths, and features within ``normal``'s 2 ulp. The arrays live on the
key's device. ``fedprox_synthetic``'s labels are an argmax of logits summed
over 30-60 features, so a row whose two largest logits lie within that
rounding may take the other label (``tests/test_torch_utils.py`` counts
them). ``dirichlet_partition`` draws one integer from the key and then makes
JAX's numpy calls in JAX's order: the same parts bit for bit.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

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


def fedprox_synthetic(
    key: torch.Tensor,
    n_clients: int,
    samples_per_client: int,
    alpha: float = 0.5,
    beta: float = 0.5,
    dim: int = 60,
    n_classes: int = 10,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The FedProx paper's heterogeneous generator: client k's ``W_k ~ N(u_k,
    1)``, ``u_k ~ N(0, alpha)``; features ``x ~ N(v_k, Sigma)``, ``v_k ~
    N(B_k, 1)``, ``B_k ~ N(0, beta)``, ``Sigma = diag(j^-1.2)``; labels
    ``argmax(W x + b)``. Client k draws from ``fold_in(key, k)``. Returns
    f32 ``x [samples, dim]`` and int32 ``y`` a client."""
    device = key.device
    f32 = torch.float32
    sigma = torch.diag(torch.arange(1, dim + 1, dtype=f32, device=device) ** -1.2)
    sqrt_sigma = torch.sqrt(sigma)
    sqrt_alpha = torch.sqrt(torch.tensor(alpha, dtype=f32, device=device))
    sqrt_beta = torch.sqrt(torch.tensor(beta, dtype=f32, device=device))
    out = []
    for k in range(n_clients):
        rk = rng.fold_in(key, k)
        k1, k2, k3, k4, k5 = rng.split(rk, 5)
        u_k = rng.normal(k1, ()) * sqrt_alpha
        b_k = rng.normal(k2, ()) * sqrt_beta
        w = rng.normal(k3, (n_classes, dim)) + u_k
        bias = rng.normal(k4, (n_classes,)) + u_k
        v_k = rng.normal(k5, (dim,)) + b_k
        x = v_k + rng.normal(rng.fold_in(rk, 99), (samples_per_client, dim)) @ sqrt_sigma
        logits = x @ w.T + bias
        out.append((x, logits.argmax(dim=-1).to(torch.int32)))
    return out


def dirichlet_partition(
    key: torch.Tensor,
    x: Any,
    y: Any,
    n_partitions: int,
    beta: float,
    n_classes: int | None = None,
    min_examples: int = 1,
    max_retries: int = 5,
) -> list[tuple[Any, Any]]:
    """Dirichlet label skew: for each label draw ``p ~ Dir(beta 1_N)`` and
    deal that label's examples to the N partitions by ``p``; retry while a
    partition holds fewer than ``min_examples``. The numpy generator is
    seeded by one ``randint`` from ``key``, as in JAX. Rows are taken from
    ``x`` and ``y`` (tensors or arrays) in ascending index order."""
    y_np = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    n_classes = int(y_np.max()) + 1 if n_classes is None else n_classes
    seed = int(rng.randint(key, (), 0, 2**31 - 1))
    gen = np.random.default_rng(seed)
    for _attempt in range(max_retries):
        parts: list[list[int]] = [[] for _ in range(n_partitions)]
        for c in range(n_classes):
            idx = np.flatnonzero(y_np == c)
            gen.shuffle(idx)
            p = gen.dirichlet(np.full((n_partitions,), beta))
            splits = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for part, chunk in zip(parts, np.split(idx, splits)):
                part.extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_examples:
            break
    else:
        raise ValueError(
            f"Dirichlet partition failed to give every partition >= {min_examples} "
            f"examples in {max_retries} tries (beta={beta})")
    def take(a, sel):
        if isinstance(a, torch.Tensor):
            return a[torch.from_numpy(sel).to(a.device)]
        return np.asarray(a)[sel]

    sels = [np.sort(np.asarray(part, dtype=np.int64)) for part in parts]
    return [(take(x, sel), take(y, sel)) for sel in sels]
