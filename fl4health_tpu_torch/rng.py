"""The threefry2x32 random stream of ``jax.random``, as torch integer ops
(the JAX package draws every key, mask and noise sample from it).

A key is a ``[2]`` int64 tensor holding two unsigned 32-bit words, the
``key_data`` of JAX's default threefry key; ``split`` gives ``[n, 2]``. Every
function runs on the device its key lives on, so a key on the card draws on
the card. The draws equal JAX's bit for bit (``split``, ``fold_in``,
``bits``, ``uniform``, ``bernoulli``, ``rademacher``, ``permutation``)
under JAX's default
``jax_threefry_partitionable=True``: the counter of element ``i`` is the
hi/lo word pair of the flat index ``i``, and a 32-bit draw is the XOR of the
hash's two output words. XLA contracts a multiply and an add into one fused
multiply-add (``uniform``'s scale and shift, each Horner step of
``erf_inv``); ``_fma`` does the same in f64, where the product of two f32 is
exact. ``normal`` applies XLA's single-precision ``erf_inv`` polynomial and
agrees with JAX to about 2 ulp: ``log1p`` may round differently in the two
libraries, and ``gumbel`` by as much through ``log``; ``categorical`` (an
argmax over Gumbel noise plus logits) gives JAX's indices.

Every function is pure tensor code on the key, with no host copy and no
branch on a tensor's value, so it runs under ``torch.func.vmap(...,
randomness="error")`` over a ``[K, 2]`` stack of keys and equals the
per-key loop bit for bit.

32-bit words are held in int64 tensors and masked to 32 bits after each add
and shift: CUDA builds of torch lack shifts and adds on ``torch.uint32``.
Sources: ``jax/_src/prng.py`` (``threefry_2x32``, ``_threefry_split``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``, ``_shuffle``,
``_normal_real``, ``_gumbel``, ``categorical``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)
# XLA's ErfInv32: Giles' polynomial, split at w = -log1p(-x^2) < 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)

Shape = int | Sequence[int]


def _shape(shape: Shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of f32 values (tensors, or python floats that are f32
    values), rounded once to f32 as a fused multiply-add rounds it: the f64
    product is exact, and the f64 sum rounds twice only where it falls on an
    f32 tie."""
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    return (f64(a) * f64(b) + f64(c)).float()


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under key
    words (k0, k1); every argument holds 32-bit words in int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]):
    """The hash's two output words over the counters 0..prod(shape)-1, each
    split into its hi and lo 32-bit words (JAX's ``iota_2x32_shape``)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    w0, w1 = _threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return w0.reshape(shape), w1.reshape(shape)


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under 32-bit JAX: ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The key's two 32-bit words (a key is its data here)."""
    return key


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``[*num, 2]`` new keys."""
    w0, w1 = _hash_iota(key, _shape(num))
    return torch.stack([w0, w1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` for ``0 <= data < 2**32``: the hash of the
    counter words ``(0, data)``."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    x0 = torch.zeros((), dtype=torch.int64, device=key.device)
    w0, w1 = _threefry2x32(key[0], key[1], x0, x0 + data)
    return torch.stack([w0, w1])


def fold_in_many(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(lambda d: jax.random.fold_in(key, d))(data)``: one key a
    value of the integer tensor ``data`` (each in ``[0, 2**32)``), as
    ``[*data.shape, 2]``, in one pass of the hash."""
    data = data.to(device=key.device, dtype=torch.int64) & _MASK
    w0, w1 = _threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([w0, w1], dim=-1)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uniform 32-bit words, held in int64."""
    w0, w1 = _hash_iota(key, _shape(shape))
    return w0 ^ w1


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 on ``[minval, maxval)``: the top 23 bits
    as the mantissa of a float in [1, 2), less 1, scaled and shifted with one
    rounding."""
    shape = _shape(shape)
    # JAX ors the top 23 bits into the mantissa of 1.0 and subtracts 1: that
    # is m * 2^-23 exactly, which the conversion of m (< 2^23) gives too
    # (and without a dtype view, which older torch cannot vmap)
    floats = (bits(key, shape) >> 9).to(torch.float32) * 2.0 ** -23
    # the bounds as f32 values, their difference rounded in f32; python
    # scalars, so nothing is copied to the device
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(_fma(floats, float(hi - lo), float(lo)), min=float(lo))


def bernoulli(key: torch.Tensor, p: float | torch.Tensor = 0.5,
              shape: Shape | None = None) -> torch.Tensor:
    """``jax.random.bernoulli`` (its default ``mode="low"``) for an f32
    ``p``: ``uniform(key, shape) < p``, ``shape`` defaulting to ``p``'s; a
    bool tensor. A python ``p`` is compared as the f32 value JAX converts it
    to."""
    if shape is None:
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
    if not isinstance(p, torch.Tensor):
        p = float(np.float32(p))
    return uniform(key, shape) < p


def rademacher(key: torch.Tensor, shape: Shape = (),
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.rademacher``: ``2 * bernoulli(key, 0.5, shape) - 1``
    in ``dtype`` (int32 by default, as 32-bit JAX's ``int``)."""
    return (2 * bernoulli(key, 0.5, shape).to(dtype) - 1).to(dtype)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 on ``[minval, maxval)``: JAX's two
    draws of 32 bits (from ``split(key)``), each taken modulo the span and
    joined as ``hi * m + lo`` with ``m = (2^16 mod span)^2 mod span``, every
    product and sum in wrapping uint32 arithmetic as JAX's, then modulo the
    span again. A span of 0 or less returns ``minval``."""
    shape = _shape(shape)
    lo_val, hi_val = int(minval), int(maxval)
    for v in (lo_val, hi_val):
        if not -2**31 <= v <= 2**31 - 1:
            raise OverflowError(f"randint bound {v} is out of int32's range")
    span = (hi_val - lo_val) & _MASK if hi_val > lo_val else 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span  # a uint32 product wraps
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    offset = ((higher % span) * multiplier & _MASK) + lower % span
    return (lo_val + (offset & _MASK) % span).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, its default (low) mode:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: Shape | None = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)`` with
    replacement: the argmax over the last axis of Gumbel noise of shape
    ``(*shape, n_categories)`` plus the logits, broadcast over the leading
    axes that ``shape`` adds; int32 indices (the first of equal maxima, as
    both argmaxes take)."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else _shape(shape)
    if tuple(shape[len(shape) - len(batch):]) != batch:
        raise ValueError(f"categorical shape {shape} must end in the logits' "
                         f"batch shape {batch}")
    noise = gumbel(key, (*shape, logits.shape[-1]))
    return torch.argmax(noise + logits.float(), dim=-1).to(torch.int32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (``lax.erf_inv``), evaluated in f32."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    # scalar coefficients select into f32 tensors: no copy to the device
    coef = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])  # noqa: E731
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)
    return erf_inv(u) * float(np.float32(math.sqrt(2.0)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: JAX's sort-based shuffle of
    ``arange(n)``, each round a ``split`` and a stable sort on fresh 32-bit
    keys; int64 on the key's device."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.sort(bits(subkey, (n,)), stable=True).indices
        x = x[order]
    return x
