"""The port's random stream (``fl4health_tpu_torch/rng.py``) against
``jax.random`` on the CPU: keys, ``split``, ``fold_in``, ``bits``,
``uniform``, ``randint``, ``permutation`` and ``categorical`` bit for bit,
``normal`` within rtol/atol 1e-6 over a million draws (XLA's ``log1p`` rounds
a few draws an ulp away) and ``gumbel`` within 5e-7 (two ``log``s)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import pytest
import torch

from fl4health_tpu_torch import rng

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(), (7,), (64,), (3, 5, 11), (1001,)]


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31, -1, -5, 2**32 + 5])
def test_key_data(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(rng.key_data(rng.PRNGKey(seed)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8, (2, 3)])
def test_split(seed, num):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(rng.split(tk, num).numpy(),
                                  np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 2001, 2**31, 2**32 - 1])
def test_fold_in(seed, data):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(rng.fold_in(tk, data).numpy(),
                                  np.asarray(jax.random.fold_in(jk, data)))


def test_fold_in_rejects_data_outside_uint32():
    with pytest.raises(OverflowError):
        rng.fold_in(rng.PRNGKey(0), -1)
    with pytest.raises(OverflowError):
        rng.fold_in(rng.PRNGKey(0), 2**32)


def test_chained_keys():
    # keys derived from derived keys, as the strategy and sim chain them
    jk, tk = _keys(3)
    jk, tk = jax.random.fold_in(jk, 2002), rng.fold_in(tk, 2002)
    jk, tk = jax.random.split(jk, 3)[1], rng.split(tk, 3)[1]
    np.testing.assert_array_equal(rng.bits(tk, (9,)).numpy(),
                                  np.asarray(jax.random.bits(jk, (9,))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits(seed, shape):
    jk, tk = _keys(seed)
    got = rng.bits(tk, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.bits(jk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("lo_hi", [(0.0, 1.0), (-2.5, 3.0)], ids=str)
def test_uniform(seed, shape, lo_hi):
    jk, tk = _keys(seed)
    got = rng.uniform(tk, shape, *lo_hi)
    want = np.asarray(jax.random.uniform(jk, shape, minval=lo_hi[0], maxval=lo_hi[1]))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 64, 1000, 2000])
def test_permutation(seed, n):
    # 2000 > 2^(32/3) takes two sort rounds
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(rng.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_million_draws(seed):
    jk, tk = _keys(seed)
    n = 1_000_003
    got = rng.normal(tk, (n,))
    want = np.asarray(jax.random.normal(jk, (n,)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy() == want).mean() > 0.95


@pytest.mark.parametrize("shape", [(), (3, 5, 11)], ids=str)
def test_normal_shapes(shape):
    jk, tk = _keys(11)
    got = rng.normal(tk, shape)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.random.normal(jk, shape)),
                               rtol=1e-6, atol=1e-6)


def test_erf_inv_matches_lax_over_the_open_interval():
    x = np.linspace(-1, 1, 200_001, dtype=np.float32)[1:-1]
    want = np.asarray(jax.lax.erf_inv(x))
    got = rng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ends = rng.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    np.testing.assert_array_equal(ends, np.asarray(jax.lax.erf_inv(np.float32([-1, 1]))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((7,), 0, 10), ((1000,), 5, 37), ((3, 5), -2**31, 2**31 - 1),
    ((64,), 3, 3), ((50,), 9, 2), ((100,), 0, 2**31 - 1), ((50,), -1000, 70000),
], ids=str)
def test_randint(seed, shape, lo, hi):
    jk, tk = _keys(seed)
    got = rng.randint(tk, shape, lo, hi)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (40, 63))) * 2
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.categorical(jk, logits, axis=-1, shape=(80, 40)))
    got = rng.categorical(tk, torch.tensor(logits), shape=(80, 40))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rng.categorical(tk, torch.tensor(logits)).numpy(),
                                  np.asarray(jax.random.categorical(jk, logits)))
    with pytest.raises(ValueError, match="batch shape"):
        rng.categorical(tk, torch.tensor(logits), shape=(80, 41))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel(seed):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.gumbel(jk, (100_000,)))
    got = rng.gumbel(tk, (100_000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    assert np.isfinite(got).all()
