"""The port's nnU-Net augmentation (``nnunet/augment.py``) against the JAX
package's on the CPU, transform by transform for the same keys: the
grid-exact ones (mirror, 90° rotation, brightness) bit for bit, the
interpolating and reducing ones within AUG_TOL (their sums run in another
order, XLA fuses some multiply-adds, and the noise comes through
``rng.normal``'s 2 ulp); labels equal on every voxel; the resize and
``map_coordinates`` rewrites against ``jax.image.resize`` and
``jax.scipy.ndimage.map_coordinates``; the whole batch transform under the
engine's client vmap against the loop; and the ``nnunet_augmented`` smoke
config (augmentation on, patches resampled every round, so pipelined in
both packages), against JAX and its golden."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates as jmap_coordinates

from fl4health_tpu.nnunet import augment as ja
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.nnunet import augment as ta
from fl4health_tpu_torch.server import simulation as tsim

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402
from test_torch_nnunet import (assert_config_matches, jax_initial_params,  # noqa: E402
                               port_nnunet_synthetic)

# f32 values of order 1-5 after a few roundings in another order
AUG_TOL = 2e-5
SEEDS = range(6)


def _example(seed, shape=(10, 10, 8), channels=2):
    g = np.random.default_rng(seed)
    x = (g.standard_normal((*shape, channels)) * 1.5 + 0.3).astype(np.float32)
    y = g.integers(0, 3, shape).astype(np.int32)
    return x, y


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_exact_transforms_bit_for_bit(seed):
    x, y = _example(seed)
    jk, tk = _keys(seed)
    jx, jy = ja._mirror_one(jnp.asarray(x), jnp.asarray(y), jk, (0, 1, 2), 0.5)
    tx, ty = ta._mirror_one(torch.tensor(x), torch.tensor(y), tk, (0, 1, 2), 0.5)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    x2, y2 = _example(seed, (8, 8, 8), 1)
    pairs = ja._isotropic_pairs((8, 8, 8))
    assert ta._isotropic_pairs((8, 8, 8)) == pairs
    jx, jy = ja._rot90_one(jnp.asarray(x2), jnp.asarray(y2), jk, pairs, 0.9)
    tx, ty = ta._rot90_one(torch.tensor(x2), torch.tensor(y2), tk, pairs, 0.9)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        ta._brightness_one(torch.tensor(x), tk, 0.9, 0.75, 1.25).numpy(),
        np.asarray(ja._brightness_one(jnp.asarray(x), jk, 0.9, 0.75, 1.25)))


INTENSITY = {
    "noise": (lambda m, x, k: m._noise_one(x, k, 0.9, 0.1)),
    "blur": (lambda m, x, k: m._blur_one(x, k, 0.9)),
    "contrast": (lambda m, x, k: m._contrast_one(x, k, 0.9, 0.75, 1.25)),
    "gamma": (lambda m, x, k: m._gamma_one(x, k, 0.9, 0.7, 1.5, invert=False)),
    "gamma_invert": (lambda m, x, k: m._gamma_one(x, k, 0.9, 0.7, 1.5, invert=True)),
    "lowres": (lambda m, x, k: m._lowres_one(x, k, 0.9)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(INTENSITY))
def test_intensity_transforms_match_jax(name, seed):
    x, _ = _example(seed)
    jk, tk = _keys(seed)
    want = np.asarray(INTENSITY[name](ja, jnp.asarray(x), jk))
    got = INTENSITY[name](ta, torch.tensor(x), tk).numpy()
    np.testing.assert_allclose(got, want, atol=AUG_TOL, rtol=AUG_TOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("elastic", [0.0, 0.9])
def test_spatial_resample_matches_jax(seed, elastic):
    x, y = _example(seed)
    jk, tk = _keys(seed)
    args = (0.9, 0.9, 30.0 * np.pi / 180.0, 0.7, 1.4, elastic, 8.0)
    jx, jy = ja._spatial_resample_one(jnp.asarray(x), jnp.asarray(y), jk, *args)
    tx, ty = ta._spatial_resample_one(torch.tensor(x), torch.tensor(y), tk, *args)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=AUG_TOL, rtol=AUG_TOL)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("order", [0, 1])
def test_map_coordinates_matches_jax(order):
    g = np.random.default_rng(7)
    img = g.standard_normal((6, 7, 5)).astype(np.float32)
    labels = g.integers(0, 4, (6, 7, 5)).astype(np.int32)
    # coordinates past the edges, and exact half-way ties (rounded away
    # from zero by lax.round, to even by torch.round)
    coords = [g.uniform(-2, s + 1, (4, 9)).astype(np.float32) for s in img.shape]
    coords[0][0, :4] = [0.5, 1.5, 2.5, -0.5]
    for arr in (img, labels):
        want = np.asarray(jmap_coordinates(jnp.asarray(arr), [jnp.asarray(c) for c in coords],
                                           order=order, mode="nearest"))
        got = ta.map_coordinates(torch.tensor(arr), [torch.tensor(c) for c in coords], order)
        assert got.dtype == torch.tensor(arr).dtype
        np.testing.assert_allclose(got.numpy(), want, atol=AUG_TOL, rtol=0)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("shape", [(5, 12, 2), (16, 3, 2), (7, 7, 1)])
def test_resize_matches_jax_image(method, shape):
    x = np.random.default_rng(8).standard_normal((9, 6, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, method=method))
    got = ta.resize(torch.tensor(x), shape, method).numpy()
    np.testing.assert_allclose(got, want, atol=AUG_TOL, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_augment_patch_batch_matches_jax(seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal((4, 8, 8, 6, 2)).astype(np.float32)
    y = g.integers(0, 3, (4, 8, 8, 6)).astype(np.int32)
    jk, tk = _keys(seed)
    probs = dict(p_rotation=0.6, p_scaling=0.6, p_lowres=0.6, p_noise=0.6, p_blur=0.6)
    jx, jy = ja.augment_patch_batch(jnp.asarray(x), jnp.asarray(y), jk, **probs)
    tx, ty = ta.augment_patch_batch(torch.tensor(x), torch.tensor(y), tk, **probs)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=AUG_TOL, rtol=AUG_TOL)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_augment_under_the_client_vmap_equals_the_loop():
    g = np.random.default_rng(9)
    x = torch.tensor(g.standard_normal((2, 3, 8, 8, 6, 1)).astype(np.float32))
    y = torch.tensor(g.integers(0, 2, (2, 3, 8, 8, 6)).astype(np.int32))
    keys = torch.stack([rng.PRNGKey(1), rng.PRNGKey(2)])
    vx, vy = tsim.vmap_clients(ta.augment_patch_batch, (0, 0, 0))(x, y, keys)
    for i in range(2):
        lx, ly = ta.augment_patch_batch(x[i], y[i], keys[i])
        assert torch.equal(vy[i], ly)
        np.testing.assert_allclose(vx[i].numpy(), lx.numpy(), atol=1e-6, rtol=0)


def test_nnunet_augmented_matches_jax_and_its_golden():
    jserver = harness.CONFIGS["nnunet_augmented"]()
    init = jax_initial_params(harness.CONFIGS["nnunet_augmented"]())
    tserv = port_nnunet_synthetic(augment=True, resample=True, init=init)
    _, thist = assert_config_matches("nnunet_augmented", jserver, tserv)
    assert tserv.sim._select_execution_mode(1) == (
        tsim.EXEC_PIPELINED, "train_data_provider needs a host data refresh every round")
