"""The port's CNNs and small dense models against the flax modules, from the
same converted params (``models/convert.py``, no transposes) and the same
numpy inputs: f32 logits and grads within 1e-4; CifarNet in bf16 compute
against flax in bf16 at a stated bf16 bound. Plus the synthetic image
generator's distribution."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.models import cnn as jcnn
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert

CASES = {
    "mnist": (lambda: jcnn.MnistNet(hidden=32),
              lambda: tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1)), (14, 14, 1), 10),
    "mnist_28": (lambda: jcnn.MnistNet(),
                 lambda: tcnn.MnistNet(), (28, 28, 1), 10),
    "cifar": (lambda: jcnn.CifarNet(),
              lambda: tcnn.CifarNet(), (32, 32, 3), 10),
    "cifar_8x8": (lambda: jcnn.CifarNet(n_classes=4),
                  lambda: tcnn.CifarNet(n_classes=4, input_shape=(8, 8, 3)), (8, 8, 3), 4),
    "mlp": (lambda: jcnn.Mlp(features=(16, 8), n_outputs=3),
            lambda: tcnn.Mlp(20, features=(16, 8), n_outputs=3), (5, 4), 3),
    "logreg": (lambda: jcnn.LogisticRegression(n_outputs=3),
               lambda: tcnn.LogisticRegression(20, n_outputs=3), (5, 4), 3),
}


def _inputs(shape, n_classes, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *shape)).astype(np.float32)
    y = rng.integers(0, n_classes, size=b).astype(np.int32)
    mask = np.ones((b,), np.float32)
    mask[-1] = 0.0  # a padding row
    return x, y, mask


def _pair(name, seed=0):
    jmake, tmake, shape, n_classes = CASES[name]
    jm, tm = jmake(), tmake()
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, *shape)), train=False)["params"]
    return jm, tm, params, shape, n_classes


def _jax_loss_and_grads(jm, params, x, y, mask):
    def loss(p):
        preds, _ = jm.apply({"params": p}, x, train=True)
        return jengine.masked_cross_entropy(preds["prediction"], y, mask), preds
    (value, preds), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return preds["prediction"], value, grads


def _torch_loss_and_grads(tm, params, x, y, mask):
    model = tengine.from_module(tm)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    (preds, _), _ = model.apply(leaves, {}, torch.tensor(x))
    value = tengine.masked_cross_entropy(preds["prediction"], torch.tensor(y),
                                         torch.tensor(mask))
    grads = torch.autograd.grad(value, list(leaves.values()))
    return preds["prediction"], value, dict(zip(leaves, grads))


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_grads_match_flax(name):
    jm, tm, jparams, shape, n_classes = _pair(name)
    tparams = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    # the port's own init has the flax names and shapes
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in tparams.items()}
    x, y, mask = _inputs(shape, n_classes)
    jlogits, jvalue, jgrads = _jax_loss_and_grads(jm, jparams, x, y, mask)
    tlogits, tvalue, tgrads = _torch_loss_and_grads(tm, tparams, x, y, mask)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(float(tvalue.detach()), float(jvalue), atol=1e-4)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(tgrads) == set(want)
    for k in want:
        np.testing.assert_allclose(tgrads[k].numpy(), want[k].numpy(), atol=1e-4,
                                   err_msg=k)


def test_cifarnet_bf16_matches_flax_bf16():
    """bf16 compute in both packages from the same f32 params. Logits pass
    four bf16-rounded layers (conv, conv, dense, dense), each a rounding of
    at most 2^-8 relative that XLA and PyTorch may take differently: atol
    4 * 2^-8 of the largest logit. Grads stay f32 (the params are f32) but
    flow back through bf16 cotangents; a bias grad sums up to 4 * 32 * 32 of
    them, and the two frameworks round those partial sums to bf16 at
    different points: atol 2^-4 of each leaf's largest entry. (bf16 against
    f32 moves the conv grads by up to ~14% of that, so the bound still tells
    the bf16 model from the f32 one.)"""
    jm = jcnn.CifarNet(dtype=jnp.bfloat16)
    tm = tcnn.CifarNet(dtype=torch.bfloat16)
    params = jm.init(jax.random.PRNGKey(1), jnp.ones((1, 32, 32, 3)), train=False)["params"]
    tparams = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    x, y, mask = _inputs((32, 32, 3), 10, b=4, seed=1)
    jlogits, _, jgrads = _jax_loss_and_grads(jm, params, x, y, mask)
    tlogits, _, tgrads = _torch_loss_and_grads(tm, tparams, x, y, mask)
    assert tlogits.dtype == torch.float32
    want = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits.detach().numpy(), want,
                               atol=4 * 2**-8 * np.abs(want).max())
    want_g = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    for k in want_g:
        assert tgrads[k].dtype == torch.float32
        np.testing.assert_allclose(tgrads[k].numpy(), want_g[k].numpy(),
                                   atol=2**-4 * float(want_g[k].abs().max()), err_msg=k)


def test_cifarnet_has_the_north_star_size():
    tm = tcnn.CifarNet()
    shapes = {k: tuple(v.shape) for k, v in tm.init_params(torch.Generator()).items()}
    assert shapes == {"Conv_0/kernel": (5, 5, 3, 32), "Conv_0/bias": (32,),
                      "Conv_1/kernel": (5, 5, 32, 64), "Conv_1/bias": (64,),
                      "Dense_0/kernel": (4096, 128), "Dense_0/bias": (128,),
                      "Dense_1/kernel": (128, 10), "Dense_1/bias": (10,)}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 579_402


def test_convert_round_trips_flax_params():
    jm = jcnn.CifarNet(n_classes=4)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(2), jnp.ones((1, 8, 8, 3)))["params"])
    back = convert.torch_to_flax(convert.flax_to_torch(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_draws_lecun_normal_fan_in():
    # flax lecun_normal: variance 1 / fan_in, fan_in over every axis but the
    # last (5*5*32 = 800 for Conv_1)
    p = tcnn.CifarNet().init_params(torch.Generator().manual_seed(3))
    for key, fan_in in (("Conv_1/kernel", 800), ("Dense_0/kernel", 4096)):
        assert float(p[key].std()) == pytest.approx(fan_in ** -0.5, rel=0.05), key
    assert torch.count_nonzero(p["Conv_0/bias"]) == 0


def test_synthetic_classification_matches_the_jax_distribution():
    n, shape, k = 5000, (4, 4, 3), 50
    x, y = synthetic_classification(rng.PRNGKey(0), n, shape, k)
    x2, y2 = synthetic_classification(rng.PRNGKey(0), n, shape, k)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert x.shape == (n, *shape) and x.dtype == torch.float32
    assert y.shape == (n,) and y.dtype == torch.int32
    assert set(y.tolist()) == set(range(k))
    jx, jy = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(0), n, shape, k))
    # the same draws: labels equal, images within rng.normal's 2 ulp, carried
    # through the class_sep scale and the standardization (values up to ~5)
    np.testing.assert_array_equal(y.numpy(), jy)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-5)
    # globally standardized in both; class structure of the same strength:
    # after standardization the within-class variance is the unit noise over
    # the total, about 1 / (1 + sep^2 (k - 1) / k) for k drawn class means
    for xs, ys in ((x.numpy(), y.numpy()), (jx, jy)):
        assert abs(xs.mean()) < 1e-5 and abs(xs.std() - 1.0) < 1e-5
        flat = xs.reshape(n, -1)
        within = np.mean([flat[ys == c].var(axis=0).mean() for c in range(k)])
        assert within == pytest.approx(1.0 / (1.0 + 4.0 * (k - 1) / k), rel=0.1)
