"""The port's sliding-window inference (``fl4health_tpu_torch/nnunet/inference.py``)
against JAX's (``fl4health_tpu/nnunet/inference.py``) on the CPU, from the
same converted params: the window starts and the Gaussian map exactly,
and ``sliding_window_predict`` within 5e-4 on ``tests/nnunet/test_inference.py``'s
2-D U-Net (patch equal to the volume, overlapping windows, a volume smaller
than the patch) and on a small 3-D U-Net with and without the Gaussian."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.models.unet import PlainConvUNet as JUNet
from fl4health_tpu.nnunet import inference as jinf
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.unet import PlainConvUNet as TUNet
from fl4health_tpu_torch.nnunet import inference as tinf

TOL = 5e-4
N_CLASSES = 3
NETS = {
    "2d": dict(features_per_stage=(8, 16), kernel_sizes=((3, 3), (3, 3)),
               strides=((1, 1), (2, 2))),
    "3d": dict(features_per_stage=(4, 8), kernel_sizes=((3, 3, 3), (3, 3, 3)),
               strides=((1, 1, 1), (2, 2, 2))),
}


@pytest.mark.parametrize("size,patch,step", [(24, 16, 0.5), (16, 16, 0.5), (10, 16, 0.5),
                                             (256, 128, 0.5), (192, 128, 0.5),
                                             (100, 7, 0.33), (37, 5, 1.0)])
def test_window_starts_match(size, patch, step):
    assert tinf._window_starts(size, patch, step) == jinf._window_starts(size, patch, step)


@pytest.mark.parametrize("patch", [(16, 16), (128, 128, 128), (5, 7, 3)])
def test_gaussian_map_matches(patch):
    got, want = tinf.gaussian_importance_map(patch), jinf.gaussian_importance_map(patch)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _models(kind):
    cfg = NETS[kind]
    jnet = JUNet(n_conv_per_stage=1, n_classes=N_CLASSES, deep_supervision=False, **cfg)
    shape = (1,) + (8,) * len(cfg["strides"][0]) + (1,)
    jp = jnet.init(jax.random.PRNGKey(1), jnp.zeros(shape))
    tnet = TUNet(1, cfg["features_per_stage"], cfg["strides"], cfg["kernel_sizes"],
                 N_CLASSES, n_conv_per_stage=1, deep_supervision=False)
    tp = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jp["params"]))
    return jengine.from_flax(jnet), jp, tengine.from_module(tnet), tp


@pytest.mark.parametrize("kind,vol,patch,step,gaussian", [
    ("2d", (16, 16), (16, 16), 0.5, True),
    ("2d", (24, 24), (16, 16), 0.5, True),
    ("2d", (10, 12), (16, 16), 0.5, True),
    ("3d", (12, 10, 9), (8, 8, 8), 0.5, True),
    ("3d", (12, 10, 9), (8, 8, 8), 0.5, False),
])
def test_sliding_window_predict_matches_jax(kind, vol, patch, step, gaussian):
    jmodel, jp, tmodel, tp = _models(kind)
    x = np.random.default_rng(2).standard_normal((*vol, 1)).astype(np.float32)
    want = np.asarray(jinf.sliding_window_predict(
        jmodel.apply, jp["params"], jp.get("batch_stats", {}), jnp.asarray(x), patch,
        step_fraction=step, gaussian=gaussian))
    got = tinf.sliding_window_predict(tmodel.apply, tp, None, torch.tensor(x), patch,
                                      step_fraction=step, gaussian=gaussian)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (*vol, N_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_patch_equal_to_volume_is_the_direct_forward():
    _, _, tmodel, tp = _models("2d")
    x = torch.tensor(np.random.default_rng(3).standard_normal((16, 16, 1)).astype(np.float32))
    direct = tmodel.apply(tp, {}, x[None], train=False)[0][0]["prediction"][0]
    got = tinf.sliding_window_predict(tmodel.apply, tp, None, x, (16, 16))
    np.testing.assert_allclose(got.numpy(), direct.detach().numpy(), atol=1e-5, rtol=0)


def test_r6_logits_below_the_weight_floor_are_scaled_down():
    """R6 (ROADMAP C), pinned in both packages: a 3-D patch's Gaussian map
    falls under the 1e-8 floor of the blend's division near its corners, so
    a volume equal to the patch comes out as the direct forward times
    ``w / 1e-8`` there (the argmax unchanged), in JAX as in the port."""
    cfg = NETS["3d"]
    jnet = JUNet(n_conv_per_stage=1, n_classes=N_CLASSES, deep_supervision=False, **cfg)
    patch = (32, 32, 32)
    jp = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, *patch, 1)))
    tnet = TUNet(1, cfg["features_per_stage"], cfg["strides"], cfg["kernel_sizes"],
                 N_CLASSES, n_conv_per_stage=1, deep_supervision=False)
    tp = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jp["params"]))
    x = np.random.default_rng(4).standard_normal((*patch, 1)).astype(np.float32)
    w = tinf.gaussian_importance_map(patch)
    below = w < 1e-8
    assert below.sum() == 304 and below[0, 0, 0] and not below[16, 16, 16]
    direct = tengine.from_module(tnet).apply(tp, {}, torch.tensor(x)[None], train=False)[0][0][
        "prediction"][0].detach().numpy()
    got = tinf.sliding_window_predict(tengine.from_module(tnet).apply, tp, None,
                                      torch.tensor(x), patch).numpy()
    want = np.asarray(jinf.sliding_window_predict(jengine.from_flax(jnet).apply, jp["params"],
                                                  {}, jnp.asarray(x), patch))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    scale = np.where(below, w / 1e-8, 1.0)[..., None].astype(np.float32)
    np.testing.assert_allclose(got, direct * scale, atol=1e-5, rtol=1e-5)
    assert np.abs(got[below] - direct[below]).max() > 1e-2
    np.testing.assert_array_equal(got.argmax(-1), direct.argmax(-1))
