"""The port's U-Net (``models/unet.py``) against flax's
(``fl4health_tpu/models/unet.py``) on the CPU at narrow widths, from the
same converted params, within 5e-4: one flax ``SAME`` convolution at
stride 2 on odd and even extents (flax pads ``(0, 1)`` where
``padding=1`` would pad ``(1, 1)``), the transposed convolution's kernel
orientation, the instance norm (its fast variance, on inputs far from
zero), the 3-D and 2-D networks with deep supervision, and the network's
client vmap against the loop over clients at 1e-5."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.models import unet as junet
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models import unet as tunet

TOL = 5e-4
VMAP_TOL = 1e-5


def _params(module, x):
    p = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return p, convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, p))


def _apply(tmodule, tparams, x):
    return tengine.from_module(tmodule).apply(tparams, {}, torch.tensor(x))[0]


@pytest.mark.parametrize("extent", [(11, 12, 9), (12, 12, 12), (7, 5, 6)])
@pytest.mark.parametrize("stride", [(2, 2, 2), (1, 2, 2)])
def test_same_conv_matches_flax(extent, stride):
    x = np.random.default_rng(0).standard_normal((2, *extent, 3)).astype(np.float32)
    jconv = fnn.Conv(5, (3, 3, 3), strides=stride)
    jp, _ = _params(jconv, x)
    want = np.asarray(jconv.apply({"params": jp}, jnp.asarray(x)))
    tconv = tunet.Conv(3, 5, (3, 3, 3), stride)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    got = torch.func.functional_call(tconv, tp, (torch.tensor(x).permute(0, 4, 1, 2, 3),))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kernel", [(2, 2, 2), (1, 2, 2), (2, 2)])
def test_conv_transpose_orientation_matches_flax(kernel):
    nd = len(kernel)
    x = np.random.default_rng(1).standard_normal((2, *(3,) * nd, 4)).astype(np.float32)
    jct = fnn.ConvTranspose(6, kernel_size=kernel, strides=kernel, padding="VALID")
    jp, _ = _params(jct, x)
    # a kernel that is not symmetric in its taps, so a missing flip shows
    jp = {"kernel": jnp.asarray(np.random.default_rng(2).standard_normal(
        jp["kernel"].shape).astype(np.float32)), "bias": jp["bias"] + 0.1}
    want = np.asarray(jct.apply({"params": jp}, jnp.asarray(x)))
    tct = tunet.ConvTranspose(4, 6, kernel)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    to_first = (0, nd + 1, *range(1, nd + 1))
    to_last = (0, *range(2, nd + 2), 1)
    got = torch.func.functional_call(tct, tp, (torch.tensor(x).permute(to_first),))
    got = got.permute(to_last).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    unflipped = torch.nn.functional.conv_transpose3d if nd == 3 else \
        torch.nn.functional.conv_transpose2d
    wrong = unflipped(torch.tensor(x).permute(to_first),
                      tp["kernel"].permute(nd, nd + 1, *range(nd)), tp["bias"],
                      stride=kernel).permute(to_last).numpy()
    if any(k > 1 for k in kernel):
        assert np.abs(wrong - want).max() > 10 * TOL  # the flip matters


@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_instance_norm_matches_flax(offset):
    x = (np.random.default_rng(3).standard_normal((2, 6, 5, 4, 3)) * 2 + offset).astype(
        np.float32)
    jn = fnn.InstanceNorm(epsilon=1e-5)
    jp, _ = _params(jn, x)
    jp = {"scale": jnp.asarray([0.5, 1.5, -1.0], jnp.float32),
          "bias": jnp.asarray([0.1, -0.2, 0.3], jnp.float32)}
    want = np.asarray(jn.apply({"params": jp}, jnp.asarray(x)))
    tn = tunet.InstanceNorm(3)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    got = torch.func.functional_call(tn, tp, (torch.tensor(x).permute(0, 4, 1, 2, 3),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=TOL, rtol=0)


NETS = {
    "3d": dict(features=(4, 8, 16), strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
               kernels=((3, 3, 3),) * 3, shape=(2, 8, 12, 12, 2)),
    "3d_anisotropic": dict(features=(4, 8, 8), strides=((1, 1, 1), (1, 2, 2), (2, 2, 2)),
                           kernels=((1, 3, 3), (3, 3, 3), (3, 3, 3)), shape=(1, 4, 8, 8, 1)),
    "2d": dict(features=(4, 8, 16, 16), strides=((1, 1), (2, 2), (2, 2), (2, 2)),
               kernels=((3, 3),) * 4, shape=(2, 16, 16, 1)),
}


@pytest.mark.parametrize("deep_supervision", [True, False])
@pytest.mark.parametrize("name", sorted(NETS))
def test_unet_matches_flax(name, deep_supervision):
    cfg = NETS[name]
    x = np.random.default_rng(4).standard_normal(cfg["shape"]).astype(np.float32)
    jnet = junet.PlainConvUNet(features_per_stage=cfg["features"], strides=cfg["strides"],
                               kernel_sizes=cfg["kernels"], n_classes=3,
                               deep_supervision=deep_supervision)
    jp, tp = _params(jnet, x)
    tnet = tunet.PlainConvUNet(cfg["shape"][-1], cfg["features"], cfg["strides"],
                               cfg["kernels"], n_classes=3, deep_supervision=deep_supervision)
    assert set(tp) == set(tunet.PlainConvUNet.init_params(
        tnet, torch.Generator().manual_seed(1)))
    want = jnet.apply({"params": jp}, jnp.asarray(x))[0]
    got = _apply(tnet, tp, x)[0]
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=TOL,
                                   rtol=0, err_msg=k)


def test_unet_from_plans_and_ds_strides_match_flax():
    plans = {"configurations": {"3d_fullres": {
        "features_per_stage": [4, 8, 8], "strides": [[1, 1, 1], [2, 2, 2], [1, 2, 2]],
        "kernel_sizes": [[3, 3, 3]] * 3, "n_conv_per_stage": 2}}}
    assert tunet.deep_supervision_strides(plans) == junet.deep_supervision_strides(plans)
    x = np.random.default_rng(5).standard_normal((1, 4, 8, 8, 1)).astype(np.float32)
    jnet = junet.unet_from_plans(plans, 1, 2)
    jp, tp = _params(jnet, x)
    tnet = tunet.unet_from_plans(plans, 1, 2)
    want, got = jnet.apply({"params": jp}, jnp.asarray(x))[0], _apply(tnet, tp, x)[0]
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=TOL,
                                   rtol=0)
    with pytest.raises(ValueError, match="conv_impl"):
        tunet.unet_from_plans(plans, 1, 2, conv_impl="mxu")


def test_client_vmap_matches_the_loop():
    cfg = NETS["3d"]
    tnet = tunet.PlainConvUNet(2, cfg["features"], cfg["strides"], cfg["kernels"], 3)
    model = tengine.from_module(tnet)
    params = ptu.stack_clients([tnet.init_params(torch.Generator().manual_seed(s))
                                for s in (1, 2)])
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, *cfg["shape"])).astype(
        np.float32))

    def loss(p, xb):
        preds = model.apply(p, {}, xb)[0][0]
        return sum((v * v).mean() for v in preds.values())

    fn = torch.func.grad_and_value(loss)
    vg, vv = torch.func.vmap(fn)(params, x)
    for i in range(2):
        lg, lv = fn(ptu.client_slice(params, i), x[i])
        np.testing.assert_allclose(vv[i].item(), lv.item(), atol=VMAP_TOL, rtol=0)
        for k in lg:
            np.testing.assert_allclose(vg[k][i].numpy(), lg[k].numpy(), atol=VMAP_TOL,
                                       rtol=0, err_msg=k)
