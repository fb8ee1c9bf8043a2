"""The port's TransformerClassifier against the flax module, from the same
converted params and the same numpy tokens: logits atol 1e-4, grads atol
2e-3 / rtol 1e-3 (the bounds of tests/kernels/test_flash_attention.py's
transformer test)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.models import transformer as jtr
from fl4health_tpu_torch.kernels.flash_attention import flash_attention
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models import transformer as ttr

jfa = importlib.import_module("fl4health_tpu.kernels.flash_attention")

CFG = dict(vocab_size=64, n_classes=3, d_model=32, n_heads=2, n_layers=2,
           d_ff=64, max_len=40)


def _tokens(b=4, t=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, CFG["vocab_size"], size=(b, t)).astype(np.int32)
    lengths = np.asarray([t, t - 7, t // 2, 3])[:b]
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0  # ragged PAD tails
    return x


def _pair(flash: bool, remat: bool, lora_rank: int = 0):
    jfn = (functools.partial(jfa.flash_attention, block_q=16, block_k=16)
           if flash else None)
    tfn = flash_attention if flash else None
    jm = jtr.TransformerClassifier(**CFG, lora_rank=lora_rank, remat=remat,
                                   attention_fn=jfn)
    tm = ttr.TransformerClassifier(**CFG, lora_rank=lora_rank, remat=remat,
                                   attention_fn=tfn)
    variables = jm.init(jax.random.PRNGKey(0), jnp.ones((1, CFG["max_len"]), jnp.int32),
                        train=False)
    return jm, tm, variables["params"]


def _torch_apply(tm, params, x):
    named = {k.replace("/", "."): v for k, v in params.items()}
    return torch.func.functional_call(tm, named, (torch.tensor(x),))


@pytest.mark.parametrize("flash,remat", [(True, True), (True, False), (False, False)])
def test_logits_and_grads_match_flax(flash, remat):
    jm, tm, jparams = _pair(flash, remat)
    x = _tokens()
    tparams = convert.flax_to_torch(jparams)
    jlogits = jm.apply({"params": jparams}, jnp.asarray(x), train=False)[0]["prediction"]
    tlogits = _torch_apply(tm, tparams, x)[0]["prediction"]
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)

    jgrads = jax.grad(lambda p: jnp.sum(jnp.square(
        jm.apply({"params": p}, jnp.asarray(x), train=True)[0]["prediction"])))(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tparams.items()}
    loss = torch.sum(torch.square(_torch_apply(tm, leaves, x)[0]["prediction"]))
    tgrads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(tgrads) == set(want)
    for k in want:
        np.testing.assert_allclose(tgrads[k].numpy(), want[k].numpy(), atol=2e-3,
                                   rtol=1e-3, err_msg=k)


def test_param_names_and_shapes_are_the_flax_tree():
    _, tm, jparams = _pair(flash=True, remat=True)
    want = {k: tuple(v.shape) for k, v in convert.flax_to_torch(jparams).items()}
    got = {k: tuple(v.shape) for k, v in ttr.param_dict(tm).items()}
    assert got == want


def test_init_params_draws_from_the_generator():
    tm = ttr.TransformerClassifier(**CFG)
    a = tm.init_params(torch.Generator().manual_seed(1))
    b = tm.init_params(torch.Generator().manual_seed(1))
    c = tm.init_params(torch.Generator().manual_seed(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0/attn/q_proj/kernel"], c["layer_0/attn/q_proj/kernel"])
    assert torch.all(a["layer_0/ln_attn/scale"] == 1)
    # lecun_normal: variance ~ 1 / fan_in
    k = a["layer_0/ff_in/kernel"]
    assert abs(float(k.var()) * k.shape[0] - 1.0) < 0.15


def test_lora_dense_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    jd = jtr.LoraDense(features=8, rank=2, alpha=4.0)
    params = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # lora_b starts at zero; give it values so the adapter path is exercised
    params = {**params, "lora_b": jnp.asarray(rng.standard_normal((2, 8)), jnp.float32)}
    want = jd.apply({"params": params}, jnp.asarray(x))
    td = ttr.LoraDense(12, 8, rank=2, alpha=4.0)
    got = torch.func.functional_call(
        td, dict(convert.flax_to_torch(params)), (torch.tensor(x),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_bf16_compute_keeps_f32_params_and_logits():
    tm = ttr.TransformerClassifier(**CFG, dtype=torch.bfloat16, remat=True,
                                   attention_fn=flash_attention)
    params = {k: v.requires_grad_(True)
              for k, v in tm.init_params(torch.Generator().manual_seed(0)).items()}
    preds, _ = _torch_apply(tm, params, _tokens())
    assert preds["prediction"].dtype == torch.float32
    grads = torch.autograd.grad(preds["prediction"].square().sum(), list(params.values()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_converter_round_trips():
    _, _, jparams = _pair(flash=False, remat=False)
    tparams = convert.flax_to_torch(jparams)
    back = convert.torch_to_flax(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jparams))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    again = convert.flax_to_torch(back)
    assert all(torch.equal(tparams[k], again[k]) for k in tparams)
