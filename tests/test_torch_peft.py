"""The port's path helpers, exchangers and PEFT filters
(``core/pytree.py``, ``exchange/exchanger.py``, ``utils/peft.py``) against
the JAX package on the CPU: the paths, mask and exchanger on the BERT-base
tree (the JAX tree by ``eval_shape``, the port's on the meta device, so no
weights are made), the segment rules, and ``push``/``pull`` under the
client vmap, exactly."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.core import pytree as jptu
from fl4health_tpu.exchange import exchanger as jex
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.utils import peft as jpeft
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.exchange import exchanger as tex
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import TransformerClassifier as TTransformer
from fl4health_tpu_torch.models.transformer import param_dict
from fl4health_tpu_torch.utils import peft as tpeft

# bench.py's transformer config at BERT-base width, with
# examples/bert_finetuning_example's lora_rank
BERT_BASE = dict(vocab_size=16384, n_classes=4, d_model=768, n_heads=12, n_layers=12,
                 d_ff=3072, max_len=128, lora_rank=4)


@pytest.fixture(scope="module")
def bert_trees():
    jshapes = jax.eval_shape(
        lambda: JTransformer(**BERT_BASE).init(jax.random.PRNGKey(0),
                                               jnp.ones((1, 128), jnp.int32),
                                               train=False)["params"])
    with torch.device("meta"):
        tparams = param_dict(TTransformer(**BERT_BASE))
    return jshapes, tparams


def _flat_bools(tree) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = bool(v)
    return out


def test_bert_base_tree_matches(bert_trees):
    jshapes, tparams = bert_trees
    jleaves = {"/".join(str(k.key) for k in p): tuple(v.shape)
               for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {k: tuple(v.shape) for k, v in tparams.items()} == jleaves
    assert len(tparams) == 342
    assert sum(v.numel() for v in tparams.values()) == 98_403_844
    assert ptu.leaf_paths(tparams) == jptu.leaf_paths(jshapes)


def test_peft_paths_and_mask_match(bert_trees):
    jshapes, tparams = bert_trees
    paths = tpeft.peft_parameter_paths(tparams)
    assert paths == jpeft.peft_parameter_paths(jshapes)
    assert len(paths) == 146
    mask = tpeft.lora_trainable_mask(tparams)
    assert mask == _flat_bools(jpeft.lora_trainable_mask(jshapes))
    assert sum(v.numel() for k, v in tparams.items() if mask[k]) == 666_628
    assert tpeft.lora_exchanger().mask(tparams) == _flat_bools(
        jpeft.lora_exchanger().mask(jshapes))


@pytest.mark.parametrize("factory,args", [
    ("fixed_exchanger_excluding", (("ln_", "classifier"),)),
    ("fixed_exchanger_including", (("attn", "bias"),)),
    ("norm_exclusion_exchanger", ()),
])
def test_factory_masks_match(bert_trees, factory, args):
    jshapes, tparams = bert_trees
    assert getattr(tex, factory)(*args).mask(tparams) == _flat_bools(
        getattr(jex, factory)(*args).mask(jshapes))


def test_segment_rules():
    paths = ["subnet/kernel", "BatchNorm_0/scale", "bn/mean", "encoder/layernorm/bias",
             "norm_1/scale", "layer_0/ln_attn/scale", "aux_classifier_head/kernel",
             "classifier/kernel", "layer_0/attn/q_proj/lora_a", "my_lora_a/kernel"]
    params = {p: torch.zeros(1) for p in paths}
    nested = convert.torch_to_flax(params)
    for tx, jx in ((tex.norm_exclusion_exchanger(), jex.norm_exclusion_exchanger()),
                   (tpeft.lora_exchanger(), jpeft.lora_exchanger())):
        assert tx.mask(params) == _flat_bools(jx.mask(nested))
    norm = tex.norm_exclusion_exchanger().mask(params)
    assert norm["subnet/kernel"] and not norm["BatchNorm_0/scale"] and not norm["bn/mean"]
    lora = tpeft.lora_exchanger().mask(params)
    # whole segments only: a module merely named like a marker stays off the wire
    assert not lora["aux_classifier_head/kernel"] and not lora["my_lora_a/kernel"]
    assert lora["classifier/kernel"] and lora["layer_0/attn/q_proj/lora_a"]


def test_push_pull_under_the_client_vmap():
    rng = np.random.default_rng(0)
    shapes = {"layer_0/attn/q_proj/kernel": (4, 4), "layer_0/attn/q_proj/lora_a": (4, 2),
              "layer_0/ln_attn/scale": (4,), "classifier/kernel": (4, 3)}
    local = {k: rng.standard_normal((3, *s)).astype(np.float32) for k, s in shapes.items()}
    payload = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx, jx = tpeft.lora_exchanger(), jpeft.lora_exchanger()

    def port(loc, pay):
        pulled = tx.pull(pay, loc)
        return pulled, tx.push({k: 2 * v for k, v in pulled.items()}, pulled)

    tpulled, tpushed = torch.func.vmap(port, in_dims=(0, None), randomness="error")(
        {k: torch.tensor(v) for k, v in local.items()},
        {k: torch.tensor(v) for k, v in payload.items()})

    def jport(loc, pay):
        pulled = jx.pull(pay, loc)
        return pulled, jx.push(jax.tree_util.tree_map(lambda v: 2 * v, pulled), pulled)

    jpulled, jpushed = jax.vmap(jport, in_axes=(0, None))(
        convert.torch_to_flax({k: torch.tensor(v) for k, v in local.items()}),
        convert.torch_to_flax({k: torch.tensor(v) for k, v in payload.items()}))
    for got, want in ((tpulled, jpulled), (tpushed, jpushed)):
        want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, want))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    mask = tx.mask(payload)
    for k in shapes:  # exchanged leaves come from the payload, the rest stay local
        want = np.broadcast_to(payload[k], local[k].shape) if mask[k] else local[k]
        np.testing.assert_array_equal(tpulled[k].numpy(), want)
        if not mask[k]:
            assert torch.equal(tpushed[k], torch.zeros_like(tpushed[k]))


def test_select_and_merge_by_path():
    params = {"a/b": torch.ones(2), "a/c": torch.zeros(3), "d": torch.full((1,), 5.0)}
    mask = ptu.select_by_path(params, lambda p: p.startswith("a."))
    assert mask == {"a/b": True, "a/c": True, "d": False}
    other = {k: -v for k, v in params.items()}
    merged = ptu.merge_by_mask(mask, other, params)
    assert torch.equal(merged["a/b"], -params["a/b"]) and merged["d"] is params["d"]
    cast = ptu.tree_astype({**params, "i": torch.ones(2, dtype=torch.int32)}, torch.bfloat16)
    assert cast["a/b"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


def test_lora_tree_converts_and_applies_like_flax():
    """A flax LoRA tree (adapters made non-zero) carried into the port by
    path: the same logits within 1e-4 (the transformer tests' bound), no
    change to the converter needed."""
    cfg = dict(vocab_size=40, n_classes=3, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_len=12, lora_rank=4)
    x = np.random.default_rng(1).integers(1, 40, size=(3, 12)).astype(np.int32)
    x[2, 7:] = 0
    jm = JTransformer(**cfg)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32) * 0.1
                      if str(p[-1].key) == "lora_b" else v), params)
    want = jm.apply({"params": params}, jnp.asarray(x), train=False)[0]["prediction"]
    tparams = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    tm = TTransformer(**cfg)
    assert set(tparams) == set(param_dict(tm))
    got = torch.func.functional_call(tm, {k.replace("/", "."): v for k, v in tparams.items()},
                                     (torch.tensor(x),), {"train": False})[0]["prediction"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    back = convert.torch_to_flax(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
