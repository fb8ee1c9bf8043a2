"""The port's msgpack codec (``fl4health_tpu_torch/checkpointing/serialization.py``)
against ``flax.serialization`` byte for byte: nested dicts, lists, tuples
and namedtuples of f32, bf16, int32, uint32, bool and int64 leaves and of
numpy scalars and Python scalars; the ``__msgpack_chunked_array__`` split
with ``MAX_CHUNK_SIZE`` patched small in both packages; flax's bytes decoded
by the port; and the params files: the port's ``save_params`` of converted
params writes JAX's ``save_params`` bytes for the same params (as JAX's round
programs hold them: a tree-mapped dict, keys sorted), and each package loads
the other's file."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import collections

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.checkpointing import checkpointer as jckpt
from fl4health_tpu.models.cnn import CifarNet as JCifarNet
from fl4health_tpu_torch.checkpointing import checkpointer as tckpt
from fl4health_tpu_torch.checkpointing import serialization as tser
from fl4health_tpu_torch.models import convert

NT = collections.namedtuple("NT", ["count", "scale"])
R = np.random.default_rng(0)
LEAVES = {
    "f32": R.standard_normal((3, 4)).astype(np.float32),
    "bf16": R.standard_normal((5,)).astype(np.float32),
    "i32": np.arange(-3, 4, dtype=np.int32),
    "u32": np.array([0, 1, 2**31, 2**32 - 1], np.uint32),
    "bool": np.array([True, False, True]),
    "i64": np.arange(-2, 300, dtype=np.int64),
}


def _jax_leaf(name):
    # int64 stays numpy: JAX without x64 would narrow it to int32
    a = LEAVES[name]
    if name == "i64":
        return a
    return jnp.asarray(a, jnp.bfloat16) if name == "bf16" else jnp.asarray(a)


def _torch_leaf(name):
    a = LEAVES[name]
    if name == "bf16":
        return torch.tensor(a).to(torch.bfloat16)
    if name == "u32":
        return torch.tensor(a.astype(np.int64)).to(torch.uint32)
    return torch.from_numpy(a.copy())


def _tree(leaf):
    return {"z": {"w": leaf("f32"), "bf": leaf("bf16")},
            "a": [leaf("i32"), (leaf("u32"), leaf("bool"))],
            "nt": NT(leaf("i64"), np.float32(2.5)),
            "scalars": {"npi": np.int64(-3), "npf": np.float64(0.25), "int": 1,
                        "neg": -40000, "big": 70000, "huge": 2**40, "float": 2.5,
                        "none": None, "true": True, "str": "hello" * 10, "empty": ()}}


def test_to_bytes_equals_flax():
    want = fser.to_bytes(_tree(_jax_leaf))
    got = tser.to_bytes(_tree(_torch_leaf))
    assert got == want


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_each_dtype_leaf_equals_flax(name):
    assert tser.to_bytes({"x": _torch_leaf(name)}) == fser.to_bytes({"x": _jax_leaf(name)})
    assert tser.to_bytes({"x": LEAVES[name]}) == fser.to_bytes({"x": LEAVES[name]})


def test_msgpack_serialize_sorts_keys_like_flax():
    tree = {"k": [np.ones(3, np.float32), [1, 2]], "a": {"c": np.int32(4), "b": [1.5]}}
    assert tser.msgpack_serialize(tree) == fser.msgpack_serialize(tree)
    assert (tser.msgpack_serialize(dict(tree), in_place=True)
            == fser.msgpack_serialize(dict(tree), in_place=True))


def test_chunked_leaf_equals_flax(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 16)
    tree = {"w": np.arange(10, dtype=np.float32), "n": {"v": np.arange(9, dtype=np.int64)},
            "small": np.arange(3, dtype=np.int32)}
    want = fser.to_bytes(tree)
    assert tser.to_bytes(tree) == want
    assert tser.msgpack_serialize(tree) == fser.msgpack_serialize(tree)
    back = tser.msgpack_restore(want)
    for k, v in (("w", tree["w"]), ("small", tree["small"])):
        np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(back["n"]["v"], tree["n"]["v"])


def test_port_decodes_flax_bytes():
    tmpl = _tree(_torch_leaf)
    back = tser.from_bytes(tmpl, fser.to_bytes(_tree(_jax_leaf)))
    assert isinstance(back["nt"], NT) and isinstance(back["a"][1], tuple)
    assert back["z"]["bf"].dtype == torch.bfloat16
    assert torch.equal(back["z"]["bf"], _torch_leaf("bf16"))
    for name, got in (("f32", back["z"]["w"]), ("i32", back["a"][0]),
                      ("u32", back["a"][1][0]), ("bool", back["a"][1][1]),
                      ("i64", back["nt"].count)):
        assert got.dtype == LEAVES[name].dtype
        np.testing.assert_array_equal(got, LEAVES[name])
    assert back["nt"].scale == np.float32(2.5) and type(back["nt"].scale) is np.float32
    assert back["scalars"] == {**_tree(_torch_leaf)["scalars"], "empty": ()}


def test_flax_decodes_port_bytes():
    back = fser.from_bytes(_tree(_jax_leaf), tser.to_bytes(_tree(_torch_leaf)))
    np.testing.assert_array_equal(np.asarray(back["z"]["bf"], np.float32),
                                  np.asarray(_jax_leaf("bf16"), np.float32))
    np.testing.assert_array_equal(back["a"][1][0], LEAVES["u32"])


def _cifar_params():
    p = JCifarNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    # as JAX's round programs hold them: tree-mapped (each level's keys sorted)
    return jax.tree_util.tree_map(np.asarray, p)


def test_save_params_bytes_equal_and_files_cross_load(tmp_path):
    jparams = _cifar_params()
    tparams = convert.flax_to_torch(jparams)
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_params(jpath, jparams)
    tckpt.save_params(tpath, tparams)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    loaded = tckpt.load_params(jpath, {k: torch.zeros_like(v) for k, v in tparams.items()})
    assert list(loaded) == list(tparams)
    for k in tparams:
        assert torch.equal(loaded[k], tparams[k])
    back = jckpt.load_params(tpath, jax.tree_util.tree_map(np.zeros_like, jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), b)
