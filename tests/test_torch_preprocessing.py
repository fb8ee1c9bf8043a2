"""Warm starts and the autoencoder preprocessing of the port against the
JAX package on the CPU.

- The same ``.npz`` (JAX's ``save_checkpoint``, and the port's, whose file
  holds the same arrays), ``.pt`` (a torch state dict in Linear's ``[out,
  in]`` convention, with an embedding table) and ``.safetensors`` file give
  the same warm-started tree in both packages, through prefix mappings and
  a shape mismatch that keeps the fresh init; bit for bit.
- ``AutoEncoderDatasetConverter`` (no condition, the label, one-hot, a
  fixed vector) and its unpacking bit for bit; the four latent processors
  and ``PcaPreprocessor`` at 1e-5 (``rng.normal`` is within 2 ulp of
  JAX's), their keys split once a call as JAX's.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.models.autoencoders import PcaModule as JPca
from fl4health_tpu.preprocessing import autoencoders as jae
from fl4health_tpu.preprocessing import checkpoint_io as jio
from fl4health_tpu.preprocessing.warm_up import WarmedUpModule as JWarm
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.autoencoders import PcaModule as TPca
from fl4health_tpu_torch.preprocessing import autoencoders as tae
from fl4health_tpu_torch.preprocessing import checkpoint_io as tio
from fl4health_tpu_torch.preprocessing.warm_up import WarmedUpModule as TWarm

FN_TOL = 1e-5


def _params(seed, hidden=5):
    r = np.random.default_rng(seed)
    return {"global_model": {"Dense_0": {"kernel": r.standard_normal((4, hidden))
                                         .astype(np.float32),
                                         "bias": r.standard_normal(hidden).astype(np.float32)},
                             "Dense_1": {"kernel": r.standard_normal((hidden, 3))
                                         .astype(np.float32),
                                         "bias": r.standard_normal(3).astype(np.float32)}},
            "Embed_0": {"embedding": r.standard_normal((7, 4)).astype(np.float32)},
            "head": {"kernel": r.standard_normal((4, 2)).astype(np.float32)}}


def _port(tree):
    return convert.flax_to_torch(tree)


def _same(port_params, jax_params):
    want = _port(jax.tree_util.tree_map(np.asarray, jax_params))
    assert list(port_params) == sorted(want) and set(port_params) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(port_params[k]), want[k].numpy(), err_msg=k)


MAPPINGS = [None, {"global_model": "", "Embed_0": "Embed_0", "head": "head"},
            {"global_model.Dense_0": "Dense_0"}]


@pytest.mark.parametrize("mapping", MAPPINGS, ids=["none", "strip", "partial"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_npz_warm_starts_both_packages_alike(tmp_path, mapping, writer):
    pretrained = _params(1)
    if mapping is not None:  # a checkpoint saved from a model without the prefix
        pretrained = {**pretrained["global_model"], "Embed_0": pretrained["Embed_0"],
                      "head": {"kernel": np.zeros((3, 3), np.float32)}}  # a shape mismatch
    path = (jio.save_checkpoint(tmp_path / "ckpt", pretrained) if writer == "jax"
            else tio.save_checkpoint(tmp_path / "ckpt", _port(pretrained)))
    assert path.suffix == ".npz" and path.exists()
    fresh = _params(2)
    want = jio.warm_up_from_file(fresh, path, mapping)
    got = tio.warm_up_from_file(_port(fresh), path, mapping)
    _same(got, want)
    if mapping is not None:  # the mismatched head kept its fresh init
        np.testing.assert_array_equal(got["head/kernel"].numpy(), fresh["head"]["kernel"])


def test_the_port_writes_the_npz_jax_writes(tmp_path):
    tree = _params(3)
    a = np.load(jio.save_checkpoint(tmp_path / "j.npz", tree))
    b = np.load(tio.save_checkpoint(tmp_path / "t.npz", _port(tree)))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def _torch_state_dict(tree):
    """A torch state dict of ``tree``: Linear weights ``[out, in]``, the
    embedding table as it is, dotted names."""
    sd = {}
    for path, leaf in tio.flatten_params(_port(tree)).items():
        if path.endswith(".kernel") and leaf.ndim == 2:
            sd[path[:-len("kernel")] + "weight"] = torch.tensor(leaf.T.copy())
        else:
            sd[path] = torch.tensor(leaf)
    return sd


@pytest.mark.parametrize("suffix", [".pt", ".bin", ".safetensors"])
def test_a_torch_file_warm_starts_both_packages_alike(tmp_path, suffix):
    pretrained = _params(4)
    sd = _torch_state_dict(pretrained)
    path = tmp_path / f"model{suffix}"
    if suffix == ".safetensors":
        safetensors_torch = pytest.importorskip("safetensors.torch")
        safetensors_torch.save_file(sd, str(path))
    else:
        torch.save(sd, path)
    want_flat = jio.load_flat_checkpoint(path, torch_linear_convention=True)
    got_flat = tio.load_flat_checkpoint(path, torch_linear_convention=True)
    assert set(got_flat) == set(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(np.asarray(got_flat[k]), want_flat[k])
    assert "Embed_0.kernel" not in got_flat  # no alias for a table
    fresh = _params(5)
    got = tio.warm_up_from_file(_port(fresh), path, torch_linear_convention=True)
    _same(got, jio.warm_up_from_file(fresh, path, torch_linear_convention=True))
    # every Dense kernel came back from its transposed weight, bit for bit
    _same(got, pretrained)


def test_warmed_up_module_matching_as_jax():
    pre = _params(6)
    mapping = {"a.b": "global_model.Dense_0", "global_model": "", "x": "head"}
    jw, tw = JWarm(pre, mapping), TWarm(_port(pre), mapping)
    for key in ("a.b.kernel", "global_model.Dense_1.bias", "x.kernel", "y.z", "a.c"):
        assert tw.get_matching_component(key) == jw.get_matching_component(key)
    assert set(tw.pretrained) == {p.replace("/", ".") for p in _port(pre)}


def test_unknown_suffix_and_missing_file_raise_as_jax(tmp_path):
    bad = tmp_path / "x.ckpt"
    bad.write_bytes(b"")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="unsupported checkpoint format"):
            mod.load_flat_checkpoint(bad)
        with pytest.raises(FileNotFoundError):
            mod.load_flat_checkpoint(tmp_path / "absent.npz")


CONDITIONS = [None, "label", "label_one_hot", "fixed"]


@pytest.mark.parametrize("condition", CONDITIONS)
def test_dataset_converter_packs_and_unpacks_as_jax(condition):
    r = np.random.default_rng(7)
    x = r.standard_normal((6, 2, 3)).astype(np.float32)
    y = r.integers(0, 4, 6).astype(np.int32)
    fixed = np.asarray([0.5, -1.0, 2.0], np.float32)
    kw = {None: {}, "label": {"condition": "label"},
          "label_one_hot": {"condition": "label", "do_one_hot_encoding": True},
          "fixed": {}}[condition]
    jconv = jae.AutoEncoderDatasetConverter(condition=jnp.asarray(fixed), **kw) \
        if condition == "fixed" else jae.AutoEncoderDatasetConverter(**kw)
    tconv = tae.AutoEncoderDatasetConverter(condition=torch.tensor(fixed), **kw) \
        if condition == "fixed" else tae.AutoEncoderDatasetConverter(**kw)
    jpacked, jtarget = jconv.convert_dataset(jnp.asarray(x), jnp.asarray(y))
    tpacked, ttarget = tconv.convert_dataset(torch.tensor(x), torch.tensor(y))
    assert str(tpacked.dtype).replace("torch.", "") == str(jpacked.dtype)
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(ttarget.numpy(), np.asarray(jtarget))
    assert tconv.get_condition_vector_size() == jconv.get_condition_vector_size()
    if condition is not None:
        jd, jc = jconv.get_unpacking_function()(jpacked)
        td, tc = tconv.get_unpacking_function()(tpacked)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _encoders(seed=8, d=6, latent=3):
    r = np.random.default_rng(seed)
    w_mu, w_lv = (r.standard_normal((d, latent)).astype(np.float32) * 0.5 for _ in range(2))
    c_w = r.standard_normal((2, latent)).astype(np.float32)

    def jenc(x):
        return x @ w_mu, x @ w_lv

    def tenc(x):
        return x @ torch.tensor(w_mu), x @ torch.tensor(w_lv)

    def jcenc(x, c):
        return x @ w_mu + c @ c_w, x @ w_lv

    def tcenc(x, c):
        return x @ torch.tensor(w_mu) + c @ torch.tensor(c_w), x @ torch.tensor(w_lv)

    return jenc, tenc, jcenc, tcenc


@pytest.mark.parametrize("mu_only", [False, True])
@pytest.mark.parametrize("seed", [0, 11])
def test_latent_processors_match_jax(mu_only, seed):
    jenc, tenc, jcenc, tcenc = _encoders()
    r = np.random.default_rng(9)
    cond = np.asarray([1.0, -0.5], np.float32)
    jp = [jae.VaeProcessor(jenc, mu_only, seed),
          jae.CvaeFixedConditionProcessor(jcenc, jnp.asarray(cond), mu_only, seed),
          jae.CvaeVariableConditionProcessor(jcenc, mu_only, seed)]
    tp = [tae.VaeProcessor(tenc, mu_only, seed),
          tae.CvaeFixedConditionProcessor(tcenc, torch.tensor(cond), mu_only, seed),
          tae.CvaeVariableConditionProcessor(tcenc, mu_only, seed)]
    for _call in range(3):  # three calls: the key splits once a call
        x = r.standard_normal((5, 6)).astype(np.float32)
        c = r.standard_normal((5, 2)).astype(np.float32)
        for i, (j, t) in enumerate(zip(jp, tp)):
            args_j = (jnp.asarray(x), jnp.asarray(c)) if i == 2 else (jnp.asarray(x),)
            args_t = (torch.tensor(x), torch.tensor(c)) if i == 2 else (torch.tensor(x),)
            np.testing.assert_allclose(t(*args_t).numpy(), np.asarray(j(*args_j)),
                                       atol=FN_TOL, rtol=0)
    ae_j = jae.AeProcessor(lambda v: jenc(v)[0])
    ae_t = tae.AeProcessor(lambda v: tenc(v)[0])
    np.testing.assert_allclose(ae_t(torch.tensor(x)).numpy(), np.asarray(ae_j(jnp.asarray(x))),
                               atol=FN_TOL, rtol=0)


def test_pca_preprocessor_matches_jax():
    r = np.random.default_rng(10)
    x = r.standard_normal((40, 7)).astype(np.float32)
    jstate = JPca().fit(jnp.asarray(x))
    from fl4health_tpu_torch.models.autoencoders import PcaState

    tstate = PcaState(*(torch.tensor(np.asarray(a)) for a in
                        (jstate.components, jstate.singular_values, jstate.data_mean)))
    for center in (False, True):
        want = jae.PcaPreprocessor(jstate).reduce_dimension(jnp.asarray(x), 3, center)
        got = tae.PcaPreprocessor(tstate, TPca()).reduce_dimension(torch.tensor(x), 3, center)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FN_TOL, rtol=0)
