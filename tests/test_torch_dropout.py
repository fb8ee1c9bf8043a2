"""Dropout in the port's transformer against flax on the CPU: every
``Dropout`` of a 2-layer model draws flax's mask bit for bit (its key is
flax's ``make_rng`` key: the module path and the scope's counter, hashed),
with remat and without; a 2-round federated run with ``dropout_rate`` 0.1
agrees with JAX within 5e-4 (f32, the reference's tolerance); evaluation
draws no mask."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen.stochastic as flax_stochastic

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_text_classification as jtext
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models import transformer as ttr
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

TOL = 5e-4
CFG = dict(vocab_size=48, n_classes=3, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=10)


def _tokens(b=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(1, CFG["vocab_size"], size=(b, CFG["max_len"])).astype(np.int32)
    x[1, 6:] = 0  # a ragged pad tail
    return x


def _jax_masks(remat: bool, key_seed: int, monkeypatch):
    """(key words, mask) of every bernoulli draw of one train-mode grad of
    the flax model, in draw order."""
    drawn = []
    orig = flax_stochastic.random.bernoulli

    def recording(key, p=0.5, shape=None):
        mask = orig(key, p, shape)
        jax.debug.callback(lambda k, m: drawn.append((tuple(np.asarray(k).tolist()),
                                                      np.asarray(m))),
                           jax.random.key_data(key), mask)
        return mask

    monkeypatch.setattr(flax_stochastic.random, "bernoulli", recording)
    model = JTransformer(**CFG, dropout_rate=0.1, remat=remat)
    x = jnp.asarray(_tokens())
    params = model.init(jax.random.PRNGKey(0), x, train=False)["params"]
    key = jax.random.PRNGKey(key_seed)
    jax.grad(lambda p: model.apply({"params": p}, x, train=True, rngs={"dropout": key})[0]
             ["prediction"].sum())(params)
    monkeypatch.undo()
    return drawn, params


def _port_masks(remat: bool, key_seed: int, params, monkeypatch):
    drawn = []
    orig = ttr.dropout_mask

    def plain(t):  # the remat's recompute runs under torch.func.vjp's wrappers
        while torch._C._functorch.is_functorch_wrapped_tensor(t):
            t = torch._C._functorch.get_unwrapped(t)
        with torch._C._DisableFuncTorch():
            return t.numpy().copy()

    def recording(key, shape, rate):
        mask = orig(key, shape, rate)
        drawn.append((tuple(plain(key).tolist()), plain(mask)))
        return mask

    monkeypatch.setattr(ttr, "dropout_mask", recording)
    model = ttr.TransformerClassifier(**CFG, dropout_rate=0.1, remat=remat)
    tparams = {k: v.requires_grad_(True)
               for k, v in convert.flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                        params)).items()}
    named = {k.replace("/", "."): v for k, v in tparams.items()}
    out = torch.func.functional_call(model, named, (torch.tensor(_tokens()),),
                                     {"train": True, "rng": rng.PRNGKey(key_seed)})
    out[0]["prediction"].sum().backward()
    monkeypatch.undo()
    return drawn


@pytest.mark.parametrize("remat", [False, True])
def test_masks_equal_flax_bit_for_bit(remat, monkeypatch):
    jdrawn, params = _jax_masks(remat, 5, monkeypatch)
    tdrawn = _port_masks(remat, 5, params, monkeypatch)
    # 3 dropouts a layer (probabilities, after attention, after the MLP);
    # remat redraws each in the backward's recompute
    assert len(jdrawn) == len(tdrawn) == 6 * (2 if remat else 1)
    jby, tby = {}, {}
    for by, drawn in ((jby, jdrawn), (tby, tdrawn)):
        for key, mask in drawn:
            if key in by:  # a recompute draws the same mask from the same key
                np.testing.assert_array_equal(by[key], mask)
            by[key] = mask
    assert set(jby) == set(tby) and len(jby) == 6
    for key, mask in jby.items():
        assert tby[key].dtype == np.bool_ and tby[key].shape == mask.shape
        np.testing.assert_array_equal(tby[key], mask)
    assert 0.8 < np.mean([m.mean() for m in jby.values()]) < 1.0


def test_keys_follow_flax_paths():
    key = rng.PRNGKey(3)
    want = jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(3), jnp.uint32(ttr.flax_scope_hash(("layer_1", "Dropout_0", 1)))))
    assert ttr.dropout_key(key, ("layer_1", "Dropout_0")).tolist() == np.asarray(
        want).tolist()


def _sims(dropout_rate=0.1, remat=True):
    datasets = []
    for i in range(2):
        x, y = jtext(jax.random.PRNGKey(40 + i), 40, CFG["vocab_size"], CFG["max_len"],
                     CFG["n_classes"], class_sep=2.0)
        datasets.append(jsim.ClientDataset(x[:30], y[:30], x[30:], y[30:]))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JTransformer(
            **CFG, dropout_rate=dropout_rate, remat=remat)), jengine.masked_cross_entropy),
        tx=optax.sgd(0.1), strategy=JFedAvg(), datasets=datasets, batch_size=10,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=3, seed=5,
        execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(ttr.TransformerClassifier(
            **CFG, dropout_rate=dropout_rate, remat=remat)), tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*(np.asarray(a) for a in (d.x_train, d.y_train,
                                                                d.x_val, d.y_val)))
                  for d in datasets],
        batch_size=10, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=3,
        seed=5, device="cpu")
    ts.set_global_params(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                      js.global_params)))
    return js, ts


def test_two_rounds_with_dropout_match_jax():
    """SGD: under Adam, a leaf whose true gradient is zero (the key
    projection's bias: softmax ignores a shift of every score) takes
    lr-sized steps steered by rounding noise, in either package."""
    js, ts = _sims()
    jhist, thist = js.fit(2), ts.fit(2)
    for tr, jr in zip(thist, jhist, strict=True):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k in want:
        np.testing.assert_allclose(ts.global_params[k].numpy(), want[k].numpy(), atol=TOL,
                                   rtol=0, err_msg=k)
    # dropout changed the trajectory: the same run without it differs
    _, ts0 = _sims(dropout_rate=0.0)
    assert abs(ts0.fit(2)[0].fit_losses["backward"] - thist[0].fit_losses["backward"]) > 1e-4


def test_no_dropout_at_eval(monkeypatch):
    model = ttr.TransformerClassifier(**CFG, dropout_rate=0.5)
    plain = ttr.TransformerClassifier(**CFG)
    params = model.init_params(torch.Generator().manual_seed(1))
    named = {k.replace("/", "."): v for k, v in params.items()}
    x = torch.tensor(_tokens())
    calls = []
    monkeypatch.setattr(ttr, "dropout_mask", lambda *a: calls.append(a))
    with torch.no_grad():
        a = torch.func.functional_call(model, named, (x,), {"train": False,
                                                            "rng": rng.PRNGKey(0)})
        b = torch.func.functional_call(plain, named, (x,), {"train": False})
    assert not calls
    assert torch.equal(a[0]["prediction"], b[0]["prediction"])
    with pytest.raises(ValueError, match="needs the model's rng"):
        torch.func.functional_call(model, named, (x,), {"train": True})
