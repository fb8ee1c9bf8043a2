"""Dict inputs (multi-input models, the reference's ``DictionaryDataset``)
in the port against the JAX package on the CPU, the cases of
``tests/server/test_dict_inputs.py``: a federated run whose clients hold
``{"a": ..., "b": ...}`` features, within 5e-4 of JAX's; the round's
gathered dict batches equal to the concatenated single-array pipeline's and
to JAX's; ``epoch_batches`` over a dict; and the three row and structure
errors."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.transformer import LoraDense
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

DIM_A, DIM_B, CLASSES = 6, 3, 3
TOL = 5e-4


class JTwoInputNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        h = jnp.concatenate([x["a"], x["b"]], axis=-1)
        h = fnn.relu(fnn.Dense(16)(h))
        return {"prediction": fnn.Dense(CLASSES)(h)}, {"features": h}


class TTwoInputNet(nn.Module):
    """The same two-input model: the named inputs concatenated, two Dense."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = LoraDense(DIM_A + DIM_B, 16, dtype=None)
        self.Dense_1 = LoraDense(16, CLASSES, dtype=None)

    def init_params(self, generator):
        return _init_params(self, generator)

    def forward(self, x):
        h = torch.relu(self.Dense_0(torch.cat([x["a"], x["b"]], dim=-1)))
        return {"prediction": self.Dense_1(h)}, {"features": h}


class TConcatNet(TTwoInputNet):
    def forward(self, x):
        h = torch.relu(self.Dense_0(x))
        return {"prediction": self.Dense_1(h)}, {"features": h}


def _client_data(seed, n=20):
    g = np.random.default_rng(seed)
    a = g.normal(size=(n, DIM_A)).astype(np.float32)
    b = g.normal(size=(n, DIM_B)).astype(np.float32)
    y = g.integers(0, CLASSES, n).astype(np.int32)
    return a, b, y


def _dict_datasets(cls):
    out = []
    for i in range(3):
        a, b, y = _client_data(i)
        out.append(cls(x_train={"a": a[:16], "b": b[:16]}, y_train=y[:16],
                       x_val={"a": a[16:], "b": b[16:]}, y_val=y[16:]))
    return out


def _tsim(model, datasets):
    return tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(model), tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=datasets, batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=4,
        device="cpu")


def _jsim(datasets):
    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JTwoInputNet()),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(), datasets=datasets, batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2, seed=4)


def test_dict_round_matches_jax():
    js = _jsim(_dict_datasets(jsim.ClientDataset))
    ts = _tsim(TTwoInputNet(), _dict_datasets(tsim.ClientDataset))
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist, thist = js.fit(2), ts.fit(2)
    assert len(thist) == 2
    for tr, jr in zip(thist, jhist):
        assert abs(tr.fit_losses["backward"] - jr.fit_losses["backward"]) <= TOL
        assert abs(tr.eval_losses["checkpoint"] - jr.eval_losses["checkpoint"]) <= TOL
        assert tr.eval_metrics["accuracy"] == pytest.approx(jr.eval_metrics["accuracy"])
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=TOL, rtol=0)


def test_gathered_batches_match_concatenated_and_jax():
    dict_sets = _dict_datasets(tsim.ClientDataset)
    concat_sets = [tsim.ClientDataset(
        x_train=np.concatenate([d.x_train["a"], d.x_train["b"]], -1), y_train=d.y_train,
        x_val=np.concatenate([d.x_val["a"], d.x_val["b"]], -1), y_val=d.y_val)
        for d in dict_sets]
    sim_dict, sim_cat = _tsim(TTwoInputNet(), dict_sets), _tsim(TConcatNet(), concat_sets)
    b_dict, b_cat = sim_dict._round_batches(1), sim_cat._round_batches(1)
    b_jax = _jsim(_dict_datasets(jsim.ClientDataset))._round_batches(1)
    np.testing.assert_array_equal(
        torch.cat([b_dict.x["a"], b_dict.x["b"]], dim=-1).numpy(), b_cat.x.numpy())
    for k in ("a", "b"):
        np.testing.assert_array_equal(b_dict.x[k].numpy(), np.asarray(b_jax.x[k]))
    np.testing.assert_array_equal(b_dict.y.numpy(), b_cat.y.numpy())
    np.testing.assert_array_equal(b_dict.y.numpy(), np.asarray(b_jax.y))
    np.testing.assert_array_equal(b_dict.example_mask.numpy(), b_cat.example_mask.numpy())
    # and the dict pipeline trains on those batches
    assert np.isfinite(sim_dict.fit(1)[-1].fit_losses["backward"])


def test_epoch_batches_with_dict_x_matches_jax():
    a, b, y = _client_data(3)
    want = jengine.epoch_batches(jax.random.PRNGKey(5),
                                 {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                 jnp.asarray(y), batch_size=8)
    got = tengine.epoch_batches(rng.PRNGKey(5), {"a": torch.tensor(a), "b": torch.tensor(b)},
                                torch.tensor(y), batch_size=8)
    assert got.x["a"].shape[1:] == (8, DIM_A) and got.x["b"].shape[1:] == (8, DIM_B)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got.x[k].numpy(), np.asarray(want.x[k]))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.example_mask.numpy(), np.asarray(want.example_mask))
    np.testing.assert_array_equal(got.step_mask.numpy(), np.asarray(want.step_mask))


def test_pad_batch_stacks_over_dict_x_matches_jax():
    a, b, y = _client_data(4)
    stacks_t, stacks_j = [], []
    for seed, n in ((0, 20), (1, 9)):
        stacks_j.append(jengine.epoch_batches(
            jax.random.PRNGKey(seed), {"a": jnp.asarray(a[:n]), "b": jnp.asarray(b[:n])},
            jnp.asarray(y[:n]), batch_size=4))
        stacks_t.append(tengine.epoch_batches(
            rng.PRNGKey(seed), {"a": torch.tensor(a[:n]), "b": torch.tensor(b[:n])},
            torch.tensor(y[:n]), batch_size=4))
    want, got = jengine.pad_batch_stacks(stacks_j), tengine.pad_batch_stacks(stacks_t)
    assert got.step_mask.shape == (2, 5)
    for g, w in zip((got.x["a"], got.x["b"], got.y, got.example_mask, got.step_mask),
                    (want.x["a"], want.x["b"], want.y, want.example_mask, want.step_mask)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_y_leaf_row_disagreement_raises_in_epoch_batches():
    with pytest.raises(ValueError, match="disagree on example count"):
        tengine.epoch_batches(rng.PRNGKey(0), torch.zeros((10, 3)),
                              torch.zeros((8,), dtype=torch.int32), batch_size=4)


def test_leaf_row_disagreement_raises():
    a, b, y = _client_data(0)
    with pytest.raises(ValueError, match="disagree on example count"):
        _tsim(TTwoInputNet(), [tsim.ClientDataset(
            x_train={"a": a[:16], "b": b[:10]}, y_train=y[:16],
            x_val={"a": a[16:], "b": b[16:]}, y_val=y[16:])])


def test_structure_mismatch_across_clients_raises():
    a, b, y = _client_data(0)
    good = tsim.ClientDataset(x_train={"a": a[:16], "b": b[:16]}, y_train=y[:16],
                              x_val={"a": a[16:], "b": b[16:]}, y_val=y[16:])
    bad = tsim.ClientDataset(x_train={"a": a[:16]}, y_train=y[:16],
                             x_val={"a": a[16:]}, y_val=y[16:])
    with pytest.raises(ValueError, match="structure"):
        _tsim(TTwoInputNet(), [good, bad])
