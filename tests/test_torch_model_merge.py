"""Federated evaluation and model merging in the port
(``server/servers.py`` ``EvaluateServer``, ``ModelMergeServer``;
``strategies/model_merge.py``) against the JAX package on the CPU, on
``examples/federated_eval_example`` and ``model_merge_example``'s recipe
(4 clients, an ``Mlp(16)`` in place of ``MnistNet``, batch 8):

- ``EvaluateServer`` on the constructor's init, on given params and after
  a trained run: the aggregated eval losses and metrics at 5e-4;
- ``ModelMergeServer`` over distinct client params: the merged params at
  1e-6, its evaluation at 5e-4;
- ``ModelMergeStrategy``, weighted and uniform, with a dropped client and
  an empty cohort, at 1e-6."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.model_merge import ModelMergeStrategy as JMerge
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.model_merge import ModelMergeStrategy as TMerge

TOL = 5e-4
FN_TOL = 1e-6
N_CLIENTS = 4


def _flat(jtree) -> dict:
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jtree))


def _pair():
    arrays = []
    for i in range(N_CLIENTS):
        x, y = synthetic_classification(jax.random.PRNGKey(i), 40, (8,), 3)
        x, y = np.asarray(x), np.asarray(y)
        arrays.append((x[:28], y[:28], x[28:], y[28:]))
    common = dict(batch_size=8, seed=42, local_epochs=1)
    js = JSim(logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                                        jengine.masked_cross_entropy),
              tx=optax.sgd(0.1), strategy=JFedAvg(), datasets=[JDataset(*a) for a in arrays],
              metrics=JMetricManager((jefficient.accuracy(),)), **common)
    ts = TSim(logic=tengine.ClientLogic(tengine.from_module(TMlp(8, (16,), 3)),
                                        tengine.masked_cross_entropy),
              tx=optim.sgd(0.1), strategy=TFedAvg(), datasets=[TDataset(*a) for a in arrays],
              metrics=TMetricManager((tefficient.accuracy(),)), device="cpu", **common)
    ts.set_global_params(_flat(js.global_params))
    return js, ts


def _close(got: tuple, want: tuple) -> None:
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=TOL), k


def test_evaluate_server_matches_jax_on_the_init_given_params_and_a_trained_run():
    js, ts = _pair()
    _close(tservers.EvaluateServer(ts).fit(), jservers.EvaluateServer(js).fit())
    other = {k: v * 0.5 for k, v in _flat(js.global_params).items()}
    jother = jax.tree_util.tree_map(lambda v: v * 0.5, js.global_params)
    _close(tservers.EvaluateServer(ts, params=other).fit(),
           jservers.EvaluateServer(js, params=jother).fit())
    # the given params became the server's model
    for k, v in other.items():
        np.testing.assert_array_equal(ts.global_params[k].numpy(), v.numpy())
    js.fit(2)
    ts.fit(2)
    _close(tservers.EvaluateServer(ts).fit(), jservers.EvaluateServer(js).fit())
    assert ts.history[-1].eval_losses["checkpoint"] == pytest.approx(
        js.history[-1].eval_losses["checkpoint"], abs=TOL)


def test_model_merge_server_matches_jax():
    js, ts = _pair()
    r = np.random.default_rng(0)
    base = _flat(js.global_params)
    stacked = {k: np.stack([v.numpy() + r.normal(size=v.shape).astype(np.float32) * 0.1
                            for _ in range(N_CLIENTS)]) for k, v in base.items()}
    nested = {}
    for path, v in stacked.items():
        node = nested
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    js.client_states = js.client_states.replace(params=nested)
    ts.client_states = dataclasses.replace(
        ts.client_states, params={k: torch.tensor(stacked[k]) for k in ts.client_states.params})
    jmerged, jl, jm = jservers.ModelMergeServer(js).fit()
    tmerged, tl, tm = tservers.ModelMergeServer(ts).fit()
    for k, v in _flat(jmerged).items():
        np.testing.assert_allclose(tmerged[k].numpy(), v.numpy(), rtol=0, atol=FN_TOL)
        np.testing.assert_allclose(tmerged[k].numpy(), stacked[k].mean(axis=0), rtol=0,
                                   atol=FN_TOL)
    _close((tl, tm), (jl, jm))


@pytest.mark.parametrize("weighted", [False, True])
def test_model_merge_strategy_matches_jax(weighted):
    r = np.random.default_rng(1)
    shapes = {"d/kernel": (3, 2), "d/bias": (2,)}
    prev = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    packets = {k: r.normal(size=(3, *s)).astype(np.float32) for k, s in shapes.items()}
    counts = np.asarray([5.0, 10.0, 20.0], np.float32)
    for mask in ([1.0, 0.0, 1.0], [0.0, 0.0, 0.0]):
        m = np.asarray(mask, np.float32)
        jst = JMerge(weighted).init({"d": {"kernel": jnp.asarray(prev["d/kernel"]),
                                           "bias": jnp.asarray(prev["d/bias"])}})
        tst = TMerge(weighted).init({k: torch.tensor(v) for k, v in prev.items()})
        jp = {"d": {"kernel": jnp.asarray(packets["d/kernel"]),
                    "bias": jnp.asarray(packets["d/bias"])}}
        want = JMerge(weighted).aggregate(
            jst, JFitResults(jp, jnp.asarray(counts), {}, {}, jnp.asarray(m)), 1)
        got = TMerge(weighted).aggregate(
            tst, TFitResults({k: torch.tensor(v) for k, v in packets.items()},
                             torch.tensor(counts), {}, {}, torch.tensor(m)), 1)
        for k, v in _flat(want.params).items():
            np.testing.assert_allclose(got.params[k].numpy(), v.numpy(), rtol=0, atol=FN_TOL)
        if not m.any():
            for k, v in prev.items():
                np.testing.assert_array_equal(got.params[k].numpy(), v)
