"""FedOpt in the port (``strategies/fedopt.py``) against the JAX package on
the CPU: the four factories' aggregation over 3 rounds of seeded client
packets within 1e-6, a round with no client keeping the old state, the
optax-state converter mid-run, and ``examples/fedopt_example``'s
configuration (MnistNet, 4 Dirichlet clients, SGD 0.1 clients, FedOpt(adam
0.01)) for 5 rounds: within 5e-4 (the tolerance of the port's other runs
against JAX, f32) for 4 rounds, and within JAX's own one-ulp sensitivity
for the fifth."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.partitioners import DirichletLabelBasedAllocation
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.datasets.vision import federated_client_datasets
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import MnistNet as JMnistNet
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies import fedopt as jfedopt
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies import fedopt as tfedopt
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults

FN_TOL = 1e-6
TOL = 5e-4
SHAPES = {"Dense_0": {"kernel": (5, 3), "bias": (3,)}, "Dense_1": {"kernel": (3, 2)}}
FACTORIES = {
    "fed_adam": dict(lr=0.1), "fed_yogi": dict(lr=0.1), "fed_adagrad": dict(lr=0.1),
    "fed_avg_m": dict(lr=1.0, momentum=0.9),
}


def _tree(rng, lead=()):
    return {m: {k: rng.standard_normal((*lead, *s)).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _flat(tree) -> np.ndarray:
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values()):
        tree = convert.torch_to_flax(tree)
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _aggregate_rounds(name, masks):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    jstrat = getattr(jfedopt, name)(**FACTORIES[name])
    tstrat = getattr(tfedopt, name)(**FACTORIES[name])
    jstate = jstrat.init(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = tstrat.init(convert.flax_to_torch(params))
    counts = np.asarray([10.0, 30.0, 20.0], np.float32)
    for r, mask in enumerate(masks):
        packets = _tree(rng, lead=(3,))
        mask = np.asarray(mask, np.float32)
        jstate = jstrat.aggregate(jstate, JFitResults(
            packets=jax.tree_util.tree_map(jnp.asarray, packets),
            sample_counts=jnp.asarray(counts), train_losses={}, train_metrics={},
            mask=jnp.asarray(mask)), r + 1)
        tstate = tstrat.aggregate(tstate, TFitResults(
            packets=convert.flax_to_torch(packets), sample_counts=torch.tensor(counts),
            train_losses={}, train_metrics={}, mask=torch.tensor(mask)), r + 1)
        np.testing.assert_allclose(_flat(tstate.params), _flat(jstate.params),
                                   rtol=FN_TOL, atol=FN_TOL, err_msg=f"round {r + 1}")
    return jstate, tstate


@pytest.mark.parametrize("n", [3, 4, 32, 64])
def test_weighted_mean_sums_as_xla_does(n):
    """The masked weighted mean equals JAX's jitted one bit for bit, a
    client of weight 0 and identical rows (a leaf no client moved)
    included: FedOpt's Adam turns the last bit of such a pseudo-gradient
    into a step. Up to 32 clients as one fused multiply-add a client,
    beyond in XLA's windows of 32 rows."""
    from fl4health_tpu.core import aggregate as jagg
    from fl4health_tpu_torch.core import aggregate as tagg

    rng = np.random.default_rng(n)
    tree = {"a": rng.standard_normal((n, 300, 7)).astype(np.float32),
            "b": rng.standard_normal((n, 5)).astype(np.float32)}
    tree["a"][:, :100] = tree["a"][:1, :100]
    w = rng.random(n).astype(np.float32)
    w[1] = 0.0
    w = (w / w.sum()).astype(np.float32)
    want = jax.jit(jagg.weighted_mean)(jax.tree_util.tree_map(jnp.asarray, tree),
                                       jnp.asarray(w))
    got = tagg.weighted_mean({k: torch.tensor(v) for k, v in tree.items()}, torch.tensor(w))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_aggregates_like_jax(name):
    jstate, tstate = _aggregate_rounds(name, [[1, 1, 1], [1, 0, 1], [0, 1, 1]])
    conv = convert.optax_state_to_torch(jax.tree_util.tree_map(np.asarray,
                                                               jstate.opt_state))
    assert type(tstate.opt_state) is type(conv)
    for got, want in zip(ptu.tree_leaves(tstate.opt_state), ptu.tree_leaves(conv)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FN_TOL, atol=FN_TOL)
    lr = tstate.opt_state.hyperparams["learning_rate"]
    assert lr.ndim == 0 and lr.dtype == torch.float32
    assert float(lr) == pytest.approx(FACTORIES[name]["lr"])


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_round_with_no_client_keeps_the_state(name):
    _, tstate = _aggregate_rounds(name, [[1, 1, 1]])
    tstrat = getattr(tfedopt, name)(**FACTORIES[name])
    packets = convert.flax_to_torch(_tree(np.random.default_rng(2), lead=(3,)))
    after = tstrat.aggregate(tstate, TFitResults(
        packets=packets, sample_counts=torch.ones(3), train_losses={}, train_metrics={},
        mask=torch.zeros(3)), 2)
    for a, b in zip(ptu.tree_leaves(after), ptu.tree_leaves(tstate)):
        assert torch.equal(a, b)


def test_converted_state_continues_like_jax():
    """Both packages resume from the same mid-run server state (the optax
    state converted) and take the same next step."""
    jstate, _ = _aggregate_rounds("fed_adam", [[1, 1, 1], [1, 1, 0]])
    tstrat = tfedopt.fed_adam(lr=0.1)
    jstrat = jfedopt.fed_adam(lr=0.1)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = tfedopt.FedOptState(params=convert.flax_to_torch(host.params),
                                 opt_state=convert.optax_state_to_torch(host.opt_state))
    packets = _tree(np.random.default_rng(5), lead=(3,))
    counts = np.asarray([1.0, 2.0, 3.0], np.float32)
    jnext = jstrat.aggregate(jstate, JFitResults(
        packets=jax.tree_util.tree_map(jnp.asarray, packets),
        sample_counts=jnp.asarray(counts), train_losses={}, train_metrics={},
        mask=jnp.ones(3)), 3)
    tnext = tstrat.aggregate(tstate, TFitResults(
        packets=convert.flax_to_torch(packets), sample_counts=torch.tensor(counts),
        train_losses={}, train_metrics={}, mask=torch.ones(3)), 3)
    np.testing.assert_allclose(_flat(tnext.params), _flat(jnext.params), rtol=FN_TOL,
                               atol=FN_TOL)


def _fedopt_example_sims(jdata):
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMnistNet(hidden=32)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.1), strategy=jfedopt.FedOpt(optax.adam(0.01)), datasets=jdata,
        batch_size=32, metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1,
        seed=42, execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(
            tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1))), tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=tfedopt.FedOpt(optim.adam(0.01)),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in jdata],
        batch_size=32, metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1,
        seed=42, device="cpu")
    return js, ts


def test_fedopt_example_matches_jax():
    """examples/fedopt_example/config.yaml: 5 rounds, 4 clients, batch 32,
    one local epoch, client SGD(0.1), server adam(0.01), MnistNet(hidden 32)
    on the examples' synthetic 14x14 MNIST-shaped corpus.

    The server's Adam (eps 1e-8) turns a pseudo-gradient of 1e-8, a leaf
    the clients barely moved, into a step of about lr, so the last bits of
    the clients' updates steer whole steps: this configuration is chaotic.
    Rounds 1-4 hold to 5e-4. Round 5 and the final params are held to how
    far JAX moves from itself when its initial params move one ulp (the
    port stays closer to JAX than that in every round)."""
    x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(0), 960, (14, 14, 1), 10,
                                           class_sep=1.2))
    part = DirichletLabelBasedAllocation(number_of_partitions=4,
                                         unique_labels=list(range(10)), beta=0.8,
                                         min_label_examples=1, hash_key=42)
    jdata = federated_client_datasets(x, y, n_clients=4, partitioner=part, hash_key=7)
    js, ts = _fedopt_example_sims(jdata)
    js_ulp, _ = _fedopt_example_sims(jdata)
    init = jax.tree_util.tree_map(np.asarray, js.global_params)
    js_ulp.set_global_params(jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(a, np.float32(np.inf))), init))
    ts.set_global_params(convert.flax_to_torch(init))
    jhist, ulp_hist, thist = js.fit(5), js_ulp.fit(5), ts.fit(5)
    for tr, jr, ur in zip(thist, jhist, ulp_hist):
        for kind, key in (("fit_losses", "backward"), ("eval_losses", "checkpoint")):
            want = getattr(jr, kind)[key]
            gap = abs(getattr(tr, kind)[key] - want)
            bound = TOL if tr.round <= 4 else max(TOL, abs(getattr(ur, kind)[key] - want))
            assert gap <= bound, (tr.round, key, gap, bound)
    jflat = _flat(js.global_params)
    gap = np.abs(_flat(ts.global_params) - jflat).max()
    assert gap <= np.abs(_flat(js_ulp.global_params) - jflat).max(), gap
    # the losses fell, and the server's Adam took a step each round
    assert thist[-1].eval_losses["checkpoint"] < thist[0].eval_losses["checkpoint"]
    assert int(ts.server_state.opt_state[0].count) == 5
