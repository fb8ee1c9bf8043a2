"""SCAFFOLD in the port against the JAX package on the CPU: the engine's
``transform_gradients`` hook (after the gradients, before the optimizer, in
both train paths, and once a step on DP's noised mean), the client's
variate math, the server update with its partial-cohort scaling, the warm
start, the ``scaffold_mnist`` smoke config with its golden, and the
vmapped clients against the loop with uneven clients.

Tolerances: 5e-4 for runs against JAX (f32, the reference's), 1e-6 for
single functions, 1e-5 for the vmapped clients against the loop (batched
and per-client reductions sum in another order)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.scaffold import ScaffoldClientLogic as JScaffoldLogic
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.exchange.packer import ControlVariatesPacket as JPacket
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import CifarNet as JCifarNet
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.scaffold import Scaffold as JScaffold
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import DpScaffoldClientLogic
from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic as TScaffoldLogic
from fl4health_tpu_torch.datasets.partitioners import DirichletLabelBasedAllocation
from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
from fl4health_tpu_torch.datasets.vision import split_data_and_targets
from fl4health_tpu_torch.exchange.packer import ControlVariatesPacket as TPacket
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.scaffold import Scaffold as TScaffold

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4
FN_TOL = 1e-6
AXIS_TOL = 1e-5


def _flat(tree) -> np.ndarray:
    """A flax tree or a port ``Params`` dict as one vector, in JAX's order."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values()):
        tree = convert.torch_to_flax(tree)
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _uneven_data(n_clients=3, seed=0, width=8):
    """Uneven clients (13, 21, 29 train rows at batch 8: 2, 3 and 4 steps,
    ragged final batches), 3 classes."""
    out = []
    for i in range(n_clients):
        n_train = 13 + 8 * i
        x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(seed + i), n_train + 6,
                                               (width,), 3))
        out.append((x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def _port_sim(data, logic=None, strategy=None, lr=0.1, seed=2, width=8, **kw):
    logic = logic or TScaffoldLogic(tengine.from_module(tcnn.Mlp(width, (16,), 3)),
                                    tengine.masked_cross_entropy, learning_rate=lr)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(lr), strategy=strategy or TScaffold(),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=seed,
        device="cpu", **kw)


def _jax_sim(data, lr=0.1, seed=2):
    return jsim.FederatedSimulation(
        logic=JScaffoldLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                             jengine.masked_cross_entropy, learning_rate=lr),
        tx=optax.sgd(lr), strategy=JScaffold(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=seed,
        execution_mode="pipelined")


def _trained_states(sim):
    """The clients' states at the end of round 1's local training (before
    the evaluation pulls the new global model)."""
    mask = torch.ones((sim.n_clients,))
    return sim._fit_round(sim.server_state, sim.client_states, sim._round_batches(1), mask,
                          1, sim._val_batches()[0])[1]


def _install(ts, js):
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)
    return init


# ---------------------------------------------------------------------------
# The engine hook
# ---------------------------------------------------------------------------

class _ZeroingLogic(tengine.ClientLogic):
    """Zeroes every gradient in ``transform_gradients`` and counts the calls
    and the shapes it was handed."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def transform_gradients(self, grads, state, ctx):
        self.calls.append({k: tuple(g.shape) for k, g in grads.items()})
        return {k: torch.zeros_like(g) for k, g in grads.items()}


@pytest.mark.parametrize("early_stopping", [None, tengine.EarlyStoppingConfig(2, 1)],
                         ids=["plain", "early_stopping"])
def test_transform_gradients_runs_between_grads_and_optimizer(early_stopping):
    # zeroed before the optimizer: no client's params move, on either train
    # path; the hook runs once a step (all clients at once under the vmap)
    data = _uneven_data()
    logic = _ZeroingLogic(tengine.from_module(tcnn.Mlp(8, (16,), 3)),
                          tengine.masked_cross_entropy)
    sim = _port_sim(data, logic=logic, strategy=TFedAvg(), early_stopping=early_stopping)
    init = {k: v.clone() for k, v in sim.global_params.items()}
    states = _trained_states(sim)
    for k, v in init.items():
        for i in range(sim.n_clients):
            assert torch.equal(states.params[k][i], v), k
    if early_stopping is None:  # (early stopped: no improvement, all stop at 2)
        assert states.step.tolist() == [2, 3, 4]
    # the longest client's 4 steps (early stopping: 2 chunks of 2)
    assert len(logic.calls) == 4
    assert logic.calls[0] == {k: tuple(v.shape) for k, v in init.items()}


def test_dp_scaffold_corrects_the_noised_mean_once_a_step():
    # the transform sees the step's clipped and noised mean (param shapes,
    # no per-example axis), once a step
    seen = []

    class Recording(DpScaffoldClientLogic):
        def transform_gradients(self, grads, state, ctx):
            seen.append({k: tuple(g.shape) for k, g in grads.items()})
            return super().transform_gradients(grads, state, ctx)

    logic = Recording(tengine.from_module(tcnn.Mlp(8, (16,), 3)),
                      tengine.masked_cross_entropy, learning_rate=0.1,
                      clipping_bound=1.0, noise_multiplier=1.0)
    sim = _port_sim(_uneven_data(), logic=logic)
    sim.fit(1)
    shapes = {k: tuple(v.shape) for k, v in sim.global_params.items()}
    assert seen == [shapes] * 4


# ---------------------------------------------------------------------------
# The client's variate math and the server update
# ---------------------------------------------------------------------------

def test_variate_math_single_client_single_step():
    # one client, one step, c = c_i = 0: c_i+ = (x - y) / lr, and with |S| = N
    # the server's c is that delta, so y = x - lr c
    lr = 0.1
    x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(0), 8, (8,), 3))
    data = [(x, y, x, y)]
    ts = tsim.FederatedSimulation(
        logic=TScaffoldLogic(tengine.from_module(tcnn.Mlp(8, (16,), 3)),
                             tengine.masked_cross_entropy, learning_rate=lr),
        tx=optim.sgd(lr), strategy=TScaffold(), datasets=[tsim.ClientDataset(*data[0])],
        batch_size=8, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=1,
        seed=0, device="cpu")
    js = jsim.FederatedSimulation(
        logic=JScaffoldLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                             jengine.masked_cross_entropy, learning_rate=lr),
        tx=optax.sgd(lr), strategy=JScaffold(), datasets=[jsim.ClientDataset(*data[0])],
        batch_size=8, metrics=JMetricManager((jefficient.accuracy(),)), local_steps=1,
        seed=0, execution_mode="pipelined")
    init = _install(ts, js)
    ts.fit(1)
    js.fit(1)
    cv = ts.server_state.control_variates
    np.testing.assert_allclose(_flat(ts.global_params), _flat(init) - lr * _flat(cv),
                               atol=1e-5)
    # the client's c_i and delta are the server's c (one client, |S| = N)
    extra = ts.client_states.extra
    for k in cv:
        assert torch.equal(extra.client_variates[k][0], cv[k])
        assert torch.equal(extra.delta[k][0], cv[k])
    np.testing.assert_allclose(_flat(cv), _flat(js.server_state.control_variates),
                               atol=FN_TOL, rtol=0)


def test_uneven_clients_divide_by_their_own_steps():
    # from c = c_i = 0, c_i+ = (x - y_i) / (K_i lr) with K_i the client's own
    # count of real steps (2, 3, 4), though all run 4 padded to the longest
    lr = 0.1
    sim = _port_sim(_uneven_data(), lr=lr)
    x = {k: v.clone() for k, v in sim.global_params.items()}
    states = _trained_states(sim)
    assert states.step.tolist() == [2, 3, 4]
    for i, k_i in enumerate((2, 3, 4)):
        for k in x:
            want = (x[k] - states.params[k][i]) / (k_i * lr)
            torch.testing.assert_close(states.extra.client_variates[k][i], want,
                                       atol=FN_TOL, rtol=FN_TOL)


def _packet_results(jpackets, tpackets, mask):
    counts = [1.0] * len(mask)
    jres = JFitResults(packets=jpackets, sample_counts=jnp.asarray(counts),
                       train_losses={}, train_metrics={}, mask=jnp.asarray(mask))
    tres = TFitResults(packets=tpackets, sample_counts=torch.tensor(counts),
                       train_losses={}, train_metrics={}, mask=torch.tensor(mask))
    return jres, tres


@pytest.mark.parametrize("lr,params,deltas,mask,want_x,want_c", [
    # full cohort: x += 0.5 (3 - 0) = 1.5, c += (2/2) 0.3 = 0.3
    (0.5, [[2.0], [4.0]], [[0.2], [0.4]], [1.0, 1.0], 1.5, 0.3),
    # client 1 left out: y_bar 2, delta_bar 0.4, |S|/N = 1/2
    (1.0, [[2.0], [99.0]], [[0.4], [99.0]], [1.0, 0.0], 2.0, 0.2),
    # empty cohort: both kept
    (1.0, [[2.0], [4.0]], [[0.2], [0.4]], [0.0, 0.0], 0.0, 0.0),
], ids=["full_cohort", "partial_cohort", "empty_cohort"])
def test_server_update_matches_jax(lr, params, deltas, mask, want_x, want_c):
    jstrat, tstrat = JScaffold(learning_rate=lr), TScaffold(learning_rate=lr)
    jres, tres = _packet_results(
        JPacket(params={"w": jnp.asarray(params)}, control_variates={"w": jnp.asarray(deltas)}),
        TPacket(params={"w": torch.tensor(params)}, control_variates={"w": torch.tensor(deltas)}),
        mask)
    jnew = jstrat.aggregate(jstrat.init({"w": jnp.zeros((1,))}), jres, 1)
    tnew = tstrat.aggregate(tstrat.init({"w": torch.zeros((1,))}), tres, 1)
    np.testing.assert_allclose(float(tnew.params["w"][0]), want_x, rtol=FN_TOL)
    np.testing.assert_allclose(float(tnew.control_variates["w"][0]), want_c, rtol=FN_TOL)
    np.testing.assert_allclose(tnew.params["w"].numpy(), np.asarray(jnew.params["w"]),
                               atol=FN_TOL, rtol=0)
    np.testing.assert_allclose(tnew.control_variates["w"].numpy(),
                               np.asarray(jnew.control_variates["w"]), atol=FN_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------

def test_warm_start_sets_variates_and_keeps_weights_and_keys():
    data = _uneven_data()
    ts, js = _port_sim(data), _jax_sim(data)
    _install(ts, js)
    pre = {k: v.clone() for k, v in ts.global_params.items()}
    pre_states = ts.client_states
    tservers.scaffold_warm_start(ts)
    jservers.scaffold_warm_start(js)
    # the weights, the clients' keys and steps and the history are untouched
    for k in pre:
        assert torch.equal(ts.global_params[k], pre[k]), k
        assert torch.equal(ts.client_states.params[k], pre_states.params[k]), k
    assert torch.equal(ts.client_states.rng, pre_states.rng)
    assert torch.equal(ts.client_states.step, pre_states.step)
    assert ts.history == []
    # the variates are warm, and JAX's
    cv = ts.server_state.control_variates
    assert float(np.abs(_flat(cv)).max()) > 0
    np.testing.assert_allclose(_flat(cv), _flat(js.server_state.control_variates),
                               atol=TOL, rtol=0)
    tci = ts.client_states.extra.client_variates
    jci = js.client_states.extra.client_variates
    for k, v in convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jci)).items():
        np.testing.assert_allclose(tci[k].numpy(), v.numpy(), atol=TOL, rtol=0, err_msg=k)
    # every client took part: c is the mean of the clients' variates
    for k in cv:
        torch.testing.assert_close(cv[k], tci[k].mean(dim=0), atol=FN_TOL, rtol=FN_TOL)


def test_round_one_after_warm_start_draws_a_cold_runs_keys():
    data = _uneven_data()
    cold, warm = _port_sim(data), _port_sim(data)
    server = tservers.ScaffoldServer(warm, warm_start=True)
    server.fit(1)
    cold.fit(1)
    assert [r.round for r in warm.history] == [1]
    # the same keys split the same number of times, the same steps taken
    assert torch.equal(warm.client_states.rng, cold.client_states.rng)
    assert torch.equal(warm.client_states.step, cold.client_states.step)
    # but the warm variates moved round 1 elsewhere
    assert any(not torch.equal(warm.global_params[k], cold.global_params[k])
               for k in cold.global_params)


def test_scaffold_server_requires_scaffold():
    sim = _port_sim(_uneven_data(), strategy=TFedAvg())
    with pytest.raises(AssertionError, match="Scaffold"):
        tservers.ScaffoldServer(sim)


def test_warm_started_run_matches_jax():
    data = _uneven_data()
    ts, js = _port_sim(data), _jax_sim(data)
    _install(ts, js)
    thist = tservers.ScaffoldServer(ts, warm_start=True).fit(3)
    jhist = jservers.ScaffoldServer(js, warm_start=True).fit(3)
    assert [r.round for r in thist] == [r.round for r in jhist] == [1, 2, 3]
    for tr, jr in zip(thist, jhist):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
    np.testing.assert_allclose(_flat(ts.global_params), _flat(js.global_params),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_flat(ts.server_state.control_variates),
                               _flat(js.server_state.control_variates), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The smoke config and its golden
# ---------------------------------------------------------------------------

def test_scaffold_mnist_matches_jax_and_its_golden():
    js = harness.scaffold_mnist()
    ts = tsim.FederatedSimulation(
        logic=TScaffoldLogic(
            tengine.from_module(tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1))),
            tengine.masked_cross_entropy, learning_rate=0.1),
        tx=optim.sgd(0.1), strategy=TScaffold(learning_rate=1.0),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in js.datasets],
        batch_size=32, metrics=TMetricManager((tefficient.accuracy(),)),
        local_epochs=1, seed=2024, device="cpu")
    _install(ts, js)
    jhist = js.fit(harness.N_ROUNDS)
    thist = ts.fit(harness.N_ROUNDS)
    for tr, jr in zip(thist, jhist):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=1e-6)
    np.testing.assert_allclose(_flat(ts.global_params), _flat(js.global_params),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_flat(ts.server_state.control_variates),
                               _flat(js.server_state.control_variates), atol=TOL, rtol=0)
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden("scaffold_mnist", rounds)
    assert not errors, "\n".join(errors)


# ---------------------------------------------------------------------------
# Config 2's step size
# ---------------------------------------------------------------------------

# A client "diverged" where its round's training loss is non-finite or
# above this: chance is ln 10 = 2.3, and the clients that stay bounded read
# below 1e3 at lr 0.1
DIVERGED = 1e4


def _config2_clients():
    """``chip_smoke.py``'s config-2 clients, drawn on the CPU: the
    3,584-row 32x32x3 pool from ``PRNGKey(0)``, 16 Dirichlet clients (beta
    0.5, one example of each label, hash key 42), each split 80/20."""
    x, y = (a.numpy() for a in synthetic_classification(rng.PRNGKey(0, "cpu"), 3584,
                                                         (32, 32, 3), 10))
    parts = DirichletLabelBasedAllocation(16, list(range(10)), min_label_examples=1,
                                          beta=0.5, hash_key=42).partition_dataset(
        x, y, max_retries=None)[0]
    return [split_data_and_targets(px, py, 0.2, 7 + i) for i, (px, py) in enumerate(parts)]


def _recording(policy_cls):
    """A failure policy of ``policy_cls`` that keeps every round's
    per-client training losses."""
    class Recording(policy_cls):
        def __init__(self):
            super().__init__()
            self.rows = []

        def check(self, per_client_losses, mask):
            self.rows.append(np.asarray(per_client_losses["backward"], np.float64))
            return super().check(per_client_losses, mask)

    return Recording()


@pytest.mark.parametrize("lr", [0.1, 0.01])
def test_config2_step_size_diverges_alike_in_both_packages(lr):
    """Config 2 at full width (CifarNet, f32) on the smoke's 16 Dirichlet
    clients, SCAFFOLD with its warm start and round 1, from the same init
    in both packages. At the examples' lr 0.1 both lose the same clients
    in round 1, so the divergence is the configuration's on this pool, not
    the port's; at the smoke's 0.01 neither loses one, and each client's
    loss agrees within 1e-2 (it reads 2e-3: the first local epochs
    overshoot, loss ~3.5 against chance's 2.3, and carry the packages'
    summation orders forward)."""
    data = _config2_clients()
    jpolicy, tpolicy = _recording(jsim.FailurePolicy), _recording(tsim.FailurePolicy)
    js = jsim.FederatedSimulation(
        logic=JScaffoldLogic(jengine.from_flax(JCifarNet(10, conv_impl="mxu")),
                             jengine.masked_cross_entropy, learning_rate=lr),
        tx=optax.sgd(lr), strategy=JScaffold(1.0),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=32,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=0,
        failure_policy=jpolicy, execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=TScaffoldLogic(tengine.from_module(tcnn.CifarNet(10)),
                             tengine.masked_cross_entropy, learning_rate=lr),
        tx=optim.sgd(lr), strategy=TScaffold(1.0),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=32,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=0,
        device="cpu", failure_policy=tpolicy)
    _install(ts, js)
    jservers.ScaffoldServer(js, warm_start=True).fit(1)
    tservers.ScaffoldServer(ts, warm_start=True).fit(1)
    (jrow,), (trow,) = jpolicy.rows, tpolicy.rows
    diverged = lambda row: set(np.nonzero(~(np.abs(row) <= DIVERGED))[0].tolist())  # noqa: E731
    assert diverged(jrow) == diverged(trow), (jrow, trow)
    if lr == 0.1:
        assert diverged(trow), trow
    else:
        assert not diverged(trow), trow
        np.testing.assert_allclose(trow, jrow, atol=1e-2, rtol=0)


# ---------------------------------------------------------------------------
# The client axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [False, True], ids=["scaffold", "dp_scaffold"])
def test_vmapped_clients_match_the_loop(dp):
    data = _uneven_data()
    runs = []
    for axis in (tsim.vmap_clients, tsim.loop_clients):
        logic = (DpScaffoldClientLogic(tengine.from_module(tcnn.Mlp(8, (16,), 3)),
                                       tengine.masked_cross_entropy, learning_rate=0.1,
                                       clipping_bound=1.0, noise_multiplier=1.0)
                 if dp else None)
        sim = _port_sim(data, logic=logic)
        sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
        if runs:
            sim.set_global_params(runs[0][1])
        init = {k: v.clone() for k, v in sim.global_params.items()}
        tservers.scaffold_warm_start(sim)
        hist = sim.fit(2)
        runs.append((hist, init, sim))
    (vh, _, vs), (lh, _, ls) = runs
    for a, b in zip(vh, lh):
        for key in a.fit_losses:
            np.testing.assert_allclose(a.fit_losses[key], b.fit_losses[key],
                                       atol=AXIS_TOL, rtol=0)
    for tree_v, tree_l in ((vs.global_params, ls.global_params),
                           (vs.server_state.control_variates,
                            ls.server_state.control_variates),
                           (vs.client_states.extra.client_variates,
                            ls.client_states.extra.client_variates)):
        for k in tree_v:
            torch.testing.assert_close(tree_v[k], tree_l[k], atol=AXIS_TOL, rtol=0)
    assert torch.equal(vs.client_states.step, ls.client_states.step)
