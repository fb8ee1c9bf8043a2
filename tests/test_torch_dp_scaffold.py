"""DP-SCAFFOLD in the port against the JAX package on the CPU: a 2-round
run at sigma 1 with the warm start under ``DpScaffoldServer`` (the noise
from the same threefry keys in both packages), and the instance-level
accountant's epsilon and delta with and without the full-participation
rounds that the warm start is charged as.

The JAX client takes its XLA clip route, the port the fused kernel route
(the same function, held together by tests/test_torch_dp_clip.py); the port
runs its plain versions on the CPU. Tolerances: 5e-4 for the run (f32, the
reference's), 1e-9 for the accountant."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import chip_smoke
import jax
import numpy as np
import optax
import pytest

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import DpScaffoldClientLogic as JLogic
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import cnn as jcnn
from fl4health_tpu.privacy import accountants as jacc
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.scaffold import Scaffold as JScaffold
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import DpScaffoldClientLogic as TLogic
from fl4health_tpu_torch.kernels import dp_clip as dp
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer
from fl4health_tpu_torch.privacy import accountants as tacc
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.scaffold import Scaffold as TScaffold

TOL = 5e-4
EPS_TOL = 1e-9


def _data():
    """2 clients of 8x8x3 images, 10 classes: 16 and 13 train rows at batch
    8 (client 1's final batch ragged)."""
    out = []
    for i, (n_train, n_val) in enumerate(((16, 6), (13, 5))):
        x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(i), n_train + n_val,
                                               (8, 8, 3), 10))
        out.append((x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def _flat_close(tparams, jtree, tol):
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jtree))
    assert set(tparams) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(tparams[k].numpy(), v.numpy(), atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("warm_start", [True, False])
def test_dp_scaffold_run_matches_jax(warm_start):
    data, sigma, lr = _data(), 1.0, 0.05
    js = jsim.FederatedSimulation(
        logic=JLogic(jengine.from_flax(jcnn.CifarNet()), jengine.masked_cross_entropy,
                     learning_rate=lr, clipping_bound=1.0, noise_multiplier=sigma),
        tx=optax.sgd(lr), strategy=JScaffold(1.0),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=3, seed=5,
        execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=TLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                     tengine.masked_cross_entropy, learning_rate=lr, clipping_bound=1.0,
                     noise_multiplier=sigma),
        tx=optim.sgd(lr), strategy=TScaffold(1.0),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=3, seed=5,
        device="cpu",
        # the telemetry build averages DP's clip fraction into the fit losses
        observability=Observability(enabled=True, registry=MetricsRegistry(),
                                    tracer=Tracer(), introspection=False))
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)
    jhist, jeps = jservers.DpScaffoldServer(js, sigma, 8, warm_start=warm_start,
                                            delta=1e-3).fit(2)
    thist, teps = tservers.DpScaffoldServer(ts, sigma, 8, warm_start=warm_start,
                                            delta=1e-3).fit(2)
    assert abs(teps - jeps) <= EPS_TOL and 0.0 < teps < np.inf
    assert [r.round for r in thist] == [r.round for r in jhist] == [1, 2]
    for tr, jr in zip(thist, jhist):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        assert 0.0 <= tr.fit_losses["clip_fraction"] <= 1.0
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
    _flat_close(ts.global_params, js.global_params, TOL)
    _flat_close(ts.server_state.control_variates, js.server_state.control_variates, TOL)
    moved = max(float((ts.global_params[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-3
    # the port's clip and sum ran through the kernels' plain versions
    assert dp.LAUNCHES == {k: 0 for k in dp.LAUNCHES}


def test_warm_start_is_charged_as_a_full_participation_round():
    data = _data()

    def eps(warm_start):
        sim = tsim.FederatedSimulation(
            logic=TLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                         tengine.masked_cross_entropy, learning_rate=0.05,
                         clipping_bound=1.0, noise_multiplier=1.0),
            tx=optim.sgd(0.05), strategy=TScaffold(), datasets=[tsim.ClientDataset(*d)
                                                              for d in data],
            batch_size=8, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2,
            seed=1, device="cpu")
        server = tservers.DpScaffoldServer(sim, 1.0, 8, warm_start=warm_start)
        return server.fit(1)[1], server.accountant

    warm, acc = eps(True)
    cold, _ = eps(False)
    delta = 1.0 / 29
    assert warm == acc.get_epsilon(1, delta, full_participation_rounds=1)
    assert cold == acc.get_epsilon(1, delta)
    assert warm > cold


@pytest.mark.parametrize("q,full_rounds,steps,epochs", [
    (1.0, 0, 5, None), (1.0, 1, 5, None), (0.25, 0, 5, None), (0.25, 1, 5, None),
    (0.25, 2, None, 1), (0.5, 1, None, 2),
])
def test_accountant_matches_jax(q, full_rounds, steps, epochs):
    kw = dict(client_sampling_rate=q, noise_multiplier=1.0, epochs_per_round=epochs,
              client_batch_sizes=[32, 32, 16], client_dataset_sizes=[160, 224, 97],
              steps_per_round=steps)
    jac, tac = jacc.FlInstanceLevelAccountant(**kw), tacc.FlInstanceLevelAccountant(**kw)
    for rounds in (1, 3):
        want = jac.get_epsilon(rounds, 1e-5, full_participation_rounds=full_rounds)
        got = tac.get_epsilon(rounds, 1e-5, full_participation_rounds=full_rounds)
        assert abs(got - want) <= EPS_TOL * max(1.0, want)
        want_d = jac.get_delta(rounds, 4.0, full_participation_rounds=full_rounds)
        got_d = tac.get_delta(rounds, 4.0, full_participation_rounds=full_rounds)
        assert abs(got_d - want_d) <= EPS_TOL
    # with q < 1 a full round costs more than a subsampled one; at q = 1 the
    # two rates are the same
    plain = tac.get_epsilon(3, 1e-5)
    with_full = tac.get_epsilon(3, 1e-5, full_participation_rounds=1)
    if q < 1.0:
        assert with_full > tac.get_epsilon(4, 1e-5)
    else:
        assert with_full == pytest.approx(tac.get_epsilon(4, 1e-5), rel=1e-12)
    assert with_full > plain


def test_dp_scaffold_server_requires_scaffold():
    sim = tsim.FederatedSimulation(
        logic=TLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                     tengine.masked_cross_entropy, learning_rate=0.05, clipping_bound=1.0,
                     noise_multiplier=1.0),
        tx=optim.sgd(0.05), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in _data()], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=1, device="cpu")
    with pytest.raises(AssertionError, match="Scaffold"):
        tservers.DpScaffoldServer(sim, 1.0, 8)


def test_chip_smoke_dp_scaffold_epsilon():
    # the full-width DP-SCAFFOLD run of chip_smoke.py, whose epsilon it checks
    # on the card: 2 rounds and the warm start as one full-participation round
    cs = chip_smoke
    kw = dict(client_sampling_rate=1.0, noise_multiplier=cs.DP_SIGMA, epochs_per_round=None,
              client_batch_sizes=[cs.BATCH] * cs.DP_CLIENTS,
              client_dataset_sizes=[cs.DP_TRAIN] * cs.DP_CLIENTS,
              steps_per_round=cs.LOCAL_STEPS)
    delta = 1 / (cs.DP_TRAIN * cs.DP_CLIENTS)
    for accountant in (jacc.FlInstanceLevelAccountant(**kw), tacc.FlInstanceLevelAccountant(**kw)):
        eps = accountant.get_epsilon(cs.DPS_ROUNDS, delta, full_participation_rounds=1)
        assert abs(eps - cs.DPS_EPSILON) <= EPS_TOL
        assert eps > accountant.get_epsilon(cs.DPS_ROUNDS, delta)
