"""The DP slice as a whole against the JAX package: FedAvg over clients that
take instance-level DP-SGD steps (per-example grads -> clip -> masked sum ->
noise), 2 rounds from the same converted flax init and the same numpy data,
at ``noise_multiplier=0`` (the two packages' random streams differ), per-round
losses and final global params within 5e-4; and the non-DP ``fedavg_mnist``
smoke config per round within 5e-4 over 5 rounds, reproducing its golden
under the harness's tolerances. The port runs its plain versions on the CPU;
the JAX client takes its XLA clip route, the port the fused kernel route
(the same function, held together by tests/test_torch_dp_clip.py)."""

import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import (
    InstanceLevelDpClientLogic as JDpLogic,
)
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import cnn as jcnn
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import (
    InstanceLevelDpClientLogic as TDpLogic,
)
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4


def _dp_data():
    """2 clients of 8x8x3 images, 10 classes; client 1 has a ragged final
    batch (example_mask zeros)."""
    out = []
    for i, (n_train, n_val) in enumerate(((16, 6), (13, 5))):
        x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(i), n_train + n_val,
                                               (8, 8, 3), 10))
        out.append((x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def _port_dp_sim(data, noise_multiplier, seed=5):
    logic = TDpLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                     tengine.masked_cross_entropy, clipping_bound=1.0,
                     noise_multiplier=noise_multiplier)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=3, seed=seed,
        device="cpu")


def _assert_history_close(thist, jhist, tol, metric_atol):
    assert [r.round for r in thist] == [r.round for r in jhist]
    for tr, jr in zip(thist, jhist):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=tol, rtol=0)
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=metric_atol)


def _assert_params_close(tparams, jparams, tol):
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(want)
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(), atol=tol,
                                   rtol=0, err_msg=k)


def test_dp_fedavg_run_matches_jax():
    data = _dp_data()
    js = jsim.FederatedSimulation(
        logic=JDpLogic(jengine.from_flax(jcnn.CifarNet()), jengine.masked_cross_entropy,
                       clipping_bound=1.0, noise_multiplier=0.0),
        tx=optax.sgd(0.05), strategy=JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=3, seed=5,
        execution_mode="pipelined")
    ts = _port_dp_sim(data, noise_multiplier=0.0)
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)
    # the servers account with sigma 1 (the clients' noise is 0 for parity)
    jhist, jeps = jservers.InstanceLevelDpServer(js, 1.0, 8).fit(2)
    thist, teps = tservers.InstanceLevelDpServer(ts, 1.0, 8).fit(2)
    assert abs(teps - jeps) <= 1e-9 and 0.0 < teps < np.inf
    _assert_history_close(thist, jhist, TOL, 1e-6)
    for r in thist:  # the clip fraction rides beside the loss
        assert 0.0 <= r.fit_losses["clip_fraction"] <= 1.0
    _assert_params_close(ts.global_params, js.global_params, TOL)
    moved = max(float((ts.global_params[k] - init[k]).abs().max()) for k in init)
    assert moved > 1e-3


def test_dp_noise_is_reproducible_and_moves_the_run():
    data = _dp_data()
    runs = []
    for sigma in (1.0, 1.0, 0.0):
        sim = _port_dp_sim(data, sigma)
        runs.append((sim.fit(1), sim.global_params))
    (h1, p1), (h2, p2), (h0, p0) = runs
    assert h1[0].fit_losses == h2[0].fit_losses
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert any(not torch.equal(p1[k], p0[k]) for k in p1)


def test_dp_client_rejects_batchnorm():
    module = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(4, 3),
                                 torch.nn.BatchNorm1d(3))
    model = tengine.ModelDef(init=lambda g: {}, apply=lambda p, x, train=True: None,
                             module=module)
    with pytest.raises(ValueError, match="BatchNorm"):
        TDpLogic(model, tengine.masked_cross_entropy, clipping_bound=1.0,
                 noise_multiplier=1.0)


def test_fedavg_mnist_matches_jax_and_its_golden():
    js = harness.fedavg_mnist()
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(
            tengine.from_module(tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1))),
            tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in js.datasets],
        batch_size=32, metrics=TMetricManager((tefficient.accuracy(),)),
        local_epochs=1, seed=2024, device="cpu")
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist = js.fit(harness.N_ROUNDS)
    thist = ts.fit(harness.N_ROUNDS)
    _assert_history_close(thist, jhist, TOL, 1e-6)
    _assert_params_close(ts.global_params, js.global_params, TOL)
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden("fedavg_mnist", rounds)
    assert not errors, "\n".join(errors)
