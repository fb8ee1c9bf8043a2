"""The client-level DP slice as a whole against the JAX package on the CPU:
the ``client_dp_mnist`` and ``client_dp_weighted_mnist`` smoke configs of
``tests/smoke/harness.py`` through the port from the same converted flax init
and the same numpy data, per round within 5e-4 of the JAX run over
``harness.N_ROUNDS`` and reproducing their goldens; and a 2-round run with
``PoissonSamplingManager(fraction=0.5)`` at nonzero noise under
``ClientLevelDpFedAvgServer``: the same sampled masks, losses, params and
clipping bound within 5e-4 and the same epsilon within 1e-9. The server
noise and the masks come from ``rng.py``, JAX's own stream."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.clipping import ClippingClientLogic as JClipLogic
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.datasets.vision import federated_client_datasets as jfederated
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM as JStrategy
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.clipping import ClippingClientLogic as TClipLogic
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM as TStrategy

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4
# the strategy settings of harness.client_dp_mnist / client_dp_weighted_mnist
HARNESS_STRATEGY = {
    "client_dp_mnist": dict(noise_multiplier=0.15, server_momentum=0.5,
                            initial_clipping_bound=0.5, seed=7),
    "client_dp_weighted_mnist": dict(noise_multiplier=0.1, server_momentum=0.5,
                                     initial_clipping_bound=0.5, weighted_aggregation=True,
                                     adaptive_clipping=True, bit_noise_multiplier=1.0,
                                     seed=7),
}


def _port_datasets(datasets):
    return [tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val) for d in datasets]


def _install_jax_init(ts, js):
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)
    return init


def _assert_close_run(thist, jhist, tparams, jparams, tbound, jbound):
    assert [r.round for r in thist] == [r.round for r in jhist]
    for tr, jr in zip(thist, jhist):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=1e-6)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(want)
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(tbound), float(jbound), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(HARNESS_STRATEGY))
def test_smoke_config_matches_jax_and_its_golden(name):
    js = getattr(harness, name)()
    cfg = HARNESS_STRATEGY[name]
    ts = tsim.FederatedSimulation(
        logic=TClipLogic(tengine.from_module(TMlp(14 * 14, (16,), 10)),
                         tengine.masked_cross_entropy,
                         adaptive_clipping=cfg.get("adaptive_clipping", False)),
        tx=optim.sgd(0.05), strategy=TStrategy(**cfg),
        datasets=_port_datasets(js.datasets), batch_size=32,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=2024,
        device="cpu")
    init = _install_jax_init(ts, js)
    jhist = js.fit(harness.N_ROUNDS)
    thist = ts.fit(harness.N_ROUNDS)
    _assert_close_run(thist, jhist, ts.global_params, js.global_params,
                      ts.server_state.clipping_bound, js.server_state.clipping_bound)
    if cfg.get("adaptive_clipping"):  # the noised bits moved the bound
        assert float(ts.server_state.clipping_bound) != pytest.approx(0.5)
    assert max(float((ts.global_params[k] - init[k]).abs().max()) for k in init) > 1e-3
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden(name, rounds)
    assert not errors, "\n".join(errors)


class _Recording:
    """Wraps a manager and keeps every mask it hands out."""

    def __init__(self, inner):
        self.inner, self.masks = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, key, round_idx):
        mask = self.inner.sample(key, round_idx)
        self.masks.append(np.asarray(mask).copy())
        return mask


def test_poisson_sampled_noisy_run_matches_jax():
    x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(3), 480, (6, 6, 1), 10,
                                          class_sep=1.2))
    datasets = jfederated(x, y, n_clients=8, hash_key=7)
    cfg = dict(noise_multiplier=0.1, server_momentum=0.5, initial_clipping_bound=0.5,
               weighted_aggregation=True, adaptive_clipping=True,
               bit_noise_multiplier=1.0, seed=7)
    jmanager = _Recording(jcm.PoissonSamplingManager(8, 0.5))
    tmanager = _Recording(tcm.PoissonSamplingManager(8, 0.5))
    js = jsim.FederatedSimulation(
        logic=JClipLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=10)),
                         jengine.masked_cross_entropy, adaptive_clipping=True),
        tx=optax.sgd(0.05), strategy=JStrategy(**cfg), datasets=datasets,
        batch_size=16, metrics=JMetricManager((jefficient.accuracy(),)), local_steps=3,
        client_manager=jmanager, seed=11, execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=TClipLogic(tengine.from_module(TMlp(36, (16,), 10)),
                         tengine.masked_cross_entropy, adaptive_clipping=True),
        tx=optim.sgd(0.05), strategy=TStrategy(**cfg), datasets=_port_datasets(datasets),
        batch_size=16, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=3,
        client_manager=tmanager, seed=11, device="cpu")
    assert ts.strategy.fraction_fit == 0.5  # derived from the manager at setup
    _install_jax_init(ts, js)
    jhist, jeps = jservers.ClientLevelDpFedAvgServer(js, 0.1).fit(2)
    thist, teps = tservers.ClientLevelDpFedAvgServer(ts, 0.1).fit(2)
    assert abs(teps - jeps) <= 1e-9 and 0.0 < teps < np.inf
    assert len(tmanager.masks) == len(jmanager.masks) == 2
    for got, want in zip(tmanager.masks, jmanager.masks):
        np.testing.assert_array_equal(got, want)
    # the draws sample some clients and drop others
    assert all(0 < m.sum() < 8 for m in tmanager.masks)
    _assert_close_run(thist, jhist, ts.global_params, js.global_params,
                      ts.server_state.clipping_bound, js.server_state.clipping_bound)


@pytest.mark.parametrize("manager,accountant", [
    (lambda: tcm.PoissonSamplingManager(4, 0.5), "FlClientLevelAccountantPoissonSampling"),
    (lambda: tcm.FixedFractionManager(4, 0.5),
     "FlClientLevelAccountantFixedSamplingNoReplacement"),
    (lambda: tcm.FullParticipationManager(4),
     "FlClientLevelAccountantFixedSamplingNoReplacement"),
])
def test_server_picks_the_accountant_of_the_sampling_scheme(manager, accountant):
    rng_np = np.random.default_rng(0)
    data = [tsim.ClientDataset(rng_np.standard_normal((6, 3)).astype(np.float32),
                               rng_np.integers(0, 2, 6).astype(np.int32),
                               rng_np.standard_normal((2, 3)).astype(np.float32),
                               rng_np.integers(0, 2, 2).astype(np.int32)) for _ in range(4)]
    sim = tsim.FederatedSimulation(
        logic=TClipLogic(tengine.from_module(TMlp(3, (), 2)), tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=TStrategy(noise_multiplier=1.0), datasets=data,
        batch_size=4, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=1,
        client_manager=manager(), device="cpu")
    server = tservers.ClientLevelDpFedAvgServer(sim, noise_multiplier=1.0)
    acc = server._accountant()
    assert type(acc).__name__ == accountant
    if accountant.endswith("NoReplacement"):
        want = max(int(round(sim.client_manager.fraction * 4)), 1)
        assert acc.n_clients_sampled == want
    hist, eps = server.fit(1)
    assert len(hist) == 1 and np.isfinite(eps) and eps > 0
    assert eps == acc.get_epsilon(1, 1 / 4)
    assert all(torch.isfinite(v).all() for v in sim.global_params.values())
