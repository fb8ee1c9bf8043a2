"""FedProx in the port against the JAX package on the CPU: the drift
penalty, the server's mu adaptation over a crafted loss sequence (from the
+inf start through a patience hit and an increase), and the
``fedprox_mnist`` smoke config with both extra loss keys and its golden.

Tolerances: 1e-6 for single functions, 5e-4 for runs (f32, the
reference's)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.exchange.packer import AdaptiveConstraintPacket as JPacket
from fl4health_tpu.losses.drift import weight_drift_loss as jdrift
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.fedprox import FedAvgWithAdaptiveConstraint as JStrategy
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic as TProxLogic
from fl4health_tpu_torch.exchange.packer import AdaptiveConstraintPacket as TPacket
from fl4health_tpu_torch.losses.drift import weight_drift_loss as tdrift
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint as TStrategy

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4
FN_TOL = 1e-6
SHAPES = {"Conv_0/kernel": (5, 5, 1, 4), "Conv_0/bias": (4,), "Dense_0/kernel": (36, 7),
          "Dense_0/bias": (7,)}


@pytest.mark.parametrize("weight", [1.0, 0.37])
def test_weight_drift_loss_matches_jax(weight):
    r = np.random.default_rng(0)
    a = {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    b = {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    want = jdrift(convert.torch_to_flax({k: torch.tensor(v) for k, v in a.items()}),
                  convert.torch_to_flax({k: torch.tensor(v) for k, v in b.items()}),
                  jnp.float32(weight))
    got = tdrift({k: torch.tensor(v) for k, v in a.items()},
                 {k: torch.tensor(v) for k, v in b.items()}, torch.tensor(weight))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=FN_TOL, atol=0)
    np.testing.assert_allclose(
        float(got), weight * sum(((a[k] - b[k]).astype(np.float64) ** 2).sum() for k in a),
        rtol=FN_TOL)


def _results(loss, mask):
    k = len(mask)
    jres = JFitResults(
        packets=JPacket(params={"w": jnp.zeros((k, 1))},
                        loss_for_adaptation=jnp.full((k,), loss, jnp.float32)),
        sample_counts=jnp.ones((k,)), train_losses={}, train_metrics={},
        mask=jnp.asarray(mask, jnp.float32))
    tres = TFitResults(
        packets=TPacket(params={"w": torch.zeros((k, 1))},
                        loss_for_adaptation=torch.full((k,), loss)),
        sample_counts=torch.ones((k,)), train_losses={}, train_metrics={},
        mask=torch.tensor(mask, dtype=torch.float32))
    return jres, tres


@pytest.mark.parametrize("adapt", [True, False])
def test_mu_adaptation_matches_jax(adapt):
    # patience 2, delta 0.1 from mu 0.5: the +inf start counts as a drop
    # (1.0 <= inf), so two drops hit patience at round 2 (mu 0.4, streak 0);
    # 0.9, 0.8 hit it again (0.3); 1.5 is an increase (0.4); an empty
    # cohort keeps the previous loss 1.5 but, as in JAX, its zero loss counts
    # as a drop, so 1.4 hits patience (0.3)
    kw = dict(initial_drift_penalty_weight=0.5, loss_weight_delta=0.1,
              loss_weight_patience=2, adapt_loss_weight=adapt)
    jstrat, tstrat = JStrategy(**kw), TStrategy(**kw)
    jstate, tstate = jstrat.init({"w": jnp.zeros((1,))}), tstrat.init({"w": torch.zeros((1,))})
    assert float(tstate.previous_loss) == float("inf")
    assert tstate.loss_drop_streak.dtype == torch.int32 and tstate.loss_drop_streak.shape == ()
    sequence = [(1.0, [1, 1]), (0.95, [1, 1]), (0.9, [1, 0]), (0.8, [1, 1]),
                (1.5, [1, 1]), (7.0, [0, 0]), (1.4, [1, 1]), (1.3, [1, 1])]
    mus = []
    for r, (loss, mask) in enumerate(sequence, 1):
        jres, tres = _results(loss, mask)
        jstate, tstate = jstrat.aggregate(jstate, jres, r), tstrat.aggregate(tstate, tres, r)
        np.testing.assert_allclose(float(tstate.drift_penalty_weight),
                                   float(jstate.drift_penalty_weight), atol=FN_TOL)
        assert int(tstate.loss_drop_streak) == int(jstate.loss_drop_streak)
        assert float(tstate.previous_loss) == float(jstate.previous_loss)
        mus.append(round(float(tstate.drift_penalty_weight), 6))
    if adapt:
        assert mus == [0.5, 0.4, 0.4, 0.3, 0.4, 0.4, 0.3, 0.3]
    else:
        assert mus == [0.5] * len(sequence)
    assert float(tstate.previous_loss) == pytest.approx(1.3)


def test_mu_floors_at_zero():
    strat = TStrategy(initial_drift_penalty_weight=0.05, loss_weight_delta=0.1,
                      loss_weight_patience=1)
    state = strat.aggregate(strat.init({"w": torch.zeros((1,))}), _results(1.0, [1])[1], 1)
    assert float(state.drift_penalty_weight) == 0.0


def test_fedprox_server_requires_the_adaptive_strategy():
    data = [tsim.ClientDataset(np.zeros((4, 3), np.float32), np.zeros(4, np.int32),
                               np.zeros((2, 3), np.float32), np.zeros(2, np.int32))]
    sim = tsim.FederatedSimulation(
        logic=TProxLogic(tengine.from_module(tcnn.Mlp(3, (), 2)), tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=TFedAvg(), datasets=data, batch_size=4,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=1, device="cpu")
    with pytest.raises(AssertionError, match="FedAvgWithAdaptiveConstraint"):
        tservers.FedProxServer(sim)


def test_fedprox_mnist_matches_jax_and_its_golden():
    js = harness.fedprox_mnist()
    ts = tsim.FederatedSimulation(
        logic=TProxLogic(
            tengine.from_module(tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1))),
            tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=TStrategy(initial_drift_penalty_weight=0.1),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in js.datasets],
        batch_size=32, metrics=TMetricManager((tefficient.accuracy(),)),
        local_epochs=1, seed=2024, device="cpu")
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)
    mus = []
    aggregate = ts.strategy.aggregate

    def aggregate_rec(*args):  # mu as each round leaves it, kept on the device
        state = aggregate(*args)
        mus.append(state.drift_penalty_weight)
        return state

    ts.strategy.aggregate = aggregate_rec
    jhist = js.fit(harness.N_ROUNDS)
    thist = tservers.FedProxServer(ts).fit(harness.N_ROUNDS)
    for tr, jr in zip(thist, jhist):
        assert set(tr.fit_losses) == set(jr.fit_losses) == {"backward", "vanilla", "penalty"}
        for key in ("backward", "vanilla", "penalty"):
            np.testing.assert_allclose(tr.fit_losses[key], jr.fit_losses[key],
                                       atol=TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=1e-6)
        assert tr.fit_losses["penalty"] > 0 or tr.round == 1
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(ts.server_state.drift_penalty_weight),
                               float(js.server_state.drift_penalty_weight), atol=FN_TOL)
    assert int(ts.server_state.loss_drop_streak) == int(js.server_state.loss_drop_streak)
    assert len(mus) == harness.N_ROUNDS and all(m.shape == () for m in mus)
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden("fedprox_mnist", rounds)
    assert not errors, "\n".join(errors)
