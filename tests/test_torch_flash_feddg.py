"""Flash and FedDG-GA in the port (``clients/flash.py``,
``strategies/flash.py``, ``strategies/feddg_ga.py``), the engine's
``masked_mse``/``masked_bce_with_logits`` and ``losses/containers.py``,
against the JAX package on the CPU.

- ``Flash``'s recursion over three rounds of drifting packets (a dropped
  client among them) at the reference's rtol 1e-5
  (``tests/strategies/test_flash_feddgga.py``);
- ``make_flash_local_train`` from JAX's state and batches (a gamma that
  never stops, one that stops after the second epoch, one between): the
  executed steps exactly, the state and the losses at 5e-4;
- a Flash run through ``FederatedSimulation(flash_early_stopping=...)``
  from JAX's converted init, pipelined at 5e-4, chunked bit for bit the
  pipelined run; JAX's refusals;
- ``FedDgGa`` and ``FedDgGaAdaptiveConstraint`` end to end (their
  ``evaluate_after_fit`` and host ``update_after_eval``): losses, weights
  and mu at 5e-4; the chunked route refused as JAX refuses it.

Tolerance: 5e-4 (f32 runs, the reference's), 1e-6 for one function."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.fedprox import FedProxClientLogic as JFedProx
from fl4health_tpu.clients.flash import FlashEarlyStopConfig as JFlashConfig
from fl4health_tpu.clients.flash import make_flash_local_train as jflash_train
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.losses import containers as jcontainers
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.feddg_ga import FedDgGa as JFedDgGa
from fl4health_tpu.strategies.feddg_ga import FedDgGaAdaptiveConstraint as JFedDgGaAC
from fl4health_tpu.strategies.flash import Flash as JFlash
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic as TFedProx
from fl4health_tpu_torch.clients.flash import FlashEarlyStopConfig as TFlashConfig
from fl4health_tpu_torch.clients.flash import make_flash_local_train as tflash_train
from fl4health_tpu_torch.losses import containers as tcontainers
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.feddg_ga import FedDgGa as TFedDgGa
from fl4health_tpu_torch.strategies.feddg_ga import FedDgGaAdaptiveConstraint as TFedDgGaAC
from fl4health_tpu_torch.strategies.flash import Flash as TFlash

TOL = 5e-4
FN_TOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(jtree) -> dict:
    return convert.flax_to_torch(_np(jtree))


def test_flash_recursion_matches_jax_over_three_rounds():
    r = np.random.default_rng(0)
    params = {"w": r.normal(size=(3, 4)).astype(np.float32),
              "b": r.normal(size=(4,)).astype(np.float32)}
    js, ts = JFlash(eta=0.1), TFlash(eta=0.1)
    jst = js.init({k: jnp.asarray(v) for k, v in params.items()})
    tst = ts.init({k: torch.tensor(v) for k, v in params.items()})
    for rnd, mask in enumerate(([1, 1, 1], [1, 0, 1], [0, 0, 0]), start=1):
        packets = {k: (v[None] + r.normal(size=(3, *v.shape)) * 0.5).astype(np.float32)
                   for k, v in params.items()}
        counts, m = np.asarray([8.0, 16.0, 24.0], np.float32), np.asarray(mask, np.float32)
        jst = js.aggregate(jst, JFitResults({k: jnp.asarray(v) for k, v in packets.items()},
                                            jnp.asarray(counts), {}, {}, jnp.asarray(m)), rnd)
        tst = ts.aggregate(tst, TFitResults({k: torch.tensor(v) for k, v in packets.items()},
                                            torch.tensor(counts), {}, {}, torch.tensor(m)), rnd)
        for field in ("params", "m", "v", "d"):
            for k in params:
                np.testing.assert_allclose(getattr(tst, field)[k].numpy(),
                                           np.asarray(getattr(jst, field)[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=f"{rnd} {field} {k}")


# ---------------------------------------------------------------------------
# The Flash client's epoch loop
# ---------------------------------------------------------------------------

def _flash_setup(n=48, n_epochs=4, batch=8):
    key = jax.random.PRNGKey(0)
    x, y = synthetic_classification(key, n + 16, (6,), 3, class_sep=2.0)
    jlogic = jengine.ClientLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                                 jengine.masked_cross_entropy)
    tlogic = tengine.ClientLogic(tengine.from_module(TMlp(6, (16,), 3)),
                                 tengine.masked_cross_entropy)
    jstate = jengine.create_train_state(jlogic, optax.sgd(0.05), key, x[:1])
    tstate = tengine.create_train_state(tlogic, optim.sgd(0.05), torch.tensor([0, 0]),
                                        torch.Generator().manual_seed(0), torch.device("cpu"))
    tstate = dataclasses.replace(tstate, params=_flat(jstate.params),
                                 rng=torch.tensor(np.asarray(jstate.rng).astype(np.int64)))
    per_epoch = [jengine.epoch_batches(jax.random.fold_in(key, e), x[:n], y[:n], batch)
                 for e in range(n_epochs)]
    jbatches = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *per_epoch)
    jval = jengine.epoch_batches(key, x[n:], y[n:], batch, shuffle=False)
    to_t = lambda b: tengine.Batch(*(torch.tensor(np.asarray(getattr(b, f)))  # noqa: E731
                                     for f in ("x", "y", "example_mask", "step_mask")))
    return jlogic, tlogic, jstate, tstate, jbatches, to_t(jbatches), jval, to_t(jval), n_epochs


@pytest.mark.parametrize("gamma", [1e-9, 0.02, 1e6])
def test_flash_local_train_matches_jax(gamma):
    jl, tl, jst, tst, jb, tb, jv, tv, n_epochs = _flash_setup()
    jtrain = jflash_train(jl, optax.sgd(0.05), JMetricManager((jefficient.accuracy(),)),
                          JFlashConfig(gamma=gamma, n_epochs=n_epochs))
    ttrain = tflash_train(tl, optim.sgd(0.05), TMetricManager((tefficient.accuracy(),)),
                          TFlashConfig(gamma=gamma, n_epochs=n_epochs))
    jout, tout = jtrain(jst, None, jb, jv), ttrain(tst, None, tb, tv)
    assert float(tout[3]) == float(jout[3])
    steps_per_epoch = tb.step_mask.shape[0] // n_epochs
    if gamma == 1e-9:
        assert float(tout[3]) == tb.step_mask.shape[0]
    if gamma == 1e6:  # epoch 0 never stops; epoch 1's finite gain is below gamma / 2
        assert float(tout[3]) == 2 * steps_per_epoch
    for k, v in _flat(jout[0].params).items():
        np.testing.assert_allclose(tout[0].params[k].numpy(), v.numpy(), rtol=0, atol=TOL)
    for i in (1, 2):
        for k, v in jout[i].items():
            np.testing.assert_allclose(float(tout[i][k]), float(v), rtol=0, atol=TOL)


def _sim_arrays(n_clients=3, n=40, seed=0):
    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(jax.random.PRNGKey(seed + i), n, (6,), 3)
        x, y = np.asarray(x), np.asarray(y)
        out.append((x[: n - 8], y[: n - 8], x[n - 8:], y[n - 8:]))
    return out


def _pair(jstrategy, tstrategy, jlogic=None, tlogic=None, modes=("pipelined",),
          arrays=None, **kw):
    """The same run in both packages (the port from JAX's init); one port
    simulation a mode."""
    jlogic = jlogic or jengine.ClientLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                                           jengine.masked_cross_entropy)
    tlogic = tlogic or tengine.ClientLogic(tengine.from_module(TMlp(6, (16,), 3)),
                                           tengine.masked_cross_entropy)
    arrays = arrays or _sim_arrays()
    common = dict(batch_size=8, **kw)
    jconf = {k: (JFlashConfig(**v) if k == "flash_early_stopping" else v)
             for k, v in common.items()}
    tconf = {k: (TFlashConfig(**v) if k == "flash_early_stopping" else v)
             for k, v in common.items()}
    js = JSim(logic=jlogic, tx=optax.sgd(0.05), strategy=jstrategy,
              datasets=[JDataset(*a) for a in arrays],
              metrics=JMetricManager((jefficient.accuracy(),)), **jconf)
    init = _flat(js.global_params)
    ports = []
    for mode in modes:
        ts = TSim(logic=tlogic, tx=optim.sgd(0.05), strategy=tstrategy(),
                  datasets=[TDataset(*a) for a in arrays],
                  metrics=TMetricManager((tefficient.accuracy(),)), execution_mode=mode,
                  device="cpu", **tconf)
        ts.set_global_params(init)
        ports.append(ts)
    return js, ports


def _close(js, ts, keys=("backward",)):
    assert len(js.history) == len(ts.history)
    for j, t in zip(js.history, ts.history):
        assert set(t.fit_losses) == set(j.fit_losses) and set(keys) <= set(t.fit_losses)
        for k in t.fit_losses:
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0, atol=TOL,
                                       err_msg=f"round {t.round} {k}")
        np.testing.assert_allclose(t.eval_losses["checkpoint"], j.eval_losses["checkpoint"],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(t.eval_metrics["accuracy"], j.eval_metrics["accuracy"],
                                   rtol=0, atol=TOL)
    for k, v in _flat(js.global_params).items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


def _same(a, b) -> bool:
    return all(x.fit_losses == y.fit_losses and x.eval_losses == y.eval_losses
               for x, y in zip(a.history, b.history, strict=True))


@pytest.mark.parametrize("gamma", [1e-9, 0.05])
def test_flash_run_matches_jax_and_its_routes_agree(gamma):
    flash = dict(gamma=gamma, n_epochs=3)
    js, (pipelined, chunked) = _pair(JFlash(eta=0.05), lambda: TFlash(eta=0.05),
                                     modes=("pipelined", "chunked"), seed=0, local_epochs=3,
                                     flash_early_stopping=flash)
    js.fit(3)
    pipelined.fit(3)
    chunked.fit(3)
    _close(js, pipelined)
    assert _same(pipelined, chunked)
    for field in ("m", "v", "d"):
        for k, v in _flat(getattr(js.server_state, field)).items():
            np.testing.assert_allclose(getattr(pipelined.server_state, field)[k].numpy(),
                                       v.numpy(), rtol=0, atol=TOL)


FLASH_REFUSALS = {
    "steps": (dict(local_steps=3, flash_early_stopping=dict(gamma=0.1, n_epochs=1)),
              "requires local_epochs"),
    "both": (dict(local_epochs=1, flash_early_stopping=dict(gamma=0.1, n_epochs=1),
                  early_stopping="es"), "exclusive"),
    "epochs": (dict(local_epochs=2, flash_early_stopping=dict(gamma=0.1, n_epochs=3)),
               "must equal local_epochs"),
}


@pytest.mark.parametrize("case", sorted(FLASH_REFUSALS))
def test_flash_early_stopping_is_refused_where_jax_refuses_it(case):
    kw, match = FLASH_REFUSALS[case]
    arrays = _sim_arrays(1)
    for pkg in ("jax", "torch"):
        conf = dict(kw)
        if pkg == "jax":
            Sim, Cfg, DS, MM = JSim, JFlashConfig, JDataset, JMetricManager
            logic = jengine.ClientLogic(jengine.from_flax(JMlp(features=(8,), n_outputs=3)),
                                        jengine.masked_cross_entropy)
            tx, es = optax.sgd(0.05), jengine.EarlyStoppingConfig(1, 1)
            extra = {}
        else:
            Sim, Cfg, DS, MM = TSim, TFlashConfig, TDataset, TMetricManager
            logic = tengine.ClientLogic(tengine.from_module(TMlp(6, (8,), 3)),
                                        tengine.masked_cross_entropy)
            tx, es = optim.sgd(0.05), tengine.EarlyStoppingConfig(1, 1)
            extra = dict(device="cpu")
        conf["flash_early_stopping"] = Cfg(**conf["flash_early_stopping"])
        if conf.get("early_stopping") == "es":
            conf["early_stopping"] = es
        with pytest.raises(ValueError, match=match):
            Sim(logic=logic, tx=tx, strategy=JFlash() if pkg == "jax" else TFlash(),
                datasets=[DS(*a) for a in arrays], batch_size=4, metrics=MM(()), seed=0,
                **conf, **extra)


# ---------------------------------------------------------------------------
# FedDG-GA
# ---------------------------------------------------------------------------

def test_feddg_ga_weights_follow_jax_round_by_round():
    js, (ts,) = _pair(JFedDgGa(n_clients=3, num_rounds=3),
                      lambda: TFedDgGa(n_clients=3, num_rounds=3), seed=42, local_epochs=1)
    js.fit(3)
    ts.fit(3)
    _close(js, ts)
    assert ts._active_execution_mode == "pipelined_per_round"
    for field in ("adjustment_weights", "local_val_losses"):
        np.testing.assert_allclose(getattr(ts.server_state, field).numpy(),
                                   np.asarray(getattr(js.server_state, field)), rtol=0, atol=TOL)
    w = ts.server_state.adjustment_weights.numpy()
    assert w.sum() == pytest.approx(1.0, abs=1e-6) and np.abs(w - 1 / 3).max() > 1e-4
    assert int(ts.server_state.round_idx) == int(js.server_state.round_idx) == 3


def test_feddg_ga_refuses_the_chunked_route_as_jax():
    _, (ts,) = _pair(JFedDgGa(n_clients=3, num_rounds=2),
                     lambda: TFedDgGa(n_clients=3, num_rounds=2), modes=("chunked",),
                     seed=42, local_epochs=1)
    with pytest.raises(ValueError, match="update_after_eval"):
        ts.fit(1)


def test_feddg_ga_update_after_eval_matches_jax():
    r = np.random.default_rng(3)
    params = {"w": r.normal(size=(4,)).astype(np.float32)}
    for signal in (1.0, -1.0):
        jga, tga = (JFedDgGa(4, 5, 0.3, signal), TFedDgGa(4, 5, 0.3, signal))
        jst = jga.init({k: jnp.asarray(v) for k, v in params.items()})
        tst = tga.init({k: torch.tensor(v) for k, v in params.items()})
        val = r.normal(size=(4,)).astype(np.float32)
        jst = jst.replace(local_val_losses=jnp.asarray(val), round_idx=jnp.asarray(2))
        tst = dataclasses.replace(tst, local_val_losses=torch.tensor(val),
                                  round_idx=torch.tensor(2, dtype=torch.int32))
        ev = r.normal(size=(4,)).astype(np.float32)
        want = jga.update_after_eval(jst, {"checkpoint": jnp.asarray(ev)}, {}, jnp.ones(4))
        got = tga.update_after_eval(tst, {"checkpoint": torch.tensor(ev)}, {}, torch.ones(4))
        np.testing.assert_allclose(got.adjustment_weights.numpy(),
                                   np.asarray(want.adjustment_weights), rtol=0, atol=FN_TOL)
        # equal gaps leave the weights where they are
        same = tga.update_after_eval(tst, {"checkpoint": torch.tensor(val) + 1.0}, {},
                                     torch.ones(4))
        np.testing.assert_array_equal(same.adjustment_weights.numpy(),
                                      tst.adjustment_weights.numpy())


def test_feddg_ga_with_the_adaptive_constraint_matches_jax():
    arrays = []
    for i in range(3):
        x, y = synthetic_classification(jax.random.PRNGKey(20 + i), 40, (6,), 3, class_sep=2.5)
        x, y = np.asarray(x), np.asarray(y)
        arrays.append((x[:32], y[:32], x[32:], y[32:]))
    kw = dict(n_clients=3, num_rounds=4, initial_drift_penalty_weight=0.1,
              loss_weight_patience=1, loss_weight_delta=0.05)
    js, (ts,) = _pair(
        JFedDgGaAC(**kw), lambda: TFedDgGaAC(**kw),
        jlogic=JFedProx(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                        jengine.masked_cross_entropy),
        tlogic=TFedProx(tengine.from_module(TMlp(6, (16,), 3)), tengine.masked_cross_entropy),
        arrays=arrays, local_steps=4, seed=1, extra_loss_keys=("vanilla", "penalty"))
    js.fit(4)
    ts.fit(4)
    _close(js, ts, ("vanilla", "penalty"))
    for field in ("adjustment_weights", "drift_penalty_weight", "previous_loss"):
        np.testing.assert_allclose(getattr(ts.server_state, field).numpy(),
                                   np.asarray(getattr(js.server_state, field)), rtol=0, atol=TOL)
    assert int(ts.server_state.loss_drop_streak) == int(js.server_state.loss_drop_streak)
    assert float(ts.server_state.drift_penalty_weight) != 0.1


# ---------------------------------------------------------------------------
# Criteria and loss containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["masked_mse", "masked_bce_with_logits"])
def test_criteria_match_jax(name):
    r = np.random.default_rng(5)
    preds = r.normal(size=(6, 3, 2)).astype(np.float32) * 3
    targets = (r.uniform(size=(6, 3, 2)) > 0.5).astype(np.float32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], np.float32)
    want = float(getattr(jengine, name)(jnp.asarray(preds), jnp.asarray(targets),
                                        jnp.asarray(mask)))
    got = float(getattr(tengine, name)(torch.tensor(preds), torch.tensor(targets),
                                       torch.tensor(mask)))
    assert got == pytest.approx(want, abs=FN_TOL)
    empty = getattr(tengine, name)(torch.tensor(preds), torch.tensor(targets), torch.zeros(6))
    assert float(empty) == 0.0


@pytest.mark.parametrize("meter_type", ["AVERAGE", "ACCUMULATION"])
def test_loss_meters_and_containers_match_jax(meter_type):
    assert [t.value for t in tcontainers.LossMeterType] == [
        t.value for t in jcontainers.LossMeterType]
    jm = jcontainers.LossMeter.create(("a", "b"), meter_type)
    tm = tcontainers.LossMeter.create(("a", "b"), meter_type)
    for step, w in enumerate((1.0, 0.0, 1.0)):
        jm = jm.update({"a": jnp.asarray(step + 0.5), "b": jnp.asarray(2.0 * step)}, w)
        tm = tm.update({"a": torch.tensor(step + 0.5), "b": torch.tensor(2.0 * step)}, w)
    want, got = jm.compute(), tm.compute()
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    tl = tcontainers.TrainingLosses(torch.tensor(1.0), {"x": torch.tensor(2.0)})
    el = tcontainers.EvaluationLosses(torch.tensor(3.0))
    jl = jcontainers.TrainingLosses(jnp.asarray(1.0), {"x": jnp.asarray(2.0)})
    assert {k: float(v) for k, v in tl.as_dict().items()} == {
        k: float(v) for k, v in jl.as_dict().items()}
    assert {k: float(v) for k, v in el.as_dict().items()} == {"checkpoint": 3.0}
