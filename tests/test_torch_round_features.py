"""The round's features in the port against the JAX package on the CPU:
the failure policy (``tests/server/test_servers.py``), the test split and its
``"test - "`` keys (``tests/server/test_simulation.py``), a logic's extra and
eval loss keys and ``evaluate_after_fit``, early stopping (the linear-model
cases of ``tests/clients/test_early_stopping.py`` at 1e-6, and 2-round
simulations, with and without DP noise, within 5e-4), the early-stopped
client vmap against the loop (1e-5, the client axis's tolerance in
tests/test_torch_client_axis.py), and the ``JsonReporter`` file. Runs start
from the converted flax init and the same numpy data; 5e-4 is the f32 CPU
tolerance of tests/conftest.py."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import (
    InstanceLevelDpClientLogic as JDpLogic,
)
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import cnn as jcnn
from fl4health_tpu.reporting.base import JsonReporter as JJsonReporter
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import (
    InstanceLevelDpClientLogic as TDpLogic,
)
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.reporting.base import JsonReporter as TJsonReporter
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

N_CLASSES, DIM = 3, 6
TOL = 5e-4
AXIS_TOL = 1e-5


def _arrays(n_clients, seed, n, shape=(DIM,), n_classes=N_CLASSES):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((n, *shape)).astype(np.float32),
             r.integers(0, n_classes, n).astype(np.int32)) for _ in range(n_clients)]


def _datasets(module, n_clients=3, seed=0, with_test=False, poison=None):
    """32 train, 16 val (and 8 test) rows a client; client ``poison``'s
    training features are NaN."""
    out = []
    for i, (x, y) in enumerate(_arrays(n_clients, seed, 56)):
        xt = np.full_like(x[:32], np.nan) if i == poison else x[:32]
        kw = dict(x_test=x[48:], y_test=y[48:]) if with_test else {}
        out.append(module.ClientDataset(xt, y[:32], x[32:48], y[32:48], **kw))
    return out


def _pair(jlogic=None, tlogic=None, jstrategy=None, tstrategy=None, datasets=None,
          seed=1, local_steps=None, **kw):
    """The same FedAvg run (an MLP unless given) in both packages, the port
    from the flax init; ``kw`` values are (JAX's, the port's) pairs."""
    jlogic = jlogic or jengine.ClientLogic(
        jengine.from_flax(jcnn.Mlp(features=(8,), n_outputs=N_CLASSES)),
        jengine.masked_cross_entropy)
    tlogic = tlogic or tengine.ClientLogic(
        tengine.from_module(tcnn.Mlp(DIM, (8,), N_CLASSES)), tengine.masked_cross_entropy)
    datasets = datasets or (lambda m: _datasets(m))
    common = dict(batch_size=8, seed=seed, **(
        dict(local_epochs=1) if local_steps is None else dict(local_steps=local_steps)))
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    js = jsim.FederatedSimulation(
        logic=jlogic, tx=optax.sgd(0.05), strategy=jstrategy or JFedAvg(),
        datasets=datasets(jsim), metrics=JMetricManager((jefficient.accuracy(),)),
        execution_mode="pipelined", **common, **jkw)
    ts = tsim.FederatedSimulation(
        logic=tlogic, tx=optim.sgd(0.05), strategy=tstrategy or TFedAvg(),
        datasets=datasets(tsim), metrics=TMetricManager((tefficient.accuracy(),)),
        execution_mode="pipelined", device="cpu", **common, **tkw)
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    return js, ts


def _assert_runs_close(jhist, thist, jparams, tparams, tol=TOL):
    assert [r.round for r in thist] == [r.round for r in jhist]
    for jr, tr in zip(jhist, thist):
        for field in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics"):
            got, want = getattr(tr, field), getattr(jr, field)
            # JAX averages a logic's telemetry keys on its telemetry build
            # only; the port always does (ROADMAP C)
            assert set(want) <= set(got), field
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                           err_msg=f"{field}[{k}] round {jr.round}")
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in want.items():
        np.testing.assert_allclose(tparams[k].numpy(), v.numpy(), atol=tol, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Failure policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [jsim, tsim], ids=["jax", "port"])
def test_failure_policy_accepts_and_raises(module):
    policy = module.FailurePolicy(accept_failures=True)
    losses = {"backward": np.asarray([1.0, np.nan, 2.0], np.float32)}
    mask = np.asarray([1.0, 1.0, 1.0], np.float32)
    assert policy.check(losses, mask) == [1]
    # a masked-out client's NaN is not a failure
    assert policy.check(losses, np.asarray([1.0, 0.0, 1.0], np.float32)) == []
    assert policy.check({"checkpoint": losses["backward"]}, mask) == []
    with pytest.raises(module.ClientFailuresError) as err:
        module.FailurePolicy(accept_failures=False).check(losses, mask)
    assert err.value.clients == [1]


def test_failed_client_is_excluded_from_the_aggregate_as_in_jax():
    js, ts = _pair(datasets=lambda m: _datasets(m, poison=1))
    jhist, thist = js.fit(2), ts.fit(2)
    for r in thist:
        assert np.isfinite(r.fit_losses["backward"])
    assert all(torch.isfinite(v).all() for v in ts.global_params.values())
    _assert_runs_close(jhist, thist, js.global_params, ts.global_params)


def test_strict_failure_policy_raises_naming_client_and_round():
    sim = _pair(datasets=lambda m: _datasets(m, poison=1),
                failure_policy=(None, tsim.FailurePolicy(accept_failures=False)))[1]
    with pytest.raises(tsim.ClientFailuresError, match=r"clients \[1\]") as err:
        sim.fit(3)
    assert err.value.clients == [1] and err.value.round == 1
    # the producer waited for round 1's screen: nothing was recorded, and
    # round 2 was never dispatched
    assert sim.history == []
    assert sim._consumer is None and sim._prefetcher is None


# ---------------------------------------------------------------------------
# Test split
# ---------------------------------------------------------------------------

def test_test_split_reports_prefixed_keys_as_in_jax():
    js, ts = _pair(datasets=lambda m: _datasets(m, with_test=True))
    jhist, thist = js.fit(2), ts.fit(2)
    rec = thist[-1]
    assert {"test - accuracy", "accuracy"} <= set(rec.eval_metrics)
    assert {"test - checkpoint", "checkpoint"} <= set(rec.eval_losses)
    _assert_runs_close(jhist, thist, js.global_params, ts.global_params)
    # the test split is its own data: its keys differ from the val keys
    assert rec.eval_losses["test - checkpoint"] != rec.eval_losses["checkpoint"]


@pytest.mark.parametrize("case,match", [
    ("y_without_x", "y_test set but x_test is None"),
    ("mixed", "no test split while others do"),
    ("x_without_y", "x_test set but y_test is None"),
    ("rows", "x_test has 8 rows but y_test has 5"),
])
def test_test_split_checks_raise_as_in_jax(case, match):
    def datasets(m):
        ds = _datasets(m, n_clients=2, with_test=True)
        d = ds[0]
        if case == "y_without_x":
            ds[0] = m.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val, y_test=d.y_test)
        elif case == "mixed":
            ds[1] = m.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
        elif case == "x_without_y":
            ds = [m.ClientDataset(e.x_train, e.y_train, e.x_val, e.y_val, x_test=e.x_test)
                  for e in ds]
        else:
            ds[0] = m.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val,
                                    x_test=d.x_test, y_test=d.y_test[:5])
        return ds

    for module, logic in (
            (jsim, jengine.ClientLogic(jengine.from_flax(jcnn.Mlp(features=(8,), n_outputs=3)),
                                       jengine.masked_cross_entropy)),
            (tsim, tengine.ClientLogic(tengine.from_module(tcnn.Mlp(DIM, (8,), 3)),
                                       tengine.masked_cross_entropy))):
        kw = dict(device="cpu") if module is tsim else {}
        tx = optim.sgd(0.05) if module is tsim else optax.sgd(0.05)
        strategy = TFedAvg() if module is tsim else JFedAvg()
        metrics = (TMetricManager((tefficient.accuracy(),)) if module is tsim
                   else JMetricManager((jefficient.accuracy(),)))
        with pytest.raises(ValueError, match=match):
            module.FederatedSimulation(logic=logic, tx=tx, strategy=strategy,
                                       datasets=datasets(module), batch_size=8,
                                       metrics=metrics, local_epochs=1, seed=0, **kw)


# ---------------------------------------------------------------------------
# Loss keys
# ---------------------------------------------------------------------------

class _JKeysLogic(jengine.ClientLogic):
    extra_loss_keys = ("l2",)
    eval_loss_keys = ("top_logit",)

    def training_loss(self, preds, features, batch, params, state, ctx):
        loss, _ = super().training_loss(preds, features, batch, params, state, ctx)
        l2 = sum(jnp.sum(p ** 2) for p in jax.tree_util.tree_leaves(params))
        return loss, {"l2": l2, "ignored": 2 * l2}

    def eval_loss(self, preds, features, batch, params, state, ctx):
        loss, _ = super().eval_loss(preds, features, batch, params, state, ctx)
        return loss, {"top_logit": jnp.max(preds["prediction"])}


class _TKeysLogic(tengine.ClientLogic):
    extra_loss_keys = ("l2",)
    eval_loss_keys = ("top_logit",)

    def training_loss(self, preds, features, batch, params, state, ctx):
        loss, _ = super().training_loss(preds, features, batch, params, state, ctx)
        l2 = sum((p ** 2).sum() for p in params.values())
        return loss, {"l2": l2, "ignored": 2 * l2}

    def eval_loss(self, preds, features, batch, params, state, ctx):
        loss, _ = super().eval_loss(preds, features, batch, params, state, ctx)
        return loss, {"top_logit": preds["prediction"].max()}


class _JPostFit(JFedAvg):
    evaluate_after_fit = True


class _TPostFit(TFedAvg):
    evaluate_after_fit = True


def _keys_pair(**kw):
    return _pair(
        jlogic=_JKeysLogic(jengine.from_flax(jcnn.Mlp(features=(8,), n_outputs=3)),
                           jengine.masked_cross_entropy),
        tlogic=_TKeysLogic(tengine.from_module(tcnn.Mlp(DIM, (8,), 3)),
                           tengine.masked_cross_entropy), **kw)


def test_logic_declared_loss_keys_match_jax():
    js, ts = _keys_pair(jstrategy=_JPostFit(), tstrategy=_TPostFit())
    jhist, thist = js.fit(2), ts.fit(2)
    for r in thist:
        assert set(r.fit_losses) == {"backward", "l2", "val_checkpoint_post_fit"}
        assert set(r.eval_losses) == {"checkpoint", "top_logit"}
    _assert_runs_close(jhist, thist, js.global_params, ts.global_params)


def test_constructor_loss_keys_win_over_the_logics():
    js, ts = _keys_pair(extra_loss_keys=(("ignored",), ("ignored",)),
                        eval_loss_keys=(("top_logit",), ("top_logit",)))
    jhist, thist = js.fit(1), ts.fit(1)
    assert set(thist[0].fit_losses) == {"backward", "ignored"}
    _assert_runs_close(jhist, thist, js.global_params, ts.global_params)


# ---------------------------------------------------------------------------
# Early stopping
# ---------------------------------------------------------------------------

def _linear_pair():
    """JAX's and the port's w * x model with scalar w, at w = 0."""
    def japply(params, model_state, x, train=True, rng=None):
        return ({"prediction": params["w"] * x}, {}), model_state

    def jmse(preds, targets, mask):
        m = mask.astype(jnp.float32)
        return jnp.sum(jnp.square(preds - targets) * m) / jnp.maximum(jnp.sum(m), 1.0)

    def tmse(preds, targets, mask):
        m = mask.float()
        return ((preds - targets) ** 2 * m).sum() / torch.clamp(m.sum(), min=1.0)

    jlogic = jengine.ClientLogic(
        jengine.ModelDef(init=lambda r, x: ({"w": jnp.zeros(())}, {}), apply=japply), jmse)
    tlogic = tengine.ClientLogic(tengine.ModelDef(
        init=lambda g: {"w": torch.zeros(())},
        apply=lambda params, ms, x, train=True: (({"prediction": params["w"] * x}, {}), ms)),
        tmse)
    jstate = jengine.create_train_state(jlogic, optax.sgd(0.1), jax.random.PRNGKey(0),
                                        jnp.ones((1,)))
    tstate = tengine.create_train_state(tlogic, optim.sgd(0.1), rng.PRNGKey(0),
                                        torch.Generator(), torch.device("cpu"))
    return jlogic, tlogic, jstate, tstate


def _stacks(x, y, steps):
    b = x.shape[0] // steps
    arrays = (x.reshape(steps, b), y.reshape(steps, b), np.ones((steps, b), np.float32),
              np.ones((steps,), np.float32))
    return (jengine.Batch(*(jnp.asarray(a) for a in arrays)),
            tengine.Batch(*(torch.tensor(a) for a in arrays)))


@pytest.mark.parametrize("case", ["stops_and_restores", "never_stops"])
def test_early_stopping_linear_model_matches_jax(case):
    jlogic, tlogic, jstate, tstate = _linear_pair()
    if case == "stops_and_restores":
        # train pushes w -> 1, val wants w = 0: every check after the first
        # worsens, so patience 2 halts after 3 chunks and w reverts
        train = _stacks(np.ones(40, np.float32), np.ones(40, np.float32), 10)
        val = _stacks(np.ones(8, np.float32), np.zeros(8, np.float32), 2)
        cfg = dict(interval_steps=2, patience=2)
    else:
        x = np.linspace(-1, 1, 40).astype(np.float32)
        train, val = _stacks(x, 0.5 * x, 10), _stacks(x[:8], 0.5 * x[:8], 2)
        cfg = dict(interval_steps=2, patience=100)
    jtrain = jengine.make_local_train_with_early_stopping(
        jlogic, optax.sgd(0.1), JMetricManager(()), jengine.EarlyStoppingConfig(**cfg))
    ttrain = tengine.make_local_train_with_early_stopping(
        tlogic, optim.sgd(0.1), TMetricManager(()), tengine.EarlyStoppingConfig(**cfg))
    js, jl, _, jn = jax.jit(jtrain)(jstate, None, train[0], val[0])
    ts, tl, _, tn = ttrain(tstate, None, train[1], val[1])
    assert float(tn) == float(jn) == (6 if case == "stops_and_restores" else 10)
    np.testing.assert_allclose(float(ts.params["w"]), float(js.params["w"]), atol=1e-6)
    np.testing.assert_allclose(float(tl["backward"]), float(jl["backward"]), atol=1e-6)
    assert int(ts.step) == int(js.step)
    # the key advanced by one split a step, stopped or not
    np.testing.assert_array_equal(ts.rng.numpy(),
                                  np.asarray(jax.random.key_data(js.rng)))
    if case == "stops_and_restores":
        assert 0.0 < float(ts.params["w"]) < 0.9  # the chunk-1 snapshot


def test_early_stopping_pads_the_last_chunk_and_keeps_the_key_stream():
    # 5 steps in chunks of 2: a padded sixth step splits the key too
    jlogic, tlogic, jstate, tstate = _linear_pair()
    x = np.linspace(-1, 1, 40).astype(np.float32)
    train, val = _stacks(x, 0.5 * x, 5), _stacks(x[:8], 0.5 * x[:8], 2)
    cfg = dict(interval_steps=2, patience=100)
    jtrain = jengine.make_local_train_with_early_stopping(
        jlogic, optax.sgd(0.1), JMetricManager(()), jengine.EarlyStoppingConfig(**cfg))
    ttrain = tengine.make_local_train_with_early_stopping(
        tlogic, optim.sgd(0.1), TMetricManager(()), tengine.EarlyStoppingConfig(**cfg))
    js, _, _, jn = jax.jit(jtrain)(jstate, None, train[0], val[0])
    ts, _, _, tn = ttrain(tstate, None, train[1], val[1])
    assert float(tn) == float(jn) == 5
    want = tstate.rng
    for _ in range(6):
        want = rng.split(want)[0]
    assert torch.equal(ts.rng, want)
    np.testing.assert_array_equal(ts.rng.numpy(), np.asarray(jax.random.key_data(js.rng)))
    np.testing.assert_allclose(float(ts.params["w"]), float(js.params["w"]), atol=1e-6)


def _images(module, n_clients=2, seed=0):
    """Uneven clients of 8x8x3 images, 10 classes: 14 + 3i train rows (a
    ragged last batch), 8 val rows."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_clients):
        n_train = 14 + 3 * i
        x = r.standard_normal((n_train + 8, 8, 8, 3)).astype(np.float32)
        y = r.integers(0, 10, n_train + 8).astype(np.int32)
        out.append(module.ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


@pytest.mark.parametrize("sigma", [None, 0.0, 1.0], ids=["plain", "dp_sigma0", "dp_sigma1"])
def test_early_stopped_simulation_matches_jax(sigma):
    # 5 local steps in chunks of 2 with patience 1: three checks a round, a
    # padded step, and clients that stop inside the round
    es = (jengine.EarlyStoppingConfig(2, 1), tengine.EarlyStoppingConfig(2, 1))
    if sigma is None:
        js, ts = _pair(local_steps=5, early_stopping=es)
    else:
        js, ts = _pair(
            jlogic=JDpLogic(jengine.from_flax(jcnn.CifarNet()), jengine.masked_cross_entropy,
                            clipping_bound=1.0, noise_multiplier=sigma),
            tlogic=TDpLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                            tengine.masked_cross_entropy, clipping_bound=1.0,
                            noise_multiplier=sigma),
            datasets=_images, local_steps=5, early_stopping=es)
    jhist, thist = js.fit(2), ts.fit(2)
    _assert_runs_close(jhist, thist, js.global_params, ts.global_params)
    np.testing.assert_array_equal(ts.client_states.step.numpy(),
                                  np.asarray(js.client_states.step))
    np.testing.assert_array_equal(ts.client_states.rng.numpy(),
                                  np.asarray(jax.random.key_data(js.client_states.rng)))


@pytest.mark.parametrize("dp", [False, True], ids=["mlp", "instance_dp_sigma1"])
def test_early_stopped_clients_vmapped_match_the_loop(dp):
    def build():
        if dp:
            logic = TDpLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                             tengine.masked_cross_entropy, clipping_bound=1.0,
                             noise_multiplier=1.0)
            data = _images(tsim)
        else:
            logic = tengine.ClientLogic(tengine.from_module(tcnn.Mlp(DIM, (8,), 3)),
                                        tengine.masked_cross_entropy)
            data = _datasets(tsim)
        return tsim.FederatedSimulation(
            logic=logic, tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=data,
            batch_size=8, metrics=TMetricManager((tefficient.accuracy(),)),
            local_steps=5, seed=3, early_stopping=tengine.EarlyStoppingConfig(2, 1),
            device="cpu")

    runs = []
    for axis in (tsim.vmap_clients, tsim.loop_clients):
        sim = build()
        sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
        runs.append((sim.fit(2), sim.global_params, sim.client_states))
    (vh, vp, vs), (lh, lp, ls) = runs
    for a, b in zip(vh, lh):
        for k in a.fit_losses:
            np.testing.assert_allclose(a.fit_losses[k], b.fit_losses[k], atol=AXIS_TOL,
                                       rtol=0)
        np.testing.assert_allclose(a.eval_losses["checkpoint"], b.eval_losses["checkpoint"],
                                   atol=AXIS_TOL, rtol=0)
    for k in vp:
        np.testing.assert_allclose(vp[k].numpy(), lp[k].numpy(), atol=AXIS_TOL, rtol=0,
                                   err_msg=k)
    assert torch.equal(vs.rng, ls.rng) and torch.equal(vs.step, ls.step)
    # some client stopped early: fewer steps moved than were scheduled
    assert int(vs.step.sum()) < 2 * 5 * len(vs.step)


# ---------------------------------------------------------------------------
# JSON report
# ---------------------------------------------------------------------------

def _walk(a, b, path=""):
    """Same keys everywhere; numbers within TOL, but for wall-clock values."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (int, float)) and not isinstance(b, bool):
        if not any(s in path for s in ("elapsed", "fit_start", "fit_end")):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=path)
    elif not path.endswith("execution_mode_reason"):
        assert a == b, path


def test_json_report_matches_jax(tmp_path):
    jrep = JJsonReporter(str(tmp_path / "jax"), run_id="run")
    trep = TJsonReporter(str(tmp_path / "port"), run_id="run")
    js, ts = _pair(datasets=lambda m: _datasets(m, with_test=True),
                   reporters=([jrep], [trep]))
    js.fit(3)
    ts.fit(3)
    got = json.loads((tmp_path / "port" / "run.json").read_text())
    want = json.loads((tmp_path / "jax" / "run.json").read_text())
    _walk(got, want)
    assert sorted(got["rounds"]) == ["1", "2", "3"]
    assert got["execution_mode"] == tsim.EXEC_PIPELINED
    for r in ts.history:  # the report holds the history's values
        assert got["rounds"][str(r.round)]["eval_losses"] == r.eval_losses
        assert got["rounds"][str(r.round)]["fit_losses"] == r.fit_losses
