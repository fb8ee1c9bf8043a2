"""The chunked route (``FederatedSimulation(execution_mode=...)``,
``fit_chunk``) in the port on the CPU: its history equal to the pipelined
route's bit for bit (FedAvg, SCAFFOLD, partial participation, a test split,
``fit`` after ``fit_chunk``); the port's default ``"auto"`` against JAX's
(both ``chunked_scan``) within 5e-4 over 3 rounds; the same mode and reason
as JAX's for each configuration the port has; and ``fit_chunk``'s mask
shapes and provider error."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.reporting.base import JsonReporter as JJsonReporter
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.reporting.base import JsonReporter as TJsonReporter
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.server.client_manager import FixedFractionManager
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.scaffold import Scaffold

N_CLASSES, DIM = 3, 6
TOL = 5e-4
FIELDS = ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics")


def _datasets(module, n_clients=3, with_test=False):
    r = np.random.default_rng(0)
    out = []
    for i in range(n_clients):
        n = 56 - 6 * i  # uneven clients: padded steps and rows
        x = r.standard_normal((n, DIM)).astype(np.float32)
        y = r.integers(0, N_CLASSES, n).astype(np.int32)
        kw = dict(x_test=x[-8:], y_test=y[-8:]) if with_test else {}
        out.append(module.ClientDataset(x[:n - 24], y[:n - 24], x[n - 24:n - 8],
                                        y[n - 24:n - 8], **kw))
    return out


def _tsim(mode="auto", logic=None, strategy=None, **kw):
    model = tengine.from_module(TMlp(DIM, (12,), N_CLASSES))
    kw.setdefault("datasets", _datasets(tsim))
    return tsim.FederatedSimulation(
        logic=logic(model) if logic else tengine.ClientLogic(model,
                                                             tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=strategy or TFedAvg(), batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=5,
        execution_mode=mode, device="cpu", **kw)


def _jsim(mode="auto", **kw):
    kw.setdefault("datasets", _datasets(jsim))
    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(12,),
                                                         n_outputs=N_CLASSES)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=kw.pop("strategy", None) or JFedAvg(), batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=5,
        execution_mode=mode, **kw)


def _assert_same(a, b):
    assert [r.round for r in a.history] == [r.round for r in b.history]
    for ra, rb in zip(a.history, b.history):
        for f in FIELDS:
            assert getattr(ra, f) == getattr(rb, f), (ra.round, f)
    for x, y in zip(ptu.tree_leaves(a.server_state), ptu.tree_leaves(b.server_state)):
        assert torch.equal(x, y)
    for x, y in zip(ptu.tree_leaves(a.client_states), ptu.tree_leaves(b.client_states)):
        assert torch.equal(x, y)


def _scaffold():
    return dict(logic=lambda m: ScaffoldClientLogic(m, tengine.masked_cross_entropy,
                                                    learning_rate=0.05),
                strategy=Scaffold(learning_rate=1.0))


def _partial():
    return dict(client_manager=FixedFractionManager(3, 0.5))


@pytest.mark.parametrize("case", ["fedavg", "scaffold", "partial", "test_split"])
def test_chunked_equals_pipelined_bit_for_bit(case):
    kw = {"scaffold": _scaffold, "partial": _partial,
          "test_split": lambda: dict(datasets=_datasets(tsim, with_test=True))}.get(
              case, dict)
    chunked, piped = _tsim("chunked", **kw()), _tsim("pipelined", **kw())
    chunked.fit(3)
    piped.fit(3)
    _assert_same(chunked, piped)
    assert all(r.eval_elapsed_s == 0.0 for r in chunked.history)
    if case == "test_split":
        assert "test - checkpoint" in chunked.history[-1].eval_losses


def test_fit_chunk_equals_per_round_dispatch():
    a, b = _tsim(**_partial()), _tsim(**_partial())
    val_batches, _ = a._val_batches()
    for r in range(1, 4):
        mask = a.client_manager.sample(rng.fold_in(a.rng, 2000 + r), r)
        a.server_state, a.client_states, *_ = a._fit_round(
            a.server_state, a.client_states, a._round_batches(r), mask, r, val_batches)
    losses, metrics = b.fit_chunk(start_round=1, k=3)
    assert losses["backward"].shape == (3,) and metrics["accuracy"].shape == (3,)
    for x, y in zip(ptu.tree_leaves(a.server_state), ptu.tree_leaves(b.server_state)):
        assert torch.equal(x, y)
    assert b.history == []


def test_fit_after_fit_chunk_matches_pipelined_and_jax():
    runs = []
    for mode in ("chunked", "pipelined"):
        sim = _tsim(mode)
        sim.fit_chunk(start_round=1, k=2)
        sim.fit(2)
        runs.append(sim)
    _assert_same(*runs)
    js = _jsim()
    ts = _tsim()
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    js.fit_chunk(start_round=1, k=2)
    ts.fit_chunk(start_round=1, k=2)
    jhist, thist = js.fit(2), ts.fit(2)
    for tr, jr in zip(thist, jhist):
        assert abs(tr.fit_losses["backward"] - jr.fit_losses["backward"]) <= TOL
        assert abs(tr.eval_losses["checkpoint"] - jr.eval_losses["checkpoint"]) <= TOL


def test_auto_matches_jax_auto(tmp_path):
    jrep = JJsonReporter(str(tmp_path / "jax"), run_id="run")
    trep = TJsonReporter(str(tmp_path / "port"), run_id="run")
    js = _jsim(datasets=_datasets(jsim, with_test=True), reporters=[jrep])
    ts = _tsim(datasets=_datasets(tsim, with_test=True), reporters=[trep])
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist, thist = js.fit(3), ts.fit(3)
    assert trep.data["execution_mode"] == jrep.data["execution_mode"] == tsim.EXEC_CHUNKED
    assert trep.data["execution_mode_reason"] == jrep.data["execution_mode_reason"]
    for r in ("1", "2", "3"):
        assert trep.data["rounds"][r]["execution_mode"] == tsim.EXEC_CHUNKED
        assert trep.data["rounds"][r]["eval_elapsed_s"] == 0.0
    assert [r.round for r in thist] == [r.round for r in jhist] == [1, 2, 3]
    for tr, jr in zip(thist, jhist):
        for f in FIELDS:
            want = getattr(jr, f)
            for k in want:
                np.testing.assert_allclose(getattr(tr, f)[k], want[k], atol=TOL, rtol=0,
                                           err_msg=f"{f}[{k}] round {jr.round}")
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=TOL, rtol=0)


class _JEvalStrategy(JFedAvg):
    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return server_state


class _TEvalStrategy(TFedAvg):
    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return server_state


def _provider(round_idx):
    return None


CONFIGS = {
    "eligible": lambda m: {},
    "provider": lambda m: dict(train_data_provider=_provider),
    "strict": lambda m: dict(failure_policy=m.FailurePolicy(accept_failures=False)),
    "update_after_eval": lambda m: dict(
        strategy=_JEvalStrategy() if m is jsim else _TEvalStrategy()),
}


@pytest.mark.parametrize("mode", ["auto", "pipelined", "chunked"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mode_and_reason_as_in_jax(config, mode):
    js, ts = _jsim(mode, **CONFIGS[config](jsim)), _tsim(mode, **CONFIGS[config](tsim))
    for n_rounds in (0, 3):
        try:
            want = js._select_execution_mode(n_rounds)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                ts._select_execution_mode(n_rounds)
            assert str(got.value) == str(err)
            continue
        assert ts._select_execution_mode(n_rounds) == want


def test_unknown_mode_is_refused():
    with pytest.raises(ValueError, match="execution_mode must be"):
        _tsim("scan")


def test_fit_chunk_masks_and_provider_error():
    a, b, c = _tsim(), _tsim(), _tsim()
    a.fit_chunk(1, 2, mask=np.asarray([1.0, 0.0, 1.0], np.float32))
    b.fit_chunk(1, 2, mask=np.asarray([[1.0, 0.0, 1.0]] * 2, np.float32))
    for x, y in zip(ptu.tree_leaves(a.server_state), ptu.tree_leaves(b.server_state)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match=r"fit_chunk mask must have shape \(2, 3\) or \(3,\)"):
        c.fit_chunk(1, 2, mask=np.ones((2, 2), np.float32))
    with pytest.raises(ValueError, match="cannot honor train_data_provider"):
        _tsim(train_data_provider=_provider).fit_chunk(1, 2)
