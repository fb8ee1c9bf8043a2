"""Ditto and MR-MTL in the port (``clients/ditto.py``,
``models/bases.py`` ``TwinModel``, ``DittoServer``, ``MrMtlServer``)
against the JAX package on the CPU, on the recipe of JAX's
``tests/clients/test_personalization.py`` (3 clients of 32 train and 16 val
rows, 8 features, 3 classes, ``Mlp(16)`` copies, SGD 0.05, batch 8, one
local epoch, seed 3, 3 rounds), the same numpy data and the JAX run's
converted init in both:

- Ditto, adaptive Ditto (under ``DittoServer``) and MR-MTL: each round's
  losses with every extra key (``penalty`` among them), the clients' twin
  subtrees after eval, the global params and the server's
  ``drift_penalty_weight`` within 5e-4;
- a flax ``TwinModel`` converts: flax's paths, the forward, the exchanged
  leaves;
- ``DittoServer`` and ``MrMtlServer`` refuse another strategy;
- a DP MR-MTL run (``InstanceLevelDpMixin`` over ``MrMtlClientLogic``)
  within 5e-4 of JAX's;
- R10 (ROADMAP.md C) in both packages: a sweep's ``mrmtl`` cell is the
  standalone run with the default exchanger, not MR-MTL's
  ``KeepLocalExchanger``.

Tolerance: 5e-4 for runs (f32, the reference's), 1e-6 for one forward."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.ditto import DittoClientLogic as JDitto
from fl4health_tpu.clients.ditto import KeepLocalExchanger as JKeepLocal
from fl4health_tpu.clients.ditto import MrMtlClientLogic as JMrMtl
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpMixin as JDpMixin
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.exchange.exchanger import FixedLayerExchanger as JFixedLayer
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import bases as jbases
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedprox import FedAvgWithAdaptiveConstraint as JAdaptive
from fl4health_tpu.sweep import run_sweep as jrun
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.ditto import DittoClientLogic as TDitto
from fl4health_tpu_torch.clients.ditto import KeepLocalExchanger as TKeepLocal
from fl4health_tpu_torch.clients.ditto import MrMtlClientLogic as TMrMtl
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpMixin as TDpMixin
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger as TFixedLayer
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import bases as tbases
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint as TAdaptive
from fl4health_tpu_torch.sweep import run_sweep as trun
from torch_sweep_sims import partitioner, spec_pair, standalone

TOL = 5e-4
FN_TOL = 1e-6
N_CLASSES, DIM, HIDDEN = 3, 8, 16


class JDpMrMtl(JDpMixin, JMrMtl):
    pass


class TDpMrMtl(TDpMixin, TMrMtl):
    pass


def _arrays(n_clients: int = 3, n: int = 48) -> list:
    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(jax.random.PRNGKey(i), n, (DIM,), N_CLASSES)
        x, y = np.asarray(x), np.asarray(y)
        out.append((x[: n - 16], y[: n - 16], x[n - 16:], y[n - 16:]))
    return out


def _jmlp():
    return JMlp(features=(HIDDEN,), n_outputs=N_CLASSES)


def _tmlp():
    return TMlp(DIM, (HIDDEN,), N_CLASSES)


def _twin_logics(adaptive: bool):
    kw = dict(adaptive=True) if adaptive else dict(lam=0.5)
    jmodel = jbases.TwinModel(global_model=_jmlp(), personal_model=_jmlp())
    tmodel = tbases.TwinModel(_tmlp(), _tmlp())
    return (JDitto(jengine.from_flax(jmodel), jengine.masked_cross_entropy, **kw),
            TDitto(tengine.from_module(tmodel), tengine.masked_cross_entropy, **kw))


def _pair(jlogic, tlogic, jexchanger, texchanger, jstrategy, tstrategy, **sim_kw):
    """The same run in both packages, the port from JAX's init."""
    common = dict(batch_size=8, seed=3, **sim_kw)
    if "local_steps" not in sim_kw:
        common["local_epochs"] = 1
    arrays = _arrays()
    js = JSim(logic=jlogic, tx=optax.sgd(0.05), strategy=jstrategy,
              datasets=[JDataset(*a) for a in arrays],
              metrics=JMetricManager((jefficient.accuracy(),)), exchanger=jexchanger,
              **common)
    ts = TSim(logic=tlogic, tx=optim.sgd(0.05), strategy=tstrategy,
              datasets=[TDataset(*a) for a in arrays],
              metrics=TMetricManager((tefficient.accuracy(),)), exchanger=texchanger,
              device="cpu", **common)
    ts.set_global_params(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                      js.global_params)))
    return js, ts


def _flat(jtree) -> dict:
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jtree))


def _close_history(jhist, thist, keys):
    assert len(jhist) == len(thist)
    for j, t in zip(jhist, thist):
        assert set(keys) <= set(t.fit_losses) and set(t.fit_losses) == set(j.fit_losses)
        for k in t.fit_losses:
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0, atol=TOL,
                                       err_msg=f"round {t.round} {k}")
        for k in ("checkpoint",):
            np.testing.assert_allclose(t.eval_losses[k], j.eval_losses[k], rtol=0, atol=TOL)
        np.testing.assert_allclose(t.eval_metrics["accuracy"], j.eval_metrics["accuracy"],
                                   rtol=0, atol=TOL)


def _close_params(want: dict, got: dict):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("adaptive", [False, True], ids=["ditto", "adaptive_ditto"])
def test_ditto_matches_jax(adaptive):
    jlogic, tlogic = _twin_logics(adaptive)
    if adaptive:
        jstrat, tstrat = (JAdaptive(initial_drift_penalty_weight=0.3),
                          TAdaptive(initial_drift_penalty_weight=0.3))
    else:
        jstrat, tstrat = JFedAvg(), TFedAvg()
    js, ts = _pair(jlogic, tlogic, JFixedLayer(jbases.TwinModel.exchange_global_model),
                   TFixedLayer(tbases.TwinModel.exchange_global_model), jstrat, tstrat)
    jhist = js.fit(3)
    thist = tservers.DittoServer(ts).fit(3) if adaptive else ts.fit(3)
    _close_history(jhist, thist, ("backward", "global_ce", "personal_ce", "penalty"))
    assert all(np.isfinite(t.fit_losses["penalty"]) for t in thist)
    # the twin subtrees after eval: the pulled globals, the kept personals
    _close_params(_flat(js.client_states.params), ts.client_states.params)
    _close_params(_flat(js.global_params), ts.global_params)
    params = ts.client_states.params
    glob = torch.cat([params[k].reshape(3, -1) for k in params
                      if k.startswith("global_model/")], 1)
    pers = torch.cat([params[k].reshape(3, -1) for k in params
                      if k.startswith("personal_model/")], 1)
    assert torch.equal(glob[0], glob[1]) and torch.equal(glob[1], glob[2])
    assert float((pers[0] - pers[1]).abs().max()) > 1e-6
    if adaptive:
        np.testing.assert_allclose(float(ts.server_state.drift_penalty_weight),
                                   float(js.server_state.drift_penalty_weight), atol=FN_TOL)


def test_mr_mtl_matches_jax_and_keeps_its_personal_model():
    logic_kw = dict(lam=0.5)
    js, ts = _pair(JMrMtl(jengine.from_flax(_jmlp()), jengine.masked_cross_entropy, **logic_kw),
                   TMrMtl(tengine.from_module(_tmlp()), tengine.masked_cross_entropy, **logic_kw),
                   JKeepLocal(), TKeepLocal(), JFedAvg(), TFedAvg())
    _close_history(js.fit(3), ts.fit(3), ("backward", "vanilla", "penalty"))
    _close_params(_flat(js.client_states.params), ts.client_states.params)
    _close_params(_flat(js.global_params), ts.global_params)
    agg = torch.cat([v.reshape(-1) for v in ts.global_params.values()])
    mine = torch.cat([v[0].reshape(-1) for v in ts.client_states.params.values()])
    assert float((mine - agg).abs().max()) > 1e-6


def test_dp_mr_mtl_matches_jax():
    kw = dict(lam=0.5, adaptive=True, clipping_bound=1.0, noise_multiplier=0.5)
    js, ts = _pair(JDpMrMtl(jengine.from_flax(_jmlp()), jengine.masked_cross_entropy, **kw),
                   TDpMrMtl(tengine.from_module(_tmlp()), tengine.masked_cross_entropy, **kw),
                   JKeepLocal(), TKeepLocal(), JAdaptive(initial_drift_penalty_weight=0.2),
                   TAdaptive(initial_drift_penalty_weight=0.2), local_steps=2)
    jhist = js.fit(2)
    thist = tservers.MrMtlServer(ts).fit(2)
    _close_history(jhist, thist, ("backward", "vanilla", "penalty"))
    _close_params(_flat(js.client_states.params), ts.client_states.params)
    _close_params(_flat(js.global_params), ts.global_params)


def test_a_flax_twin_model_converts():
    jmodel = jbases.TwinModel(global_model=_jmlp(), personal_model=_jmlp())
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (5, DIM)), np.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0), x)["params"]
    params = _flat(jparams)
    tmodel = tbases.TwinModel(_tmlp(), _tmlp())
    own = tmodel.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    assert {k.split("/")[0] for k in params} == {"global_model", "personal_model"}
    jpreds, _ = jmodel.apply({"params": jparams}, x)
    (tpreds, tfeatures), _ = tengine.from_module(tmodel).apply(params, {}, torch.tensor(x))
    assert set(tpreds) == {"global", "personal", "prediction"}
    assert set(tfeatures) == {"global_features", "personal_features"}
    for k in tpreds:
        np.testing.assert_allclose(tpreds[k].detach().numpy(), np.asarray(jpreds[k]),
                                   rtol=FN_TOL, atol=FN_TOL)
    # the exchanged leaves: the global copy's, in both packages
    mask = TFixedLayer(tbases.TwinModel.exchange_global_model).mask(params)
    assert {k for k, m in mask.items() if m} == {
        k for k in params if jbases.TwinModel.exchange_global_model(k)}
    assert all(k.startswith("global_model/") for k, m in mask.items() if m)


@pytest.mark.parametrize("server", ["DittoServer", "MrMtlServer"])
def test_the_servers_refuse_another_strategy(server):
    arrays = _arrays(1)
    sim = TSim(logic=TMrMtl(tengine.from_module(_tmlp()), tengine.masked_cross_entropy),
               tx=optim.sgd(0.05), strategy=TFedAvg(),
               datasets=[TDataset(*a) for a in arrays], batch_size=8,
               metrics=TMetricManager(()), local_steps=1, device="cpu")
    with pytest.raises(AssertionError, match="requires FedAvgWithAdaptiveConstraint"):
        getattr(tservers, server)(sim)
    sim.strategy = TAdaptive()
    assert getattr(tservers, server)(sim).sim is sim


def test_r10_a_sweep_mrmtl_cell_is_not_mr_mtl_in_either_package():
    """The runner builds its template simulation without an exchanger, so a
    ``mrmtl`` cell runs under the default FullExchanger: the aggregate
    overwrites each client's personal model every round. It equals the
    standalone run with the default exchanger and parts from MR-MTL's own
    (KeepLocalExchanger), in JAX as in the port."""
    jspec, tspec = spec_pair(("fedavg",), ("mrmtl",), seeds=(5,))
    for jax_side, spec, run, keep in ((True, jspec, jrun, JKeepLocal()),
                                      (False, tspec, lambda s: trun(s, device="cpu"),
                                       TKeepLocal())):
        (cell,) = run(spec).cells
        datasets = partitioner(0, jax_side)(3)
        default = standalone(cell.cell, spec, datasets, jax_side)
        mr_mtl = standalone(cell.cell, spec, datasets, jax_side, exchanger=keep)
        assert (cell.fit_losses, cell.eval_losses) == default
        assert cell.eval_losses != mr_mtl[1]
