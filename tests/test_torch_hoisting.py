"""The scalar hoisting (``sweep/hoisting.py``) against the JAX package's:

- the binding table: the same seven names in the same order, kinds,
  attributes and docs, and the validators' messages word for word;
- ``applicable_scalars``, ``live_rebind_kind`` and the defaults on every
  strategy chain the port has (wrappers included), equal to JAX's;
- ``apply_state_scalars`` and ``bind_traced_scalars``: what they write, the
  errors they raise (the same messages), the attributes restored on exit;
- a ``server_lr`` rebind on ``fed_adam``: rebinding a fresh run's state
  trains as a run built with that learning rate from the start (bit for
  bit), and trains as JAX's same rebind (5e-4)."""

import numpy as np
import pytest
import torch

from fl4health_tpu.compression.config import CompressionConfig as JCompression
from fl4health_tpu.compression.strategy import CompressingStrategy as JCompressing
from fl4health_tpu.resilience.aggregators import RobustFedAvg as JRobust
from fl4health_tpu.resilience.quarantine import QuarantiningStrategy as JQuarantining
from fl4health_tpu.strategies import fedopt as jfedopt
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedbuff import FedBuff as JFedBuff
from fl4health_tpu.strategies.fedprox import FedAvgWithAdaptiveConstraint as JProx
from fl4health_tpu.strategies.scaffold import Scaffold as JScaffold
from fl4health_tpu.sweep import hoisting as jh
from fl4health_tpu_torch.compression.config import CompressionConfig as TCompression
from fl4health_tpu_torch.compression.strategy import CompressingStrategy as TCompressing
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg as TRobust
from fl4health_tpu_torch.resilience.quarantine import QuarantiningStrategy as TQuarantining
from fl4health_tpu_torch.strategies import fedopt as tfedopt
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedbuff import FedBuff as TFedBuff
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint as TProx
from fl4health_tpu_torch.strategies.scaffold import Scaffold as TScaffold
from fl4health_tpu_torch.sweep import hoisting as th
from torch_resilience_sims import TOL, drill_pair, drill_sim

_SCHEDULE = dict(topk_fraction=0.5, topk_schedule=("linear", 0.4, 0.2, 3))


def _chains(j: bool) -> dict:
    """Every strategy chain the port has, built in one package."""
    fedavg, robust, prox, buff, comp, quar, scaffold = (
        (JFedAvg, JRobust, JProx, JFedBuff, JCompressing, JQuarantining, JScaffold) if j
        else (TFedAvg, TRobust, TProx, TFedBuff, TCompressing, TQuarantining, TScaffold))
    fo, cfg = (jfedopt, JCompression) if j else (tfedopt, TCompression)
    return {
        "fedavg": fedavg(),
        "fed_adam": fo.fed_adam(lr=0.02),
        "fed_yogi": fo.fed_yogi(),
        "fed_adagrad": fo.fed_adagrad(),
        "fed_avg_m": fo.fed_avg_m(lr=0.5),
        "fedprox": prox(initial_drift_penalty_weight=0.3),
        "scaffold": scaffold(),
        "robust_trimmed": robust(method="trimmed_mean", trim_fraction=0.1),
        "robust_norm": robust(method="norm_bounded", max_update_norm=4.0),
        "fedbuff": buff(fedavg(), staleness_exponent=0.7),
        "compressed_schedule": comp(fo.fed_adam(lr=0.02), cfg(**_SCHEDULE), n_clients=4),
        "compressed_plain": comp(fedavg(), cfg(topk_fraction=0.5), n_clients=4),
        "quarantined_prox": quar(prox(), n_clients=4),
        "buffered_quarantined_robust": buff(quar(robust(method="trimmed_mean"), n_clients=4)),
    }


def test_binding_table_equals_jax():
    assert list(th.SCALAR_BINDINGS) == list(jh.SCALAR_BINDINGS)
    assert len(th.SCALAR_BINDINGS) == 7
    for name, tb in th.SCALAR_BINDINGS.items():
        jb = jh.SCALAR_BINDINGS[name]
        assert (tb.kind, tb.attr, tb.doc) == (jb.kind, jb.attr, jb.doc), name
        assert tb.owner().__name__ == jb.owner().__name__
        assert (tb.validate is None) == (jb.validate is None)
        assert (tb.validate_owner is None) == (jb.validate_owner is None)
    with pytest.raises(KeyError) as te:
        th.binding("nope")
    with pytest.raises(KeyError) as je:
        jh.binding("nope")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name,bad", [("server_lr", 0.0), ("proximal_weight", -1.0),
                                      ("trim_fraction", 0.5), ("max_update_norm", -2.0),
                                      ("staleness_exponent", -0.1), ("topk_f_start", 1.5),
                                      ("topk_f_end", 0.0), ("topk_f_end", 0.7)])
def test_validator_messages_equal_jax(name, bad):
    t_chain = _chains(False)["compressed_schedule"]
    j_chain = _chains(True)["compressed_schedule"]
    with pytest.raises(ValueError) as te:
        th.binding(name).check(t_chain, bad)
    with pytest.raises(ValueError) as je:
        jh.binding(name).check(j_chain, bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("chain", sorted(_chains(False)))
def test_applicable_scalars_and_defaults_equal_jax(chain):
    t, j = _chains(False)[chain], _chains(True)[chain]
    names = th.applicable_scalars(t)
    assert names == jh.applicable_scalars(j)
    assert ([type(s).__name__ for s in th.wrapper_chain(t)]
            == [type(s).__name__ for s in jh.wrapper_chain(j)])
    for name in th.SCALAR_BINDINGS:
        for async_active in (False, True):
            assert (th.live_rebind_kind(t, name, async_active=async_active)
                    == jh.live_rebind_kind(j, name, async_active=async_active))
    for name in names:
        assert th.binding(name).default(t) == pytest.approx(jh.binding(name).default(j),
                                                            rel=1e-7)


def test_apply_state_scalars_writes_the_leaf_and_refuses_as_jax():
    t = _chains(False)["compressed_schedule"]
    params = {"w": torch.ones((2, 3)), "b": torch.zeros((3,))}
    state = t.init(params)
    new = th.apply_state_scalars(t, state, {"server_lr": 0.125})
    lr = new.inner.opt_state.hyperparams["learning_rate"]
    assert lr.dtype == torch.float32 and lr.ndim == 0 and float(lr) == 0.125
    # nothing else moved
    assert new.residual is state.residual and new.inner.params is state.inner.params
    prox = _chains(False)["quarantined_prox"]
    pstate = th.apply_state_scalars(prox, prox.init(params), {"proximal_weight": 0.75})
    assert float(pstate.inner.drift_penalty_weight) == 0.75
    for call in (lambda m, s, st: m.apply_state_scalars(s, st, {"trim_fraction": 0.1}),
                 lambda m, s, st: m.apply_state_scalars(s, st, {"server_lr": -1.0})):
        with pytest.raises(ValueError) as te:
            call(th, t, state)
        jt = _chains(True)["compressed_schedule"]
        with pytest.raises(ValueError) as je:
            call(jh, jt, None)
        assert str(te.value) == str(je.value)


def test_bind_traced_scalars_sets_and_restores_as_jax():
    t = _chains(False)["buffered_quarantined_robust"]
    robust = th.wrapper_chain(t)[-1]
    with th.bind_traced_scalars(t, {"trim_fraction": torch.tensor(0.3),
                                    "staleness_exponent": 2.0}):
        assert float(robust.trim_fraction) == pytest.approx(0.3)
        assert t.staleness_exponent == 2.0
    assert robust.trim_fraction == 0.2 and t.staleness_exponent == 0.5
    with pytest.raises(RuntimeError):
        with th.bind_traced_scalars(t, {"trim_fraction": 0.4}):
            raise RuntimeError("boom")
    assert robust.trim_fraction == 0.2
    j = _chains(True)["buffered_quarantined_robust"]
    for values in ({"server_lr": 0.1}, {"topk_f_start": 0.1}):
        with pytest.raises(ValueError) as te:
            with th.bind_traced_scalars(t, values):
                pass
        with pytest.raises(ValueError) as je:
            with jh.bind_traced_scalars(j, values):
                pass
        assert str(te.value) == str(je.value)


def _adam_sim(pkg, lr, init=None):
    mod = jfedopt if pkg == "jax" else tfedopt
    return drill_sim(pkg, "chunked", strategy=mod.fed_adam(lr=lr), init=init)


def test_server_lr_rebind_is_a_run_built_with_that_lr():
    built = _adam_sim("torch", 0.05)
    rebound = _adam_sim("torch", 0.01)
    rebound.server_state = th.apply_state_scalars(rebound.strategy, rebound.server_state,
                                                  {"server_lr": 0.05})
    built.fit(2)
    rebound.fit(2)
    assert [r.fit_losses for r in built.history] == [r.fit_losses for r in rebound.history]
    for k, v in built.global_params.items():
        assert torch.equal(v, rebound.global_params[k]), k


def test_server_lr_rebind_trains_as_jax():
    js, ts = drill_pair("chunked", lambda pkg, init: _adam_sim(pkg, 0.01, init))
    js.server_state = jh.apply_state_scalars(js.strategy, js.server_state, {"server_lr": 0.2})
    ts.server_state = th.apply_state_scalars(ts.strategy, ts.server_state, {"server_lr": 0.2})
    js.fit(2)
    ts.fit(2)
    want = convert.flax_to_torch(js.global_params)
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        ts.server_state.opt_state.hyperparams["learning_rate"].numpy(),
        np.asarray(js.server_state.opt_state.hyperparams["learning_rate"]))
