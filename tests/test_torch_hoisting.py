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

import torch_threads  # noqa: F401  (first: one torch thread a test process)
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


# -- the attr-kind scalars as 0-d tensors (a sweep cell's hvec entries) ------

def _stacked(n: int = 5, seed: int = 0):
    r = np.random.default_rng(seed)
    stacked = {"w": r.standard_normal((n, 3, 4)).astype(np.float32),
               "b": r.standard_normal((n, 4)).astype(np.float32)}
    stacked["w"][1] *= 40.0  # an outlier the trim and the norm bound act on
    reference = {k: r.standard_normal(v.shape[1:]).astype(np.float32)
                 for k, v in stacked.items()}
    mask = np.asarray([1, 1, 0, 1, 1][:n], np.float32)
    return stacked, reference, mask


def _meta(tree):
    return {k: torch.empty(v.shape, dtype=torch.float32, device="meta") for k, v in tree.items()}


@pytest.mark.parametrize("fraction", [0.0, 0.2, 0.34, 0.4999, 0.7, -0.3])
def test_trim_fraction_as_a_tensor_is_jax_traced_path(fraction):
    """JAX's traced trimmed mean clamps the fraction into [0, 0.4999] in f32
    where a float is checked; a 0-d tensor computes that, on its device."""
    import jax
    import jax.numpy as jnp

    from fl4health_tpu.resilience import aggregators as jagg
    from fl4health_tpu_torch.resilience import aggregators as tagg

    stacked, _, mask = _stacked()
    want = jax.jit(lambda tf: jagg.trimmed_mean(stacked, jnp.asarray(mask), tf))(
        jnp.float32(fraction))
    got = tagg.trimmed_mean({k: torch.tensor(v) for k, v in stacked.items()},
                            torch.tensor(mask), torch.tensor(fraction))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    # never read on the host: the same call on meta tensors (no values) runs
    tagg.trimmed_mean(_meta(stacked), torch.empty((5,), device="meta"),
                      torch.empty((), device="meta"))
    if 0.0 <= fraction < 0.5:  # a float still computes the same, in range
        as_float = tagg.trimmed_mean({k: torch.tensor(v) for k, v in stacked.items()},
                                     torch.tensor(mask), fraction)
        for k in stacked:
            assert torch.equal(as_float[k], got[k]), k


@pytest.mark.parametrize("bound", [0.5, 4.0, 1000.0])
def test_max_update_norm_as_a_tensor_is_jax_traced_path(bound):
    import jax
    import jax.numpy as jnp

    from fl4health_tpu.resilience import aggregators as jagg
    from fl4health_tpu_torch.resilience import aggregators as tagg

    stacked, reference, mask = _stacked()
    counts = np.asarray([3, 1, 2, 5, 4], np.float32)
    want = jax.jit(lambda m: jagg.norm_bounded_mean(
        stacked, reference, jnp.asarray(counts), jnp.asarray(mask), m))(jnp.float32(bound))
    got = tagg.norm_bounded_mean(
        {k: torch.tensor(v) for k, v in stacked.items()},
        {k: torch.tensor(v) for k, v in reference.items()}, torch.tensor(counts),
        torch.tensor(mask), torch.tensor(bound))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    tagg.norm_bounded_mean(_meta(stacked), _meta(reference), torch.empty((5,), device="meta"),
                           torch.empty((5,), device="meta"), torch.empty((), device="meta"))


@pytest.mark.parametrize("exponent", [0.0, 0.3, 0.5, 1.7])
def test_staleness_exponent_as_a_tensor_is_jax_traced_path(exponent):
    import jax
    import jax.numpy as jnp

    staleness = np.asarray([0, 1, 2, 5, 30], np.float32)
    arrivals = np.asarray([1, 1, 0, 1, 1], np.float32)
    t, j = _chains(False)["fedbuff"], _chains(True)["fedbuff"]

    def jmask(e):
        with jh.bind_traced_scalars(j, {"staleness_exponent": e}):
            return j.async_aggregation_mask(jnp.asarray(arrivals), jnp.asarray(staleness))

    want = jax.jit(jmask)(jnp.float32(exponent))
    with th.bind_traced_scalars(t, {"staleness_exponent": torch.tensor(exponent)}):
        got = t.async_aggregation_mask(torch.tensor(arrivals), torch.tensor(staleness))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_async_routes_pass_a_bound_exponent_tensor_as_it_is():
    sim = drill_sim("torch", "chunked")
    sim.strategy = _chains(False)["fedbuff"]
    value = torch.empty((), device="meta")  # a read on the host would raise
    with th.bind_traced_scalars(sim.strategy, {"staleness_exponent": value}):
        assert sim._staleness_exponent_input() is value
    assert float(sim._staleness_exponent_input()) == np.float32(0.7)


@pytest.mark.parametrize("ends", [(0.4, 0.2), (0.05, 0.37), (0.3333, 0.1111), (0.49, 0.01)])
def test_topk_schedule_endpoints_as_tensors_are_jax_traced_path(ends):
    """The effective fraction, fed 0-d tensor endpoints, equals JAX's jitted
    traced path bit for bit (the traced endpoints are f32, so it may part
    from the float path's f64 difference by an ulp), and the count it keeps
    on its device is the float path's count of the same fraction."""
    import jax
    import jax.numpy as jnp

    from fl4health_tpu_torch.compression import codecs as tcodecs

    t, j = _chains(False)["compressed_schedule"], _chains(True)["compressed_schedule"]

    def jfraction(f0, f1, r):
        with jh.bind_traced_scalars(j, {"topk_f_start": f0, "topk_f_end": f1}):
            return j.effective_topk_fraction(r)

    compiled = jax.jit(jfraction)
    cfg = TCompression(topk_fraction=0.5, topk_schedule=("linear", *ends, 3))
    update = {"w": torch.linspace(-1.0, 1.0, 37).reshape(37)}
    for r in range(1, 6):
        want = np.float32(compiled(jnp.float32(ends[0]), jnp.float32(ends[1]), jnp.int32(r)))
        with th.bind_traced_scalars(t, {"topk_f_start": torch.tensor(ends[0]),
                                        "topk_f_end": torch.tensor(ends[1])}):
            got = t.effective_topk_fraction(r)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert np.float32(got.item()) == want, r
        by_tensor, _ = tcodecs.compress_update(update, None, None, cfg, got)
        by_float, _ = tcodecs.compress_update(update, None, None, cfg, np.float32(got.item()))
        assert torch.equal(by_tensor["w"], by_float["w"]), r
    with th.bind_traced_scalars(t, {"topk_f_start": torch.empty((), device="meta"),
                                    "topk_f_end": torch.empty((), device="meta")}):
        assert t.effective_topk_fraction(2).device.type == "meta"


def test_a_trim_fraction_sweep_over_robust_fedavg_equals_jax():
    """The sweep feeds trim_fraction in the cell's hvec (a 0-d tensor): each
    cell equals the port's standalone run built with that fraction bit for
    bit, and JAX's cell (its traced fraction) at 5e-4."""
    from fl4health_tpu.sweep import run_sweep as jrun
    from fl4health_tpu_torch.sweep import run_sweep as trun
    from torch_sweep_sims import partitioner, spec_pair, standalone

    pairs = {"strategies": ({"robust": lambda: JRobust(method="trimmed_mean")},
                            {"robust": lambda: TRobust(method="trimmed_mean")})}
    jspec, tspec = spec_pair(("fedavg",), ("sgd",), seeds=(5,), cohort_sizes=(5,),
                             scalars={"trim_fraction": (0.0, 0.2, 0.45)}, pairs=pairs)
    tcells, jcells = trun(tspec, device="cpu").cells, jrun(jspec).cells
    assert [c.cell.label() for c in tcells] == [c.cell.label() for c in jcells] == [
        f"robust/sgd/p0/c5/s5/trim_fraction={v:g}" for v in (0.0, 0.2, 0.45)]
    for r, j in zip(tcells, jcells):
        fraction = r.cell.scalar_dict["trim_fraction"]
        tspec.strategies = {"robust": lambda: TRobust(method="trimmed_mean",
                                                      trim_fraction=fraction)}
        fit_ref, eval_ref = standalone(r.cell, tspec, partitioner(0, False)(5), False)
        assert r.fit_losses == fit_ref and r.eval_losses == eval_ref, r.cell.label()
        np.testing.assert_allclose(r.eval_losses, j.eval_losses, rtol=0, atol=TOL)
        np.testing.assert_allclose(r.fit_losses, j.fit_losses, rtol=0, atol=TOL)
    assert tcells[0].eval_losses != tcells[2].eval_losses
