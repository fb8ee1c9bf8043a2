"""Buffered-async ``fit`` (FedBuff: ``server/async_schedule.py``,
``strategies/fedbuff.py``) in the port on the CPU, against itself and
against the JAX package (``tests/server/test_async_fit.py``'s cases that
the port's features allow):

- ``K`` = the cohort with no stragglers equals the synchronous run bit for
  bit on both routes, a corruption plan included;
- the pipelined and chunked async routes equal each other bit for bit
  (stragglers, dropout, compression, robust aggregation, NaN poison), and
  each run equals JAX's within 5e-4, its plan and each event's plan facts
  equal JAX's;
- two consecutive ``fit`` calls: each builds a fresh plan and prologue, as
  in JAX, and the port numbers the second call's records after the first;
- the FedBuff mask rule and cap, the wrapper's delegation, the arity shim
  for a 2-argument mask hook, and JAX's composition errors word for word."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import functools

import numpy as np
import pytest
import torch

from fl4health_tpu.compression.config import CompressionConfig as JCompression
from fl4health_tpu.resilience import aggregators as jagg
from fl4health_tpu.resilience import faults as jfaults
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedbuff import FedBuff as JFedBuff
from fl4health_tpu_torch.compression.config import CompressionConfig as TCompression
from fl4health_tpu_torch.resilience import aggregators as tagg
from fl4health_tpu_torch.resilience import faults as tfaults
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedbuff import FedBuff as TFedBuff
from tests.torch_async_sims import (assert_matches_jax, flat, jax_init, jsim_of, rows,
                                    same_history, tsim_of)

N = 4
DATA = rows(N)


def _straggler(m):
    return m.FaultPlan(client_faults=(m.ClientFault(clients=(0,), kind="slow", scale=5.0),))


def _dropout(m):
    return m.FaultPlan(client_faults=(
        m.ClientFault(clients=(1,), kind="dropout", probability=0.5),
        m.ClientFault(clients=(0,), kind="slow", scale=4.0)))


def _nan_poison(m):
    return m.FaultPlan(seed=2, client_faults=(
        m.ClientFault(clients=(1,), kind="nan", probability=0.5),
        m.ClientFault(clients=(0,), kind="slow", scale=5.0)))


# name: (AsyncConfig kwargs, fault plan, strategy (package -> strategy),
#        extra simulation kwargs (package -> dict), events)
CASES = {
    "stragglers": (dict(buffer_size=2, compute_jitter=0.05, seed=3), _straggler,
                   None, None, 4),
    "dropout": (dict(buffer_size=2, compute_jitter=0.05), _dropout, None, None, 4),
    "compression": (dict(buffer_size=2, compute_jitter=0.05), _straggler, None,
                    lambda p: dict(compression=(JCompression if p == "jax" else TCompression)(
                        quant_bits=8)), 3),
    "trimmed_mean": (dict(buffer_size=3, compute_jitter=0.05), _straggler,
                     lambda agg: agg.RobustFedAvg("trimmed_mean", trim_fraction=0.2), None, 3),
    # 3 arrivals an event, at most one poisoned: the median out-votes it
    "nan_poison_median": (dict(buffer_size=3, compute_jitter=0.05), _nan_poison,
                          lambda agg: agg.RobustFedAvg("median"), None, 3),
    "exponent_1_capped": (dict(buffer_size=2, compute_jitter=0.05, staleness_exponent=1.0,
                               max_staleness=1), _straggler, None, None, 4),
}


def _kwargs(case, pkg):
    cfg, faults, strategy, extra, _ = CASES[case]
    jax_side = pkg == "jax"
    return dict(
        async_config=(jas if jax_side else tas).AsyncConfig(**cfg),
        fault_plan=faults(jfaults if jax_side else tfaults),
        strategy=(strategy(jagg if jax_side else tagg) if strategy
                  else (JFedAvg() if jax_side else TFedAvg())),
        **(extra(pkg) if extra else {}))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    js = jsim_of(DATA, **_kwargs(case, "jax"))
    init = jax_init(js)
    return js, js.fit(CASES[case][-1]), init


@pytest.mark.parametrize("case", list(CASES))
def test_async_runs_match_jax_and_routes_are_bit_equal(case):
    js, jhist, init = _jax_run(case)
    runs = {}
    for mode in ("pipelined", "auto"):
        ts = tsim_of(DATA, mode=mode, **_kwargs(case, "torch"))
        assert isinstance(ts.strategy, TFedBuff)
        want = js._select_execution_mode(CASES[case][-1])
        assert ts._select_execution_mode(CASES[case][-1]) == (
            want if mode == "auto" else (tsim.EXEC_PIPELINED, "forced by execution_mode='pipelined'"))
        ts.set_global_params(init)
        ts.fit(CASES[case][-1])
        runs[mode] = ts
        for f in ("arrivals", "staleness", "event_times"):
            assert np.array_equal(getattr(ts._async_plan, f), getattr(js._async_plan, f))
        assert_matches_jax(ts, jhist, js)
        assert [{k: m[k] for k in m if k not in ("round", "fault")} for m in ts.round_metrics] \
            == [_jax_event_info(js._async_plan, e) for e in range(CASES[case][-1])]
        if ts._fault_plan.has_client_faults:
            assert [m["fault"] for m in ts.round_metrics] == [
                js._fault_plan.summarize_round(e, N) for e in range(1, CASES[case][-1] + 1)]
    piped, chunked = runs["pipelined"], runs["auto"]
    assert same_history(piped, chunked)
    assert np.array_equal(flat(piped.server_state), flat(chunked.server_state))
    assert np.array_equal(flat(piped.client_states), flat(chunked.client_states))
    assert all(np.isfinite(r.eval_losses["checkpoint"]) for r in piped.history)
    if case == "stragglers":
        assert piped._async_plan.staleness[piped._async_plan.arrivals > 0].max() >= 1.0


def _jax_event_info(plan, i):
    """JAX's ``_async_event_info``: the event's plan facts and the arrived
    updates' staleness values."""
    info = plan.summarize_event(i)
    info["_staleness_values"] = [float(s) for s in plan.staleness[i][plan.arrivals[i] > 0]]
    return info


@pytest.mark.parametrize("mode", ["pipelined", "chunked"])
@pytest.mark.parametrize("faults", ["none", "corruption"])
def test_buffer_of_the_whole_cohort_is_the_sync_run_bit_for_bit(mode, faults):
    plan = (tfaults.FaultPlan(client_faults=(tfaults.ClientFault(
        clients=(2,), kind="scale", scale=3.0),)) if faults == "corruption" else None)
    sync = tsim_of(DATA, TFedAvg(), mode=mode, fault_plan=plan)
    async_ = tsim_of(DATA, TFedAvg(), mode=mode, fault_plan=plan,
                     async_config=tas.AsyncConfig(buffer_size=N))
    sync.fit(3)
    async_.fit(3)
    assert same_history(sync, async_)
    assert np.array_equal(flat(sync.global_params), flat(async_.global_params))
    assert all(m["staleness_max"] == 0.0 for m in async_.round_metrics)


def test_two_fit_calls_each_start_a_fresh_plan_as_in_jax():
    js = jsim_of(DATA, **_kwargs("stragglers", "jax"))
    init = jax_init(js)
    js.fit(2)
    jhist = list(js.fit(3))
    ts = tsim_of(DATA, **_kwargs("stragglers", "torch"))
    ts.set_global_params(init)
    ts.fit(2)
    ts.fit(3)
    # both append to the history; JAX numbers each call's records from 1,
    # the port after the history
    assert [r.round for r in jhist] == [1, 2, 1, 2, 3]
    assert [r.round for r in ts.history] == [1, 2, 3, 4, 5]
    for tr, jr in zip(ts.history, jhist, strict=True):
        np.testing.assert_allclose(tr.eval_losses["checkpoint"], jr.eval_losses["checkpoint"],
                                   atol=5e-4, rtol=0)
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=5e-4, rtol=0)
    assert_matches_jax(ts, jhist[2:], js, offset=2)
    # the second call's plan is a fresh 3-event plan, JAX's
    assert np.array_equal(ts._async_plan.arrivals, js._async_plan.arrivals)


def test_fedbuff_mask_rule_and_cap_equal_jax():
    arr, stal = [1.0, 1.0, 0.0, 1.0], [0.0, 3.0, 5.0, 1.0]
    got = TFedBuff(TFedAvg()).async_aggregation_mask(torch.tensor(arr), torch.tensor(stal))
    want = np.asarray(JFedBuff(JFedAvg()).async_aggregation_mask(np.asarray(arr, np.float32),
                                                                np.asarray(stal, np.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), [1.0, 0.5, 0.0, 1.0 / np.sqrt(2.0)], rtol=1e-6)
    capped = TFedBuff(TFedAvg(), max_staleness=2).async_aggregation_mask(
        torch.ones(3), torch.tensor([0.0, 2.0, 3.0])).numpy()
    assert capped[0] == 1.0 and capped[1] > 0.0 and capped[2] == 0.0
    for kw in (dict(staleness_exponent=-1.0), dict(max_staleness=-1)):
        with pytest.raises(ValueError) as je:
            JFedBuff(JFedAvg(), **kw)
        with pytest.raises(ValueError) as te:
            TFedBuff(TFedAvg(), **kw)
        assert str(te.value) == str(je.value)


def test_fedbuff_wrapper_delegates_the_params():
    sim = tsim_of(DATA, TFedAvg(), async_config=tas.AsyncConfig(buffer_size=2))
    assert isinstance(sim.strategy, TFedBuff)
    new = {k: v + 1.0 for k, v in sim.global_params.items()}
    sim.set_global_params(new)
    assert np.array_equal(flat(sim.global_params), flat(new))
    assert sim.strategy.state_rows(sim.server_state) is None


class _TwoArgFedBuff(TFedBuff):
    def async_aggregation_mask(self, arrivals, staleness):
        return super().async_aggregation_mask(arrivals, staleness)


def test_a_two_argument_mask_hook_runs_and_a_missing_exponent_raises():
    cfg = tas.AsyncConfig(buffer_size=2, compute_jitter=0.05, seed=3)
    plain = tsim_of(DATA, TFedAvg(), async_config=cfg, fault_plan=_straggler(tfaults))
    shim = tsim_of(DATA, _TwoArgFedBuff(TFedAvg()), async_config=cfg,
                   fault_plan=_straggler(tfaults))
    plain.fit(3)
    shim.fit(3)
    assert same_history(plain, shim)
    errors = []
    for sim in (jsim_of(DATA, JFedAvg(), async_config=jas.AsyncConfig(buffer_size=2)),
                tsim_of(DATA, TFedAvg(), async_config=tas.AsyncConfig(buffer_size=2))):
        del sim.strategy.staleness_exponent
        with pytest.raises(ValueError, match="staleness_exponent") as err:
            sim.fit(1)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


class _JEval(JFedAvg):
    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return server_state


class _TEval(TFedAvg):
    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return server_state


COMPOSITION = {
    "duck_typed": (TypeError, lambda m, pkg: dict(async_config={"buffer_size": 2})),
    "oversized": (ValueError, lambda m, pkg: dict(async_config=m.AsyncConfig(buffer_size=N + 1))),
    "sampling_manager": (ValueError, lambda m, pkg: dict(
        async_config=m.AsyncConfig(buffer_size=2),
        client_manager=(jcm if pkg == "jax" else tcm).FixedFractionManager(N, 0.5))),
    "host_eval": (ValueError, lambda m, pkg: dict(
        async_config=m.AsyncConfig(buffer_size=2),
        strategy=_JEval() if pkg == "jax" else _TEval())),
    "data_provider": (ValueError, lambda m, pkg: dict(
        async_config=m.AsyncConfig(buffer_size=2), train_data_provider=lambda r: None)),
    "mismatched_fedbuff": (ValueError, lambda m, pkg: dict(
        async_config=m.AsyncConfig(buffer_size=2),
        strategy=(JFedBuff(JFedAvg(), staleness_exponent=1.0) if pkg == "jax"
                  else TFedBuff(TFedAvg(), staleness_exponent=1.0)))),
}


@pytest.mark.parametrize("case", list(COMPOSITION))
def test_composition_errors_equal_jax(case):
    kind, kw = COMPOSITION[case]
    msgs = []
    for pkg, mod, build, fedavg in (("jax", jas, jsim_of, JFedAvg), ("torch", tas, tsim_of,
                                                                      TFedAvg)):
        args = kw(mod, pkg)
        args.setdefault("strategy", fedavg())
        with pytest.raises(kind) as err:
            build(DATA, **args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_matching_prewrapped_fedbuff_fit_zero_and_auto_wrapping():
    cfg = dict(buffer_size=2, staleness_exponent=1.0, max_staleness=4)
    sim = tsim_of(DATA, TFedBuff(TFedAvg(), staleness_exponent=1.0, max_staleness=4),
                  async_config=tas.AsyncConfig(**cfg))
    assert isinstance(sim.strategy, TFedBuff) and isinstance(sim.strategy.inner, TFedAvg)
    assert sim.fit(0) == [] and sim.round_metrics == []
    # the wrapper is the outermost, around the compressing one
    wrapped = tsim_of(DATA, TFedAvg(), async_config=tas.AsyncConfig(buffer_size=2),
                      compression=TCompression(quant_bits=8))
    assert type(wrapped.strategy.inner).__name__ == "CompressingStrategy"
    # a strict failure policy keeps the per-event route, as in JAX
    strict = tsim_of(DATA, TFedAvg(), async_config=tas.AsyncConfig(buffer_size=2),
                     failure_policy=tsim.FailurePolicy(accept_failures=False))
    assert strict._select_execution_mode(2) == (
        tsim.EXEC_PIPELINED, "accept_failures=False must be able to terminate mid-run")
