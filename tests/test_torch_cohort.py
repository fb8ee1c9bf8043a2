"""Cohort-slot execution (``FederatedSimulation(cohort=CohortConfig(...))``)
in the port on the CPU, against itself and against the JAX package:

- ``slots == N`` under full participation equals the port's dense
  pipelined and chunked runs bit for bit (JAX's ``TestSlotsEqualsDenseParity``),
  ``Compressing(Scaffold)`` with SCAFFOLD clients included, whose registry
  rows (client states, error-feedback residuals) equal the dense state's;
- the port's cohort runs against JAX's at 5e-4 (``FixedFractionManager``
  and Poisson, both routes, a DP client, the repeat-heavy 6-client registry
  whose clients are sampled in consecutive rounds), the port's chunked
  route equal to its pipelined one bit for bit;
- JAX's composition errors and the chunked route's reasons word for word,
  ``fit(0)``, and the draw check at the chunk's pull;
- the reference faults R4 and R5, pinned in both packages: the
  instance-level DP server divides by zero on a cohort run, and the
  client-level DP server accounts over the slots, not the registry."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDpLogic
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDpLogic
from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic
from fl4health_tpu_torch.compression.config import CompressionConfig
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.scaffold import Scaffold

DIM, N_CLASSES = 6, 3
TOL = 5e-4


def _rows(n, rows=40):
    r = np.random.default_rng(0)
    out = []
    for i in range(n):
        m = rows - 2 * (i % 3)  # uneven clients: padded steps and rows
        x = r.standard_normal((m, DIM)).astype(np.float32)
        y = r.integers(0, N_CLASSES, m).astype(np.int32)
        out.append((x[:m - 8], y[:m - 8], x[m - 8:], y[m - 8:]))
    return out


def _tsim(n=4, logic=None, strategy=None, mode="auto", dp_sigma=None, **kw):
    model = tengine.from_module(TMlp(DIM, (12,), N_CLASSES))
    if dp_sigma is not None:
        logic = TDpLogic(model, tengine.masked_cross_entropy, clipping_bound=1.0,
                         noise_multiplier=dp_sigma)
    elif logic is not None:
        logic = logic(model)
    else:
        logic = tengine.ClientLogic(model, tengine.masked_cross_entropy)
    kw.setdefault("local_epochs", 1)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=strategy or TFedAvg(),
        datasets=kw.pop("datasets", None) or [tsim.ClientDataset(*d) for d in _rows(n)],
        batch_size=8, metrics=TMetricManager((tefficient.accuracy(),)), seed=5,
        execution_mode=mode, device="cpu", **kw)


def _jsim(n=4, mode="auto", dp_sigma=None, **kw):
    model = jengine.from_flax(JMlp(features=(12,), n_outputs=N_CLASSES))
    logic = (JDpLogic(model, jengine.masked_cross_entropy, clipping_bound=1.0,
                      noise_multiplier=dp_sigma) if dp_sigma is not None
             else jengine.ClientLogic(model, jengine.masked_cross_entropy))
    kw.setdefault("local_epochs", 1)
    return jsim.FederatedSimulation(
        logic=logic, tx=optax.sgd(0.05), strategy=kw.pop("strategy", None) or JFedAvg(),
        datasets=kw.pop("datasets", None) or [jsim.ClientDataset(*d) for d in _rows(n)],
        batch_size=8, metrics=JMetricManager((jefficient.accuracy(),)), seed=5,
        execution_mode=mode, **kw)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in ptu.tree_leaves(tree)])


def _assert_same_history(a, b):
    assert [r.round for r in a.history] == [r.round for r in b.history]
    for ra, rb in zip(a.history, b.history):
        for f in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics"):
            assert getattr(ra, f) == getattr(rb, f), (ra.round, f)


def _scaffold_kw():
    return dict(strategy=Scaffold(),
                logic=lambda m: ScaffoldClientLogic(m, tengine.masked_cross_entropy,
                                                    learning_rate=0.05),
                compression=CompressionConfig(topk_fraction=0.5, error_feedback=True,
                                              quant_bits=8, seed=3))


@pytest.mark.parametrize("config", ["fedavg", "compressing_scaffold", "local_steps"])
def test_slots_equal_to_registry_is_the_dense_run_bit_for_bit(config):
    kw = {"fedavg": {}, "compressing_scaffold": _scaffold_kw(),
          "local_steps": dict(local_epochs=None, local_steps=3)}[config]
    dense_p = _tsim(mode="pipelined", **kw)
    dense_p.fit(3)
    dense_c = _tsim(mode="chunked", **kw)
    dense_c.fit(3)
    for mode in ("pipelined", "auto"):
        slot = _tsim(mode=mode, cohort=treg.CohortConfig(slots=4), **kw)
        assert slot._select_execution_mode(3)[0] == (
            tsim.EXEC_PIPELINED if mode == "pipelined" else tsim.EXEC_CHUNKED)
        slot.fit(3)
        _assert_same_history(dense_p, slot)
        _assert_same_history(dense_c, slot)
        assert np.array_equal(_flat(dense_p.global_params), _flat(slot.global_params))
        # the clients' persistent rows (params, optimizer state, keys,
        # SCAFFOLD's variates) and the strategy's (the error-feedback
        # residuals) equal the dense state's
        assert np.array_equal(_flat(dense_p.client_states),
                              _flat(slot.registry.gather_client_states(np.arange(4))))
        assert slot.registry.has_strategy_rows == (config == "compressing_scaffold")
        if slot.registry.has_strategy_rows:
            assert np.array_equal(
                _flat(dense_p.strategy.state_rows(dense_p.server_state)),
                _flat(slot.registry.gather_strategy_rows(np.arange(4))))
        assert [m["cohort_valid"] for m in slot.round_metrics] == [4, 4, 4]


COHORT_CASES = {
    # name: (registry size, slots, manager factory, rounds, extra kw)
    "fixed_fraction": (8, 4, lambda m: m.FixedFractionManager(8, 0.5), 3, {}),
    "poisson": (8, 8, lambda m: m.PoissonSamplingManager(8, 0.5), 3, {}),
    # repeats certain: 3 of 6 clients a round, rows read after they were
    # written the round before
    "repeat_heavy": (6, 3, lambda m: m.FixedFractionManager(6, 0.5), 4, {}),
    "dp_client": (6, 3, lambda m: m.FixedFractionManager(6, 0.5), 3, dict(dp_sigma=1.0)),
}


@pytest.mark.parametrize("case", list(COHORT_CASES))
def test_cohort_runs_match_jax(case):
    n, slots, manager, rounds, kw = COHORT_CASES[case]
    js = _jsim(n=n, cohort=jreg.CohortConfig(slots=slots), client_manager=manager(jcm), **kw)
    jhist = js.fit(rounds)
    init = convert.flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jax.device_get(js.registry._client_proto.params)))
    runs = {}
    for mode in ("pipelined", "auto"):
        ts = _tsim(n=n, mode=mode, cohort=treg.CohortConfig(slots=slots),
                   client_manager=manager(tcm), **kw)
        ts.set_global_params(init)
        assert ts._select_execution_mode(rounds) == js._select_execution_mode(rounds) or (
            mode == "pipelined")
        ts.fit(rounds)
        runs[mode] = ts
        for tr, jr in zip(ts.history, jhist, strict=True):
            np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                       atol=TOL, rtol=0, err_msg=(case, mode, tr.round))
            np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                       jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
            np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                       jr.eval_metrics["accuracy"], atol=1e-6)
        want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
        for k in want:
            np.testing.assert_allclose(ts.global_params[k].numpy(), want[k].numpy(),
                                       atol=TOL, rtol=0, err_msg=k)
        assert ts.registry.dirty_rows == js.registry.dirty_rows
        # the registry's stored params: each client's last post-eval row
        ids = np.asarray(sorted(js.registry._client_store._rows))
        jrows = js.registry.gather_client_states(ids).params
        trows = ts.registry.gather_client_states(ids).params
        for k, v in convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jrows)).items():
            if k in trows:
                np.testing.assert_allclose(trows[k], v.numpy(), atol=TOL, rtol=0)
    piped, chunked = runs["pipelined"], runs["auto"]
    _assert_same_history(piped, chunked)
    assert np.array_equal(_flat(piped.registry.gather_client_states(np.arange(n))),
                          _flat(chunked.registry.gather_client_states(np.arange(n))))
    assert [m["cohort_draw"] for m in piped.round_metrics] == ["host"] * rounds
    assert [m["cohort_draw"] for m in chunked.round_metrics] == ["in_graph"] * rounds
    assert all(m["rounds_per_dispatch"] == rounds for m in chunked.round_metrics)


class _EvalConsumer:
    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return server_state


class TEvalFedAvg(_EvalConsumer, TFedAvg):
    pass


class JEvalFedAvg(_EvalConsumer, JFedAvg):
    pass


def _error(build):
    with pytest.raises(Exception) as info:
        build()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", [
    "bad_cohort_type", "update_after_eval", "train_data_provider", "too_few_slots",
    "wrong_population", "bad_compression"])
def test_composition_errors_as_in_jax(case):
    kw = {
        "bad_cohort_type": lambda pkg: dict(cohort=4),
        "update_after_eval": lambda pkg: dict(cohort=pkg[0].CohortConfig(slots=4),
                                              strategy=pkg[2]()),
        "train_data_provider": lambda pkg: dict(cohort=pkg[0].CohortConfig(slots=4),
                                                train_data_provider=lambda r: None),
        "too_few_slots": lambda pkg: dict(cohort=pkg[0].CohortConfig(slots=3)),
        "wrong_population": lambda pkg: dict(cohort=pkg[0].CohortConfig(slots=4),
                                             client_manager=pkg[1].FixedFractionManager(3, 0.5)),
        "bad_compression": lambda pkg: dict(compression={"topk_fraction": 0.1}),
    }[case]
    want = _error(lambda: _jsim(**kw((jreg, jcm, JEvalFedAvg))))
    got = _error(lambda: _tsim(**kw((treg, tcm, TEvalFedAvg))))
    assert got == want


def test_chunked_route_reasons_as_in_jax():
    for build in (lambda m: m.FixedSamplingManager(6, 0.5),
                  lambda m: m.FixedFractionManager(6, 0.5)):
        js = _jsim(n=6, cohort=jreg.CohortConfig(slots=3), client_manager=build(jcm))
        ts = _tsim(n=6, cohort=treg.CohortConfig(slots=3), client_manager=build(tcm))
        assert ts._select_execution_mode(2) == js._select_execution_mode(2)
    # forced chunked without draw_cohort raises the same words
    js = _jsim(n=6, mode="chunked", cohort=jreg.CohortConfig(slots=3),
               client_manager=jcm.FixedSamplingManager(6, 0.5))
    ts = _tsim(n=6, mode="chunked", cohort=treg.CohortConfig(slots=3),
               client_manager=tcm.FixedSamplingManager(6, 0.5))
    assert _error(lambda: ts.fit(1)) == _error(lambda: js.fit(1))
    # a strict failure policy keeps the cohort pipelined, as in JAX
    ts = _tsim(n=6, cohort=treg.CohortConfig(slots=3),
               client_manager=tcm.FixedFractionManager(6, 0.5),
               failure_policy=tsim.FailurePolicy(accept_failures=False))
    assert ts._select_execution_mode(2) == (
        tsim.EXEC_PIPELINED, "accept_failures=False must be able to terminate mid-run")


def test_fit_zero_runs_nothing():
    for mode in ("auto", "pipelined", "chunked"):
        ts = _tsim(n=6, mode=mode, cohort=treg.CohortConfig(slots=3),
                   client_manager=tcm.FixedFractionManager(6, 0.5))
        assert ts.fit(0) == [] and ts.registry.dirty_rows == 0
    js = _jsim(n=6, mode="chunked", cohort=jreg.CohortConfig(slots=3),
               client_manager=jcm.FixedFractionManager(6, 0.5))
    assert js.fit(0) == []


def test_diverging_device_draw_raises_at_the_pull(monkeypatch):
    ts = _tsim(n=6, cohort=treg.CohortConfig(slots=3),
               client_manager=tcm.FixedFractionManager(6, 0.5))
    real = ts.client_manager.draw_cohort

    def shifted(key, round_idx, slots):
        ids, valid = real(key, round_idx, slots)
        return torch.roll(ids, 1), valid

    monkeypatch.setattr(ts.client_manager, "draw_cohort", shifted)
    with pytest.raises(RuntimeError, match="in-graph cohort draw diverged from the host "
                                           "sampler for rounds \\[1, 3\\)"):
        ts.fit(2)
    assert ts.registry.dirty_rows == 0  # nothing stored from the untrusted chunk


@pytest.mark.parametrize("mode", ["pipelined", "chunked"])
def test_host_draws_follow_a_reassigned_rng(mode):
    ts = _tsim(n=6, mode=mode, cohort=treg.CohortConfig(slots=3),
               client_manager=tcm.FixedFractionManager(6, 0.5))
    ts.rng = trng.PRNGKey(11)
    want = [ts.client_manager.sample_indices(trng.fold_in(trng.PRNGKey(11), 2000 + r), r, 3)
            for r in (1, 2)]
    assert [ts._stage_cohort_round(r)["idx"].tolist() for r in (1, 2)] == [
        w[0].tolist() for w in want]
    ts.fit(2)  # the chunked route's draw check holds the two streams equal
    assert len(ts.history) == 2


def test_failed_slot_is_named_by_registry_id():
    data = [tsim.ClientDataset(*d) for d in _rows(6)]
    data[4] = dataclasses.replace(data[4], x_train=np.full_like(data[4].x_train, np.nan))
    ts = _tsim(datasets=data, cohort=treg.CohortConfig(slots=6),
               client_manager=tcm.FullParticipationManager(6),
               failure_policy=tsim.FailurePolicy(accept_failures=False))
    with pytest.raises(tsim.ClientFailuresError) as info:
        ts.fit(2)
    assert info.value.round == 1 and info.value.clients == [4]
    assert info.value.registry_clients == [4]


# -- R4 and R5: reference faults, pinned in both packages -----------------

def test_r4_instance_level_dp_server_divides_by_zero_on_a_cohort():
    js = _jsim(n=4, cohort=jreg.CohortConfig(slots=2),
               client_manager=jcm.FixedFractionManager(4, 0.5))
    ts = _tsim(n=4, cohort=treg.CohortConfig(slots=2),
               client_manager=tcm.FixedFractionManager(4, 0.5))
    # the servers poll sim.datasets, which is empty under a cohort
    assert js.datasets == [] and ts.datasets == []
    with pytest.raises(ZeroDivisionError):
        jservers.InstanceLevelDpServer(js, 1.0, 8).fit(1)
    with pytest.raises(ZeroDivisionError):
        tservers.InstanceLevelDpServer(ts, 1.0, 8).fit(1)


@pytest.mark.parametrize("manager", ["FixedFractionManager", "PoissonSamplingManager"])
def test_r5_client_level_dp_server_accounts_over_the_slots(manager):
    eps = {}
    for pkg, build, reg, cm, servers in (("jax", _jsim, jreg, jcm, jservers),
                                         ("port", _tsim, treg, tcm, tservers)):
        for cohort in (None, reg.CohortConfig(slots=8)):
            sim = build(n=32, cohort=cohort, client_manager=getattr(cm, manager)(32, 0.25))
            sim.fit = lambda n: []  # the accounting alone
            eps[pkg, cohort is not None] = servers.ClientLevelDpFedAvgServer(sim, 1.0).fit(2)[1]
    for cohort in (False, True):
        assert abs(eps["port", cohort] - eps["jax", cohort]) <= 1e-9
    # the cohort reports less privacy loss than the dense run of the same
    # sampling scheme: n (and delta = 1/n) are the 8 slots, not the 32 clients
    assert eps["port", True] < eps["port", False]
    want = {"FixedFractionManager": (10.02752895943187, 8.17913647793868),
            "PoissonSamplingManager": (1.1712786179529746, 0.516631213226221)}[manager]
    np.testing.assert_allclose((eps["port", False], eps["port", True]), want, rtol=1e-9)
