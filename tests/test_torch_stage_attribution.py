"""Stage attribution (``observability/stages.py`` + ``hloscan.py``) in the
port, on the tiny DP recipe of ``tests/torch_obs_sims.py``:

- the ``fl_stage::`` scopes, the introspection run and an armed, idle
  operations plane are metadata only: parameters and histories are
  bit-equal to an all-off run on the pipelined, dense chunked and cohort
  chunked routes;
- the spine stages land where their code runs: ``local_train``,
  ``dp_clip`` (its custom calls a round: one K1 and one K2 a leaf a step),
  ``server_update``, ``cohort_exchange`` on the cohort chunk,
  ``rotation``/``topk``/``quantize``/``robust_aggregate`` under a
  compressing robust strategy; with the ``fl_stage_*`` gauges and ``stage``
  events, conservation, and no ``bound`` keys off a known card;
- the scopes hold inside ``torch.func.vmap`` and ``grad`` (a scope
  around the gradient call is charged the backward too) and are ranges a
  ``torch.profiler`` trace shows; attribution off keeps the records' shape (no ``stages`` key, no
  ``stage`` events), as in JAX."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import numpy as np
import pytest
import torch

from fl4health_tpu_torch.compression.config import CompressionConfig
from fl4health_tpu_torch.compression.strategy import CompressingStrategy
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.observability import MetricsRegistry, Observability, SLOPolicy, Tracer
from fl4health_tpu_torch.observability import hloscan
from fl4health_tpu_torch.observability import stages as stage_attr
from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from torch_obs_sims import data_of, sim_of

ROUTES = {
    "pipelined": dict(mode="pipelined"),
    "chunked": dict(mode="chunked"),
    "cohort_chunked": dict(mode="chunked", cohort=True),
}


def _armed():
    return Observability(enabled=True, tracer=Tracer(), registry=MetricsRegistry(),
                         slo=SLOPolicy(min_rounds_per_hour=0.001, max_eval_loss=1e9,
                                       stall_rounds=10_000, max_bytes_per_client=1e15))


def _sim(route: str, obs, **kw):
    spec = dict(ROUTES[route])
    if spec.pop("cohort", False):
        kw.update(cohort=treg.CohortConfig(slots=3),
                  client_manager=tcm.FixedFractionManager(6, 0.5))
        return sim_of("torch", data_of(6), obs=obs, **spec, **kw)
    return sim_of("torch", data_of(4), obs=obs, **spec, **kw)


def _result(sim):
    return ([t.clone() for t in ptu.tree_leaves(sim.global_params)],
            [(r.fit_losses, r.fit_metrics, r.eval_losses, r.eval_metrics)
             for r in sim.history])


@pytest.mark.parametrize("route", list(ROUTES))
def test_attribution_introspection_and_ops_plane_leave_every_bit(route):
    armed = _sim(route, _armed())
    armed.fit(3)
    assert armed.observability.introspector.reports
    with stage_attr.disabled():
        off_obs = Observability(enabled=True, tracer=Tracer(), registry=MetricsRegistry(),
                                introspection=False)
        off = _sim(route, off_obs)
        off.fit(3)
    (pa, ha), (pb, hb) = _result(armed), _result(off)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert ha == hb


def _rows(obs, program: str) -> dict:
    return {r["stage"]: r for r in obs.introspector.reports[program].stages}


def test_spine_rows_gauges_and_events_land():
    obs = _armed()
    sim = _sim("pipelined", obs)
    sim.fit(1)
    rows = _rows(obs, "fit_round_t")
    assert list(rows) == ["local_train", "dp_clip", "server_update",
                          stage_attr.UNATTRIBUTED]
    # 2 steps of a 4-leaf Mlp: one K1 and four K2 calls a step
    assert rows["dp_clip"]["custom_calls"] == 2 * (1 + 4)
    assert rows["local_train"]["flops"] > rows["server_update"]["flops"] > 0
    assert all("bound" not in r for r in rows.values())  # the CPU: never fabricated
    rep = obs.introspector.reports["fit_round_t"]
    assert hloscan.conservation(rep.stages, rep.flops, rep.bytes_accessed)["ok"]
    prom = obs.registry.to_prometheus()
    assert 'fl_stage_flops{program="fit_round_t",stage="dp_clip"}' in prom
    stage_events = [e for e in obs.registry.events if e["event"] == "stage"]
    assert len(stage_events) == sum(len(r.stages) for r in obs.introspector.reports.values())


def test_cohort_exchange_lands_on_the_cohort_chunk():
    obs = _armed()
    sim = _sim("cohort_chunked", obs)
    sim._introspect_programs(sim._select_execution_mode(2)[0], 2)
    rows = _rows(obs, "fit_cohort_chunk")
    assert {"local_train", "dp_clip", "server_update", "cohort_exchange"} <= set(rows)
    assert rows["cohort_exchange"]["bytes_accessed"] > 0


def test_compression_and_robust_stages_land():
    obs = _armed()
    strategy = CompressingStrategy(
        RobustFedAvg(method="trimmed_mean", trim_fraction=0.25),
        CompressionConfig(topk_fraction=0.5, quant_bits=8, rotation=True), n_clients=4)
    sim = sim_of("torch", data_of(4), dp=False, obs=obs, mode="pipelined",
                 strategy=strategy)
    sim._introspect_programs(sim._select_execution_mode(1)[0], 1)
    rows = _rows(obs, "fit_round_t")
    assert list(rows)[:6] == ["local_train", "rotation", "topk", "quantize",
                              "robust_aggregate", "server_update"]
    assert all(rows[s]["ops"] > 0 for s in ("rotation", "topk", "quantize",
                                            "robust_aggregate"))


def test_stage_charges_the_backward_under_vmap_and_grad():
    """Eager autograd runs a backward where the gradient is asked for: a
    scope around the ``vmap(grad)`` call (the engine's ``local_train``)
    holds the backward too; a scope inside the differentiated function
    holds its forward alone."""
    def fwd(w, x):
        return ((x @ w) ** 2).sum()

    def scoped_fwd(w, x):
        with stage_attr.stage("dp_clip"):
            return fwd(w, x)

    def around(w, x):
        with stage_attr.stage("local_train"):
            return torch.func.vmap(torch.func.grad(fwd))(w, x)

    args = (torch.ones(3, 4, 2), torch.ones(3, 5, 4))
    counter = hloscan.count_program(around, args)
    assert set(counter.accs) == {"local_train"} and counter.dot_flops > 0
    inner = hloscan.count_program(torch.func.vmap(torch.func.grad(scoped_fwd)), args)
    # one forward matmul, one backward (the weight gradient), of equal size
    assert inner.accs["dp_clip"].dot_flops == inner.dot_flops / 2
    assert inner.dot_flops == counter.dot_flops


def test_stage_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stage_attr.stage("dp_clip"):
            torch.ones(4) * 2
    assert "fl_stage::dp_clip" in {e.name for e in prof.events()}
    with stage_attr.disabled():
        with stage_attr.stage("dp_clip"):
            assert stage_attr.current() is None


def test_attribution_off_keeps_the_record_shape():
    obs = _armed()
    with stage_attr.disabled():
        sim = _sim("chunked", obs)
        sim.fit(1)
    programs = [e for e in obs.registry.events if e["event"] == "program"]
    assert programs and all("stages" not in e for e in programs)
    assert not [e for e in obs.registry.events if e["event"] == "stage"]
    assert "fl_stage_flops" not in obs.registry.to_prometheus()
    assert np.isfinite(programs[0]["flops"])


def test_a_report_from_another_thread_charges_the_entering_threads_stage():
    """On a card autograd runs a backward on its device thread while the
    dispatching thread waits in the gradient call: what runs there is
    charged to the stage the dispatching thread holds open (here a kernel
    report from a helper thread)."""
    import threading

    def prog(x):
        with stage_attr.stage("local_train"):
            helper = threading.Thread(
                target=lambda: hloscan.note_custom_call("dp_sq_norms", (x,), (x,)))
            helper.start()
            helper.join()
            return x * 2

    counter = hloscan.count_program(prog, (torch.ones(4),))
    assert counter.kernel_calls == {"dp_sq_norms": 1}
    assert counter.accs["local_train"].custom_calls == 1
    assert stage_attr.current() is None
