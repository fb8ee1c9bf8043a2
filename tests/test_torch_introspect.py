"""Round-program introspection (``observability/introspect.py``,
``hloscan.py``, ``flops.py``) in the port, against the JAX package:

- the analytic rules of ``flops.py`` equal JAX's, exactly;
- the port's stage rows have JAX's schema, numbers and order on the same
  small programs (JAX's rows from HLO text, the port's from the op stream),
  and ``totals``/``conservation`` agree on the same rows;
- a dot with no scan: the port's counted flops equal JAX's
  ``cost_analysis`` for a ``[16,32]@[32,8]`` dot and a client-vmapped dense
  layer; the counter's dot and convolution flops equal FlopCounterMode's
  (with its grouped weight-gradient term divided by ``groups``) on the
  tiny DP rounds, Mlp and CifarNet;
- the reference fault R9 (ROADMAP.md C): XLA's ``cost_analysis`` counts a
  scan body once, so JAX's flops of the engine's local training do not
  grow with the steps; the port's grow by one step's flops a step;
- the programs a ``fit`` introspects have JAX's names on the pipelined,
  chunked and cohort routes; ``fit_chunk_eval``'s flops a round equal
  ``round_flops(fit_round_t, eval_round_t)`` exactly; a cohort's records do
  not depend on the registry size;
- the kernel wrappers' fake branch: custom calls reported, nothing launched
  and nothing counted in ``LAUNCHES``, on the DP kernels and a transformer's
  flash kernels; a failing introspection degrades to a warning."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.observability import flops as jflops
from fl4health_tpu.observability import hloscan as jhloscan
from fl4health_tpu.observability import introspect as jintrospect
from fl4health_tpu.observability import stages as jstages
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDpLogic
from fl4health_tpu_torch.kernels import dp_clip as tdp
# the module: the package exports the function of that name, as JAX's does
tfa = importlib.import_module("fl4health_tpu_torch.kernels.flash_attention")
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.models.transformer import TransformerClassifier
from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer
from fl4health_tpu_torch.observability import flops as tflops
from fl4health_tpu_torch.observability import hloscan as thloscan
from fl4health_tpu_torch.observability import introspect as tintrospect
from fl4health_tpu_torch.observability import stages as tstages
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_obs_sims import data_of, sim_of


def _tobs():
    return Observability(enabled=True, tracer=Tracer(), registry=MetricsRegistry())


# ---------------------------------------------------------------------------
# Pure-Python parts, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,args", [
    ("dot_flops", ((16, 8), (32,))),
    ("dot_flops", ((4, 5, 6), (7, 3))),
    ("matmul_flops", (64, 128, 32)),
    ("transformer_fwd_flops_per_token", (768, 3072, 12, 128)),
    ("transformer_round_flops", (256, 1024, 4, 2048, 8, 16, 5)),
])
def test_flops_rules_equal_jax(rule, args):
    assert getattr(tflops, rule)(*args) == getattr(jflops, rule)(*args)
    assert tflops.TRAIN_STEP_FLOP_MULTIPLIER == jflops.TRAIN_STEP_FLOP_MULTIPLIER


@pytest.mark.parametrize("op_name", [
    "jit(f)/fl_stage::dp_clip/mul", "x/fl_stage::server_update/fl_stage::robust_aggregate/y",
    "plain/scope", "", None, "fl_stage::cohort_exchange"])
def test_stage_of_and_spine_equal_jax(op_name):
    assert tstages.stage_of(op_name) == jstages.stage_of(op_name)
    assert tstages.SPINE_STAGES == jstages.SPINE_STAGES
    assert tstages.UNATTRIBUTED == jstages.UNATTRIBUTED
    assert tstages.STAGE_PREFIX == jstages.STAGE_PREFIX


_HLO = """\
HloModule m

ENTRY %main (a: f32[4,4]) -> f32[4,4] {{
  %a = f32[4,4]{{1,0}} parameter(0)
  %q = f32[4,4]{{1,0}} multiply(f32[4,4]{{1,0}} %a, f32[4,4]{{1,0}} %a), metadata={{op_name="x/fl_stage::{s1}/m"}}
  %c = f32[4,4]{{1,0}} add(f32[4,4]{{1,0}} %q, f32[4,4]{{1,0}} %a), metadata={{op_name="x/fl_stage::{s2}/a"}}
  ROOT %s = f32[4,4]{{1,0}} subtract(f32[4,4]{{1,0}} %c, f32[4,4]{{1,0}} %a)
}}
"""


@pytest.mark.parametrize("s1,s2", [("quantize", "dp_clip"), ("dp_clip", "dp_clip"),
                                   ("zz_extra", "local_train")])
def test_stage_rows_equal_jax_on_the_same_program(s1, s2):
    """The same three ops, staged the same way: JAX's rows from the HLO
    text, the port's from the op stream: the same keys, numbers and order."""
    jrows = jhloscan.analyze_text(_HLO.format(s1=s1, s2=s2), device_kind="unknown")

    def prog(a):
        with tstages.stage(s1):
            q = a * a
        with tstages.stage(s2):
            c = q + a
        return c - a

    trows = thloscan.count_program(prog, (torch.ones(4, 4),)).rows("unknown")
    assert trows == jrows
    assert thloscan.totals(trows) == jhloscan.totals(jrows)
    for prog_flops, prog_bytes in ((48.0, 576.0), (48.0 * 1.2, None), (None, None)):
        assert (thloscan.conservation(trows, prog_flops, prog_bytes)
                == jhloscan.conservation(jrows, prog_flops, prog_bytes))
    assert (thloscan.FLOPS_RTOL, thloscan.BYTES_RTOL) == (jhloscan.FLOPS_RTOL,
                                                          jhloscan.BYTES_RTOL)


def test_program_report_dict_equals_jax():
    kw = dict(flops=100.0, bytes_accessed=10.0, argument_bytes=4, output_bytes=4,
              temp_bytes=2, generated_code_bytes=None, rounds_per_dispatch=4,
              cohort_draw="in_graph", stages=[{"stage": "local_train"}])
    t = tintrospect.ProgramReport("p", "gpu", "NVIDIA H100 80GB HBM3", **kw)
    j = jintrospect.ProgramReport("p", "gpu", "NVIDIA H100 80GB HBM3", **kw)
    assert t.as_dict().keys() == j.as_dict().keys()
    assert t.flops_per_round == j.flops_per_round == 25.0
    assert t.peak_hbm_bytes == j.peak_hbm_bytes == 10
    reg = MetricsRegistry()
    intro = tintrospect.ProgramIntrospector(reg)
    intro.record(tintrospect.ProgramReport("fit", "cpu", "cpu", flops=100.0))
    intro.record(tintrospect.ProgramReport("chunk", "cpu", "cpu", flops=1000.0,
                                           rounds_per_dispatch=10))
    assert intro.round_flops(("fit", "chunk")) == 200.0
    assert intro.round_flops(("nope",)) is None
    assert intro.hbm_headroom_bytes() is None  # no card: no capacity, no gauge
    assert "fl_hbm_headroom_bytes" not in reg.snapshot()


# ---------------------------------------------------------------------------
# A dot with no scan, and FlopCounterMode
# ---------------------------------------------------------------------------

def _cost_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost["flops"])


@pytest.mark.parametrize("case", ["dot", "vmapped_dense"])
def test_dot_flops_equal_jax_cost_analysis(case):
    r = np.random.default_rng(0)
    if case == "dot":
        a, b = r.standard_normal((16, 32), np.float32), r.standard_normal((32, 8), np.float32)
        jf = _cost_flops(lambda x, y: x @ y, a, b)
        counter = thloscan.count_program(lambda x, y: x @ y,
                                         (torch.from_numpy(a), torch.from_numpy(b)))
        assert jf == 2 * 16 * 32 * 8
    else:  # 4 clients, each its own [32, 8] dense layer with a bias
        x, w, bias = (r.standard_normal(s, np.float32) for s in
                      ((4, 16, 32), (4, 32, 8), (4, 8)))
        jf = _cost_flops(jax.vmap(lambda x, w, b: x @ w + b), x, w, bias)
        counter = thloscan.count_program(
            torch.func.vmap(lambda x, w, b: x @ w + b),
            tuple(torch.from_numpy(a) for a in (x, w, bias)))
    assert sum(row["flops"] for row in counter.rows()) == jf


def _flop_counter_pair(sim):
    """(the counter's dot and convolution flops over a fake run, the
    reference FlopCounterMode's over a real run) of one fit round."""
    batches = sim._round_batches(1)
    val, _ = sim._val_batches()
    mask = sim.client_manager.sample(trng.fold_in(sim.rng, 2001), 1)
    args = (sim.server_state, sim.client_states, batches, mask, 1, val)
    counted = thloscan.count_program(sim._fit_round, args).dot_flops
    ref = thloscan.reference_flop_counter()
    with ref:
        sim._fit_round(*args)
    return counted, ref.get_total_flops()


def _tiny_cifar_sim():
    r = np.random.default_rng(3)
    data = [tsim.ClientDataset(r.standard_normal((n, 8, 8, 3)).astype(np.float32),
                               r.integers(0, 10, n).astype(np.int32),
                               r.standard_normal((5, 8, 8, 3)).astype(np.float32),
                               r.integers(0, 10, 5).astype(np.int32)) for n in (16, 13)]
    logic = TDpLogic(tengine.from_module(tcnn.CifarNet(input_shape=(8, 8, 3))),
                     tengine.masked_cross_entropy, clipping_bound=1.0, noise_multiplier=1.0)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=data, batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=5,
        device="cpu")


def test_dot_flops_equal_flop_counter_on_the_tiny_dp_mlp_round():
    from torch.utils.flop_counter import FlopCounterMode

    sim = sim_of("torch", data_of(4))
    counted, ref = _flop_counter_pair(sim)
    assert counted == ref > 0
    stock = FlopCounterMode(display=False)  # no convolution: the stock counter agrees
    with stock:
        sim._fit_round(sim.server_state, sim.client_states, sim._round_batches(1),
                       torch.ones(4), 1, sim._val_batches()[0])
    assert stock.get_total_flops() == ref


def test_conv_flops_equal_flop_counter_on_the_tiny_dp_cifar_round():
    """Per-example weight gradients are grouped convolutions (groups =
    clients x examples): held to FlopCounterMode with the weight term
    divided by groups; the stock count is larger by that factor's share."""
    from torch.utils.flop_counter import FlopCounterMode

    sim = _tiny_cifar_sim()
    counted, ref = _flop_counter_pair(sim)
    assert counted == ref > 0
    stock = FlopCounterMode(display=False)
    with stock:
        sim._fit_round(sim.server_state, sim.client_states, sim._round_batches(1),
                       torch.ones(2), 1, sim._val_batches()[0])
    assert stock.get_total_flops() > 2 * ref


# ---------------------------------------------------------------------------
# R9: XLA counts a scan body once
# ---------------------------------------------------------------------------

# an Mlp of 32 features, 64 hidden units and 3 classes, batch 16: a step's
# flops dwarf the scan's own loop bookkeeping
R9_DIM, R9_HIDDEN, R9_BATCH = 32, 64, 16


def _jax_train_flops(steps: int) -> float:
    model = jengine.from_flax(JMlp(features=(R9_HIDDEN,), n_outputs=3))
    logic = jengine.ClientLogic(model, jengine.masked_cross_entropy)
    train = jengine.make_local_train(logic, optax.sgd(0.1),
                                     JMetricManager((jefficient.accuracy(),)))
    x = jnp.zeros((R9_BATCH, R9_DIM), jnp.float32)
    state = jengine.create_train_state(logic, optax.sgd(0.1), jax.random.PRNGKey(0), x)
    batches = jengine.Batch(x=jnp.zeros((steps, R9_BATCH, R9_DIM)),
                            y=jnp.zeros((steps, R9_BATCH), jnp.int32),
                            example_mask=jnp.ones((steps, R9_BATCH)),
                            step_mask=jnp.ones((steps,)))
    ctx = logic.init_round_context(state, state.params)
    return _cost_flops(lambda s, b: train(s, ctx, b), state, batches)


def _port_train_flops(steps: int) -> float:
    logic = tengine.ClientLogic(tengine.from_module(TMlp(R9_DIM, (R9_HIDDEN,), 3)),
                                tengine.masked_cross_entropy)
    tx = optim.sgd(0.1)
    train = tengine.make_local_train(logic, tx, TMetricManager((tefficient.accuracy(),)))
    state = tengine.create_train_state(logic, tx, trng.PRNGKey(0), torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    batches = tengine.Batch(x=torch.zeros((steps, R9_BATCH, R9_DIM)),
                            y=torch.zeros((steps, R9_BATCH), dtype=torch.int32),
                            example_mask=torch.ones((steps, R9_BATCH)),
                            step_mask=torch.ones((steps,)))
    ctx = logic.init_round_context(state, state.params)
    counter = thloscan.count_program(lambda s, b: train(s, ctx, b), (state, batches))
    return thloscan.totals(counter.rows())["flops"]


def test_r9_xla_counts_the_step_scan_once_the_port_every_step():
    j1, j5 = _jax_train_flops(1), _jax_train_flops(5)
    np.testing.assert_allclose(j5, j1, rtol=1e-3)  # JAX: one scan body
    t1, t2, t5 = (_port_train_flops(s) for s in (1, 2, 5))
    setup = 2 * t1 - t2  # the work outside the step loop
    assert t2 > t1 > setup >= 0
    np.testing.assert_allclose(t5 - setup, 5 * (t1 - setup), rtol=1e-3)


# ---------------------------------------------------------------------------
# The programs of a fit
# ---------------------------------------------------------------------------

def _jax_sim_names(mode: str, cohort: bool) -> list[str]:
    from fl4health_tpu.observability import MetricsRegistry as JRegistry
    from fl4health_tpu.observability import Observability as JObservability
    from fl4health_tpu.observability import Tracer as JTracer

    obs = JObservability(enabled=True, tracer=JTracer(), registry=JRegistry())
    kw = (dict(cohort=jreg.CohortConfig(slots=3),
               client_manager=jcm.FixedFractionManager(6, 0.5)) if cohort else {})
    js = sim_of("jax", data_of(6 if cohort else 4), mode=mode, obs=obs, **kw)
    js._introspect_programs(js._select_execution_mode(2)[0], 2)
    return sorted(obs.introspector.reports)


@pytest.mark.parametrize("mode,cohort", [("pipelined", False), ("chunked", False),
                                         ("chunked", True)],
                         ids=["pipelined", "chunked", "cohort_chunked"])
def test_program_names_equal_jax(mode, cohort):
    obs = _tobs()
    kw = (dict(cohort=treg.CohortConfig(slots=3),
               client_manager=tcm.FixedFractionManager(6, 0.5)) if cohort else {})
    ts = sim_of("torch", data_of(6 if cohort else 4), mode=mode, obs=obs, **kw)
    ts._introspect_programs(ts._select_execution_mode(2)[0], 2)
    assert sorted(obs.introspector.reports) == _jax_sim_names(mode, cohort)
    for rep in obs.introspector.reports.values():
        assert rep.flops > 0 and rep.bytes_accessed > 0 and rep.generated_code_bytes is None
        assert rep.stages and thloscan.conservation(rep.stages, rep.flops,
                                                    rep.bytes_accessed)["ok"]
    if cohort:
        chunk = obs.introspector.reports["fit_cohort_chunk"]
        assert (chunk.cohort_draw, chunk.rounds_per_dispatch) == ("in_graph", 2)


def test_chunk_flops_a_round_equal_the_round_programs():
    obs = _tobs()
    ts = sim_of("torch", data_of(4), mode="chunked", obs=obs)
    ts._introspect_programs(tsim.EXEC_CHUNKED, 3)
    ts._introspect_programs(tsim.EXEC_PIPELINED, 3)
    intro = obs.introspector
    assert intro.reports["fit_chunk_eval"].rounds_per_dispatch == 3
    assert (intro.reports["fit_chunk_eval"].flops_per_round
            == intro.round_flops(("fit_round_t", "eval_round_t")))


def _pool_cohort_sim(n: int):
    r = np.random.default_rng(0)
    pool = (r.standard_normal((64, 6)).astype(np.float32),
            r.integers(0, 3, 64).astype(np.int32))
    source = treg.IndexedPoolSource(pool, pool, [np.arange(i % 8, i % 8 + 8)
                                                 for i in range(n)],
                                    [np.arange(i % 4, i % 4 + 4) for i in range(n)])
    obs = _tobs()
    sim = sim_of("torch", None, dp=False, obs=obs, mode="chunked", datasets=source,
                 cohort=treg.CohortConfig(slots=4),
                 client_manager=tcm.FixedFractionManager(n, 4 / n))
    sim._introspect_programs(tsim.EXEC_CHUNKED, 2)
    return obs


def test_cohort_program_records_do_not_depend_on_the_registry_size():
    """The slot programs' records are the same at N 32 and 4,096 (O(K));
    the cohort chunk's differ only in its unattributed row, which holds
    the in-graph draw over the N clients (O(N) in both packages)."""
    def programs(obs, names):
        prom = obs.registry.to_prometheus().splitlines()
        lines = [ln for ln in prom if ln.startswith("fl_program_")
                 and "compile_seconds" not in ln and any(f'"{n}"' in ln for n in names)]
        reps = {n: {k: v for k, v in obs.introspector.reports[n].as_dict().items()
                    if k != "compile_seconds"} for n in names}
        return lines, reps

    small, large = _pool_cohort_sim(32), _pool_cohort_sim(4096)
    slot = ("fit_round_t", "eval_round_t")
    assert programs(small, slot) == programs(large, slot) and programs(small, slot)[0]
    rows = [{r["stage"]: r for r in obs.introspector.reports["fit_cohort_chunk"].stages}
            for obs in (small, large)]
    assert rows[0].keys() == rows[1].keys() >= {"local_train", "cohort_exchange"}
    for stage in rows[0].keys() - {tstages.UNATTRIBUTED}:
        assert rows[0][stage] == rows[1][stage], stage
    assert (rows[1][tstages.UNATTRIBUTED]["flops"]
            > rows[0][tstages.UNATTRIBUTED]["flops"])


# ---------------------------------------------------------------------------
# The kernels' fake branch
# ---------------------------------------------------------------------------

def test_dp_kernels_fake_branch_reports_calls_and_launches_nothing():
    tdp.reset_launch_counts()
    grads = {"w": torch.randn(3, 5, 4), "b": torch.randn(3, 5)}

    def clip(g, m):
        return tdp.fused_clipped_masked_sum(g, m, 1.0)

    counter = thloscan.count_program(torch.func.vmap(clip, in_dims=(0, 0)),
                                     ({"w": torch.randn(2, 3, 5, 4), "b": torch.randn(2, 3, 5)},
                                      torch.ones(2, 3)))
    assert counter.kernel_calls == {"dp_sq_norms": 1, "dp_scaled_sum": 2}
    row = {r["stage"]: r for r in counter.rows()}["dp_clip"]
    assert row["custom_calls"] == 3
    assert tdp.LAUNCHES == {"dp_sq_norms": 0, "dp_scaled_sum": 0}
    assert tdp.COPIES == {"dp_per_example": 0}
    # real CPU tensors still run the plain versions, outside any counter
    out = tdp.fused_clipped_masked_sum(grads, torch.ones(3), 1.0)
    assert out["w"].shape == (5, 4) and tdp.LAUNCHES["dp_sq_norms"] == 0


def test_transformer_introspection_reports_the_flash_kernels(caplog):
    module = TransformerClassifier(vocab_size=32, n_classes=3, d_model=16, n_heads=2,
                                   n_layers=1, d_ff=32, max_len=24, remat=True,
                                   attention_fn=tfa.flash_attention)
    r = np.random.default_rng(0)
    data = []
    for i in range(2):
        x = r.integers(1, 32, size=(20, 24)).astype(np.int32)
        y = r.integers(0, 3, 20).astype(np.int32)
        data.append(tsim.ClientDataset(x[:14], y[:14], x[14:], y[14:]))
    obs = _tobs()
    sim = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(module), tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=data, batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=7,
        device="cpu", observability=obs, execution_mode="pipelined")
    tfa.reset_launch_counts()
    with caplog.at_level(logging.WARNING):
        sim._introspect_programs(tsim.EXEC_PIPELINED, 1)
    assert not [r for r in caplog.records if "introspection failed" in r.getMessage()]
    calls = obs.introspector.counters["fit_round_t"].kernel_calls
    # 2 steps x 1 layer: the forward (and remat's recompute), dQ, dK/dV
    assert calls["flash_fwd"] >= 2 and calls["flash_bwd_dq"] == calls["flash_bwd_dkv"] == 2
    assert obs.introspector.counters["eval_round_t"].kernel_calls == {"flash_fwd": 1}
    assert all(v == 0 for v in tfa.LAUNCHES.values())


def test_failing_introspection_degrades_to_a_warning(caplog):
    intro = tintrospect.ProgramIntrospector(MetricsRegistry())

    def broken(x):
        return x[x > 0].sum()  # a data-dependent shape: no fake run

    with caplog.at_level(logging.WARNING):
        assert intro.introspect_fn("broken", broken, (torch.ones(3),)) is None
    assert "broken" in caplog.text and not intro.reports
