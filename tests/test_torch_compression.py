"""The compressed exchange in the port against the JAX package on the CPU:
each codec bit for bit with the same keys against JAX's compiled codecs,
what the JAX simulation runs (the FWHT, the rotation signs, top-k with
planted ties and ``k_effective``, stochastic quantization,
``compress_update`` over a ``Params`` tree, the wire-byte arithmetic; with
rotation on, ``compress_update`` within ``ROTATION_ATOL``: XLA fuses the
dequantize's multiply into the inverse rotation's first butterfly add);
``CompressionConfig``'s checks word for word; ``CompressingStrategy``'s
aggregate and its adaptive fraction against JAX's; compressed runs against
JAX at 5e-4 with error feedback on and off and under a ``topk_schedule``,
and ``Compressing(Scaffold)`` over a sampled cohort; ``replace_global_params``
through the wrapper, ``set_global_params`` on a compressed simulation, and
the ``FixedLayerExchanger`` rejection."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.scaffold import ScaffoldClientLogic as JScaffoldLogic
from fl4health_tpu.compression import codecs as jc
from fl4health_tpu.compression import config as jcfg
from fl4health_tpu.compression.strategy import CompressingStrategy as JCompressing
from fl4health_tpu.exchange.exchanger import fixed_exchanger_excluding as jexcluding
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies import base as jbase
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.scaffold import Scaffold as JScaffold
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic as TScaffoldLogic
from fl4health_tpu_torch.compression import codecs as tc
from fl4health_tpu_torch.compression import config as tcfg
from fl4health_tpu_torch.compression.strategy import CompressingStrategy as TCompressing
from fl4health_tpu_torch.exchange.exchanger import fixed_exchanger_excluding as texcluding
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies import base as tbase
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.scaffold import Scaffold as TScaffold
from fl4health_tpu_torch.strategies.base import FitResults

DIM, N_CLASSES = 6, 3
TOL = 5e-4
# compiled JAX rounds a rotated update's dequantize-then-butterfly once (a
# fused multiply-add) where the port rounds twice: a few f32 ulps of O(1)
ROTATION_ATOL = 1e-6
CONFIGS = {
    "topk": dict(topk_fraction=0.1),
    "topk_q8": dict(topk_fraction=0.5, quant_bits=8, seed=3),
    "q4_rotation": dict(quant_bits=4, rotation=True, seed=2),
    "topk_q8_rotation": dict(topk_fraction=0.3, quant_bits=8, rotation=True, seed=1),
}


def _update(seed=0):
    r = np.random.default_rng(seed)
    shapes = {"Dense_0": {"kernel": (6, 12), "bias": (12,)},
              "Dense_1": {"kernel": (12, 3), "bias": (3,)}}
    return {m: {k: r.standard_normal(s).astype(np.float32) for k, s in d.items()}
            for m, d in shapes.items()}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _assert_trees_equal(got, want, atol=0.0):
    want = _port(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def _jit_compress(config, key, **kw):
    return jax.jit(lambda u, r: jc.compress_update(u, r, key, config, **kw))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("with_residual", [True, False])
def test_compress_update_matches_jax(name, with_residual):
    upd = _update(0)
    res = (jax.tree_util.tree_map(lambda a: 0.1 * a, _update(1)) if with_residual else None)
    want_dec, want_res = _jit_compress(jcfg.CompressionConfig(**CONFIGS[name]),
                                       jax.random.PRNGKey(5))(upd, res)
    got_dec, got_res = tc.compress_update(_port(upd), _port(res) if res else None,
                                          rng.PRNGKey(5), tcfg.CompressionConfig(**CONFIGS[name]))
    atol = ROTATION_ATOL if CONFIGS[name].get("rotation") else 0.0
    _assert_trees_equal(got_dec, want_dec, atol)
    if with_residual:
        _assert_trees_equal(got_res, want_res, atol)
    else:
        assert got_res is None


@pytest.mark.parametrize("fraction", [0.05, 0.17, 0.25])
def test_compress_update_with_an_effective_fraction_matches_jax(fraction):
    upd, res = _update(2), _update(3)
    cfg = dict(topk_fraction=0.3, quant_bits=8, seed=4)
    want = jax.jit(lambda u, r, f: jc.compress_update(
        u, r, jax.random.PRNGKey(1), jcfg.CompressionConfig(**cfg), topk_fraction_eff=f))(
        upd, res, jnp.float32(fraction))
    got = tc.compress_update(_port(upd), _port(res), rng.PRNGKey(1),
                             tcfg.CompressionConfig(**cfg),
                             topk_fraction_eff=np.float32(fraction))
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)


def test_topk_mask_breaks_planted_ties_to_the_lowest_index():
    # magnitudes 3 and 2 tie at many places, signs mixed
    flat = np.asarray([1, -3, 2, 3, -2, 3, 0, -3, 2, 2, -1, 3], np.float32)
    for k, k_eff in ((3, None), (5, None), (6, None), (6, 4), (6, 1), (12, 7)):
        want = np.asarray(jc.topk_mask(jnp.asarray(flat), k,
                                       None if k_eff is None else jnp.int32(k_eff)))
        got = tc.topk_mask(torch.from_numpy(flat), k, k_eff)
        np.testing.assert_array_equal(got.numpy(), want)
    # 3 of the four 3s: the three lowest indices
    np.testing.assert_array_equal(np.nonzero(tc.topk_mask(torch.from_numpy(flat), 3).numpy())[0],
                                  [1, 3, 5])
    # quantized updates tie often: a whole compress_update over a tied leaf
    tied = {"d": {"w": np.repeat(np.asarray([0.5, -0.5, 0.25], np.float32), 20)}}
    cfg = dict(topk_fraction=0.4, quant_bits=8, seed=0)
    want = _jit_compress(jcfg.CompressionConfig(**cfg), jax.random.PRNGKey(0))(tied, None)
    got = tc.compress_update(_port(tied), None, rng.PRNGKey(0), tcfg.CompressionConfig(**cfg))
    _assert_trees_equal(got[0], want[0])


@pytest.mark.parametrize("n", [1, 2, 8, 300])
def test_rotation_pieces_match_jax(n):
    pad = jc._next_pow2(n)
    assert tc._next_pow2(n) == pad
    signs = tc._rotation_signs(7, 3, pad)
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jc._rotation_signs(7, 3, pad)))
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(tc._fwht(torch.from_numpy(np.resize(x, pad))).numpy(),
                                  np.asarray(jax.jit(jc._fwht)(jnp.asarray(np.resize(x, pad)))))
    rot = tc.rotate_leaf(torch.from_numpy(x), signs)
    np.testing.assert_array_equal(rot.numpy(), np.asarray(jax.jit(jc.rotate_leaf)(
        jnp.asarray(x), jnp.asarray(signs))))
    back = tc.unrotate_leaf(rot, signs, n)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_stochastic_quantization_matches_jax(bits):
    r = np.random.default_rng(bits)
    for flat in (r.standard_normal(500).astype(np.float32), np.zeros(7, np.float32),
                 np.asarray([1.0, np.nan, -2.0], np.float32), np.zeros(0, np.float32)):
        q, scale = tc.stochastic_quantize_leaf(torch.from_numpy(flat), bits, rng.PRNGKey(3))
        wq, wscale = jax.jit(lambda v, k: jc.stochastic_quantize_leaf(v, bits, k))(
            jnp.asarray(flat), jax.random.PRNGKey(3))
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(wscale))
        np.testing.assert_array_equal(tc.dequantize_leaf(q, scale).numpy(),
                                      np.asarray(jc.dequantize_leaf(wq, wscale)))


def test_wire_bytes_and_config_checks_match_jax():
    tree = _update(0)
    for name, cfg in {**CONFIGS, "off": {}, "q4": dict(quant_bits=4)}.items():
        t, j = tcfg.CompressionConfig(**cfg), jcfg.CompressionConfig(**cfg)
        assert tc.estimate_wire_nbytes(_port(tree), t) == jc.estimate_wire_nbytes(tree, j), name
        assert (t.enabled, t.uses_error_feedback, t.describe()) == (
            j.enabled, j.uses_error_feedback, j.describe())
    assert tc.logical_nbytes(_port(tree)) == jc.logical_nbytes(tree)
    assert tcfg.QUANT_LEVELS == jcfg.QUANT_LEVELS
    bad = [dict(topk_fraction=0.0), dict(topk_fraction=1.5), dict(quant_bits=2),
           dict(rotation=True), dict(topk_schedule=("linear", 0.1, 0.05, 3)),
           dict(topk_fraction=0.2, topk_schedule=("cosine", 0.1, 0.05, 3)),
           dict(topk_fraction=0.2, topk_schedule=("linear", 0.3, 0.05, 3)),
           dict(topk_fraction=0.2, topk_schedule=("linear", 0.1, 0.05, 0))]
    for cfg in bad:
        with pytest.raises(ValueError) as want:
            jcfg.CompressionConfig(**cfg)
        with pytest.raises(ValueError) as got:
            tcfg.CompressionConfig(**cfg)
        assert str(got.value) == str(want.value)
    for wrap, cls in ((TCompressing, tcfg), (JCompressing, jcfg)):
        with pytest.raises(ValueError, match="no lossy stage"):
            wrap(TFedAvg(), cls.CompressionConfig(), n_clients=2)
        with pytest.raises(TypeError, match="config must be a CompressionConfig"):
            wrap(TFedAvg(), {"quant_bits": 8}, n_clients=2)


@pytest.mark.parametrize("schedule", [("linear", 0.5, 0.1, 4), ("linear", 0.3, 0.05, 7),
                                      ("linear", 0.2, 0.2, 1), ("linear", 0.1, 0.4, 13)])
def test_effective_topk_fraction_matches_jax_compiled(schedule):
    cfg = dict(topk_fraction=0.5, topk_schedule=schedule)
    j = JCompressing(JFedAvg(), jcfg.CompressionConfig(**cfg), n_clients=2)
    t = TCompressing(TFedAvg(), tcfg.CompressionConfig(**cfg), n_clients=2)
    compiled = jax.jit(j.effective_topk_fraction)
    for r in range(16):
        assert t.effective_topk_fraction(r) == np.float32(compiled(jnp.int32(r))), r


@pytest.mark.parametrize("error_feedback", [True, False])
def test_aggregate_matches_jax(error_feedback):
    cfg = dict(topk_fraction=0.25, quant_bits=8, error_feedback=error_feedback, seed=9)
    n = 4
    params = _update(4)
    packets = jax.tree_util.tree_map(
        lambda p: np.stack([p + 0.1 * i * np.sign(p) for i in range(n)]), params)
    mask = np.asarray([1, 1, 0, 1], np.float32)
    counts = np.asarray([3, 5, 2, 7], np.float32)
    j = JCompressing(JFedAvg(), jcfg.CompressionConfig(**cfg), n_clients=n)
    t = TCompressing(TFedAvg(), tcfg.CompressionConfig(**cfg), n_clients=n)
    jstate, tstate = j.init(params), t.init(_port(params))
    for rnd in (1, 2):
        jstate = jax.jit(j.aggregate)(jstate, jbase.FitResults(
            packets=packets, sample_counts=counts, train_losses={}, train_metrics={},
            mask=mask), jnp.int32(rnd))
        tstate = t.aggregate(tstate, FitResults(
            packets=_port(packets), sample_counts=torch.from_numpy(counts), train_losses={},
            train_metrics={}, mask=torch.from_numpy(mask)), rnd)
        want = _port(jstate.inner.params)
        for k in want:
            np.testing.assert_allclose(tstate.inner.params[k].numpy(), want[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
        if error_feedback:
            _assert_trees_equal(tstate.residual, jstate.residual)
            # an unsampled client's residual row stays as it was
            assert all(not v[2].any() for v in tstate.residual.values())
        else:
            assert tstate.residual is None and jstate.residual is None
    rows = t.state_rows(tstate)
    assert rows["inner"] is None
    back = t.scatter_state_rows(tstate, rows)
    assert back.residual is tstate.residual and back.inner is tstate.inner


def _rows(n):
    r = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = r.standard_normal((40, DIM)).astype(np.float32)
        y = r.integers(0, N_CLASSES, 40).astype(np.int32)
        out.append((x[:32], y[:32], x[32:], y[32:]))
    return out


def _tsim(n=3, scaffold=False, **kw):
    model = tengine.from_module(TMlp(DIM, (12,), N_CLASSES))
    logic = (TScaffoldLogic(model, tengine.masked_cross_entropy, learning_rate=0.05)
             if scaffold else tengine.ClientLogic(model, tengine.masked_cross_entropy))
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=TScaffold() if scaffold else TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in _rows(n)], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=5,
        device="cpu", **kw)


def _jsim(n=3, scaffold=False, **kw):
    model = jengine.from_flax(JMlp(features=(12,), n_outputs=N_CLASSES))
    logic = (JScaffoldLogic(model, jengine.masked_cross_entropy, learning_rate=0.05)
             if scaffold else jengine.ClientLogic(model, jengine.masked_cross_entropy))
    return jsim.FederatedSimulation(
        logic=logic, tx=optax.sgd(0.05), strategy=JScaffold() if scaffold else JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in _rows(n)], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=5, **kw)


RUNS = {
    "ef_topk_q8": dict(compression=dict(topk_fraction=0.3, error_feedback=True,
                                        quant_bits=8, seed=3)),
    "no_ef_q8_rotation": dict(compression=dict(quant_bits=8, rotation=True,
                                               error_feedback=False, seed=1)),
    "topk_schedule": dict(compression=dict(topk_fraction=0.5, error_feedback=True, seed=2,
                                           topk_schedule=("linear", 0.5, 0.1, 3))),
    # SCAFFOLD's variates compressed too, the residual rows through the
    # registry of a sampled cohort
    "cohort_compressing_scaffold": dict(
        n=6, scaffold=True, cohort=True,
        compression=dict(topk_fraction=0.5, error_feedback=True, quant_bits=8, seed=3)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_compressed_runs_match_jax(name):
    spec = dict(RUNS[name])
    comp = spec.pop("compression")
    n, scaffold, cohort = spec.get("n", 3), spec.get("scaffold", False), spec.get("cohort")
    jkw = dict(compression=jcfg.CompressionConfig(**comp))
    tkw = dict(compression=tcfg.CompressionConfig(**comp))
    if cohort:
        jkw.update(cohort=jreg.CohortConfig(slots=3),
                   client_manager=jcm.FixedFractionManager(n, 0.5))
        tkw.update(cohort=treg.CohortConfig(slots=3),
                   client_manager=tcm.FixedFractionManager(n, 0.5))
    js = _jsim(n, scaffold, **jkw)
    init = jax.device_get(js.global_params)
    jhist = js.fit(3)
    ts = _tsim(n, scaffold, **tkw)
    ts.set_global_params(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, init)))
    assert ts._select_execution_mode(3) == js._select_execution_mode(3)
    thist = ts.fit(3)
    for tr, jr in zip(thist, jhist, strict=True):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"], jr.eval_losses["checkpoint"],
                                   atol=TOL, rtol=0)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k in want:
        np.testing.assert_allclose(ts.global_params[k].numpy(), want[k].numpy(), atol=TOL,
                                   rtol=0, err_msg=k)
    if comp.get("error_feedback"):
        if cohort:
            ids = np.arange(n)
            jres = js.registry.gather_strategy_rows(ids)["residual"]
            tres = ts.registry.gather_strategy_rows(ids)["residual"]
            tres = {k: torch.from_numpy(v) for k, v in tres.items()}
        else:
            jres, tres = js.server_state.residual, ts.server_state.residual
        for k, v in _port(jres).items():
            np.testing.assert_allclose(tres[k].numpy(), v.numpy(), atol=TOL, rtol=0, err_msg=k)
    # compression moved the run: the uncompressed one differs
    plain = _tsim(n, scaffold, **{k: v for k, v in tkw.items() if k != "compression"})
    plain.set_global_params(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, init)))
    assert [r.fit_losses for r in plain.fit(3)] != [r.fit_losses for r in thist]


def test_replace_global_params_through_the_wrapper():
    cfg = dict(topk_fraction=0.5, error_feedback=True)
    params = _update(0)
    for base, wrap, cls, conv in ((tbase, TCompressing, tcfg, _port),
                                  (jbase, JCompressing, jcfg, lambda t: t)):
        inner = TScaffold() if base is tbase else JScaffold()
        strategy = wrap(inner, cls.CompressionConfig(**cfg), n_clients=2)
        state = strategy.init(conv(params))
        new = conv(_update(7))
        got = base.replace_global_params(strategy, state, new)
        assert got.residual is state.residual
        assert got.inner.control_variates is state.inner.control_variates
        assert strategy.global_params(got) is new
        # an unwrapped state takes the plain replace
        assert base.replace_global_params(inner, state.inner, new).params is new


def test_set_global_params_on_a_compressed_simulation():
    ts = _tsim(compression=tcfg.CompressionConfig(topk_fraction=0.5, quant_bits=8))
    new = {k: torch.full_like(v, 0.25) for k, v in ts.global_params.items()}
    ts.set_global_params(new)
    for k in new:
        assert torch.equal(ts.global_params[k], new[k])
        assert torch.equal(ts.client_states.params[k][1], new[k])
    assert isinstance(ts.server_state.residual, dict)
    ts.fit(1)
    assert all(torch.isfinite(v).all() for v in ts.global_params.values())


def test_partial_exchange_and_bad_configs_are_refused_as_in_jax():
    cfg = dict(topk_fraction=0.5)
    cases = [
        (lambda: _jsim(exchanger=jexcluding(["Dense_1"]),
                       compression=jcfg.CompressionConfig(**cfg)),
         lambda: _tsim(exchanger=texcluding(["Dense_1"]),
                       compression=tcfg.CompressionConfig(**cfg))),
        (lambda: _jsim(compression=dataclasses.asdict(jcfg.CompressionConfig(**cfg))),
         lambda: _tsim(compression=dataclasses.asdict(tcfg.CompressionConfig(**cfg)))),
    ]
    for jbuild, tbuild in cases:
        with pytest.raises(Exception) as want:
            jbuild()
        with pytest.raises(Exception) as got:
            tbuild()
        assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))
    # a config with no lossy stage wraps nothing
    ts = _tsim(compression=tcfg.CompressionConfig())
    assert isinstance(ts.strategy, TFedAvg)
