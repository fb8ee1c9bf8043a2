"""The port's federated simulation against the JAX one: a 2-client, 2-round,
2-local-step FedAvg run of a flash-attention TransformerClassifier from the
same converted init and the same numpy data, per-round losses and final
global params within 5e-4 (the f32 CPU tolerance of tests/conftest.py);
plus the pieces under it (seeds, index plans, aggregation, FedAvg, SGD, the
data generator, device selection)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.core import aggregate as jagg
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import aggregate as tagg
from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
from fl4health_tpu_torch.device import resolve_device
from fl4health_tpu_torch.kernels.flash_attention import flash_attention
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import TransformerClassifier as TTransformer
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.base import FitResults
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

jfa = importlib.import_module("fl4health_tpu.kernels.flash_attention")

CFG = dict(vocab_size=32, n_classes=3, d_model=16, n_heads=2, n_layers=1,
           d_ff=32, max_len=24, remat=True)
TOL = 5e-4


def _client_data(seed, n_train, n_val, t=24):
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x = rng.integers(1, CFG["vocab_size"], size=(n, t)).astype(np.int32)
    lengths = rng.integers(t // 2, t + 1, size=n)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0
    y = rng.integers(0, CFG["n_classes"], size=n).astype(np.int32)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def test_fedavg_run_matches_jax():
    # client 1 has a ragged final batch (example_mask zeros) and more rows
    data = [_client_data(0, 16, 6), _client_data(1, 20, 5)]
    seed = 7
    jmodule = JTransformer(**CFG, attention_fn=functools.partial(
        jfa.flash_attention, block_q=16, block_k=16))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(jmodule),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2, seed=seed,
        execution_mode="pipelined")
    tmodule = TTransformer(**CFG, attention_fn=flash_attention)
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(tmodule),
                                  tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=seed,
        device="cpu")
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    ts.set_global_params(init)

    jhist, thist = js.fit(2), ts.fit(2)
    assert [r.round for r in thist] == [1, 2]
    for jr, tr in zip(jhist, thist):
        for got, want in ((tr.fit_losses, jr.fit_losses),
                          (tr.eval_losses, jr.eval_losses)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
        for k in jr.eval_metrics:
            np.testing.assert_allclose(tr.eval_metrics[k], jr.eval_metrics[k], atol=1e-6)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    got = ts.global_params
    assert set(got) == set(want)
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
        moved = max(moved, float((got[k] - init[k]).abs().max()))
    assert moved > 1e-3  # training changed the global params


@pytest.mark.parametrize("seed", [0, 42, 2024])
def test_base_entropy_is_the_jax_key_data(seed):
    want = [int(v) for v in np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))]
    assert tsim.base_entropy(seed) == want


def test_index_plans_match_jax():
    ents = [[0, 5, 1001, 0], [0, 5, 1001, 1]]
    for kw in (dict(n_steps=4), dict(local_epochs=2), dict(n_steps=3, pad_steps=6)):
        want = jengine.multi_client_index_plans(ents, [19, 7], 8, **kw)
        got = tengine.multi_client_index_plans(ents, [19, 7], 8, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_gather_batches_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 9, 3)).astype(np.float32)
    ys = rng.integers(0, 4, size=(2, 9)).astype(np.int32)
    plan = jengine.multi_client_index_plans([[1], [2]], [9, 5], 4, n_steps=3)
    want = jengine.gather_batches(jnp.asarray(xs), jnp.asarray(ys), *plan)
    got = tengine.gather_batches(torch.tensor(xs), torch.tensor(ys), *plan)
    for name in ("x", "y", "example_mask", "step_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("mask", [[1, 1, 1], [0, 0, 0], [1, 0, 1]])
@pytest.mark.parametrize("weighted", [True, False])
def test_aggregate_matches_jax_with_empty_cohorts_and_nan_rows(mask, weighted):
    rng = np.random.default_rng(1)
    stacked = {"w": rng.standard_normal((3, 4, 2)).astype(np.float32)}
    stacked["w"][1, 0, 0] = np.nan  # a NaN in client 1's row
    counts = np.asarray([3.0, 5.0, 2.0], np.float32)
    m = np.asarray(mask, np.float32)
    want = jagg.aggregate({"w": jnp.asarray(stacked["w"])}, jnp.asarray(counts),
                          jnp.asarray(m), weighted)
    got = tagg.aggregate({"w": torch.tensor(stacked["w"])}, torch.tensor(counts),
                         torch.tensor(m), weighted)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)
    if m[1] == 0:
        assert torch.isfinite(got["w"]).all()
    np.testing.assert_allclose(
        tagg.effective_weights(torch.tensor(counts), torch.tensor(m), weighted).numpy(),
        np.asarray(jagg.effective_weights(jnp.asarray(counts), jnp.asarray(m), weighted)),
        rtol=1e-6)
    losses = np.asarray([0.5, 2.0, 1.0], np.float32)
    np.testing.assert_allclose(
        float(tagg.aggregate_losses(torch.tensor(losses), torch.tensor(counts),
                                    torch.tensor(m), weighted)),
        float(jagg.aggregate_losses(jnp.asarray(losses), jnp.asarray(counts),
                                    jnp.asarray(m), weighted)), rtol=1e-6)


def test_fedavg_keeps_params_on_an_empty_cohort():
    old = {"w": torch.ones(3)}
    strategy = TFedAvg()
    results = FitResults(packets={"w": torch.full((2, 3), 5.0)},
                         sample_counts=torch.tensor([1.0, 1.0]), train_losses={},
                         train_metrics={}, mask=torch.zeros(2))
    new = strategy.aggregate(strategy.init(old), results, 1)
    assert torch.equal(new.params["w"], old["w"])
    results = FitResults(packets={"w": torch.full((2, 3), 5.0)},
                         sample_counts=torch.tensor([1.0, 3.0]), train_losses={},
                         train_metrics={}, mask=torch.ones(2))
    assert torch.equal(strategy.aggregate(strategy.init(old), results, 1).params["w"],
                       torch.full((3,), 5.0))


def test_sgd_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 2)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    tx = optax.sgd(0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), tx.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    ttx = optim.sgd(0.05)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tupd, _ = ttx.update({k: torch.tensor(v) for k, v in grads.items()}, ttx.init(tp), tp)
    got = optim.apply_updates(tp, tupd)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.integers(0, 4, 6).astype(np.int32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], np.float32)
    want = jengine.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    got = tengine.masked_cross_entropy(torch.tensor(logits), torch.tensor(y), torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_synthetic_text_has_the_jax_generators_shape_and_support():
    x, y = synthetic_text_classification(torch.Generator().manual_seed(0), 64,
                                         vocab_size=50, seq_len=20, n_classes=4)
    x2, _ = synthetic_text_classification(torch.Generator().manual_seed(0), 64,
                                          vocab_size=50, seq_len=20, n_classes=4)
    assert torch.equal(x, x2)
    assert x.shape == (64, 20) and y.shape == (64,)
    assert x.dtype == torch.int32 and y.dtype == torch.int32
    assert int(x.min()) == 0 and int(x.max()) <= 49
    lengths = (x > 0).sum(dim=1)
    assert int(lengths.min()) >= 10 and int(lengths.max()) <= 20
    # real tokens form a prefix: PAD only in the tail
    assert torch.all((x > 0).int().diff(dim=1) <= 0)
    assert set(y.tolist()) <= {0, 1, 2, 3}


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    module = TTransformer(**CFG)
    data = [tsim.ClientDataset(*_client_data(0, 8, 2))]
    kwargs = dict(logic=tengine.ClientLogic(tengine.from_module(module),
                                            tengine.masked_cross_entropy),
                  tx=optim.sgd(0.1), strategy=TFedAvg(), datasets=data,
                  batch_size=4, metrics=TMetricManager((tefficient.accuracy(),)),
                  local_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.FederatedSimulation(**kwargs)
    assert tsim.FederatedSimulation(**kwargs, device="cpu").device.type == "cpu"


def test_pytree_helpers_match_jax():
    from fl4health_tpu.core import pytree as jpt
    from fl4health_tpu.core import types as jtypes
    from fl4health_tpu_torch.core import pytree as tpt
    from fl4health_tpu_torch.core import types as ttypes

    rng = np.random.default_rng(4)
    trees = [{"a": rng.standard_normal((2, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(4).astype(np.float32)}} for _ in range(3)]
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    tt = [tpt.tree_map(torch.tensor, t) for t in trees]
    jst, tst = jpt.stack_clients(jt), tpt.stack_clients(tt)
    np.testing.assert_array_equal(tst["b"]["c"].numpy(), np.asarray(jst["b"]["c"]))
    for j, t in zip(jpt.unstack_clients(jst, 3), tpt.unstack_clients(tst, 3)):
        np.testing.assert_array_equal(t["a"].numpy(), np.asarray(j["a"]))
    np.testing.assert_array_equal(tpt.client_slice(tst, 1)["a"].numpy(),
                                  np.asarray(jpt.client_slice(jst, 1)["a"]))
    np.testing.assert_array_equal(tpt.broadcast_clients(tt[0], 4)["b"]["c"].numpy(),
                                  np.asarray(jpt.broadcast_clients(jt[0], 4)["b"]["c"]))
    assert tpt.tree_nbytes(tst) == jpt.tree_nbytes(jst)
    flat = {"a": tt[0]["a"], "c": tt[0]["b"]["c"]}
    assert ttypes.num_params(flat) == jtypes.num_params(jt[0]) == 10


def test_non_finite_client_is_masked_out_of_the_aggregate():
    # client 1's labels are all 2, on which the criterion returns NaN: its
    # params go NaN and it must drop out of the aggregate, so the 2-client run
    # equals the run of client 0 alone (same seed -> same index plan)
    cfg = {**CFG, "remat": False}
    x0, y0, xv0, yv0 = _client_data(0, 16, 6)
    y0, yv0 = y0 % 2, yv0 % 2
    x1, _, xv1, _ = _client_data(1, 16, 6)
    poisoned = tsim.ClientDataset(x1, np.full(16, 2, np.int32), xv1, np.full(6, 1, np.int32))

    def criterion(logits, targets, mask):
        loss = tengine.masked_cross_entropy(logits, targets, mask)
        return torch.where((targets == 2).any(), torch.full_like(loss, float("nan")), loss)

    def run(datasets):
        module = TTransformer(**cfg)
        sim = tsim.FederatedSimulation(
            logic=tengine.ClientLogic(tengine.from_module(module), criterion),
            tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=datasets, batch_size=8,
            metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=5,
            device="cpu")
        return sim.fit(2), sim.global_params

    clean = tsim.ClientDataset(x0, y0, xv0, yv0)
    both_hist, both_params = run([clean, poisoned])
    alone_hist, alone_params = run([clean])
    for b, a in zip(both_hist, alone_hist):
        assert np.isfinite(b.fit_losses["backward"])
        assert b.fit_losses["backward"] == a.fit_losses["backward"]
    for k in alone_params:
        assert torch.equal(both_params[k], alone_params[k]), k


def test_plain_logic_ignores_the_step_stream(monkeypatch):
    # every local step hands value_and_grads a generator; the non-DP logic
    # draws nothing from it, so a run with other streams is the same run,
    # bit for bit
    data = [tsim.ClientDataset(*_client_data(0, 16, 6))]

    def run():
        sim = tsim.FederatedSimulation(
            logic=tengine.ClientLogic(tengine.from_module(TTransformer(**CFG)),
                                      tengine.masked_cross_entropy),
            tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=data, batch_size=8,
            metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=1,
            device="cpu")
        return sim.fit(1), sim.global_params

    hist_a, params_a = run()
    seen = []
    real = tengine.step_generator

    def other_stream(entropy, step, device):
        seen.append((tuple(entropy), step))
        return real([*entropy, 99], step + 7, device)

    monkeypatch.setattr(tengine, "step_generator", other_stream)
    hist_b, params_b = run()
    assert seen == [((0, 1, 1001, 0), 0), ((0, 1, 1001, 0), 1)]
    assert hist_a[0].fit_losses == hist_b[0].fit_losses
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k
