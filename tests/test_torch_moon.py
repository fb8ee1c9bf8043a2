"""MOON in the port against the JAX package on the CPU: the contrastive loss
(with and without ``negative_mask``, one and two positives), the MOON
model's conversion from its flax init, the ``moon_mnist`` smoke config with
its golden (the contrastive term exactly 0 in round 1 and nonzero after),
and the vmapped clients (the old models' features through a nested vmap
inside ``vmap(grad)``) against the loop.

Tolerances: 1e-6 for single functions, 5e-4 for runs (f32, the
reference's), 1e-5 for the vmapped clients against the loop."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.losses import contrastive as jcon
from fl4health_tpu.models import bases as jbases
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.moon import MoonClientLogic as TMoonLogic
from fl4health_tpu_torch.losses import contrastive as tcon
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import bases as tbases
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import param_dict
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4
FN_TOL = 1e-6
AXIS_TOL = 1e-5


def test_cosine_similarity_matches_jax():
    r = np.random.default_rng(0)
    a, b = r.standard_normal((2, 5, 7)).astype(np.float32)
    b[0] = 0.0  # a zero row: the eps floor
    np.testing.assert_allclose(tcon.cosine_similarity(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jcon.cosine_similarity(a, b)), atol=FN_TOL, rtol=0)


@pytest.mark.parametrize("n_pos,negative_mask,mask", [
    (1, None, None),
    (1, [0.0, 1.0, 1.0], [1, 1, 1, 0, 1, 0]),
    (1, [0.0, 0.0, 0.0], None),
    (2, [1.0, 0.0, 1.0], [1, 0, 1, 1, 1, 1]),
], ids=["plain", "negative_mask", "no_negatives", "two_positives"])
def test_moon_contrastive_loss_matches_jax(n_pos, negative_mask, mask):
    r = np.random.default_rng(1)
    z = r.standard_normal((6, 8)).astype(np.float32)
    pos = r.standard_normal((n_pos, 6, 8)).astype(np.float32)
    neg = r.standard_normal((3, 6, 8)).astype(np.float32)
    kw_j = dict(temperature=0.5,
                mask=None if mask is None else jnp.asarray(mask, jnp.float32),
                negative_mask=None if negative_mask is None else jnp.asarray(negative_mask))
    kw_t = dict(temperature=0.5,
                mask=None if mask is None else torch.tensor(mask, dtype=torch.float32),
                negative_mask=None if negative_mask is None else torch.tensor(negative_mask))
    want = float(jcon.moon_contrastive_loss(z, pos, neg, **kw_j))
    got = tcon.moon_contrastive_loss(torch.tensor(z), torch.tensor(pos), torch.tensor(neg),
                                     **kw_t)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, atol=FN_TOL, rtol=FN_TOL)


@pytest.mark.parametrize("projection", [False, True])
def test_moon_model_converts_from_its_flax_init(projection):
    jmodel = jbases.MoonModel(base_module=jbases.DenseFeatures((16,)),
                              head_module=jbases.DenseHead(10),
                              projection_module=jbases.DenseFeatures((12,)) if projection
                              else None)
    x = np.random.default_rng(2).standard_normal((5, 14, 14, 1)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), x)
    (jpreds, jfeats) = jmodel.apply(variables, x)
    tmodel = tbases.MoonModel(tbases.DenseFeatures(196, (16,)),
                              tbases.DenseHead(12 if projection else 16, 10),
                              tbases.DenseFeatures(16, (12,)) if projection else None)
    params = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, variables["params"]))
    own = param_dict(tmodel)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    assert "base_module/Dense_0/kernel" in params and "head_module/Dense_0/bias" in params
    (preds, feats), _ = tengine.from_module(tmodel).apply(params, {}, torch.tensor(x))
    np.testing.assert_allclose(preds["prediction"].detach().numpy(),
                               np.asarray(jpreds["prediction"]), atol=FN_TOL, rtol=0)
    np.testing.assert_allclose(feats["features"].detach().numpy(),
                               np.asarray(jfeats["features"]), atol=FN_TOL, rtol=0)
    back = convert.torch_to_flax(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, variables["params"]))


def _port_moon_sim(datasets, seed=2024, lr=0.02, **kw):
    model = tbases.MoonModel(tbases.DenseFeatures(196, (16,)), tbases.DenseHead(16, 10))
    return tsim.FederatedSimulation(
        logic=TMoonLogic(tengine.from_module(model), tengine.masked_cross_entropy,
                         contrastive_weight=1.0, buffer_len=kw.pop("buffer_len", 1)),
        tx=optim.sgd(lr), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in datasets],
        batch_size=32, metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1,
        seed=seed, device="cpu", **kw)


def test_moon_mnist_matches_jax_and_its_golden():
    js = harness.moon_mnist()
    ts = _port_moon_sim(js.datasets)
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist = js.fit(harness.N_ROUNDS)
    thist = ts.fit(harness.N_ROUNDS)
    for tr, jr in zip(thist, jhist):
        assert set(tr.fit_losses) == {"backward", "vanilla", "contrastive"}
        for key in ("backward", "vanilla", "contrastive"):
            np.testing.assert_allclose(tr.fit_losses[key], jr.fit_losses[key],
                                       atol=TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=1e-6)
    # no old model in round 1: the term is exactly 0; active after
    assert thist[0].fit_losses["contrastive"] == 0.0
    assert all(r.fit_losses["contrastive"] > 0 for r in thist[1:])
    assert int(ts.client_states.extra.n_valid.max()) == 1
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden("moon_mnist", rounds)
    assert not errors, "\n".join(errors)


def test_buffer_shifts_newest_last():
    js = harness.moon_mnist()
    sim = _port_moon_sim(js.datasets[:2], buffer_len=2)
    sim.fit(1)
    first = {k: v[:, -1].clone() for k, v in sim.client_states.extra.old_params.items()}
    assert sim.client_states.extra.n_valid.tolist() == [1, 1]
    sim.fit(1)
    extra = sim.client_states.extra
    assert extra.n_valid.tolist() == [2, 2]
    for k, v in first.items():  # last round's model moved one slot up
        assert torch.equal(extra.old_params[k][:, 0], v), k


@pytest.mark.parametrize("buffer_len", [1, 2])
def test_vmapped_clients_match_the_loop(buffer_len):
    js = harness.moon_mnist()
    datasets = js.datasets[:3]
    runs = []
    for axis in (tsim.vmap_clients, tsim.loop_clients):
        sim = _port_moon_sim(datasets, buffer_len=buffer_len)
        sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
        runs.append((sim.fit(3), sim))
    (vh, vs), (lh, ls) = runs
    for a, b in zip(vh, lh):
        for key in ("backward", "vanilla", "contrastive"):
            np.testing.assert_allclose(a.fit_losses[key], b.fit_losses[key],
                                       atol=AXIS_TOL, rtol=0)
    assert vh[-1].fit_losses["contrastive"] > 0
    for k in vs.global_params:
        torch.testing.assert_close(vs.global_params[k], ls.global_params[k],
                                   atol=AXIS_TOL, rtol=0)
        torch.testing.assert_close(vs.client_states.extra.old_params[k],
                                   ls.client_states.extra.old_params[k], atol=AXIS_TOL, rtol=0)
