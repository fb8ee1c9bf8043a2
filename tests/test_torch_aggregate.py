"""The port's aggregate above 32 clients (``core/aggregate.py``
``weighted_mean``) against the JAX package on the CPU: bit for bit with
JAX's jitted masked weighted sum at 33 to 200 clients, NaN rows under
weight 0 included, and a 2-round FedOpt(adam) run of 40 clients within
5e-4 of JAX's (the server's Adam turns a pseudo-gradient's last bit into
an lr-sized step, so a sum in another order leaves JAX's trajectory in
round 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.core import aggregate as jagg
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies import fedopt as jfedopt
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import aggregate as tagg
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies import fedopt as tfedopt

TOL = 5e-4


@pytest.mark.parametrize("n", [33, 47, 64, 65, 100, 200])
def test_weighted_mean_above_32_clients_is_jax_sum(n):
    rng = np.random.default_rng(n)
    tree = {"a": rng.standard_normal((n, 40, 7)).astype(np.float32),
            "b": rng.standard_normal((n, 5)).astype(np.float32),
            "c": rng.standard_normal((n, 3, 2, 2)).astype(np.float32)}
    counts = rng.integers(1, 200, n).astype(np.float32)
    mask = (rng.random(n) > 0.25).astype(np.float32)
    for leaf in tree.values():
        leaf[:, :1] = leaf[:1, :1]  # a column no client moved
        leaf[mask == 0] = np.nan  # an unsampled client's row must not leak
    w = np.asarray(jagg.effective_weights(jnp.asarray(counts), jnp.asarray(mask)))
    tw = tagg.effective_weights(torch.tensor(counts), torch.tensor(mask))
    np.testing.assert_array_equal(tw.numpy(), w)
    want = jax.jit(jagg.weighted_mean)(jax.tree_util.tree_map(jnp.asarray, tree),
                                       jnp.asarray(w))
    got = tagg.weighted_mean({k: torch.tensor(v) for k, v in tree.items()}, tw)
    for k in tree:
        assert np.isfinite(got[k].numpy()).all()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_fedopt_adam_with_40_clients_tracks_jax():
    n, rows, shape = 40, 24, (6, 6, 1)
    jdata = []
    for i in range(n):
        x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(i), rows, shape, 4))
        jdata.append(jsim.ClientDataset(x[:16], y[:16], x[16:], y[16:]))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=4)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.1), strategy=jfedopt.FedOpt(optax.adam(0.01)), datasets=jdata,
        batch_size=8, metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2,
        seed=3, execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(
            tengine.from_module(tcnn.Mlp(int(np.prod(shape)), features=(16,), n_outputs=4)),
            tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=tfedopt.FedOpt(optim.adam(0.01)),
        datasets=[tsim.ClientDataset(d.x_train, d.y_train, d.x_val, d.y_val)
                  for d in jdata],
        batch_size=8, metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2,
        seed=3, device="cpu")
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist, thist = js.fit(2), ts.fit(2)
    for tr, jr in zip(thist, jhist):
        assert abs(tr.fit_losses["backward"] - jr.fit_losses["backward"]) <= TOL
        assert abs(tr.eval_losses["checkpoint"] - jr.eval_losses["checkpoint"]) <= TOL
    jflat = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), atol=TOL, rtol=0, err_msg=k)
    assert int(ts.server_state.opt_state[0].count) == 2
