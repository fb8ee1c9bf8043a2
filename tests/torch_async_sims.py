"""Shared tiny setups for the buffered-async, fault and robust-aggregation
parity tests (``tests/test_torch_async_*.py``, ``test_torch_faults.py``,
``test_torch_robust.py``): the JAX tests' Mlp over 4-8 clients of 6
features and 3 classes (``rows``), or ``tests/resilience/conftest.py``'s
separable 4-feature shards (``resilience_rows``), built in both packages
from the same numpy data; the port's run installs the JAX run's converted
flax init."""

import jax
import numpy as np
import optax

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import simulation as tsim

TOL = 5e-4


def rows(n: int, dim: int = 6, n_classes: int = 3, n_rows: int = 40) -> list:
    """Uneven clients (padded steps and rows), random labels."""
    r = np.random.default_rng(0)
    out = []
    for i in range(n):
        m = n_rows - 2 * (i % 3)
        x = r.standard_normal((m, dim)).astype(np.float32)
        y = r.integers(0, n_classes, m).astype(np.int32)
        out.append((x[:m - 8], y[:m - 8], x[m - 8:], y[m - 8:]))
    return out


def resilience_rows(n: int) -> list:
    """``tests/resilience/conftest.py``'s shards: 32 rows of 4 features,
    label = sign of the sum, the first 8 rows as val."""
    out = []
    for i in range(n):
        r = np.random.default_rng(100 + i)
        x = r.normal(size=(32, 4)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.int32)
        out.append((x, y, x[:8], y[:8]))
    return out


def _shape(data):
    return data[0][0].shape[1], int(max(d[1].max() for d in data)) + 1


def tsim_of(data, strategy, mode="auto", hidden=12, n_classes=None, lr=0.05, **kw):
    dim, nc = _shape(data)
    model = tengine.from_module(TMlp(dim, (hidden,), n_classes or max(nc, 3)))
    kw.setdefault("local_epochs", 1)
    kw.setdefault("seed", 5)
    return tsim.FederatedSimulation(
        logic=tengine.ClientLogic(model, tengine.masked_cross_entropy), tx=optim.sgd(lr),
        strategy=strategy, datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), execution_mode=mode, device="cpu",
        **kw)


def jsim_of(data, strategy, mode="auto", hidden=12, n_classes=None, lr=0.05, **kw):
    dim, nc = _shape(data)
    model = jengine.from_flax(JMlp(features=(hidden,), n_outputs=n_classes or max(nc, 3)))
    kw.setdefault("local_epochs", 1)
    kw.setdefault("seed", 5)
    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(model, jengine.masked_cross_entropy), tx=optax.sgd(lr),
        strategy=strategy, datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), execution_mode=mode, **kw)


def jax_init(js) -> dict:
    """The JAX simulation's initial global params, converted (call before
    its ``fit``)."""
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(
        js.global_params)))


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in ptu.tree_leaves(tree)])


def same_history(a, b) -> bool:
    return ([r.round for r in a.history] == [r.round for r in b.history] and all(
        getattr(x, f) == getattr(y, f) for x, y in zip(a.history, b.history)
        for f in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics")))


def assert_matches_jax(ts, jhist, js, tol=TOL, offset=0):
    """The port's records (from ``offset``) and global params against
    JAX's, within ``tol``."""
    for tr, jr in zip(ts.history[offset:], jhist, strict=True):
        for f in ("fit_losses", "eval_losses"):
            for k, v in getattr(jr, f).items():
                np.testing.assert_allclose(getattr(tr, f)[k], v, atol=tol, rtol=0,
                                           err_msg=(tr.round, f, k))
        np.testing.assert_allclose(tr.eval_metrics["accuracy"], jr.eval_metrics["accuracy"],
                                   atol=1e-6)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), atol=tol, rtol=0,
                                   err_msg=k)
