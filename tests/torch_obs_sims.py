"""Shared tiny recipes for the observability parity tests
(``tests/test_torch_telemetry.py``, ``test_torch_health.py``,
``test_torch_flightrec_bundle.py``, ``test_torch_obs_records.py``,
``test_torch_fleet.py``): an Mlp of 6 features, 12 hidden units and 3
classes over 4-6 uneven clients (``torch_async_sims.rows``), plain or
instance-level DP clients (C 0.5, sigma 0.5: clipping fires and the noise is
the same in both packages), 2 local steps of batch 8, built in both packages
from the same numpy data; the port's run installs the JAX run's converted
init. Each package gets a private ``Observability`` (its own registry and
tracer, introspection off unless a test turns it on)."""

import jax
import numpy as np
import optax

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDpLogic
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.observability import MetricsRegistry as JRegistry
from fl4health_tpu.observability import Observability as JObservability
from fl4health_tpu.observability import Tracer as JTracer
from fl4health_tpu.observability.telemetry import TELEMETRY_FIELDS
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDpLogic
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.observability import MetricsRegistry as TRegistry
from fl4health_tpu_torch.observability import Observability as TObservability
from fl4health_tpu_torch.observability import Tracer as TTracer
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_async_sims import rows

DIM, HIDDEN, N_CLASSES = 6, 12, 3
TOL = 5e-4
# the per-client counts a RoundTelemetry carries: held exactly
COUNT_FIELDS = ("nonfinite_params", "nonfinite_loss", "nonfinite_eval_loss")


def obs_of(pkg: str, **kw):
    """A private, enabled handle of ``pkg`` ("jax" or "torch"); introspection
    off unless ``introspection=True`` is passed."""
    kw.setdefault("introspection", False)
    if pkg == "jax":
        return JObservability(enabled=True, tracer=JTracer(), registry=JRegistry(), **kw)
    return TObservability(enabled=True, tracer=TTracer(), registry=TRegistry(), **kw)


def data_of(n: int = 4, poison: int | None = None) -> list:
    """``n`` uneven clients; client ``poison``'s training features NaN."""
    out = rows(n)
    if poison is not None:
        x, y, xv, yv = out[poison]
        out[poison] = (np.full_like(x, np.nan), y, xv, yv)
    return out


def sim_of(pkg: str, data: list, *, dp: bool = True, mode: str = "auto", obs=None,
           strategy=None, **kw):
    """The recipe's simulation in ``pkg``; ``dp`` takes instance-level DP
    clients."""
    kw.setdefault("local_steps", 2)
    kw.setdefault("seed", 5)
    if pkg == "jax":
        model = jengine.from_flax(JMlp(features=(HIDDEN,), n_outputs=N_CLASSES))
        logic = (JDpLogic(model, jengine.masked_cross_entropy, clipping_bound=0.5,
                          noise_multiplier=0.5) if dp
                 else jengine.ClientLogic(model, jengine.masked_cross_entropy))
        datasets = [jsim.ClientDataset(*d) for d in data] if data is not None else None
        return jsim.FederatedSimulation(
            logic=logic, tx=optax.sgd(0.05), strategy=strategy or JFedAvg(),
            datasets=kw.pop("datasets", None) or datasets, batch_size=8,
            metrics=JMetricManager((jefficient.accuracy(),)), execution_mode=mode,
            observability=obs, **kw)
    model = tengine.from_module(TMlp(DIM, (HIDDEN,), N_CLASSES))
    logic = (TDpLogic(model, tengine.masked_cross_entropy, clipping_bound=0.5,
                      noise_multiplier=0.5) if dp
             else tengine.ClientLogic(model, tengine.masked_cross_entropy))
    datasets = [tsim.ClientDataset(*d) for d in data] if data is not None else None
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=strategy or TFedAvg(),
        datasets=kw.pop("datasets", None) or datasets, batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), execution_mode=mode,
        observability=obs, device="cpu", **kw)


def jax_init(js) -> dict:
    """The JAX run's initial global params (a cohort run's client proto),
    converted; call before its ``fit``."""
    tree = (js.registry._client_proto.params if getattr(js, "registry", None) is not None
            else js.global_params)
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(tree)))


def events(obs, name: str) -> list[dict]:
    return [e for e in obs.registry.events if e["event"] == name]


def assert_telemetry_close(t_events: list[dict], j_events: list[dict], tol: float = TOL):
    """The port's ``telemetry`` events against JAX's: counts exact, the
    rest within ``tol`` relative (NaN where JAX has NaN)."""
    assert [e["round"] for e in t_events] == [e["round"] for e in j_events]
    for te, je in zip(t_events, j_events):
        assert set(te) - {"ts"} == set(je) - {"ts"}
        for k in TELEMETRY_FIELDS + ("loss_scale_skips",):
            if k not in je:
                continue
            t, j = np.asarray(te[k], np.float64), np.asarray(je[k], np.float64)
            if k in COUNT_FIELDS:
                np.testing.assert_array_equal(t, j, err_msg=(te["round"], k))
            else:
                np.testing.assert_allclose(t, j, rtol=tol, atol=1e-6,
                                           err_msg=(te["round"], k))
