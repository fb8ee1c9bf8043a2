"""Shared recipes for the recovery parity tests
(``tests/test_torch_supervisor.py``, ``test_torch_quarantine.py``,
``test_torch_hoisting.py``).

The drill is the reference's own (``tests/resilience/test_supervisor.py``):
an Mlp of 6 features, 8 hidden units and 3 classes over 6 clients of 24
training and 8 validation rows (JAX's ``synthetic_classification`` at keys
20..25), SGD 0.05, batch 8, 2 local steps, seed 9, FedAvg; a
probability-1 ``scale`` fault (-15) on clients 1 and 2 from round 2; the
watchdog halting on a loss divergence over a window of 1 at factor 1.4 or
on non-finite values; a frame every round in a ring of 8. The same numpy
data and the JAX run's converted init go to both packages."""

import jax
import numpy as np
import optax

from fl4health_tpu import observability as jobs
from fl4health_tpu import resilience as jres
from fl4health_tpu.checkpointing.state import SimulationStateCheckpointer as JCheckpointer
from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import observability as tobs
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import resilience as tres
from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer as TCheckpointer
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_obs_sims import jax_init

N_CLIENTS, DIM, HIDDEN, N_CLASSES = 6, 6, 8, 3
POISONED = (1, 2)
TOL = 5e-4


def drill_data(n: int = N_CLIENTS, poison_nan=()) -> list:
    """The reference drill's clients as numpy (x, y, x_val, y_val)."""
    out = []
    for i in range(n):
        x, y = synthetic_classification(jax.random.PRNGKey(20 + i), 32, (DIM,), N_CLASSES)
        x, y = np.asarray(x).copy(), np.asarray(y)
        if i in poison_nan:
            x[:] = np.nan
        out.append((x[:24], y[:24], x[24:], y[24:]))
    return out


def pkg_mod(pkg: str, jax_mod, torch_mod):
    return jax_mod if pkg == "jax" else torch_mod


def drill_obs(pkg: str, output_dir=None, watchdog: bool = True):
    m = pkg_mod(pkg, jobs, tobs)
    return m.Observability(
        enabled=True, tracer=m.Tracer(), registry=m.MetricsRegistry(), sync_device=False,
        output_dir=str(output_dir) if output_dir else None, introspection=False,
        watchdog=m.HealthWatchdog(m.HealthPolicy(
            loss_divergence_window=1, loss_divergence_factor=1.4,
            on_loss_divergence="halt", on_nonfinite="halt")) if watchdog else None)


def scale_fault(pkg: str):
    m = pkg_mod(pkg, jres, tres)
    return m.FaultPlan(seed=3, client_faults=(m.ClientFault(
        clients=POISONED, kind="scale", scale=-15.0, probability=1.0, start_round=2),))


def drill_sim(pkg: str, mode: str = "chunked", *, data=None, ckpt_dir=None, strategy=None,
              obs=None, fault=None, recovery=None, init=None, **kw):
    """The drill's simulation in ``pkg``; the port's installs ``init`` (the
    JAX run's converted init) when given."""
    data = data if data is not None else drill_data()
    if pkg == "jax":
        if ckpt_dir is not None:
            kw["state_checkpointer"] = JCheckpointer(str(ckpt_dir), checkpoint_every=1, keep=8)
        return jsim.FederatedSimulation(
            logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(HIDDEN,),
                                                             n_outputs=N_CLASSES)),
                                      jengine.masked_cross_entropy),
            tx=optax.sgd(0.05), strategy=strategy if strategy is not None else JFedAvg(),
            datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
            metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2, seed=9,
            execution_mode=mode, observability=obs or jobs.Observability(enabled=False),
            fault_plan=fault, recovery=recovery, **kw)
    if ckpt_dir is not None:
        kw["state_checkpointer"] = TCheckpointer(str(ckpt_dir), checkpoint_every=1, keep=8)
    sim = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(TMlp(DIM, (HIDDEN,), N_CLASSES)),
                                  tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=strategy if strategy is not None else TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=2, seed=9,
        execution_mode=mode, observability=obs or tobs.Observability(enabled=False),
        fault_plan=fault, recovery=recovery, device="cpu", **kw)
    if init is not None:
        sim.set_global_params(init)
    return sim


def drill_pair(mode: str, make):
    """Build the JAX simulation with ``make("jax", init=None)``, then the
    port's with ``make("torch", init=<the JAX run's converted init>)``."""
    js = make("jax", None)
    ts = make("torch", jax_init(js))
    return js, ts


def events(obs, name: str) -> list[dict]:
    return [e for e in obs.registry.events if e["event"] == name]


def strip_ts(e: dict) -> dict:
    return {k: v for k, v in e.items() if k != "ts"}
