"""Shared recipes of the port's sweep tests: JAX's sweep fixtures
(``tests/sweep/test_sweep.py``: an ``Mlp(12)`` on 6 features, 3 clients, 2
rounds, batch 8, 2 local steps) built in both packages on the same numpy
data. A port model's init is the flax init JAX's simulation draws for the
same seed (``fold_in(PRNGKey(seed), 0)``), converted, so a port cell and a
JAX cell start from the same params."""

import dataclasses

import jax
import numpy as np
import optax

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.ditto import MrMtlClientLogic as JMrMtl
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedopt import fed_adam as jfed_adam
from fl4health_tpu.sweep import SweepSpec as JSpec
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.ditto import MrMtlClientLogic as TMrMtl
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedopt import fed_adam as tfed_adam
from fl4health_tpu_torch.sweep import SweepSpec as TSpec

TOL = 5e-4
N_CLASSES = 3
N_FEATURES = 6


def partition_arrays(salt: int, cohort: int) -> list:
    """JAX's fixture partitioner as numpy: a per-client draw, unequal train
    sizes (24, 28 or 32 rows) and 8 val rows."""
    out = []
    for i in range(cohort):
        x, y = synthetic_classification(jax.random.PRNGKey(1000 * salt + i), 40,
                                        (N_FEATURES,), N_CLASSES)
        x, y = np.asarray(x), np.asarray(y)
        n = 24 + 4 * ((i + salt) % 3)
        out.append((x[:n], y[:n], x[32:], y[32:]))
    return out


_ARRAYS: dict = {}


def _arrays(salt: int, cohort: int) -> list:
    if (salt, cohort) not in _ARRAYS:
        _ARRAYS[(salt, cohort)] = partition_arrays(salt, cohort)
    return _ARRAYS[(salt, cohort)]


def partitioner(salt: int, jax_side: bool):
    cls = JDataset if jax_side else TDataset
    return lambda cohort: [cls(*a) for a in _arrays(salt, cohort)]


def _jmodel():
    return jengine.from_flax(JMlp(features=(12,), n_outputs=N_CLASSES))


_INITS: dict = {}


def flax_init(seed: int) -> dict:
    """The converted flax init a JAX simulation of this seed draws."""
    if seed not in _INITS:
        params, _ = _jmodel().init(jax.random.fold_in(jax.random.PRNGKey(seed), 0),
                                   np.zeros((1, N_FEATURES), np.float32))
        _INITS[seed] = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    return _INITS[seed]


def tmodel():
    """The port's Mlp(12) whose init is JAX's for the simulation's seed (the
    init generator is seeded with it)."""
    md = tengine.from_module(tcnn.Mlp(N_FEATURES, (12,), N_CLASSES))
    return dataclasses.replace(
        md, init=lambda gen: {k: v.clone() for k, v in flax_init(gen.initial_seed()).items()})


JCLIENTS = {
    "sgd": lambda: jengine.ClientLogic(_jmodel(), jengine.masked_cross_entropy),
    "mrmtl": lambda: JMrMtl(_jmodel(), jengine.masked_cross_entropy, lam=0.5),
}
TCLIENTS = {
    "sgd": lambda: tengine.ClientLogic(tmodel(), tengine.masked_cross_entropy),
    "mrmtl": lambda: TMrMtl(tmodel(), tengine.masked_cross_entropy, lam=0.5),
}
JSTRATEGIES = {"fedavg": JFedAvg, "fedadam": lambda: jfed_adam(0.1)}
TSTRATEGIES = {"fedavg": TFedAvg, "fedadam": lambda: tfed_adam(0.1)}


def spec_pair(strategies=("fedavg", "fedadam"), clients=("sgd", "mrmtl"),
              salts=(0,), pairs=None, **overrides) -> tuple:
    """(JAX spec, port spec) of JAX's fixture grid over the named
    strategies, clients and partitioner salts (``p<salt>``), with
    ``overrides``; ``pairs`` maps a field to its (JAX, port) values."""
    common = dict(rounds=2, batch_size=8, local_steps=2, seeds=(5, 7), cohort_sizes=(3,))
    common.update(overrides)
    j = dict(strategies={k: JSTRATEGIES[k] for k in strategies},
             clients={k: JCLIENTS[k] for k in clients},
             partitioners={f"p{s}": partitioner(s, True) for s in salts},
             tx=lambda: optax.sgd(0.05))
    t = dict(strategies={k: TSTRATEGIES[k] for k in strategies},
             clients={k: TCLIENTS[k] for k in clients},
             partitioners={f"p{s}": partitioner(s, False) for s in salts},
             tx=lambda: optim.sgd(0.05))
    pairs = pairs or {}
    for name, (jv, tv) in pairs.items():
        j[name], t[name] = jv, tv
    return JSpec(**j, **common), TSpec(**t, **common)


def standalone(cell, spec, datasets, jax_side: bool, execution_mode: str = "chunked",
               **sim_kw) -> tuple:
    """The cell's configuration as an ordinary simulation of either
    package: (fit losses, eval losses) a round."""
    if jax_side:
        sim = JSim(logic=spec.clients[cell.client](), tx=spec.tx(),
                   strategy=spec.strategies[cell.strategy](), datasets=datasets,
                   batch_size=spec.batch_size, metrics=JMetricManager(()),
                   local_steps=spec.local_steps, seed=cell.seed,
                   execution_mode=execution_mode, **sim_kw)
    else:
        sim = TSim(logic=spec.clients[cell.client](), tx=spec.tx(),
                   strategy=spec.strategies[cell.strategy](), datasets=datasets,
                   batch_size=spec.batch_size, metrics=TMetricManager(()),
                   local_steps=spec.local_steps, seed=cell.seed,
                   execution_mode=execution_mode, device="cpu", **sim_kw)
    hist = sim.fit(spec.rounds)
    return ([h.fit_losses["backward"] for h in hist],
            [h.eval_losses["checkpoint"] for h in hist])
