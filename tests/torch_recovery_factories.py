"""Simulation factories for the port's crash-drill children
(``fl4health_tpu_torch/resilience/recovery.py``), the counterparts of
``tests/resilience/recovery_factories.py``: the child loads this file by
path and calls ``factory(ckpt_dir)``. It imports only the port and numpy
(the drill child must load no JAX), and every factory is deterministic, so
every child reproduces the same trajectory bit for bit: a child computes on
one CPU thread, since a multi-threaded CPU reduction may split its sums
differently from one process to the next when other processes load the
cores."""

import json
import os
import sys

import numpy as np
import torch

from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.datasets.synthetic import synthetic_classification
from fl4health_tpu_torch.metrics import efficient
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.models.cnn import Mlp
from fl4health_tpu_torch.server.async_schedule import AsyncConfig
from fl4health_tpu_torch.server.simulation import ClientDataset, FederatedSimulation
from fl4health_tpu_torch.strategies.fedavg import FedAvg

N_CLASSES = 3
torch.set_num_threads(1)


def _datasets(n=2, seed0=20):
    out = []
    for i in range(n):
        x, y = synthetic_classification(rng.PRNGKey(seed0 + i), 32, (6,), N_CLASSES)
        x, y = np.asarray(x), np.asarray(y)
        out.append(ClientDataset(x[:24], y[:24], x[24:], y[24:]))
    return out


def _base(ckpt_dir, *, checkpoint_every=1, device="cpu", **kwargs):
    args = dict(
        logic=engine.ClientLogic(engine.from_module(Mlp(6, (8,), N_CLASSES)),
                                 engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=_datasets(), batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=2, seed=9,
        device=device)
    if ckpt_dir is not None:
        args["state_checkpointer"] = SimulationStateCheckpointer(
            str(ckpt_dir), checkpoint_every=checkpoint_every, keep=3)
    args.update(kwargs)
    return FederatedSimulation(**args)


def sync_chunked(ckpt_dir, device="cpu"):
    return _base(ckpt_dir, checkpoint_every=2, execution_mode="chunked", device=device)


def sync_pipelined(ckpt_dir, device="cpu"):
    return _base(ckpt_dir, checkpoint_every=2, execution_mode="pipelined", device=device)


def sync_chunked_every1(ckpt_dir, device="cpu"):
    return _base(ckpt_dir, checkpoint_every=1, execution_mode="chunked", device=device)


def _async(ckpt_dir, mode, device):
    return _base(ckpt_dir, checkpoint_every=1, execution_mode=mode, device=device,
                 async_config=AsyncConfig(buffer_size=2, compute_jitter=0.3, seed=13))


def async_chunked(ckpt_dir, device="cpu"):
    return _async(ckpt_dir, "chunked", device)


def async_pipelined(ckpt_dir, device="cpu"):
    return _async(ckpt_dir, "pipelined", device)


def cohort_sampled(ckpt_dir, device="cpu"):
    """A 6-client registry over 3 slots, half sampled each round: the
    registry-scatter drill's configuration."""
    from fl4health_tpu_torch.server.client_manager import FixedFractionManager
    from fl4health_tpu_torch.server.registry import CohortConfig

    return _base(ckpt_dir, checkpoint_every=1, execution_mode="auto", device=device,
                 datasets=_datasets(6, seed0=40), cohort=CohortConfig(slots=3),
                 client_manager=FixedFractionManager(6, 0.5))


def sync_chunked_observed(ckpt_dir, device="cpu"):
    """``sync_chunked_every1`` with observability on (the flight recorder
    and the fleet ledger armed), its artifacts and postmortem bundles in
    ``obs`` beside the checkpoint directory: the SIGTERM drill's child."""
    from fl4health_tpu_torch.observability import Observability

    out_dir = os.path.join(os.path.dirname(os.path.abspath(str(ckpt_dir))), "obs")
    return _base(ckpt_dir, checkpoint_every=1, execution_mode="chunked", device=device,
                 observability=Observability(enabled=True, output_dir=out_dir,
                                             introspection=False))


def probe_modules(ckpt_dir, device="cpu"):
    """``sync_chunked_every1`` whose ``fit`` also writes the names of the
    JAX-side modules loaded in the child (``loaded_modules.json``)."""
    sim = sync_chunked_every1(ckpt_dir, device)
    fit = sim.fit

    def probed(n):
        out = fit(n)
        roots = ("jax", "jaxlib", "flax", "optax", "msgpack", "fl4health_tpu")
        with open(os.path.join(str(ckpt_dir), "loaded_modules.json"), "w") as f:
            json.dump(sorted(m for m in sys.modules if m.split(".")[0] in roots), f)
        return out

    sim.fit = probed
    return sim
