"""The algorithm-breadth strategies under a device mesh (``MeshConfig()``
over a 4-rank gloo world, ``torch.distributed``) against the unsharded port.

Each of these aggregations reduces over clients: ``FedAvgDynamicLayer`` and
``FedAvgSparse`` sum the sender weights and the weighted params, FedDG-GA
normalises its adjustment weights over the round's participants and keeps a
post-fit loss per client, Flash averages before its server moments, and
``ModelMergeServer`` averages the clients' current params. A rank that
reduced over its own block only would take another global model than the
unsharded run. The runs are held to the unsharded port at 1e-5 (the order of
the ranks' partial sums differs), the exchangers' masks and FedDG-GA's
per-client rows too; the unsharded port is held against JAX in
``test_torch_partial_exchange.py``, ``test_torch_flash_feddg.py`` and
``test_torch_model_merge.py``. The ranks never import JAX.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)

import dataclasses
import datetime
import os
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_mesh_ranks as R

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic
from fl4health_tpu_torch.clients.flash import FlashEarlyStopConfig
from fl4health_tpu_torch.exchange.exchanger import DynamicLayerExchanger, SparseExchanger
from fl4health_tpu_torch.metrics import efficient
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.models.cnn import Mlp
from fl4health_tpu_torch.server import simulation as sim_mod
from fl4health_tpu_torch.server.servers import ModelMergeServer
from fl4health_tpu_torch.strategies.dynamic_layer import FedAvgDynamicLayer, FedAvgSparse
from fl4health_tpu_torch.strategies.feddg_ga import FedDgGa, FedDgGaAdaptiveConstraint
from fl4health_tpu_torch.strategies.flash import Flash

WORLD = 4
ATOL = 1e-5
ROUNDS = 3


def _mlp():
    return engine.from_module(Mlp(R.DIM, (R.HIDDEN,), R.N_CLASSES))


# name -> (simulation keywords, the routes it runs on)
CASES = {
    "dynamic_topk": (lambda: dict(strategy=FedAvgDynamicLayer(), exchanger=DynamicLayerExchanger(
        mode="topk", exchange_fraction=0.5)), ("pipelined", "chunked")),
    "sparse": (lambda: dict(strategy=FedAvgSparse(), exchanger=SparseExchanger(
        sparsity_level=0.3)), ("pipelined", "chunked")),
    "flash": (lambda: dict(strategy=Flash(eta=0.05), local_epochs=2,
                           flash_early_stopping=FlashEarlyStopConfig(gamma=0.05, n_epochs=2)),
              ("pipelined", "chunked")),
    "feddg_ga": (lambda: dict(strategy=FedDgGa(n_clients=R.N_CLIENTS, num_rounds=ROUNDS)),
                 ("pipelined",)),
    "feddg_ga_adaptive": (lambda: dict(
        strategy=FedDgGaAdaptiveConstraint(n_clients=R.N_CLIENTS, num_rounds=ROUNDS,
                                           loss_weight_patience=1),
        logic=FedProxClientLogic(_mlp(), engine.masked_cross_entropy),
        extra_loss_keys=("vanilla", "penalty")), ("pipelined",)),
}
STATE_FIELDS = ("updated", "adjustment_weights", "local_val_losses", "drift_penalty_weight",
                "m", "v", "d")


def _sim(case: str, data, init, mesh=None, mode="pipelined"):
    kw = CASES[case][0]()
    if "local_epochs" not in kw:
        kw["local_steps"] = 3
    s = sim_mod.FederatedSimulation(
        logic=kw.pop("logic", None) or engine.ClientLogic(_mlp(), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), datasets=[sim_mod.ClientDataset(*d) for d in data], batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), seed=11, execution_mode=mode,
        mesh=mesh, device="cpu", **kw)
    if init is not None:  # else the simulation's own init from its seed
        s.set_global_params(init)
    return s


def _record(s) -> dict:
    out = R.history(s)
    for field in STATE_FIELDS:
        v = getattr(s.server_state, field, None)
        if v is not None:
            out[field] = ({k: x.numpy() for k, x in v.items()} if isinstance(v, dict)
                          else v.numpy())
    return out


def _client_params(init: dict) -> dict:
    """Distinct params for every client: the init plus seeded noise."""
    r = np.random.default_rng(5)
    return {k: np.stack([v + 0.1 * r.normal(size=v.shape).astype(np.float32)
                         for _ in range(R.N_CLIENTS)]) for k, v in init.items()}


def _merge(s, stacked: dict, lo: int, hi: int):
    """``ModelMergeServer`` over ``stacked``'s rows [lo, hi) installed as the
    clients' current params."""
    s.client_states = dataclasses.replace(s.client_states, params={
        k: torch.tensor(stacked[k][lo:hi]) for k in s.client_states.params})
    merged, losses, metrics = ModelMergeServer(s).fit()
    return {"merged": {k: v.numpy() for k, v in merged.items()}, "losses": losses,
            "metrics": metrics}


# -- the rank program ---------------------------------------------------------

def _rank_program(payload: dict) -> dict:
    from fl4health_tpu_torch.parallel.program import MeshConfig

    data, init = payload["data"], payload["init"]
    out = {}
    for case, (_, modes) in CASES.items():
        for mode in modes:
            try:
                s = _sim(case, data, init, mesh=MeshConfig(), mode=mode)
                s.fit(ROUNDS)
                out[(case, mode)] = _record(s)
            except Exception:  # the test reports a case's failure
                out[(case, mode)] = {"error": traceback.format_exc()}
    try:
        s = R.mlp_sim(data, init, mesh=MeshConfig())
        out["merge"] = _merge(s, payload["stacked"], *s._program_builder.client_block())
    except Exception:
        out["merge"] = {"error": traceback.format_exc()}
    return out


def _rank_main(rank: int, world: int, tmp_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp_dir, "store"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(tmp_dir, "payload.pkl"), "rb") as f:
            results = _rank_program(pickle.load(f))
        with open(os.path.join(tmp_dir, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The payload, and every rank's results of one 4-rank world."""
    import torch.multiprocessing as mp

    data = R.mlp_data()
    init = {k: v.numpy() for k, v in _sim("sparse", data, None).global_params.items()}
    payload = dict(data=data, init=init, stacked=_client_params(init))
    tmp_dir = str(tmp_path_factory.mktemp("mesh_algorithms"))
    with open(os.path.join(tmp_dir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(_rank_main, args=(WORLD, tmp_dir), nprocs=WORLD, start_method="spawn",
                       join=True)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp_dir, f"rank_{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return payload, ranks


def _results(world, key) -> list:
    _, ranks = world
    for r, res in enumerate(ranks):
        if isinstance(res[key], dict) and "error" in res[key]:
            pytest.fail(f"rank {r} case {key!r} raised:\n{res[key]['error']}")
    return [res[key] for res in ranks]


def _close(got, want, key="") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _close(got[k], want[k], f"{key}/{k}")
    elif isinstance(want, list):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=ATOL, err_msg=key)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("case,mode", [(c, m) for c, (_, modes) in CASES.items()
                                       for m in modes])
def test_run_under_the_mesh_matches_unsharded(world, case, mode):
    payload, _ = world
    s = _sim(case, payload["data"], payload["init"], mode=mode)
    s.fit(ROUNDS)
    want = _record(s)
    for got in _results(world, (case, mode)):
        _close(got, want, case)
        if "updated" in want:  # a mask is a selection: exact
            for k, v in want["updated"].items():
                np.testing.assert_array_equal(got["updated"][k], v, err_msg=k)


def test_model_merge_server_under_the_mesh_matches_unsharded(world):
    payload, _ = world
    s = R.mlp_sim(payload["data"], payload["init"])
    want = _merge(s, payload["stacked"], 0, R.N_CLIENTS)
    for k, v in payload["stacked"].items():
        np.testing.assert_allclose(want["merged"][k], v.mean(axis=0), rtol=0, atol=ATOL)
    for got in _results(world, "merge"):
        _close(got, want, "merge")
