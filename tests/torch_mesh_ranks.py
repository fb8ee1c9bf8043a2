"""Rank programs of the port's mesh parity tests (``tests/test_torch_mesh.py``,
``test_torch_ring_attention.py``), and the recipes both sides build.

A test module spawns ONE gloo world (``spawn_world``: ``torch.multiprocessing``
with the ``spawn`` start method, a ``FileStore`` in the test's temporary
directory, one thread a rank) and runs every scenario of its program in it;
each rank pickles its scenarios' results (or the error a scenario raised) for
the test process to hold against the unsharded port run and the JAX run.
This module imports only torch, numpy and the port: the spawned ranks never
import JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.metrics import efficient
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.models.cnn import Mlp
from fl4health_tpu_torch.server import simulation as sim_mod
from fl4health_tpu_torch.strategies.fedavg import FedAvg

N_CLIENTS, DIM, HIDDEN, N_CLASSES = 8, 6, 12, 3


# -- recipes (the JAX side builds the same ones in the test modules) --------

def mlp_data(n_clients: int = N_CLIENTS, seed: int = 0) -> list[tuple]:
    """``n_clients`` clients of 24 train and 16 val rows of a 3-class,
    6-feature problem, from numpy's generator."""
    out = []
    for i in range(n_clients):
        rng = np.random.default_rng(seed + i)
        x = rng.normal(size=(40, DIM)).astype(np.float32)
        w = rng.normal(size=(DIM, N_CLASSES)).astype(np.float32)
        y = np.argmax(x @ w, axis=1).astype(np.int32)
        out.append((x[:24], y[:24], x[24:], y[24:]))
    return out


def text_data(n_clients: int = 4, seed: int = 0, vocab: int = 64, t: int = 8) -> list:
    """``n_clients`` clients of 8 train and 4 val token rows (0 is padding)."""
    out = []
    for i in range(n_clients):
        rng = np.random.default_rng(100 + seed + i)
        x = rng.integers(1, vocab, size=(12, t)).astype(np.int32)
        lengths = rng.integers(t // 2, t + 1, size=12)
        x[np.arange(t)[None, :] >= lengths[:, None]] = 0
        y = rng.integers(0, 4, size=12).astype(np.int32)
        out.append((x[:8], y[:8], x[8:], y[8:]))
    return out


TRANSFORMER = dict(vocab_size=64, n_classes=4, d_model=16, n_heads=2, n_layers=1,
                   d_ff=32, max_len=8)


def mlp_sim(data, init, *, mesh=None, mode="pipelined", strategy=None, tx=None,
            logic=None, **kw):
    s = sim_mod.FederatedSimulation(
        logic=logic or engine.ClientLogic(
            engine.from_module(Mlp(DIM, (HIDDEN,), N_CLASSES)), engine.masked_cross_entropy),
        tx=tx or optim.sgd(0.05), strategy=strategy or FedAvg(),
        datasets=[sim_mod.ClientDataset(*d) for d in data], batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=3, seed=11,
        execution_mode=mode, mesh=mesh, device="cpu", **kw)
    s.set_global_params(init)
    return s


def transformer_sim(data, init, *, mesh=None, attention_fn=None):
    from fl4health_tpu_torch.models.transformer import TransformerClassifier

    module = TransformerClassifier(**TRANSFORMER, attention_fn=attention_fn)
    s = sim_mod.FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(),
        datasets=[sim_mod.ClientDataset(*d) for d in data], batch_size=4,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=2, seed=1,
        execution_mode="pipelined", mesh=mesh, device="cpu")
    s.set_global_params(init)
    return s


def history(sim) -> dict:
    """A run's records as plain floats, and its final global params."""
    return {"fit": [r.fit_losses["backward"] for r in sim.history],
            "eval": [r.eval_losses["checkpoint"] for r in sim.history],
            "acc": [r.eval_metrics.get("accuracy") for r in sim.history],
            "params": {k: v.detach().cpu().numpy() for k, v in sim.global_params.items()}}


# -- the world ----------------------------------------------------------------

def spawn_world(program: str, world: int, payload: dict, tmp_dir: str) -> list[dict]:
    """Run ``PROGRAMS[program](payload)`` on every rank of a ``world``-rank
    gloo world; returns each rank's results."""
    import torch.multiprocessing as mp

    path = os.path.join(tmp_dir, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(_rank_main, args=(world, tmp_dir, program), nprocs=world,
                       start_method="spawn", join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, tmp_dir: str, program: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp_dir, "store"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(tmp_dir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        results = {}
        for name, fn in PROGRAMS[program]:
            try:
                results[name] = fn(payload, rank, tmp_dir)
            except Exception:  # a scenario's failure is the test's to report
                results[name] = {"error": traceback.format_exc()}
        with open(os.path.join(tmp_dir, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# -- scenarios of tests/test_torch_mesh.py ---------------------------------------

def _collectives(payload, rank, tmp_dir):
    """Each collective's forward and its vmap(grad) backward on a [3, 4]
    client stack (rank r holds r + the stack)."""
    from fl4health_tpu_torch.parallel import compat
    from fl4health_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh((4,), ("clients",)).axis("clients")
    x = torch.tensor(payload["coll_x"]) + rank
    c = torch.tensor(payload["coll_c"])
    ops = {
        "ring_shift": lambda t: compat.ring_shift(t, axis),
        "copy_to_axis": lambda t: compat.copy_to_axis(t, axis),
        "reduce_from_axis": lambda t: compat.reduce_from_axis(t, axis),
        "scatter_to_block": lambda t: compat.scatter_to_block(t, axis, 0),
        "gather_from_blocks": lambda t: compat.gather_from_blocks(t, axis, 0),
        "psum_scatter": lambda t: compat.psum_scatter(t, axis, 0),
    }
    out = {}
    for name, op in ops.items():
        fwd = torch.func.vmap(op)(x)

        def loss(row, op=op):
            y = op(row)
            return (y * c[: y.shape[0]]).sum()

        grad = torch.func.vmap(torch.func.grad(loss))(x)
        # vmap(vmap(grad)) over a [2, 3, 4] stack: the same rows twice
        gg = torch.func.vmap(torch.func.vmap(torch.func.grad(loss)))(torch.stack([x, x]))
        out[name] = (fwd.numpy(), grad.numpy(), bool(torch.equal(gg[0], grad)))
    return out


def _specs(payload, rank, tmp_dir):
    """The builder's placements at JAX's shapes, as tuples."""
    from fl4health_tpu_torch.parallel.program import MeshConfig, RoundProgramBuilder

    def spec(sh):
        return None if sh is None else tuple(sh.spec)

    b = RoundProgramBuilder(MeshConfig(), n_clients=8)
    out = {"client": spec(b.client_sharding()), "stacked": spec(b.stacked_client_sharding()),
           "replicated": spec(b.replicated()), "descriptor": b.descriptor()}
    try:
        RoundProgramBuilder(MeshConfig(clients=4), n_clients=6)
    except ValueError as e:
        out["divisible"] = str(e)
    try:
        MeshConfig(clients=8, model=2).build()
    except ValueError as e:
        out["too_many"] = str(e)
    # test_program_builder.py's Megatron pairing, momenta inheriting by path
    params = {"attn": {"q_proj": {"kernel": torch.zeros(4, 6, 6)},
                       "o_proj": {"kernel": torch.zeros(4, 6, 6)}},
              "norm": {"scale": torch.zeros(4, 6)}}
    template = engine.TrainState(
        params=params, opt_state=({k: {m: {n: torch.zeros_like(t) for n, t in d.items()}
                                       for m, d in v.items()} if k == "attn"
                                   else {n: torch.zeros_like(t) for n, t in v.items()}
                                   for k, v in params.items()},),
        model_state={}, rng=torch.zeros(4, 2), step=torch.zeros(4))
    tb = RoundProgramBuilder(MeshConfig(clients=2, model=2, tp_rules=True), n_clients=4)
    sh = tb.client_state_shardings(template)
    out["tp_q"] = spec(sh.params["attn"]["q_proj"]["kernel"])
    out["tp_o"] = spec(sh.params["attn"]["o_proj"]["kernel"])
    out["tp_norm"] = spec(sh.params["norm"]["scale"])
    out["tp_mu_q"] = spec(sh.opt_state[0]["attn"]["q_proj"]["kernel"])
    strat = FedAvg()
    out["server"] = spec(b.server_state_shardings(strat, strat.init({"w": torch.zeros(3)})))
    return out


def _fit_routes(payload, rank, tmp_dir):
    from fl4health_tpu_torch.parallel.program import MeshConfig

    data, init = payload["mlp_data"], payload["mlp_init"]
    out = {}
    for mode in ("pipelined", "chunked"):
        s = mlp_sim(data, init, mesh=MeshConfig(), mode=mode)
        s.fit(3)
        out[mode] = history(s)
        out[mode + "_local_rows"] = int(s.client_states.params["Dense_0/kernel"].shape[0])
    return out


def _zero1(payload, rank, tmp_dir):
    import copy

    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.parallel.zero import ZeroShardedOptimizer, zero_sharded_optimizer
    from fl4health_tpu_torch.strategies.fedopt import FedOpt, fed_adam

    data, init = payload["mlp_data"], payload["mlp_init"]
    out = {}
    strat = fed_adam(0.1)
    plain_tx = strat.tx
    s = mlp_sim(data, init, mesh=MeshConfig(zero1=True), mode="chunked", strategy=strat)
    s.fit(3)
    out["run"] = history(s)
    out["caller_unmutated"] = strat.tx is plain_tx
    inner_tx = s.strategy.tx
    out["wrapped"] = isinstance(inner_tx, ZeroShardedOptimizer)
    out["state_bytes"] = int(inner_tx.state_bytes_per_device(s.server_state.opt_state))
    for name, build in (("fedavg", lambda: FedAvg()),
                        ("foreign", lambda: FedOpt(zero_sharded_optimizer(
                            copy.copy(plain_tx), _foreign_mesh(),
                            s.global_params, axis_name="model")))):
        try:
            mlp_sim(data, init, mesh=MeshConfig(zero1=True), strategy=build())
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _foreign_mesh():
    from fl4health_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((4,), ("model",))


def _zero2(payload, rank, tmp_dir):
    """The engine's microbatched step against the plain Adam step (2 and 4
    shards), and a ZeRO-2 federated run on a (clients 2, model 2) mesh."""
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.parallel.zero import zero2_sharded_optimizer

    out = {}
    logic = engine.ClientLogic(engine.from_module(Mlp(12, (16,), 4)),
                               engine.masked_cross_entropy)
    b = payload["z2_batch"]
    batch = engine.Batch(x=torch.tensor(b["x"]), y=torch.tensor(b["y"]),
                         example_mask=torch.tensor(b["mask"]), step_mask=torch.tensor(1.0))
    from fl4health_tpu_torch import rng as trng

    state0 = engine.create_train_state(logic, optim.adam(1e-2), trng.PRNGKey(0),
                                       torch.Generator().manual_seed(0), "cpu")
    s_plain, o_plain = engine.make_train_step(logic, optim.adam(1e-2))(state0, None, batch)
    for n, mesh in ((2, make_mesh((2, 2), ("x", "model"))), (4, make_mesh((4,), ("model",)))):
        z2 = zero2_sharded_optimizer(optim.adam(1e-2), mesh, state0.params, axis_name="model")
        st = engine.TrainState(params=state0.params, opt_state=z2.init(state0.params),
                               model_state={}, rng=state0.rng, step=state0.step)
        s_z, o_z = engine.make_train_step(logic, z2)(st, None, batch)
        out[f"step_{n}"] = max(float((s_plain.params[k] - s_z.params[k]).abs().max())
                               for k in s_plain.params)
        out[f"loss_{n}"] = (float(o_plain.losses["backward"]), float(o_z.losses["backward"]))
        out[f"state_{n}"] = int(z2.state_bytes_per_device(st.opt_state))
    try:
        z2 = zero2_sharded_optimizer(optim.adam(1e-2), make_mesh((4,), ("model",)),
                                     state0.params, axis_name="model")
        cut = engine.Batch(x=batch.x[:6], y=batch.y[:6], example_mask=batch.example_mask[:6],
                           step_mask=batch.step_mask)
        engine.make_train_step(logic, z2)(
            engine.TrainState(params=state0.params, opt_state=z2.init(state0.params),
                              model_state={}, rng=state0.rng, step=state0.step), None, cut)
    except ValueError as e:
        out["indivisible"] = str(e)
    data, init = payload["mlp_data"], payload["mlp_init"]
    cfg = MeshConfig(clients=2, model=2)
    mesh = cfg.build()
    template = {k: torch.as_tensor(v) for k, v in init.items()}
    tx = zero2_sharded_optimizer(optim.adam(1e-2), mesh, template, axis_name="model")
    s = mlp_sim(data, init, mesh=cfg, tx=tx, mode="chunked")
    s.fit(2)
    out["run"] = history(s)
    return out


def _tp(payload, rank, tmp_dir):
    from fl4health_tpu_torch.parallel.program import MeshConfig

    s = transformer_sim(payload["text_data"], payload["text_init"],
                        mesh=MeshConfig(clients=2, model=2, tp_rules=True))
    s.fit(2)
    specs = s._program_builder.client_state_shardings(s.client_states).params
    return {"run": history(s),
            "q": [tuple(v.spec) for k, v in specs.items() if k.endswith("q_proj/kernel")],
            "o": [tuple(v.spec) for k, v in specs.items() if k.endswith("o_proj/kernel")],
            "q_local": tuple(s.client_states.params["layer_0/attn/q_proj/kernel"].shape)}


def _restore(payload, rank, tmp_dir):
    from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer
    from fl4health_tpu_torch.parallel.program import MeshConfig

    data, init = payload["mlp_data"], payload["mlp_init"]
    ckpt_dir = os.path.join(tmp_dir, "ckpt")
    first = mlp_sim(data, init, mesh=MeshConfig(), mode="chunked",
                    state_checkpointer=SimulationStateCheckpointer(ckpt_dir))
    first.fit(2)
    again = mlp_sim(data, init, mesh=MeshConfig(), mode="pipelined",
                    state_checkpointer=SimulationStateCheckpointer(ckpt_dir))
    again.fit(3)
    return {"run": history(again), "resumed_at": again._resume_info["next_round"]}


def _observability(payload, rank, tmp_dir):
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer
    from fl4health_tpu_torch.parallel.program import MeshConfig

    out_dir = os.path.join(tmp_dir, "obs")
    reg = MetricsRegistry()
    obs = Observability(enabled=True, tracer=Tracer(), registry=reg, introspection=True,
                        output_dir=out_dir)
    s = mlp_sim(payload["mlp_data"], payload["mlp_init"], mesh=MeshConfig(),
                mode="chunked", observability=obs)
    s.fit(2)
    import json

    events = []
    if rank == 0:
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
    return {"manifest_mesh": obs.manifest.get("mesh"),
            "program_meshes": [r.mesh for r in obs.introspector.reports.values()],
            "round_events": [{k: e.get(k) for k in ("mesh_devices", "mesh_client_axis",
                                                     "steps_per_s_per_chip")}
                             for e in events if e.get("event") == "round"],
            "config_mesh": obs.manifest.get("config", {}).get("mesh"),
            "gauges": [reg.gauge(g).value for g in
                       ("fl_mesh_devices", "fl_mesh_client_axis", "fl_mesh_model_axis")],
            # rank 0 alone publishes the run's artifacts
            "output_dir": obs.output_dir}


def _wrappers(payload, rank, tmp_dir):
    from fl4health_tpu_torch.compression.config import CompressionConfig
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.resilience.quarantine import QuarantinePolicy, QuarantiningStrategy

    s = mlp_sim(payload["mlp_data"], payload["mlp_init"], mesh=MeshConfig(), mode="chunked",
                strategy=QuarantiningStrategy(FedAvg(), QuarantinePolicy(),
                                              n_clients=N_CLIENTS),
                compression=CompressionConfig(topk_fraction=0.5, quant_bits=8,
                                              error_feedback=True, seed=3))
    s.fit(3)
    res = next(iter(s.server_state.residual.values()))
    return {"run": history(s), "residual_rows": int(res.shape[0]),
            "quarantine_rows": int(s.server_state.inner.quarantine.quarantined.shape[0])}


# -- scenarios of tests/test_torch_ring_attention.py -----------------------------

def _ring_inputs(payload, key):
    return tuple(torch.tensor(a) for a in payload[key])


def _ring_grads(fn, q, k, v, weight=None):
    """(out, dq, dk, dv) of ``sum((fn(q, k, v) * weight) ** 2)``."""
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    w = 1.0 if weight is None else weight
    ((out.float() * w) ** 2).sum().backward()
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _ring_ops(payload, rank, tmp_dir):
    """Dense and flash rings over 4 ranks (and 2: the ``seq`` axis of a
    (2, 2) mesh): forward, pad masks, an all-padding row, bf16 and the
    q/k/v gradients, all global tensors on every rank."""
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.ring_attention import (ring_flash_attention,
                                                             ring_self_attention)

    ring4 = make_mesh((4,), ("seq",))
    ring2 = make_mesh((2, 2), ("x", "seq"))
    q, k, v = _ring_inputs(payload, "qkv")
    pad = torch.tensor(payload["pad"])
    allpad = torch.tensor(payload["allpad"])
    out = {}
    for name, ring in (("dense", ring_self_attention), ("flash", ring_flash_attention)):
        out[name] = _ring_grads(lambda a, b, c: ring(a, b, c, ring4), q, k, v)
        out[name + "_pad"] = _ring_grads(lambda a, b, c: ring(a, b, c, ring4, pad_mask=pad),
                                         q, k, v, pad[:, :, None, None])
        v_bad = v.clone()
        v_bad[:, 20:] = 1e6
        out[name + "_poisoned"] = ring(q, k, v_bad, ring4, pad_mask=pad).numpy()
        out[name + "_allpad"] = ring(q, k, v, ring4, pad_mask=allpad).numpy()
        out[name + "_bf16"] = ring(*(t.to(torch.bfloat16) for t in (q, k, v)),
                                   ring4).float().numpy()
        q2, k2, v2 = (t[:, :16] for t in (q, k, v))
        out[name + "_two"] = ring(q2, k2, v2, ring2).numpy()
    try:
        ring_flash_attention(*(torch.zeros(1, 48, 1, 8) for _ in range(3)), ring4,
                             block_q=8, block_k=8)
    except ValueError as e:
        out["degenerate"] = str(e)
    return out


def _ring_transformer(payload, rank, tmp_dir):
    """A FedAvg run of the transformer whose attention is the flash ring
    over the world's 4 ranks (each rank runs the whole simulation): the
    ring under the client vmap and grad."""
    import functools

    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.ring_attention import ring_flash_attention

    fn = functools.partial(ring_flash_attention, mesh=make_mesh((4,), ("seq",)))
    s = transformer_sim(payload["text_data"], payload["text_init"], attention_fn=fn)
    s.fit(2)
    return {"run": history(s)}


def scaffold_sim(data, init, mesh=None):
    from fl4health_tpu_torch.clients.scaffold import ScaffoldClientLogic
    from fl4health_tpu_torch.strategies.scaffold import Scaffold

    logic = ScaffoldClientLogic(engine.from_module(Mlp(DIM, (HIDDEN,), N_CLASSES)),
                                engine.masked_cross_entropy, learning_rate=0.05)
    s = sim_mod.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=Scaffold(learning_rate=1.0),
        datasets=[sim_mod.ClientDataset(*d) for d in data], batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=3, seed=11,
        execution_mode="pipelined", mesh=mesh, device="cpu")
    s.set_global_params(init)
    return s


def _scaffold_warm(payload, rank, tmp_dir):
    """ScaffoldServer's warm start (the simulation's own round function)
    under a mesh, then 2 rounds."""
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.server.servers import ScaffoldServer

    s = scaffold_sim(payload["mlp_data"], payload["mlp_init"], mesh=MeshConfig())
    ScaffoldServer(s, warm_start=True).fit(2)
    return {"run": history(s)}


def cohort_sim(data, init, mesh=None, mode="auto"):
    """A registry of 16 clients, 8 slots, half of them sampled a round
    (test_cohort_slots.py's TestCohortUnderMesh recipe)."""
    from fl4health_tpu_torch.server.client_manager import FixedFractionManager
    from fl4health_tpu_torch.server.registry import CohortConfig

    s = sim_mod.FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(Mlp(DIM, (HIDDEN,), N_CLASSES)),
                                 engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(),
        datasets=[sim_mod.ClientDataset(*d) for d in data], batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_epochs=1, seed=5,
        cohort=CohortConfig(slots=8), client_manager=FixedFractionManager(16, 0.5),
        execution_mode=mode, mesh=mesh, device="cpu")
    s.set_global_params(init)
    return s


def _cohort(payload, rank, tmp_dir):
    """The cohort slots under a mesh: auto demotes to the pipelined route
    (JAX's reason), each rank trains its 2 of the 8 slots."""
    from fl4health_tpu_torch.parallel.program import MeshConfig

    s = cohort_sim(payload["cohort_data"], payload["cohort_init"], mesh=MeshConfig())
    mode, reason = s._select_execution_mode(3)
    s.fit(3)
    return {"run": history(s), "mode": mode, "reason": reason,
            "local_slots": int(s.client_states.params["Dense_0/kernel"].shape[0]),
            "dirty": s.registry.dirty_rows}


def strategy_sim(kind: str, data, init, mesh=None):
    """The strategies whose aggregate reduces over clients beyond a weighted
    mean: the order-statistic aggregators and weighted, adaptive
    client-level DP (test_sharded_mesh.py's)."""
    from fl4health_tpu_torch.clients.clipping import ClippingClientLogic
    from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg
    from fl4health_tpu_torch.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM

    kw = {}
    if kind == "client_dp":
        kw = dict(logic=ClippingClientLogic(
            engine.from_module(Mlp(DIM, (HIDDEN,), N_CLASSES)), engine.masked_cross_entropy,
            adaptive_clipping=True),
            strategy=ClientLevelDPFedAvgM(noise_multiplier=0.2, server_momentum=0.9,
                                          initial_clipping_bound=0.5,
                                          weighted_aggregation=True, adaptive_clipping=True,
                                          bit_noise_multiplier=0.5))
    else:
        kw = dict(strategy=RobustFedAvg(kind))
    return mlp_sim(data, init, mesh=mesh, mode="chunked", **kw)


def fault_plan():
    """Dropout of clients 1 and 5 half the time, client 6's update scaled
    by 5: the plan's [C] draws, taken by block under a mesh."""
    from fl4health_tpu_torch.resilience.faults import ClientFault, FaultPlan

    return FaultPlan(client_faults=(
        ClientFault(clients=(1, 5), kind="dropout", probability=0.5),
        ClientFault(clients=(6,), kind="scale", scale=5.0)), seed=3)


def _strategies(payload, rank, tmp_dir):
    from fl4health_tpu_torch.parallel.program import MeshConfig

    out = {}
    for kind in ("median", "trimmed_mean", "krum", "client_dp"):
        s = strategy_sim(kind, payload["mlp_data"], payload["mlp_init"], mesh=MeshConfig())
        s.fit(2)
        out[kind] = history(s)
    s = mlp_sim(payload["mlp_data"], payload["mlp_init"], mesh=MeshConfig(), mode="chunked",
                fault_plan=fault_plan())
    s.fit(2)
    out["faults"] = history(s)
    return out


def _refusals(payload, rank, tmp_dir):
    """What a mesh refuses, with its message: a cohort, buffered async over
    the registry (JAX's), and a cohort that does not divide."""
    from fl4health_tpu_torch.parallel.program import MeshConfig
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig
    from fl4health_tpu_torch.server.registry import CohortConfig

    out = {}
    data = payload["mlp_data"]
    for name, kw in (("async_cohort", dict(cohort=CohortConfig(slots=4),
                                           async_config=AsyncConfig(buffer_size=2))),
                     ("uneven", dict(datasets_n=6))):
        try:
            n = kw.pop("datasets_n", len(data))
            mlp_sim(data[:n], payload["mlp_init"], mesh=MeshConfig(), **kw)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def async_kw(mode: str) -> dict:
    """test_mesh_fit.py's TestAsyncUnderMesh recipe: a buffer of 4 with
    5% compute jitter, client 0 a straggler at 5x."""
    from fl4health_tpu_torch.resilience.faults import ClientFault, FaultPlan
    from fl4health_tpu_torch.server.async_schedule import AsyncConfig

    return dict(mode=mode, async_config=AsyncConfig(buffer_size=4, compute_jitter=0.05),
                fault_plan=FaultPlan(client_faults=(
                    ClientFault(clients=(0,), kind="slow", scale=5.0),)))


def _async(payload, rank, tmp_dir):
    """Buffered async on both dense routes under the mesh, each rank its
    block of the stack and of ``pending``; and a chunked run checkpointed
    at event 2 (gathered frames by rank 0) resumed pipelined to event 3."""
    from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer
    from fl4health_tpu_torch.parallel.program import MeshConfig

    data, init = payload["mlp_data"], payload["mlp_init"]
    out = {}
    for mode in ("pipelined", "chunked"):
        s = mlp_sim(data, init, mesh=MeshConfig(), **async_kw(mode))
        s.fit(3)
        out[mode] = history(s)
        out[mode + "_local_rows"] = int(s.client_states.params["Dense_0/kernel"].shape[0])
    ckpt_dir = os.path.join(tmp_dir, "async_ckpt")
    first = mlp_sim(data, init, mesh=MeshConfig(), **async_kw("chunked"),
                    state_checkpointer=SimulationStateCheckpointer(ckpt_dir))
    first.fit(2)
    again = mlp_sim(data, init, mesh=MeshConfig(), **async_kw("pipelined"),
                    state_checkpointer=SimulationStateCheckpointer(ckpt_dir))
    again.fit(3)
    out["resumed"] = history(again)
    out["resumed_at"] = again._resume_info["next_round"]
    return out


RETUNE = {"server_lr": 0.03}


def admin_sim(data, init, obs, mesh=None):
    """FedAdam (server lr 0.1) on the pipelined route with an armed admin
    plane."""
    from fl4health_tpu_torch.strategies.fedopt import fed_adam

    return mlp_sim(data, init, mesh=mesh, strategy=fed_adam(0.1), observability=obs)


def _admin(payload, rank, tmp_dir):
    """A retune submitted on rank 0 alone, just before round 2's boundary
    (rank 0 serves the endpoint); every rank applies it at round 2."""
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer
    from fl4health_tpu_torch.parallel.program import MeshConfig

    obs = Observability(enabled=True, tracer=Tracer(), registry=MetricsRegistry(),
                        introspection=False, admin_token="t")
    s = admin_sim(payload["mlp_data"], payload["mlp_init"], obs, mesh=MeshConfig())
    boundary = s._apply_admin_retunes

    def submit_on_rank_0(rnd):
        if rank == 0 and rnd == 2:
            obs.admin.submit(RETUNE)
        return boundary(rnd)

    s._apply_admin_retunes = submit_on_rank_0
    s.fit(3)
    return {"run": history(s),
            "journal": [(e["round"], e["scalars"]) for e in obs.admin.journal()]}


PROGRAMS = {
    "ring": [("ops", _ring_ops), ("transformer", _ring_transformer)],
    "mesh": [("collectives", _collectives), ("specs", _specs), ("fit", _fit_routes),
             ("zero1", _zero1), ("zero2", _zero2), ("tp", _tp), ("restore", _restore),
             ("observability", _observability), ("wrappers", _wrappers),
             ("scaffold_warm", _scaffold_warm), ("refusals", _refusals),
             ("cohort", _cohort), ("strategies", _strategies), ("async", _async),
             ("admin", _admin)],
}
