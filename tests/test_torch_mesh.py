"""The port's device mesh against the JAX package's (``parallel/`` on
``torch.distributed``): one 4-rank gloo world (``torch_mesh_ranks``, spawned
once for the module) runs every sharded scenario, and each test holds a
rank's results against the port's unsharded run in this process (within
JAX's ``TRAJ_ATOL`` 1e-5, ``tests/server/test_mesh_fit.py``) and against
the JAX package's run over this process's 8 virtual CPU devices at the same
mesh shape (within 5e-4, the f32 CPU tolerance): the collectives and their
``vmap`` rules, the builder's placements against JAX's ``PartitionSpec``s,
sharded ``fit`` on both routes, ZeRO-1 and its refusals, ZeRO-2's
microbatched step and run, the Megatron hybrid run, a restore onto the
mesh, the manifest's descriptor, the wrapper strategies' rows, buffered
async on both dense routes and its resume, and an admin-plane retune
received by rank 0 alone."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as R
from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.parallel import mesh as jmesh
from fl4health_tpu.parallel.program import MeshConfig as JMeshConfig
from fl4health_tpu.parallel.program import RoundProgramBuilder as JBuilder
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedopt import fed_adam as jfed_adam
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.parallel.mesh import P
from fl4health_tpu_torch.parallel.program import MeshConfig, RoundProgramBuilder
from fl4health_tpu_torch.strategies.fedopt import fed_adam

TRAJ_ATOL = 1e-5
TOL = 5e-4
WORLD = 4


def _jax_mlp_sim(data, *, mesh=None, strategy=None, tx=None, rounds_mode="pipelined",
                 **kw):
    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(R.HIDDEN,),
                                                         n_outputs=R.N_CLASSES)),
                                  jengine.masked_cross_entropy),
        tx=tx or optax.sgd(0.05), strategy=strategy or JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=3, seed=11,
        execution_mode=rounds_mode, mesh=mesh, **kw)


def _jax_history(js) -> dict:
    return {"fit": [r.fit_losses["backward"] for r in js.history],
            "eval": [r.eval_losses["checkpoint"] for r in js.history],
            "params": convert.flax_to_torch(jax.tree_util.tree_map(
                np.asarray, jax.device_get(js.global_params)))}


def _init(js) -> dict:
    return {k: v.numpy() for k, v in convert.flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jax.device_get(js.global_params))).items()}


def _close(got: dict, want: dict, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got["fit"], want["fit"], atol=atol, rtol=rtol)
    np.testing.assert_allclose(got["eval"], want["eval"], atol=atol, rtol=rtol)
    for k in want["params"]:
        np.testing.assert_allclose(np.asarray(got["params"][k]),
                                   np.asarray(want["params"][k]), atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX inits, the payload, and every rank's results of the one
    4-rank world."""
    data, cohort_data = R.mlp_data(), R.mlp_data(16)
    js = _jax_mlp_sim(data)
    tdata = R.text_data()
    jt = _jax_text_sim(tdata)
    rng = np.random.default_rng(0)
    payload = dict(
        mlp_data=data, mlp_init=_init(js), text_data=tdata, text_init=_init(jt),
        cohort_data=cohort_data, cohort_init={k: v.numpy() for k, v in convert.flax_to_torch(
            jax.tree_util.tree_map(np.asarray, jax.device_get(
                _jax_cohort_sim(cohort_data).registry._client_proto.params))).items()},
        coll_x=rng.normal(size=(3, 4)).astype(np.float32),
        coll_c=rng.normal(size=(16,)).astype(np.float32),
        z2_batch=dict(x=rng.normal(size=(8, 12)).astype(np.float32),
                      y=rng.integers(0, 4, size=8),
                      mask=np.array([1, 1, 1, 0, 1, 0, 0, 1], np.float32)))
    ranks = R.spawn_world("mesh", WORLD, payload, str(tmp_path_factory.mktemp("mesh_world")))
    return payload, ranks


def _jax_cohort_sim(data, mesh=None):
    from fl4health_tpu.server.client_manager import FixedFractionManager as JFixed
    from fl4health_tpu.server.registry import CohortConfig as JCohort

    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(R.HIDDEN,),
                                                         n_outputs=R.N_CLASSES)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=5,
        cohort=JCohort(slots=8), client_manager=JFixed(16, 0.5), mesh=mesh)


def _jax_text_sim(data, mesh=None):
    return jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JTransformer(**R.TRANSFORMER)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=4,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2, seed=1,
        execution_mode="pipelined", mesh=mesh)


def _scenario(world, name: str, rank: int | None = None):
    """A scenario's results on every rank (or one), failing on a rank's error."""
    _, ranks = world
    for r, res in enumerate(ranks):
        got = res[name]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"rank {r} scenario {name!r} raised:\n{got['error']}")
    return ranks[rank][name] if rank is not None else [res[name] for res in ranks]


# -- the mesh-free builder: the plain programs, as JAX's ----------------------

class TestMeshConfigValidation:
    @pytest.mark.parametrize("kw", [dict(model=0), dict(clients=0), dict(tp_rules=True)])
    def test_messages_match_jax(self, kw):
        with pytest.raises(ValueError) as theirs:
            JMeshConfig(**kw)
        with pytest.raises(ValueError) as ours:
            MeshConfig(**kw)
        assert str(ours.value) == str(theirs.value)

    def test_world_of_one(self):
        """No process group: a one-rank mesh, whose collectives are identities."""
        mesh = MeshConfig().build()
        assert mesh.shape == {"clients": 1} and mesh.device_mesh is None
        with pytest.raises(ValueError, match="needs 2x1 = 2 devices but only 1 are visible"):
            MeshConfig(clients=2).build()

    def test_builder_without_mesh_is_plain(self):
        b = RoundProgramBuilder(None, n_clients=8)
        assert (b.client_sharding(), b.stacked_client_sharding(), b.replicated(),
                b.descriptor(), b.client_state_shardings(object())) == (None,) * 5
        tree = {"w": torch.zeros(8, 3)}
        assert b.put(tree, None) is tree and b.gather(tree, None) is tree

        def fn(x):
            return x + 1

        assert b.jit(fn) is fn
        assert b.donate(0, 1) == ()

    def test_sim_refuses_other_mesh_types(self):
        with pytest.raises(TypeError, match="MeshConfig"):
            R.mlp_sim(R.mlp_data(2), {}, mesh={"clients": 8})


# -- the world's scenarios ------------------------------------------------------

class TestCollectives:
    """Each collective's forward and vmap(grad) backward (and vmap(vmap(grad))
    equal to it) against JAX's semantics: ppermute j -> j+1 transposing to
    the inverse shift, Megatron's f and g, the block scatter and gather, and
    psum_scatter, over 4 ranks whose rank r holds X + r."""

    @pytest.mark.parametrize("op", ["ring_shift", "copy_to_axis", "reduce_from_axis",
                                    "scatter_to_block", "gather_from_blocks", "psum_scatter"])
    def test_forward_and_vmap_grad(self, world, op):
        payload, _ = world
        x, c = payload["coll_x"], payload["coll_c"]
        total = sum(x + r for r in range(WORLD))
        for r, got in enumerate(_scenario(world, "collectives")):
            fwd, grad, nested_equal = got[op]
            want_fwd, want_grad = {
                "ring_shift": (x + (r - 1) % WORLD, np.broadcast_to(c[:4], x.shape)),
                "copy_to_axis": (x + r, np.broadcast_to(WORLD * c[:4], x.shape)),
                "reduce_from_axis": (total, np.broadcast_to(c[:4], x.shape)),
                "scatter_to_block": ((x + r)[:, r:r + 1], np.full(x.shape, c[0])),
                "gather_from_blocks": (np.concatenate([x + s for s in range(WORLD)], 1),
                                       np.broadcast_to(c[4 * r:4 * r + 4], x.shape)),
                "psum_scatter": (total[:, r:r + 1], np.full(x.shape, c[0])),
            }[op]
            np.testing.assert_allclose(fwd, want_fwd, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)
            assert nested_equal


class TestBuilderSpecs:
    def test_placements_match_jax(self, world, eight_devices):
        got = _scenario(world, "specs", 0)
        jb = JBuilder(JMeshConfig(clients=4), n_clients=8)
        assert got["client"] == tuple(jb.client_sharding().spec) == ("clients",)
        assert got["stacked"] == tuple(jb.stacked_client_sharding().spec)
        assert got["replicated"] == tuple(jb.replicated().spec) == ()
        want = jb.descriptor()
        assert got["descriptor"] == want  # axes, n_devices, device_kinds, flags
        assert P("clients") == jax.sharding.PartitionSpec("clients")

    def test_divisibility_and_size_messages(self, world, eight_devices):
        got = _scenario(world, "specs", 0)
        with pytest.raises(ValueError) as theirs:
            JBuilder(JMeshConfig(clients=4), n_clients=6)
        assert got["divisible"] == str(theirs.value)
        assert got["too_many"] == ("MeshConfig needs 8x2 = 16 devices but only 4 "
                                   "are visible")

    def test_tp_and_server_specs(self, world, eight_devices):
        """test_program_builder.py's Megatron pairing and replicated-server
        cases through the port's builder."""
        got = _scenario(world, "specs", 0)
        assert got["tp_q"] == ("clients", None, "model")
        assert got["tp_o"] == ("clients", "model", None)
        assert got["tp_norm"] == ("clients", None)
        assert got["tp_mu_q"] == ("clients", None, "model")
        assert got["server"] == ()


class TestShardedFit:
    @pytest.fixture(scope="class")
    def references(self, world):
        payload, _ = world
        base = {}
        for mode in ("pipelined", "chunked"):
            s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], mode=mode)
            s.fit(3)
            base[mode] = R.history(s)
        js = _jax_mlp_sim(payload["mlp_data"], mesh=JMeshConfig(clients=4))
        js.fit(3)
        return base, _jax_history(js)

    @pytest.mark.parametrize("mode", ["pipelined", "chunked"])
    def test_matches_unsharded_and_jax(self, world, references, mode, eight_devices):
        base, jax_run = references
        for got in _scenario(world, "fit"):
            _close(got[mode], base[mode], TRAJ_ATOL)
            _close(got[mode], jax_run, TOL)
            assert got[mode + "_local_rows"] == R.N_CLIENTS // WORLD

    def test_routes_agree(self, world):
        got = _scenario(world, "fit", 0)
        _close(got["pipelined"], got["chunked"], TRAJ_ATOL)


class TestZero1:
    def test_trajectory_matches_unsharded_and_jax(self, world, eight_devices):
        payload, _ = world
        got = _scenario(world, "zero1")
        s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], mode="chunked",
                      strategy=fed_adam(0.1))
        s.fit(3)
        js = _jax_mlp_sim(payload["mlp_data"], strategy=jfed_adam(0.1),
                          mesh=JMeshConfig(clients=4, zero1=True))
        js.fit(3)
        for g in got:
            # JAX's tolerance for this comparison (test_mesh_fit.py): the
            # server Adam normalises away the summation order's last bits
            _close(g["run"], R.history(s), TRAJ_ATOL, rtol=1e-4)
            _close(g["run"], _jax_history(js), TOL)
            assert g["wrapped"] and g["caller_unmutated"]

    def test_state_is_sharded(self, world):
        """Each replica holds a quarter of the server momenta: Adam's mu and
        nu over the padded flat vector (123 params -> 124), f32."""
        for g in _scenario(world, "zero1"):
            assert g["state_bytes"] == 2 * (124 // WORLD) * 4

    def test_refusals_match_jax(self, world):
        got = _scenario(world, "zero1", 0)
        assert got["fedavg"].startswith("MeshConfig(zero1=True) shards a SERVER optimizer")
        assert "got FedAvg" in got["fedavg"]
        assert got["foreign"].startswith("the server optimizer was ZeRO-sharded against "
                                         "a different mesh/axis ('model' on {'model': 4})")


class TestZero2:
    @pytest.mark.parametrize("n", [2, 4])
    def test_microbatched_step_matches_plain_adam(self, world, n):
        got = _scenario(world, "zero2", 0)
        assert got[f"step_{n}"] <= 2e-6
        plain, z = got[f"loss_{n}"]
        np.testing.assert_allclose(z, plain, rtol=1e-5)

    def test_state_and_refusal(self, world):
        got = _scenario(world, "zero2", 0)
        assert got["state_2"] == 2 * got["state_4"]
        assert "divisible by n_shards: batch=6, n_shards=4" in got["indivisible"]

    def test_federated_run_matches_unsharded_and_jax(self, world, eight_devices):
        payload, _ = world
        s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], mode="chunked",
                      tx=optim.adam(1e-2))
        s.fit(2)
        js = _jax_mlp_sim(payload["mlp_data"], tx=optax.adam(1e-2))
        js.fit(2)
        for g in _scenario(world, "zero2"):
            _close(g["run"], R.history(s), TRAJ_ATOL)
            _close(g["run"], _jax_history(js), TOL)


def test_zero2_engine_refusals_match_jax():
    """JAX's three refusals of the ZeRO-2 engine path (clients/engine.py):
    fp16 loss scaling, a reduce='sum' optimizer and a logic that owns its
    gradients (DP), on a world of one."""
    from fl4health_tpu.clients import engine as je
    from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDp
    from fl4health_tpu.parallel.zero import zero2_sharded_optimizer as jzero2
    from fl4health_tpu.precision.policy import PrecisionConfig as JPrecision
    from fl4health_tpu_torch.clients import engine as te
    from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDp
    from fl4health_tpu_torch.models.cnn import Mlp as TMlp
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.zero import zero2_sharded_optimizer
    from fl4health_tpu_torch.precision.policy import PrecisionConfig

    tmodel = te.from_module(TMlp(4, (8,), 2))
    params = tmodel.init(torch.Generator().manual_seed(0))
    tmesh = make_mesh((1,), ("model",))
    jmodel = je.from_flax(JMlp(features=(8,), n_outputs=2))
    jparams = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))
    cases = {
        "scaling": (dict(precision=PrecisionConfig("fp16")),
                    dict(precision=JPrecision("fp16")), "mean", te.ClientLogic, je.ClientLogic),
        "sum": ({}, {}, "sum", te.ClientLogic, je.ClientLogic),
        "dp": ({}, {}, "mean", lambda m, c: TDp(m, c, clipping_bound=1.0, noise_multiplier=1.0),
               lambda m, c: JDp(m, c, clipping_bound=1.0, noise_multiplier=1.0)),
    }
    for name, (tkw, jkw, reduce, tlogic, jlogic) in cases.items():
        tz = zero2_sharded_optimizer(optim.adam(1e-2), tmesh, params, "model", reduce=reduce)
        jz = jzero2(optax.adam(1e-2), jmesh, jparams, "model", reduce=reduce)
        with pytest.raises((ValueError, TypeError)) as ours:
            te.make_train_step(tlogic(tmodel, te.masked_cross_entropy), tz, **tkw)
        with pytest.raises((ValueError, TypeError)) as theirs:
            je.make_train_step(jlogic(jmodel, je.masked_cross_entropy), jz, **jkw)
        assert (type(ours.value), str(ours.value)) == (type(theirs.value), str(theirs.value)), name


class TestTensorParallel:
    def test_hybrid_run_matches_unsharded_and_jax(self, world):
        payload, _ = world
        s = R.transformer_sim(payload["text_data"], payload["text_init"])
        s.fit(2)
        jt = _jax_text_sim(payload["text_data"])
        jt.fit(2)
        for g in _scenario(world, "tp"):
            _close(g["run"], R.history(s), TRAJ_ATOL)
            _close(g["run"], _jax_history(jt), TOL)

    def test_megatron_specs(self, world):
        """JAX's check (test_mesh_fit.py): q_proj column-parallel, o_proj
        row-parallel, both split over clients; a rank holds its shard."""
        for g in _scenario(world, "tp"):
            assert g["q"] and all(s == ("clients", None, "model") for s in g["q"])
            assert g["o"] and all(s == ("clients", "model", None) for s in g["o"])
            assert g["q_local"] == (2, 16, 8)


def test_restore_onto_the_mesh(world):
    """A sharded run checkpointed at round 2 (frames by rank 0) resumes on
    every rank and equals the uninterrupted unsharded 3-round run."""
    payload, _ = world
    s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"])
    s.fit(3)
    for g in _scenario(world, "restore"):
        assert g["resumed_at"] == 3
        _close(g["run"], R.history(s), TRAJ_ATOL)


def test_manifest_descriptor_and_gauges(world, eight_devices):
    want = jmesh.mesh_descriptor(JMeshConfig(clients=4).build())
    for r, g in enumerate(_scenario(world, "observability")):
        desc = dict(g["manifest_mesh"])
        assert {k: desc[k] for k in want} == want
        assert desc["zero1"] is False and desc["tp_rules"] is False
        assert g["config_mesh"]["n_devices"] == WORLD
        assert g["gauges"] == [4.0, 4.0, 1.0]
        assert (g["output_dir"] is None) == (r != 0)
        # introspection's program records carry the descriptor
        assert g["program_meshes"] and all(m == desc for m in g["program_meshes"])
    # rank 0's round events (JAX's mesh fields; a rank's local steps a second)
    rounds = _scenario(world, "observability", 0)["round_events"]
    assert len(rounds) == 2
    for e in rounds:
        assert e["mesh_devices"] == WORLD and e["mesh_client_axis"] == WORLD
        assert e["steps_per_s_per_chip"] > 0


def test_scaffold_warm_start_under_the_mesh(world):
    """ScaffoldServer's warm start runs the simulation's own (sharded) round
    function; the run equals the unsharded one (JAX's rtol 1e-4)."""
    from fl4health_tpu_torch.server.servers import ScaffoldServer

    payload, _ = world
    s = R.scaffold_sim(payload["mlp_data"], payload["mlp_init"])
    ScaffoldServer(s, warm_start=True).fit(2)
    for g in _scenario(world, "scaffold_warm"):
        _close(g["run"], R.history(s), TRAJ_ATOL, rtol=1e-4)


def test_cohort_slots_under_the_mesh(world, eight_devices):
    """test_cohort_slots.py's TestCohortUnderMesh: the slot run over a
    registry of 16, sharded 2 slots a rank on the pipelined route (auto
    demotes with JAX's reason), against the unsharded port run and JAX's
    sharded run."""
    payload, _ = world
    s = R.cohort_sim(payload["cohort_data"], payload["cohort_init"])
    s.fit(3)
    js = _jax_cohort_sim(payload["cohort_data"], mesh=JMeshConfig(clients=4))
    jmode, jreason = js._select_execution_mode(3)
    js.fit(3)
    for g in _scenario(world, "cohort"):
        assert (g["mode"], g["reason"]) == (jmode, jreason)
        assert g["local_slots"] == 2
        assert g["dirty"] == s.registry.dirty_rows
        _close(g["run"], R.history(s), TRAJ_ATOL)
        _close(g["run"], _jax_history(js), TOL)


@pytest.mark.parametrize("kind", ["median", "trimmed_mean", "krum", "client_dp"])
def test_strategies_reducing_over_clients(world, kind):
    """test_sharded_mesh.py's cases: the order-statistic aggregators (which
    gather the packets) and weighted, adaptive client-level DP (sums and a
    max over the sharded clients) equal the unsharded runs (its atol and
    rtol 1e-5)."""
    payload, _ = world
    s = R.strategy_sim(kind, payload["mlp_data"], payload["mlp_init"])
    s.fit(2)
    for g in _scenario(world, "strategies"):
        _close(g[kind], R.history(s), TRAJ_ATOL, rtol=1e-5)


def test_fault_plan_under_the_mesh(world):
    """The fault plan's dropout and corruption draws are [C] vectors; a rank
    applies its block: the run equals the unsharded one."""
    payload, _ = world
    s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], mode="chunked",
                  fault_plan=R.fault_plan())
    s.fit(2)
    for g in _scenario(world, "strategies"):
        _close(g["faults"], R.history(s), TRAJ_ATOL, rtol=1e-5)


def test_refusals(world):
    """Buffered async over the registry refuses a mesh with JAX's message
    (simulation.py:611-617); a cohort that does not divide over the clients
    axis with JAX's (test_mesh_fit.py:152)."""
    got = _scenario(world, "refusals", 0)
    assert got["async_cohort"].startswith(
        "ValueError: async_config + cohort=CohortConfig(...) does not yet compose "
        "with mesh")
    assert got["uneven"] == (
        "ValueError: n_clients=6 must be divisible by the clients mesh axis (4 "
        "devices): XLA shards the leading [C] axis evenly — pad the cohort or "
        "shrink the axis (MeshConfig(clients=...))")


def test_wrapper_rows_shard_and_run_matches_unsharded(world):
    """Quarantine + compression: the EF residual stack and the quarantine
    vectors are the rank's block of clients; the run equals the unsharded
    one (JAX's rtol 1e-4)."""
    from fl4health_tpu_torch.compression.config import CompressionConfig
    from fl4health_tpu_torch.resilience.quarantine import (QuarantinePolicy,
                                                           QuarantiningStrategy)
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    payload, _ = world
    s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], mode="chunked",
                  strategy=QuarantiningStrategy(FedAvg(), QuarantinePolicy(),
                                                n_clients=R.N_CLIENTS),
                  compression=CompressionConfig(topk_fraction=0.5, quant_bits=8,
                                                error_feedback=True, seed=3))
    s.fit(3)
    for g in _scenario(world, "wrappers"):
        _close(g["run"], R.history(s), TRAJ_ATOL, rtol=1e-4)
        assert g["residual_rows"] == g["quarantine_rows"] == R.N_CLIENTS // WORLD


class TestAsyncUnderMesh:
    """test_mesh_fit.py's TestAsyncUnderMesh: buffered async (a buffer of 4,
    5% jitter, client 0 slow at 5x, 3 events) with each rank holding its
    block of the client stack and of ``pending``."""

    @pytest.fixture(scope="class")
    def references(self, world):
        from fl4health_tpu.resilience.faults import ClientFault as JFault
        from fl4health_tpu.resilience.faults import FaultPlan as JPlan
        from fl4health_tpu.server.async_schedule import AsyncConfig as JAsync

        payload, _ = world
        port = {}
        for mode in ("pipelined", "chunked"):
            s = R.mlp_sim(payload["mlp_data"], payload["mlp_init"], **R.async_kw(mode))
            s.fit(3)
            port[mode] = R.history(s)
        js = _jax_mlp_sim(payload["mlp_data"], mesh=JMeshConfig(clients=4),
                          rounds_mode="chunked",
                          async_config=JAsync(buffer_size=4, compute_jitter=0.05),
                          fault_plan=JPlan(client_faults=(
                              JFault(clients=(0,), kind="slow", scale=5.0),)))
        js.fit(3)
        return port, _jax_history(js)

    @pytest.mark.parametrize("mode", ["pipelined", "chunked"])
    def test_matches_unsharded_and_jax(self, world, references, mode, eight_devices):
        port, jax_run = references
        for g in _scenario(world, "async"):
            assert g[mode + "_local_rows"] == R.N_CLIENTS // WORLD
            _close(g[mode], port[mode], TRAJ_ATOL)
            _close(g[mode], jax_run, TOL)

    def test_resume_under_the_mesh(self, world, references):
        """A chunked async run checkpointed at event 2 (rank 0 writes the
        gathered stack and ``pending``) resumes pipelined on every rank at
        event 3 and equals the uninterrupted unsharded run."""
        port, _ = references
        for g in _scenario(world, "async"):
            assert g["resumed_at"] == 3
            _close(g["resumed"], port["pipelined"], TRAJ_ATOL)


def test_admin_retune_received_by_rank_0_reaches_every_rank(world):
    """A ``server_lr`` retune submitted on rank 0 alone before round 2's
    boundary applies on every rank at round 2: each rank's run equals the
    single-process run that schedules it at round 2 (and differs from the
    run without it); rank 0 alone journals it."""
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer

    payload, _ = world
    runs = {}
    for retuned in (True, False):
        obs = Observability(enabled=True, tracer=Tracer(), registry=MetricsRegistry(),
                            introspection=False, admin_token="t")
        s = R.admin_sim(payload["mlp_data"], payload["mlp_init"], obs)
        if retuned:
            obs.admin.schedule(2, R.RETUNE)
        s.fit(3)
        runs[retuned] = R.history(s)
    assert abs(runs[True]["fit"][-1] - runs[False]["fit"][-1]) > 1e-6
    for r, g in enumerate(_scenario(world, "admin")):
        _close(g["run"], runs[True], TRAJ_ATOL)
        assert g["journal"] == ([(2, R.RETUNE)] if r == 0 else [])
