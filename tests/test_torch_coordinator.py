"""The port's cross-silo coordinator against the JAX package's on the CPU.

- Mixed rounds: a JAX coordinator with port silos, a port coordinator with
  JAX silos, and a port coordinator with port silos each run a tiny FedProx
  cluster job (``research/fedprox_cluster/run_local_cluster.py``'s tiny
  sizes: 2 silos of 24 rows, dim 8, 3 classes, ``Mlp((16,), 3)``, 2
  SGD(0.05) steps of batch 8, mu 0.1, 2 rounds) over TCP; each is held
  against the all-JAX job at 5e-4 (the f32 CPU tolerance).
- R13 (ROADMAP.md C): ``weighted_merge`` gives float64 leaves in both
  packages, bit for bit, so the round-2 broadcast frame is about twice
  round 1's, and the port's frame equals JAX's.
- The DP composition (``chip_smoke.py``'s ``cross_silo_dp_cifar_cnn`` at a
  tiny size): each silo ``InstanceLevelDpClientLogic`` under
  ``make_local_train`` alone (C 1, sigma 1), the same job in both packages
  at 5e-4.
- Quorum, retries, ``SiloUpdateBuffer``'s staleness and ``chaos_handler``'s
  fault sequence equal to JAX's.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fl4health_tpu.transport as jt
from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.fedprox import FedProxClientLogic as JProx
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDp
from fl4health_tpu.datasets.synthetic import fedprox_synthetic
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetrics
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.resilience.faults import TransportFaultPolicy as JPolicy
from fl4health_tpu.resilience.faults import chaos_handler as jchaos
from fl4health_tpu.resilience.retry import RetryPolicy as JRetry
from fl4health_tpu.server.async_schedule import staleness_discount as jdiscount
import fl4health_tpu_torch.transport as tt
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic as TProx
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDp
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetrics
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.resilience import TransportFaultPolicy as TPolicy
from fl4health_tpu_torch.resilience import chaos_handler as tchaos
from fl4health_tpu_torch.resilience.retry import RetryPolicy as TRetry
from fl4health_tpu_torch.server.async_schedule import staleness_discount as tdiscount

TOL = 5e-4
N_SILOS, PER_SILO, DIM, CLASSES, STEPS, BATCH, MU, ROUNDS = 2, 24, 8, 3, 2, 8, 0.1, 2


def _shards():
    return [(np.asarray(x), np.asarray(y)) for x, y in fedprox_synthetic(
        jax.random.PRNGKey(0), N_SILOS, PER_SILO, dim=DIM, n_classes=CLASSES)]


def _init_params(x):
    """The job's initial global params: flax's init of silo 0's model."""
    return jax.tree_util.tree_map(np.asarray, JMlp(features=(16,), n_outputs=CLASSES).init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])


def jax_silo(seed, shard, dp=False):
    """``run_local_cluster.py``'s ``make_silo``: FedProx (or instance-level
    DP-SGD) local training behind a TCP handler speaking wire frames."""
    x, y = shard
    model = jengine.from_flax(JMlp(features=(16,), n_outputs=CLASSES))
    logic = (JDp(model, jengine.masked_cross_entropy, clipping_bound=1.0, noise_multiplier=1.0)
             if dp else JProx(model, jengine.masked_cross_entropy))
    tx = optax.sgd(0.05)
    state = jengine.create_train_state(logic, tx, jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    train = jax.jit(jengine.make_local_train(
        logic, tx, JMetrics((jefficient.accuracy(),)),
        loss_keys=("backward", *getattr(logic, "extra_loss_keys", ()))))

    def handler(frame: bytes) -> bytes:
        nonlocal state
        state = state.replace(params=jt.decode(frame, like=state.params))
        ctx = None if dp else logic.init_round_context(state, types.SimpleNamespace(
            drift_penalty_weight=jnp.asarray(MU, jnp.float32)))
        batches = jengine.epoch_batches(state.rng, jnp.asarray(x), jnp.asarray(y), BATCH,
                                        n_steps=STEPS)
        state, losses, metrics, _ = train(state, ctx, batches)
        return jt.encode({"params": state.params, "n": jnp.asarray(float(len(x))),
                          "loss": losses["backward"], "accuracy": metrics["accuracy"]})

    return jt.LoopbackServer(handler)


def port_silo(seed, shard, dp=False, device="cpu"):
    """The same silo in the port. The received params are cast to the
    state's dtype, as JAX's jit casts its f64 inputs (R13)."""
    x, y = (torch.tensor(a, device=device) for a in shard)
    model = tengine.from_module(TMlp(DIM, (16,), CLASSES))
    logic = (TDp(model, tengine.masked_cross_entropy, clipping_bound=1.0, noise_multiplier=1.0)
             if dp else TProx(model, tengine.masked_cross_entropy))
    tx = optim.sgd(0.05)
    state = tengine.create_train_state(logic, tx, rng.PRNGKey(seed), torch.Generator(),
                                       torch.device(device))
    train = tengine.make_local_train(
        logic, tx, TMetrics((tefficient.accuracy(),)),
        loss_keys=("backward", *getattr(logic, "extra_loss_keys", ())))

    def handler(frame: bytes) -> bytes:
        nonlocal state
        received = tt.decode(frame, like=state.params)
        state = dataclasses.replace(state, params={
            k: v.to(device=device, dtype=state.params[k].dtype) for k, v in received.items()})
        ctx = None if dp else logic.init_round_context(state, types.SimpleNamespace(
            drift_penalty_weight=torch.tensor(MU, device=device)))
        batches = tengine.epoch_batches(state.rng, x, y, BATCH, n_steps=STEPS)
        state, losses, metrics, _ = train(state, ctx, batches)
        return tt.encode({"params": state.params, "n": torch.tensor(float(len(x))),
                          "loss": losses["backward"], "accuracy": metrics["accuracy"]})

    return tt.LoopbackServer(handler)


def run_job(coordinator: str, silos: str, dp: bool = False):
    """2 rounds of the cluster job; (global params as port ``Params``, per
    round mean loss)."""
    shards = _shards()
    init = _init_params(shards[0][0])
    make = jax_silo if silos == "jax" else port_silo
    servers = [make(i, s, dp) for i, s in enumerate(shards)]
    addrs = [(s.host, s.port) for s in servers]
    losses = []
    try:
        if coordinator == "jax":
            template = {"params": init, "n": jnp.zeros(()), "loss": jnp.zeros(()),
                        "accuracy": jnp.zeros(())}
            params = init
            for _ in range(ROUNDS):
                replies = jt.broadcast_round(addrs, params, template)
                params, _ = jt.weighted_merge(replies)
                losses.append(np.mean([float(r["loss"]) for r in replies]))
            out = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
        else:
            tinit = convert.flax_to_torch(init)
            template = {"params": tinit, "n": torch.zeros(()), "loss": torch.zeros(()),
                        "accuracy": torch.zeros(())}
            params = tinit
            for _ in range(ROUNDS):
                replies = tt.broadcast_round(addrs, params, template)
                params, _ = tt.weighted_merge(replies)
                losses.append(np.mean([float(r["loss"]) for r in replies]))
            out = params
    finally:
        for s in servers:
            s.close()
    return out, losses


@pytest.fixture(scope="module")
def all_jax():
    return run_job("jax", "jax")


@pytest.mark.parametrize("coordinator,silos", [("jax", "port"), ("port", "jax"),
                                               ("port", "port")])
def test_a_mixed_fedprox_cluster_job_matches_the_jax_one(all_jax, coordinator, silos):
    want, want_losses = all_jax
    got, got_losses = run_job(coordinator, silos)
    np.testing.assert_allclose(got_losses, want_losses, atol=TOL, rtol=0)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float64 == want[k].dtype  # R13 on both sides
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)


def test_the_dp_silo_composition_matches_jax():
    """Instance-level DP-SGD silos under ``make_local_train`` alone (the
    round context None), the transport around them: the job in both
    packages at 5e-4 (the noise draws are within 2 ulp)."""
    want, want_losses = run_job("jax", "jax", dp=True)
    got, got_losses = run_job("port", "port", dp=True)
    np.testing.assert_allclose(got_losses, want_losses, atol=TOL, rtol=0)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)


def test_r13_the_merge_is_float64_and_the_round_two_frame_doubles_in_both():
    """ROADMAP.md R13, pinned in both packages: ``weighted_merge`` of f32
    replies gives f64 leaves (NumPy 2's NEP 50 keeps JAX's f64 weights'
    products f64), so the next broadcast is about twice round 1's bytes.
    The port's merged leaves and frame equal JAX's bit for bit."""
    r = np.random.default_rng(0)
    reps = [{"params": {"Dense_0": {"kernel": r.standard_normal((30, 16)).astype(np.float32),
                                    "bias": r.standard_normal(16).astype(np.float32)}},
             "n": np.float32(n)} for n in (120, 80, 100)]
    jmerged, jw = jt.weighted_merge(reps)
    assert all(v.dtype == np.float64 for v in jax.tree_util.tree_leaves(jmerged))
    treps = [{"params": convert.flax_to_torch(x["params"]), "n": torch.tensor(x["n"])}
             for x in reps]
    tmerged, tw = tt.weighted_merge(treps)
    np.testing.assert_array_equal(tw, jw)
    for k, v in convert.flax_to_torch(jmerged).items():
        assert tmerged[k].dtype == torch.float64
        np.testing.assert_array_equal(tmerged[k].numpy(), v.numpy())
    round1 = jt.encode(reps[0]["params"])
    round2 = jt.encode(jmerged)
    assert tt.encode(tmerged) == round2 and tt.encode(treps[0]["params"]) == round1
    assert 1.9 < len(round2) / len(round1) < 2.0


def _echo(offset, delay_s=0.0, pkg=tt):
    like = {"w": np.zeros(2, np.float32)}

    def handler(frame):
        got = pkg.decode(frame, like=like)
        if delay_s:
            time.sleep(delay_s)
        return pkg.encode({"params": {"w": np.asarray(got["w"]) + offset},
                           "n": np.float32(offset)})

    return pkg.LoopbackServer(handler)


def _dead():
    s = tt.LoopbackServer(lambda b: b)
    s.close()
    return s


@pytest.mark.parametrize("quorum", [None, 2, 3, 0.5])
def test_quorum_outcomes_match_jax(quorum):
    silos = [_echo(1.0), _echo(3.0)]
    dead = _dead()
    addrs = [(silos[0].host, silos[0].port), (dead.host, dead.port),
             (silos[1].host, silos[1].port)]
    params = {"w": np.asarray([10.0, 20.0], np.float32)}
    template = {"params": {"w": np.zeros(2, np.float32)}, "n": np.float32(0)}
    outcomes = {}
    try:
        for name, pkg in (("jax", jt), ("port", tt)):
            try:
                replies = pkg.broadcast_round(addrs, params, template, timeout=0.5,
                                              quorum=quorum)
                merged, w = pkg.weighted_merge(replies)
                outcomes[name] = ("ok", [float(x) for x in np.asarray(merged["w"])],
                                  list(w))
            except pkg.QuorumError as e:
                outcomes[name] = ("quorum", e.required, e.succeeded,
                                  [reason for _, reason in e.failures])
            except OSError as e:
                outcomes[name] = ("raised", type(e).__name__)
    finally:
        for s in silos:
            s.close()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == {None: "raised", 2: "ok", 3: "quorum", 0.5: "ok"}[quorum]


def test_retries_and_attempt_counts_match_jax():
    """A silo that drops its first two requests (chaos at drop probability
    1, then healed) is re-dialed; the attempts and the reply match."""
    report = {}
    for name, pkg, retry in (("jax", jt, JRetry), ("port", tt, TRetry)):
        calls = {"n": 0}
        inner = _echo(2.0, pkg=pkg).handler

        def flaky(frame, inner=inner, calls=calls):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("dropped")
            return inner(frame)

        srv = pkg.LoopbackServer(flaky)
        try:
            rep = pkg.broadcast_round_detailed(
                [(srv.host, srv.port)], {"w": np.ones(2, np.float32)},
                {"params": {"w": np.zeros(2, np.float32)}, "n": np.float32(0)},
                retry=retry(max_attempts=3, base_delay_s=0.0, timeout_s=2.0))
        finally:
            srv.close()
        res = rep.results[0]
        report[name] = (res.ok, res.attempts, np.asarray(res.reply["params"]["w"]).tolist())
    assert report["port"] == report["jax"] == (True, 3, [3.0, 3.0])


def test_silo_update_buffer_staleness_matches_jax():
    """``examples/cross_silo_buffered_async_example``'s bookkeeping: a fast
    silo and a 0.6 s straggler; the straggler's update lands one version
    stale, discounted by ``1/sqrt(1 + s)`` in both packages."""
    seen = {}
    for name, pkg, disc in (("jax", jt, jdiscount), ("port", tt, tdiscount)):
        silos = [_echo(0.0, pkg=pkg), _echo(1.0, delay_s=0.6, pkg=pkg)]
        addrs = [(s.host, s.port) for s in silos]
        params = {"w": np.zeros(2, np.float32)}
        buf = pkg.SiloUpdateBuffer({"params": params, "n": np.float32(0)})
        try:
            buf.dispatch(addrs, params, version=0)
            first = buf.take(1, timeout=30.0)
            buf.dispatch([addrs[0]], params, version=1)
            nxt = buf.take(2, timeout=30.0)
        finally:
            buf.close()
            for s in silos:
                s.close()
        stal = [1 - r.version for r in nxt]
        seen[name] = ([r.version for r in first], sorted(stal),
                      [float(d) for d in disc(np.asarray(sorted(stal), np.float64))])
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [0, 1]


@pytest.mark.parametrize("policy", [dict(drop_probability=0.3, corrupt_probability=0.2,
                                         delay_s=0.5, delay_probability=0.4),
                                    dict(delay_s=0.2, delay_probability=1.0)])
@pytest.mark.parametrize("seed,silo", [(0, 0), (7, 3)])
def test_chaos_handler_gives_jax_fault_sequence(policy, seed, silo):
    def trail(chaos, policy_cls):
        slept = []
        h = chaos(lambda f: f + b"-reply", policy_cls(**policy), seed=seed, silo_idx=silo,
                  sleep=slept.append)
        out = []
        for i in range(40):
            try:
                out.append(h(b"frame%02d" % i))
            except RuntimeError as e:
                out.append(str(e))
        return out, slept

    assert trail(tchaos, TPolicy) == trail(jchaos, JPolicy)
