"""Round telemetry (``observability/telemetry.py``, the engine's telemetry
build) against the JAX package on the tiny DP recipe of
``tests/torch_obs_sims.py``:

- ``RoundTelemetry`` field by field against JAX's on the dense pipelined,
  dense chunked, cohort chunked and async chunked routes (5e-4 relative,
  the non-finite counts exact);
- telemetry on against off, bit-identical in the port on both routes (the
  telemetry only reads what the round computes);
- a NaN-poisoned client in the non-finite counts, the device helpers and
  ``summarize_host`` against JAX's on the same numpy inputs (the summary
  exactly), the early-stopping path;
- a DP round's ``fit_losses`` keys equal JAX's with telemetry off and on
  (DP's ``clip_fraction`` enters only the telemetry build)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import functools

import numpy as np
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.observability import telemetry as jtelem
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.observability import telemetry as ttelem
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from torch_obs_sims import (assert_telemetry_close, data_of, events, jax_init, obs_of,
                            sim_of)

ROUNDS = 2

# route: (JAX run it is held against, port execution mode, extra kwargs by package)
ROUTES = {
    "dense_pipelined": ("dense", "pipelined", lambda pkg: {}),
    "dense_chunked": ("dense", "chunked", lambda pkg: {}),
    "cohort_chunked": ("cohort", "chunked", lambda pkg: dict(
        data=data_of(6),
        cohort=(jreg if pkg == "jax" else treg).CohortConfig(slots=3),
        client_manager=(jcm if pkg == "jax" else tcm).FixedFractionManager(6, 0.5))),
    "async_chunked": ("async", "chunked", lambda pkg: dict(
        async_config=(jas if pkg == "jax" else tas).AsyncConfig(
            buffer_size=2, compute_jitter=0.05, seed=3))),
}


def _kwargs(route, pkg):
    kw = ROUTES[route][2](pkg)
    return kw.pop("data", data_of(4)), kw


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    route = {"dense": "dense_chunked", "cohort": "cohort_chunked",
             "async": "async_chunked"}[kind]
    data, kw = _kwargs(route, "jax")
    obs = obs_of("jax")
    js = sim_of("jax", data, obs=obs, **kw)
    init = jax_init(js)
    js.fit(ROUNDS)
    return js, obs, init


@pytest.mark.parametrize("route", list(ROUTES))
def test_round_telemetry_matches_jax(route):
    kind, mode, _ = ROUTES[route]
    js, jobs, init = _jax_run(kind)
    data, kw = _kwargs(route, "torch")
    tobs = obs_of("torch")
    ts = sim_of("torch", data, mode=mode, obs=tobs, **kw)
    ts.set_global_params(init)
    ts.fit(ROUNDS)
    assert_telemetry_close(events(tobs, "telemetry"), events(jobs, "telemetry"))
    clip = np.asarray([e["clip_fraction"] for e in events(tobs, "telemetry")])
    assert np.all((clip >= 0) & (clip <= 1)) and clip.max() > 0


@pytest.mark.parametrize("mode", ["chunked", "pipelined"])
def test_telemetry_on_is_bit_identical_to_off(mode):
    runs = []
    for obs in (None, obs_of("torch")):
        sim = sim_of("torch", data_of(4), mode=mode, obs=obs)
        sim.fit(ROUNDS)
        runs.append(sim)
    off, on = runs
    for a, b in zip(off.history, on.history):
        assert a.fit_losses["backward"] == b.fit_losses["backward"]
        assert a.eval_losses == b.eval_losses and a.eval_metrics == b.eval_metrics
    for k, v in off.global_params.items():
        assert torch.equal(v, on.global_params[k]), k
    for a, b in zip(tsim.ptu.tree_leaves(off.client_states),
                    tsim.ptu.tree_leaves(on.client_states)):
        assert torch.equal(a, b)


def test_poisoned_client_surfaces_in_the_nonfinite_counts():
    obs = obs_of("torch")
    sim_of("torch", data_of(4, poison=1), obs=obs).fit(1)
    t = events(obs, "telemetry")[0]
    assert t["nonfinite_loss"][1] > 0 and t["nonfinite_params"][1] > 0
    assert [t["nonfinite_loss"][c] for c in (0, 2, 3)] == [0, 0, 0]
    assert events(obs, "round")[0]["nonfinite"] > 0


def test_device_helpers_match_jax():
    r = np.random.default_rng(3)
    stacked = {"a/kernel": r.normal(size=(4, 3, 2)).astype(np.float32),
               "a/bias": r.normal(size=(4, 2)).astype(np.float32),
               "b/kernel": r.normal(size=(4, 5)).astype(np.float32)}
    stacked["a/bias"][2, 1] = np.nan
    stacked["b/kernel"][0, :2] = np.inf
    ref = {k: v[1] + 0.25 for k, v in stacked.items()}
    jnest = lambda d: {"a": {"bias": d["a/bias"], "kernel": d["a/kernel"]},  # noqa: E731
                       "b": {"kernel": d["b/kernel"]}}
    tt = {k: torch.from_numpy(v) for k, v in stacked.items()}
    np.testing.assert_array_equal(ttelem.per_client_nonfinite(tt).numpy(),
                                  np.asarray(jtelem.per_client_nonfinite(jnest(stacked))))
    losses = {"backward": stacked["b/kernel"][:, 0], "x": stacked["a/bias"][:, 1]}
    np.testing.assert_array_equal(
        ttelem.nonfinite_in_losses({k: torch.from_numpy(v) for k, v in losses.items()}).numpy(),
        np.asarray(jtelem.nonfinite_in_losses(losses)))
    np.testing.assert_allclose(
        ttelem.per_client_divergence(tt, {k: torch.from_numpy(v) for k, v in ref.items()}),
        np.asarray(jtelem.per_client_divergence(jnest(stacked), jnest(ref))), rtol=1e-6)
    one = {k: v[3] for k, v in stacked.items()}
    np.testing.assert_allclose(
        float(ttelem.global_norm_diff({k: torch.from_numpy(v) for k, v in one.items()},
                                      {k: torch.from_numpy(v) for k, v in ref.items()})),
        float(jtelem.global_norm_diff(jnest(one), jnest(ref))), rtol=1e-6)
    for k, v in ttelem.nan_engine_telemetry().items():
        assert torch.isnan(v) and v.dtype == torch.float32
        assert np.isnan(np.asarray(jtelem.nan_engine_telemetry()[k]))
    assert ttelem.TELEMETRY_FIELDS == jtelem.TELEMETRY_FIELDS


@pytest.mark.parametrize("skips", [False, True])
def test_summarize_host_is_jax_exactly(skips):
    r = np.random.default_rng(7)
    tel = {k: r.normal(size=6).astype(np.float32) for k in ttelem.TELEMETRY_FIELDS}
    tel["train_loss_min"][2] = np.nan
    tel["clip_fraction"][:] = np.nan
    for k in ("nonfinite_params", "nonfinite_loss", "nonfinite_eval_loss"):
        tel[k] = r.integers(0, 3, 6).astype(np.float32)
    if skips:
        tel["loss_scale_skips"] = r.integers(0, 9, 6).astype(np.int32)
    mask = np.asarray([1, 0, 1, 1, 0, 1], np.float32)
    got, want = ttelem.summarize_host(tel, mask), jtelem.summarize_host(tel, mask)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    empty = np.zeros(6, np.float32)
    assert np.isnan(ttelem.summarize_host(tel, empty)["grad_norm_max"])


def test_engine_grad_norm_is_the_optimizer_gradient_norm():
    # the telemetry build's step reads the gradient it hands the optimizer:
    # one SGD step of lr 1 moves the params by exactly that gradient
    data = data_of(1)[0]
    logic = tengine.ClientLogic(tengine.from_module(TMlp(6, (4,), 3)),
                                tengine.masked_cross_entropy)
    state = tengine.create_train_state(logic, optim.sgd(1.0), trng.PRNGKey(0),
                                       torch.Generator().manual_seed(0), "cpu")
    step = tengine.make_train_step(logic, optim.sgd(1.0), collect_telemetry=True)
    batch = tengine.Batch(x=torch.from_numpy(data[0][:8]), y=torch.from_numpy(data[1][:8]),
                          example_mask=torch.ones(8), step_mask=torch.tensor(1.0))
    new, out = step(state, None, batch)
    moved = torch.sqrt(sum(((state.params[k] - new.params[k]) ** 2).sum()
                           for k in tsim.ptu.flax_leaf_order(state.params)))
    torch.testing.assert_close(out.grad_norm, moved, rtol=1e-6, atol=0)
    _, plain = tengine.make_train_step(logic, optim.sgd(1.0))(state, None, batch)
    assert plain.grad_norm is None


def test_early_stopping_telemetry_matches_jax():
    runs = {}
    for pkg, eng in (("jax", jengine), ("torch", tengine)):
        obs = obs_of(pkg)
        sim = sim_of(pkg, data_of(4), obs=obs, local_steps=None, local_epochs=2,
                     early_stopping=eng.EarlyStoppingConfig(interval_steps=2, patience=1))
        if pkg == "jax":
            init = jax_init(sim)
        else:
            sim.set_global_params(init)
        sim.fit(ROUNDS)
        runs[pkg] = obs
    tel = events(runs["torch"], "telemetry")
    assert all(np.all(np.isfinite(e["grad_norm_mean"])) for e in tel)
    assert_telemetry_close(tel, events(runs["jax"], "telemetry"))


@pytest.mark.parametrize("telemetry", [False, True])
def test_dp_fit_loss_keys_equal_jax(telemetry):
    keys = {}
    for pkg in ("jax", "torch"):
        obs = obs_of(pkg) if telemetry else None
        hist = sim_of(pkg, data_of(2), obs=obs).fit(1)
        keys[pkg] = set(hist[0].fit_losses)
    assert keys["torch"] == keys["jax"]
    assert ("clip_fraction" in keys["torch"]) == telemetry


def test_round_telemetry_is_a_tree():
    t = ttelem.RoundTelemetry(*[torch.zeros(3)] * 11)
    stacked = tsim.ptu.stack_clients([t, t])
    assert isinstance(stacked, ttelem.RoundTelemetry)
    assert stacked.train_loss.shape == (2, 3) and stacked.loss_scale_skips is None
    assert list(stacked.as_dict()) == list(ttelem.TELEMETRY_FIELDS)
    host = tsim.HostPull({"telemetry": t.replace(
        loss_scale_skips=torch.zeros(3, dtype=torch.int32))}).result()["telemetry"]
    assert isinstance(host, ttelem.RoundTelemetry)
    got = ttelem.telemetry_from_dict(host)
    assert set(got) == {*ttelem.TELEMETRY_FIELDS, "loss_scale_skips"}
    assert got["loss_scale_skips"].dtype == np.int32 and got["train_loss"].dtype == np.float32
