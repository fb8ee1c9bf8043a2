"""``TrainState.model_state`` in the port against the JAX package: the
engine's mutable model state (flax's ``batch_stats``) on a Dense ->
BatchNorm -> relu -> Dense model (``tests/clients/test_personalization.py``
``test_fedbn_norm_layers_stay_local``'s ``BnMlp``), from the converted flax
init (params and statistics):

- one train step and an eval call, the statistics' update and the
  running-average read, against flax's at 5e-4;
- the converted init in both directions;
- FedBN (``norm_exclusion_exchanger``) against JAX's run at 5e-4 on the
  pipelined, chunked, cohort and async routes: the statistics and the BN
  affine stay local, the Dense layers are shared;
- frames of a ``TrainState`` with an empty model state and with
  statistics, byte-equal to JAX's at one clock and read by each package
  from the other's;
- a resume on each route equal to the straight run bit for bit, and a
  resume from a frame written before ``TrainState`` had ``model_state``;
- MOON's, PerFCL's and Constrained FENDA's frozen feature passes on the
  client's statistics, against JAX at 5e-4;
- the padding step, the ZeRO-2 microbatches and early stopping keep the
  model state as JAX's engine keeps it; the DP logic refuses the model."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_pfl_sims as S
from fl4health_tpu.checkpointing import state as jstate
from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients import fenda as jfenda
from fl4health_tpu.clients import moon as jmoon
from fl4health_tpu.exchange.exchanger import FixedLayerExchanger as JFixedLayer
from fl4health_tpu.exchange.exchanger import norm_exclusion_exchanger as jnorm
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import bases as jbases
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.checkpointing import serialization
from fl4health_tpu_torch.checkpointing import state as tstate
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import fenda as tfenda
from fl4health_tpu_torch.clients import moon as tmoon
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger as TFixedLayer
from fl4health_tpu_torch.exchange.exchanger import norm_exclusion_exchanger as tnorm
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.norm import BatchNorm
from fl4health_tpu_torch.models.transformer import LoraDense
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg

TOL = 5e-4


class JBnMlp(jbases.nn.Module):
    @jbases.nn.compact
    def __call__(self, x, train: bool = True):
        x = jbases.nn.Dense(16)(x)
        x = jbases.nn.BatchNorm(use_running_average=not train)(x)
        x = jbases.nn.relu(x)
        return {"prediction": jbases.nn.Dense(S.N_CLASSES)(x)}, {}


class TBnMlp(nn.Module):
    """JAX's ``BnMlp``: Dense 16, flax's BatchNorm, relu, Dense."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = LoraDense(S.DIM, 16, dtype=None)
        self.BatchNorm_0 = BatchNorm(16)
        self.Dense_1 = LoraDense(16, S.N_CLASSES, dtype=None)

    def init_params(self, generator):
        return _init_params(self, generator)

    def init_state(self, generator):
        return {"batch_stats": {"BatchNorm_0": self.BatchNorm_0.init_stats()}}

    def forward(self, x, train=True, state=None):
        h, stats = self.BatchNorm_0(self.Dense_0(x), state["batch_stats"]["BatchNorm_0"],
                                    not train)
        return (({"prediction": self.Dense_1(F.relu(h))}, {}),
                {"batch_stats": {"BatchNorm_0": stats}})


def jlogic():
    return jengine.ClientLogic(jengine.from_flax(JBnMlp()), jengine.masked_cross_entropy)


def tlogic(params, model_state):
    """The port's logic, initialised to JAX's converted params and state."""
    logic = tengine.ClientLogic(tengine.from_module(TBnMlp()), tengine.masked_cross_entropy)
    logic = S.with_init(logic, params)
    logic.model = dataclasses.replace(
        logic.model, init_state=lambda g: ptu.tree_map(torch.clone, model_state))
    return logic


def jax_state_of(js):
    """Client 0's model state of a JAX simulation, converted."""
    return convert.flax_state_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[0], jax.device_get(js.client_states.model_state)))


def _stats(tree) -> dict:
    """The BatchNorm statistics of a (stacked) model state as numpy."""
    bn = tree["batch_stats"]["BatchNorm_0"]
    return {k: np.asarray(v) for k, v in bn.items()}


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def step_pair():
    """One client's state in both packages on JAX's init, and a batch."""
    x, y = S.arrays()[0][:2]
    jst = jengine.create_train_state(jlogic(), optax.sgd(0.05), jax.random.PRNGKey(4), x[:8])
    params, ms = S.flat(jst.params), convert.flax_state_to_torch(
        jax.device_get(jst.model_state))
    tl = tlogic(params, ms)
    tst = tengine.create_train_state(tl, optim.sgd(0.05), trng.PRNGKey(4),
                                     torch.Generator().manual_seed(0), torch.device("cpu"))
    return jst, tst, tl, (x, y)


def _batch(pkg, x, y, step_mask=1.0, rows=8):
    mask = np.ones((rows,), np.float32)
    mask[-2:] = 0.0  # padded rows still enter the statistics, as in flax
    if pkg == "jax":
        return jengine.Batch(x=jnp.asarray(x[:rows]), y=jnp.asarray(y[:rows]),
                             example_mask=jnp.asarray(mask),
                             step_mask=jnp.asarray(step_mask, jnp.float32))
    return tengine.Batch(x=torch.tensor(x[:rows]), y=torch.tensor(y[:rows]),
                         example_mask=torch.tensor(mask),
                         step_mask=torch.tensor(step_mask, dtype=torch.float32))


def test_converted_init_round_trips(step_pair):
    jst, tst, _, _ = step_pair
    assert jax.tree_util.tree_structure(jax.device_get(jst.model_state)) == \
        jax.tree_util.tree_structure(convert.torch_state_to_flax(tst.model_state))
    back = convert.torch_state_to_flax(tst.model_state)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jst.model_state)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [f.name for f in dataclasses.fields(tengine.TrainState)] == [
        "params", "opt_state", "model_state", "rng", "step", "extra", "loss_scale"]


@pytest.mark.parametrize("step_mask", [1.0, 0.0], ids=["real_step", "padding_step"])
def test_train_step_updates_the_statistics_as_flax(step_pair, step_mask):
    """A real step moves the statistics by flax's decay (0.99) over every
    row; a padding step keeps them (JAX's ``_mask_tree``)."""
    jst, tst, tl, (x, y) = step_pair
    jnew, jout = jengine.make_train_step(jlogic(), optax.sgd(0.05))(
        jst, None, _batch("jax", x, y, step_mask))
    tnew, tout = tengine.make_train_step(tl, optim.sgd(0.05))(
        tst, None, _batch("port", x, y, step_mask))
    want, got = _stats(jax.device_get(jnew.model_state)), _stats(tnew.model_state)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-5, err_msg=k)
    if step_mask == 0.0:
        for k, v in _stats(tst.model_state).items():
            np.testing.assert_array_equal(got[k], v)
    for k, v in S.flat(jnew.params).items():
        np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tout.losses["backward"]),
                               float(jout.losses["backward"]), atol=1e-6)


def test_eval_reads_the_running_statistics(step_pair):
    jst, tst, tl, (x, y) = step_pair
    stats = {"batch_stats": {"BatchNorm_0": {"mean": np.full(16, 0.3, np.float32),
                                             "var": np.full(16, 2.0, np.float32)}}}
    (jp, _), jms = jlogic().model.apply(jst.params, stats, jnp.asarray(x[:8]), train=False)
    (tp, _), tms = tl.model.apply(tst.params, convert.flax_state_to_torch(stats),
                                  torch.tensor(x[:8]), train=False)
    np.testing.assert_allclose(tp["prediction"].numpy(), np.asarray(jp["prediction"]),
                               atol=1e-6)
    assert tms["batch_stats"]["BatchNorm_0"]["mean"][0] == 0.3  # handed back


def test_zero2_microbatches_keep_the_last_microbatchs_state(step_pair):
    """``_microbatched_value_and_grads`` (2 microbatches) in both engines:
    the model state is the last microbatch's, as JAX's."""
    jst, tst, tl, (x, y) = step_pair
    tx = types.SimpleNamespace(n_shards=2)
    jout = jengine._microbatched_value_and_grads(jlogic(), tx, jst, None,
                                                 _batch("jax", x, y), jax.random.PRNGKey(1))
    tout = tengine._microbatched_value_and_grads(tl, tx, tst, None, _batch("port", x, y),
                                                 trng.PRNGKey(1))
    want, got = _stats(jax.device_get(jout[3])), _stats(tout[3])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-5, err_msg=k)


def test_early_stopping_restores_the_best_snapshots_state(step_pair):
    """The best snapshot carries the model state (JAX's ``best_state``):
    6 steps in chunks of 2, patience 1."""
    jst, tst, tl, (x, y) = step_pair
    xs, ys = S.arrays()[0][:2]
    rows = [slice(8 * (s % 4), 8 * (s % 4) + 8) for s in range(6)]
    stack = dict(x=np.stack([xs[r] for r in rows]), y=np.stack([ys[r] for r in rows]),
                 example_mask=np.ones((6, 8), np.float32), step_mask=np.ones(6, np.float32))
    val = {k: v[:2] for k, v in stack.items()}
    cfg = dict(interval_steps=2, patience=1)
    jtrain = jengine.make_local_train_with_early_stopping(
        jlogic(), optax.sgd(0.5), JMetricManager(()), jengine.EarlyStoppingConfig(**cfg))
    ttrain = tengine.make_local_train_with_early_stopping(
        tl, optim.sgd(0.5), TMetricManager(()), tengine.EarlyStoppingConfig(**cfg))
    jb = {k: jengine.Batch(**{n: jnp.asarray(v) for n, v in d.items()})
          for k, d in (("train", stack), ("val", val))}
    tb = {k: tengine.Batch(**{n: torch.tensor(v) for n, v in d.items()})
          for k, d in (("train", stack), ("val", val))}
    jfinal = jtrain(jst, None, jb["train"], jb["val"])[0]
    tfinal = ttrain(tst, None, tb["train"], tb["val"])[0]
    want, got = _stats(jax.device_get(jfinal.model_state)), _stats(tfinal.model_state)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)


def test_the_dp_logic_refuses_batch_statistics():
    with pytest.raises(ValueError, match="BatchNorm"):
        InstanceLevelDpClientLogic(tengine.from_module(TBnMlp()),
                                   tengine.masked_cross_entropy, clipping_bound=1.0,
                                   noise_multiplier=1.0)


# -- FedBN on every route -----------------------------------------------------

ROUTES = {
    "pipelined": ({}, {}, "pipelined"),
    "chunked": ({}, {}, "chunked"),
    "cohort": (dict(cohort=jreg.CohortConfig(slots=2),
                    client_manager=jcm.FixedFractionManager(3, 0.5)),
               dict(cohort=treg.CohortConfig(slots=2),
                    client_manager=tcm.FixedFractionManager(3, 0.5)), "pipelined"),
    "async": (dict(async_config=jas.AsyncConfig(buffer_size=2, seed=13)),
              dict(async_config=tas.AsyncConfig(buffer_size=2, seed=13)), "chunked"),
}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's FedBN run of each recipe (the dense routes share one), its
    converted init and initial model state."""
    out = {}
    for name in ("dense", "cohort", "async"):
        jkw = ROUTES["pipelined" if name == "dense" else name][0]
        js = S.jsim(jlogic(), jnorm(), False, **jkw)
        init, ms = S.flat(js.global_params), jax_state_of(js)
        js.fit(3)
        out[name] = (js, init, ms)
    return out


def _port(route, jax_runs, **kw):
    _, tkw, mode = ROUTES[route]
    js, init, ms = jax_runs["dense" if route in ("pipelined", "chunked") else route]
    return js, S.tsim(tlogic(init, ms), tnorm(), False, mode=mode, **tkw, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_fedbn_matches_jax_and_keeps_the_statistics_local(route, jax_runs):
    js, ts = _port(route, jax_runs)
    S.close_history(js.history, ts.fit(3))
    got = ts.client_states
    S.close_params(S.flat(js.client_states.params), got.params)
    want = jax.device_get(js.client_states.model_state)
    for k, v in _stats(want).items():
        np.testing.assert_allclose(_stats(got.model_state)[k], v, atol=TOL, rtol=TOL)
    # statistics and BN affine differ across clients (not exchanged); the
    # Dense layers were pulled
    stats = torch.cat([v.reshape(v.shape[0], -1) for v in
                       got.model_state["batch_stats"]["BatchNorm_0"].values()], 1)
    assert float((stats - stats[:1]).abs().max()) > 1e-7
    if route != "cohort":  # slots hold the last round's cohort
        assert S.client_spread(got.params, "BatchNorm_0") > 1e-7
    if route in ("pipelined", "chunked"):  # async stacks hold the restart wave
        assert S.client_spread(got.params, "Dense_0") <= 1e-6


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_resume_is_the_straight_run(tmp_path, route, jax_runs):
    """Saved after round 2 of 3 and resumed by a fresh simulation: equal
    to the straight run bit for bit, the statistics included (the cohort's
    from the registry rows)."""
    ckpt = lambda: tstate.SimulationStateCheckpointer(str(tmp_path / "run"))  # noqa: E731
    _, first = _port(route, jax_runs, state_checkpointer=ckpt())
    first.fit(2)
    _, again = _port(route, jax_runs, state_checkpointer=ckpt())
    again.fit(3)
    _, straight = _port(route, jax_runs)
    straight.fit(3)
    assert again._resume_info["next_round"] == 3
    assert [r.fit_losses for r in again.history] == [r.fit_losses for r in straight.history]
    for a, b in zip(ptu.tree_leaves(again.client_states), ptu.tree_leaves(straight.client_states)):
        assert torch.equal(a, b)
    if route == "cohort":
        for a, b in zip(ptu.tree_leaves(again.registry.export_rows()),
                        ptu.tree_leaves(straight.registry.export_rows())):
            assert np.array_equal(a, b)


def _without_model_state(tree):
    """A frame's stored trees as a frame written before ``TrainState`` had
    ``model_state``: the field dropped from the client states and the
    registry rows."""
    if isinstance(tree, dict):
        return {k: _without_model_state(v) for k, v in tree.items() if k != "model_state"}
    return tree


def _drop_model_state_from_newest_frame(directory: str) -> None:
    ck = tstate.SimulationStateCheckpointer(directory)
    path = ck.candidate_paths()[0][1]
    host, meta, blob = tstate.read_frame(path)
    trees = serialization.msgpack_restore(blob)
    assert "model_state" in trees["client_states"]
    tstate.write_frame(path, _without_model_state(trees), host_header=host, meta=meta)


@pytest.mark.parametrize("route", ["pipelined", "cohort", "async"])
def test_a_frame_without_model_state_resumes(tmp_path, route):
    """A stateless model's run resumes from a frame whose client states and
    registry rows lack ``model_state`` (written before the field existed),
    equal to the straight run bit for bit."""
    _, tkw, mode = ROUTES[route]

    def sim(**kw):
        logic = tengine.ClientLogic(tengine.from_module(S._tmlp()), tengine.masked_cross_entropy)
        return S.tsim(logic, None, False, mode=mode, **tkw, **kw)

    ckpt = lambda: tstate.SimulationStateCheckpointer(str(tmp_path / "run"))  # noqa: E731
    sim(state_checkpointer=ckpt()).fit(2)
    _drop_model_state_from_newest_frame(str(tmp_path / "run"))
    again, straight = sim(state_checkpointer=ckpt()), sim()
    again.fit(3)
    straight.fit(3)
    assert again._resume_info["next_round"] == 3 and again.client_states.model_state == {}
    assert [r.fit_losses for r in again.history] == [r.fit_losses for r in straight.history]
    for a, b in zip(ptu.tree_leaves(again.client_states), ptu.tree_leaves(straight.client_states)):
        assert torch.equal(a, b)


def test_a_frame_without_model_state_is_refused_by_a_stateful_model(tmp_path, jax_runs):
    """Such a frame cannot hold statistics: a BatchNorm model's resume from
    it fails ``from_state_dict``'s missing-field check."""
    ckpt = lambda: tstate.SimulationStateCheckpointer(str(tmp_path / "run"))  # noqa: E731
    _port("pipelined", jax_runs, state_checkpointer=ckpt())[1].fit(2)
    _drop_model_state_from_newest_frame(str(tmp_path / "run"))
    with pytest.raises(ValueError, match="Missing field model_state"):
        _port("pipelined", jax_runs, state_checkpointer=ckpt())[1].fit(3)


# -- the frozen feature passes of MOON, PerFCL and Constrained FENDA -----------

class JBnSplit(jbases.nn.Module):
    """``BnMlp``'s BatchNorm stream (decay 0.5: the statistics leave their
    init within a round) beside a plain Dense stream, with the feature keys
    of MOON (``features``) and of the FENDA family."""

    @jbases.nn.compact
    def __call__(self, x, train: bool = True):
        h = jbases.nn.Dense(16)(x)
        h = jbases.nn.relu(jbases.nn.BatchNorm(use_running_average=not train,
                                               momentum=0.5)(h))
        g = jbases.nn.Dense(16)(x)
        pred = jbases.nn.Dense(S.N_CLASSES)(jnp.concatenate([h, g], axis=-1))
        return {"prediction": pred}, {"features": h, "local_features": h,
                                      "global_features": g}


class TBnSplit(nn.Module):
    """JAX's ``JBnSplit``."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = LoraDense(S.DIM, 16, dtype=None)
        self.BatchNorm_0 = BatchNorm(16, momentum=0.5)
        self.Dense_1 = LoraDense(S.DIM, 16, dtype=None)
        self.Dense_2 = LoraDense(32, S.N_CLASSES, dtype=None)

    def init_params(self, generator):
        return _init_params(self, generator)

    def init_state(self, generator):
        return {"batch_stats": {"BatchNorm_0": self.BatchNorm_0.init_stats()}}

    def forward(self, x, train=True, state=None):
        h, stats = self.BatchNorm_0(self.Dense_0(x), state["batch_stats"]["BatchNorm_0"],
                                    not train)
        h, g = F.relu(h), self.Dense_1(x)
        pred = self.Dense_2(torch.cat([h, g], dim=-1))
        return (({"prediction": pred}, {"features": h, "local_features": h,
                                        "global_features": g}),
                {"batch_stats": {"BatchNorm_0": stats}})


SPLIT_LOGICS = {
    "moon": (jmoon.MoonClientLogic, tmoon.MoonClientLogic, dict(contrastive_weight=1.0)),
    "perfcl": (jfenda.PerFclClientLogic, tfenda.PerFclClientLogic,
               dict(global_feature_loss_weight=0.5, local_feature_loss_weight=0.5)),
    "constrained_fenda": (jfenda.ConstrainedFendaClientLogic,
                          tfenda.ConstrainedFendaClientLogic,
                          dict(cos_sim_loss_weight=0.5, contrastive_loss_weight=0.5)),
}


@pytest.mark.parametrize("kind", list(SPLIT_LOGICS))
def test_frozen_feature_passes_read_the_clients_statistics(kind):
    """The feature passes over the global and earlier params run at
    ``train=False`` on ``state.model_state``, as JAX's: 3 rounds against
    JAX at 5e-4, statistics included (MOON exchanges every param, the FENDA
    family the plain stream)."""
    jcls, tcls, kw = SPLIT_LOGICS[kind]
    shared = (lambda path: path.startswith("Dense_1")) if kind != "moon" else None
    js = S.jsim(jcls(jengine.from_flax(JBnSplit()), jengine.masked_cross_entropy, **kw),
                shared and JFixedLayer(shared), False)
    init, ms = S.flat(js.global_params), jax_state_of(js)
    js.fit(3)
    tl = tcls(tengine.from_module(TBnSplit()), tengine.masked_cross_entropy, **kw)
    tl = S.with_init(tl, init)
    tl.model = dataclasses.replace(tl.model,
                                   init_state=lambda g: ptu.tree_map(torch.clone, ms))
    ts = S.tsim(tl, shared and TFixedLayer(shared), False)
    S.close_history(js.history, ts.fit(3))
    S.close_params(S.flat(js.client_states.params), ts.client_states.params)
    for k, v in _stats(jax.device_get(js.client_states.model_state)).items():
        np.testing.assert_allclose(_stats(ts.client_states.model_state)[k], v, atol=TOL,
                                   rtol=TOL)


# -- frames -------------------------------------------------------------------

def _train_states(with_stats: bool):
    """The same TrainState in both packages (numpy leaves): nested params,
    an optimizer state, an empty model state or BatchNorm statistics."""
    params = {"Dense_0": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "bias": np.zeros(3, np.float32)}}
    ms = ({"batch_stats": {"BatchNorm_0": {"mean": np.full(3, 0.25, np.float32),
                                           "var": np.full(3, 1.5, np.float32)}}}
          if with_stats else {})
    kw = dict(params=params, opt_state=({"count": np.array(2, np.int32)},), model_state=ms,
              rng=np.array([0, 7], np.uint32), step=np.array(4, np.int32))
    return jengine.TrainState(**kw), tengine.TrainState(**kw)


@pytest.mark.parametrize("with_stats", [False, True], ids=["empty", "batch_stats"])
def test_frames_are_jax_bytes_and_cross_read(tmp_path, monkeypatch, with_stats):
    jts, tts = _train_states(with_stats)
    monkeypatch.setattr(jstate.time, "time", lambda: 1.5e9)
    monkeypatch.setattr(tstate.time, "time", lambda: 1.5e9)
    host, meta = {"kind": "sync", "current_round": 1}, {"round": 1, "kind": "sync"}
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jstate.write_frame(jp, {"client_states": jts}, host_header=host, meta=meta)
    tstate.write_frame(tp, {"client_states": tts}, host_header=host, meta=meta)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    # each package restores the other's frame into its own TrainState
    from flax import serialization as fser

    jback = fser.from_bytes({"client_states": jts}, jstate.read_frame(tp)[2])
    tback = serialization.from_bytes({"client_states": tts}, tstate.read_frame(jp)[2])
    for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert list(tback["client_states"].model_state) == list(tts.model_state)
    for a, b in zip(ptu.tree_leaves(tback["client_states"].model_state),
                    ptu.tree_leaves(tts.model_state)):
        np.testing.assert_array_equal(a, b)
