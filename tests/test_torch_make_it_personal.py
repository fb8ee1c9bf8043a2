"""``make_it_personal`` and the engine's step hooks in the port
(``clients/personalized.py``, ``clients/engine.py``) against the JAX package
on the CPU, on JAX's fixture (``tests/torch_pfl_sims.py``):

- JAX's three cases (``tests/clients/test_make_it_personal.py``): Ditto
  over MOON, MR-MTL over a plain logic against ``MrMtlClientLogic``, and
  adaptive Ditto packing the global loss; each round's losses, the
  clients' params and the server's drift weight within 5e-4 of JAX's, and
  JAX's assertions on the port's runs;
- the wrapper's refusals, word for word as JAX's;
- the hooks: ``update_before_step`` runs before the step's key split and
  its changes are selected back on a padding step, ``update_after_step``
  runs unmasked after the optimizer with the step's predictions, in both
  packages alike; a padding step moves neither a hook's state nor APFL's
  alpha; the default hooks leave a run bit for bit as it was.

Tolerance: 5e-4 for runs (f32, the reference's), 1e-6 for one step."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients import personalized as jpers
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDp
from fl4health_tpu.clients.moon import MoonClientLogic as JMoon
from fl4health_tpu.exchange.exchanger import FixedLayerExchanger as JFixedLayer
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import bases as jbases
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.strategies.fedprox import FedAvgWithAdaptiveConstraint as JAdaptive
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import personalized as tpers
from fl4health_tpu_torch.clients.ditto import MrMtlClientLogic as TMrMtl
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDp
from fl4health_tpu_torch.clients.moon import MoonClientLogic as TMoon
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger as TFixedLayer
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import bases as tbases
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint as TAdaptive
from torch_pfl_sims import (DIM, HIDDEN, N_CLASSES, arrays, batch_stack, client_spread,
                            close_history, close_params, flat, jsim, recipe, step_states,
                            tsim, with_init)

STEP_TOL = 1e-6


def _plain(pkg):
    if pkg == "jax":
        return jengine.ClientLogic(jengine.from_flax(JMlp(features=(HIDDEN,),
                                                          n_outputs=N_CLASSES)),
                                   jengine.masked_cross_entropy)
    return tengine.ClientLogic(tengine.from_module(TMlp(DIM, (HIDDEN,), N_CLASSES)),
                               tengine.masked_cross_entropy)


def _moon(pkg):
    if pkg == "jax":
        model = jbases.MoonModel(base_module=jbases.DenseFeatures((HIDDEN,)),
                                 head_module=jbases.DenseHead(N_CLASSES))
        return JMoon(jengine.from_flax(model), jengine.masked_cross_entropy,
                     contrastive_weight=1.0, buffer_len=1)
    model = tbases.MoonModel(tbases.DenseFeatures(DIM, (HIDDEN,)),
                             tbases.DenseHead(HIDDEN, N_CLASSES))
    return TMoon(tengine.from_module(model), tengine.masked_cross_entropy,
                 contrastive_weight=1.0, buffer_len=1)


def _run_pair(jlogic, tlogic, jexch, texch, jstrategy=None, tstrategy=None, rounds=3):
    js = jsim(jlogic, jexch, False, strategy=jstrategy)
    init = flat(js.global_params)
    jhist = js.fit(rounds)
    ts = tsim(with_init(tlogic, init), texch, False, strategy=tstrategy)
    thist = ts.fit(rounds)
    close_history(jhist, thist)
    close_params(flat(js.client_states.params), ts.client_states.params)
    close_params(flat(js.global_params), ts.global_params)
    return js, ts, thist


def test_ditto_personalized_moon_matches_jax():
    """The reference's flagship combination, make_it_personal(MOON, DITTO)."""
    jlogic = jpers.make_it_personal(_moon("jax"), jpers.PersonalizedMode.DITTO, lam=0.5)
    tlogic = tpers.make_it_personal(_moon("port"), tpers.PersonalizedMode.DITTO, lam=0.5)
    assert tlogic.extra_loss_keys == jlogic.extra_loss_keys
    _, ts, hist = _run_pair(jlogic, tlogic, JFixedLayer(jpers.exchange_global_subtree),
                            TFixedLayer(tpers.exchange_global_subtree))
    # MOON survives the wrapping: no contrastive term until the buffer
    # holds a model; Ditto's penalty is finite and the run learns
    assert hist[0].fit_losses["personal_contrastive"] == 0.0
    assert hist[1].fit_losses["personal_contrastive"] > 0.0
    assert np.isfinite(hist[-1].fit_losses["penalty"])
    assert hist[-1].eval_losses["checkpoint"] < hist[0].eval_losses["checkpoint"]
    params = ts.client_states.params
    assert client_spread(params, "personal_model/") > 1e-6
    assert client_spread(params, "global_model/") == 0.0
    # the base's extra (MOON's buffer) holds the personal copy's params
    assert set(ts.client_states.extra.old_params) == {
        k[len("personal_model/"):] for k in params if k.startswith("personal_model/")}


def test_mr_mtl_personalized_plain_matches_mr_mtl_logic_and_jax():
    """Wrapping a plain logic with MR_MTL is MrMtlClientLogic (the same
    math under other loss-key names), in the port as in JAX."""
    jlogic = jpers.make_it_personal(_plain("jax"), jpers.PersonalizedMode.MR_MTL, lam=0.5)
    tlogic = tpers.make_it_personal(_plain("port"), tpers.PersonalizedMode.MR_MTL, lam=0.5)
    _, wrapped, hist_w = _run_pair(jlogic, tlogic, jpers.KeepLocalExchanger(),
                                   tpers.KeepLocalExchanger())
    direct = tsim(with_init(TMrMtl(_plain("port").model, tengine.masked_cross_entropy,
                                   lam=0.5), wrapped.logic.model.init(None)),
                  tpers.KeepLocalExchanger(), False)
    hist_d = direct.fit(3)
    for w, d in zip(hist_w, hist_d, strict=True):
        np.testing.assert_allclose(w.eval_losses["checkpoint"], d.eval_losses["checkpoint"],
                                   rtol=1e-6)
        np.testing.assert_allclose(w.fit_losses["penalty"], d.fit_losses["penalty"], rtol=1e-6)
        np.testing.assert_allclose(w.fit_losses["base_loss"], d.fit_losses["vanilla"],
                                   rtol=1e-6)


def test_ditto_personalized_adaptive_packs_the_global_loss_as_jax():
    jlogic = jpers.make_it_personal(_plain("jax"), jpers.PersonalizedMode.DITTO, adaptive=True)
    tlogic = tpers.make_it_personal(_plain("port"), tpers.PersonalizedMode.DITTO, adaptive=True)
    js, ts, _ = _run_pair(jlogic, tlogic, JFixedLayer(jpers.exchange_global_subtree),
                          TFixedLayer(tpers.exchange_global_subtree),
                          JAdaptive(initial_drift_penalty_weight=0.3),
                          TAdaptive(initial_drift_penalty_weight=0.3))
    got = float(ts.server_state.drift_penalty_weight)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(js.server_state.drift_penalty_weight), atol=1e-6)


def _error(build):
    with pytest.raises(Exception) as info:
        build()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", ["dp_base", "predict_override", "unknown_mode"])
def test_the_wrapper_refuses_as_jax(case):
    def build(pkg):
        jax_side = pkg == "jax"
        pers = jpers if jax_side else tpers
        mode = pers.PersonalizedMode.DITTO
        if case == "dp_base":
            base = _plain(pkg)
            cls = JDp if jax_side else TDp
            base = cls(base.model, base.criterion, clipping_bound=1.0, noise_multiplier=1.0)
        elif case == "predict_override":
            base = recipe("apfl")[0 if jax_side else 2]
        else:
            base, mode = _plain(pkg), "ditto"
        return lambda: pers.make_it_personal(base, mode)

    assert _error(build("port")) == _error(build("jax"))


# -- the engine's step hooks ------------------------------------------------

class _Hooked:
    """A logic whose hooks leave marks in ``extra``: ``before`` counts the
    hook's runs and ``key`` sums the low word of the key the step splits
    next (mod 1000), ``after`` sums the step's mean prediction."""

    def init_extra(self, params):
        zero = self.xp.zeros(())
        return {"before": zero, "key": zero, "after": zero}

    def _with(self, state, **extra):
        extra = {**state.extra, **{k: state.extra[k] + v for k, v in extra.items()}}
        return self.replace(state, extra=extra)

    def update_before_step(self, state, ctx, batch):
        return self._with(state, before=1.0, key=self.low_word(state.rng))

    def update_after_step(self, state, ctx, batch, preds=None):
        return self._with(state, after=preds["prediction"].mean())


class JHooked(_Hooked, jengine.ClientLogic):
    xp = jnp

    @staticmethod
    def replace(state, **kw):
        return state.replace(**kw)

    @staticmethod
    def low_word(key):
        return (key[1] % 1000).astype(jnp.float32)


class THooked(_Hooked, tengine.ClientLogic):
    xp = torch

    @staticmethod
    def replace(state, **kw):
        return dataclasses.replace(state, **kw)

    @staticmethod
    def low_word(key):
        return (key[1] % 1000).float()


MASKS = [1.0, 0.0, 1.0, 0.0]


def test_the_hooks_run_in_jax_order_and_padding_steps_select_back_before_step():
    jlogic = JHooked(_plain("jax").model, jengine.masked_cross_entropy)
    tlogic = THooked(_plain("port").model, tengine.masked_cross_entropy)
    jstate, tstate = step_states(jlogic, tlogic)
    jtrain = jax.jit(jengine.make_local_train(jlogic, optax.sgd(0.05), JMetricManager(())))
    ttrain = tengine.make_local_train(tlogic, optim.sgd(0.05), TMetricManager(()))
    jout, tout = jtrain(jstate, None, batch_stack("jax", MASKS)), ttrain(tstate, None,
                                                                   batch_stack("port", MASKS))
    jex, tex = jout[0].extra, tout[0].extra
    # before: counted on the 2 real steps only; after: on all 4
    assert float(tex["before"]) == float(jex["before"]) == 2.0
    for k in ("key", "after"):
        np.testing.assert_allclose(float(tex[k]), float(jex[k]), rtol=0, atol=STEP_TOL,
                                   err_msg=k)
    close_params(flat(jout[0].params), tout[0].params, STEP_TOL)
    assert tout[0].rng.tolist() == np.asarray(jout[0].rng).tolist()


def test_a_padding_step_does_not_move_apfl_s_alpha():
    *_, tlogic, _, _ = recipe("apfl")
    x, y = arrays()[0][:2]
    state = tengine.create_train_state(tlogic, optim.sgd(0.05), trng.PRNGKey(4, "cpu"),
                                       torch.Generator().manual_seed(0), torch.device("cpu"))
    step = tengine.make_train_step(tlogic, optim.sgd(0.05))
    batch = tengine.Batch(x=torch.tensor(x[:8]), y=torch.tensor(y[:8]),
                          example_mask=torch.ones(8), step_mask=torch.tensor(1.0))
    moved, _ = step(state, None, batch)
    padded, _ = step(state, None, dataclasses.replace(batch, step_mask=torch.tensor(0.0)))
    assert float(moved.extra.alpha) != 0.5
    assert torch.equal(padded.extra.alpha, state.extra.alpha)
    for k in state.params:
        assert torch.equal(padded.params[k], state.params[k])


def test_the_default_hooks_add_no_select_to_a_step():
    """A leaf a hook hands back as it was is not selected: the default
    hooks return the state itself, so a step's state is the same tensors
    whatever the hooks."""
    logic = _plain("port")
    state = tengine.create_train_state(logic, optim.sgd(0.05), trng.PRNGKey(4, "cpu"),
                                       torch.Generator().manual_seed(0), torch.device("cpu"))
    batch = ptu.tree_map(lambda a: a[0], batch_stack("port", [0.0]))
    assert tengine._mask_changed(logic.update_before_step(state, None, batch), state,
                                 batch.step_mask) == state
    seen = []
    base = tengine.make_train_step(logic, optim.sgd(0.05))
    logic.update_before_step = lambda s, c, b: seen.append(s) or s
    stepped, _ = tengine.make_train_step(logic, optim.sgd(0.05))(state, None, batch)
    assert seen[0] is state
    want, _ = base(state, None, batch)
    for a, b in zip(ptu.tree_leaves(stepped), ptu.tree_leaves(want), strict=True):
        assert torch.equal(a, b)
