"""FedPM in the port against the JAX package: the masked layers of
``models/masked.py`` against flax's from converted variables (train calls
with their mask draws, eval calls with the expectation), ``bernoulli_ste``'s
draws and straight-through gradient, ``sample_masks`` bit for bit, the
strategy's Beta posterior (``tests/strategies/test_strategies.py``'s cases
and ``reset_frequency``), ``tests/clients/test_fedpm_simclr.py``'s
end-to-end run on both routes, and ``FedPmServer``'s pairing check.

The port's ``sigmoid`` and XLA's ``logistic`` differ by an ulp on a
fraction of inputs; a mask bit flips only where a uniform draw falls
between the two probabilities. ``test_mask_bit_flips_are_counted`` counts
the flips over a million draws and holds them to the bound below."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients import fedpm as jfedpm
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import masked as jm
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.fedpm import FedPm as JFedPm
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import fedpm as tfedpm
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models import masked as tm
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedpm import FedPm as TFedPm

TOL = 5e-4
# sigmoid's 1-ulp departures flip a mask bit only where u lands between the
# two probabilities: about 2^-24 of a departing element's draws
MAX_FLIPS_PER_MILLION = 2


# -- the layers ---------------------------------------------------------------

class _Wrap(fnn.Module):
    """A masked layer as the child ``layer`` (scope path ``("layer",)``),
    batch norm with its running average on eval calls."""

    layer: fnn.Module

    def __call__(self, x, train: bool = True):
        if isinstance(self.layer, jm.MaskedBatchNorm):
            return self.layer(x, use_running_average=not train)
        return self.layer(x)


LAYERS = {
    "dense": (lambda: jm.MaskedDense(5), lambda: tm.MaskedDense(4, 5), (6, 4)),
    "conv2d": (lambda: jm.MaskedConv(3, (3, 3)), lambda: tm.MaskedConv(2, 3, (3, 3)),
               (2, 5, 5, 2)),
    "conv1d_strided": (lambda: jm.MaskedConv(3, (3,), strides=(2,)),
                       lambda: tm.MaskedConv(2, 3, (3,), strides=(2,)), (2, 7, 2)),
    "conv_transpose": (lambda: jm.MaskedConvTranspose(3, (3, 3), strides=(2, 2)),
                       lambda: tm.MaskedConvTranspose(2, 3, (3, 3), strides=(2, 2)),
                       (2, 4, 4, 2)),
    "layer_norm": (lambda: jm.MaskedLayerNorm(), lambda: tm.MaskedLayerNorm(6), (4, 6)),
    "batch_norm": (lambda: jm.MaskedBatchNorm(), lambda: tm.MaskedBatchNorm(6), (8, 6)),
}


def _layer_pair(kind):
    jmake, tmake, shape = LAYERS[kind]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jmod = _Wrap(jmake())
    variables = jax.device_get(jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                         train=False))
    layer = tmake()
    layer.path = ("layer",)
    params = {k.split("/", 1)[1]: v
              for k, v in convert.flax_to_torch(variables["params"]).items()}
    state = convert.flax_state_to_torch({k: v for k, v in variables.items() if k != "params"})
    return jmod, variables, layer, params, state, x


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", list(LAYERS))
def test_masked_layer_matches_flax(kind, train):
    jmod, variables, layer, params, state, x = _layer_pair(kind)
    key = 5
    rngs = {"mask": jax.random.fold_in(jax.random.PRNGKey(key), 1)} if train else {}
    mutable = ["batch_stats"] if train and kind == "batch_norm" else False
    out = jmod.apply(variables, jnp.asarray(x), train=train, rngs=rngs, mutable=mutable)
    jy, jstate = out if mutable else (out, None)
    mask_rng = trng.fold_in(trng.PRNGKey(key), 1) if train else None
    frozen = state["frozen"]["layer"]
    args = (torch.tensor(x), frozen)
    if kind == "batch_norm":
        ty, tstats = torch.func.functional_call(
            layer, params, args, {"stats": state["batch_stats"]["layer"],
                                  "mask_rng": mask_rng, "use_running_average": not train})
        if train:
            for k, v in jax.device_get(jstate)["batch_stats"]["layer"].items():
                np.testing.assert_allclose(tstats[k].numpy(), np.asarray(v), atol=1e-6)
    else:
        ty = torch.func.functional_call(layer, params, args, {"mask_rng": mask_rng})
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_masked_model_step_matches_flax(model):
    """A train step of ``MaskedMlp`` / ``MaskedCnn`` through both engines
    from the converted init: the mask draws of ``fold_in(step_rng, 1)``
    per layer scope, the straight-through gradient and the frozen state."""
    if model == "mlp":
        jmod, tmod, shape = jm.MaskedMlp(features=(16,), n_outputs=3), tm.MaskedMlp(8, (16,), 3), (6, 8)
    else:
        jmod, tmod, shape = (jm.MaskedCnn(channels=(4,), n_outputs=3),
                             tm.MaskedCnn((4,), 3, input_shape=(6, 6, 1)), (6, 6, 6, 1))
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=shape).astype(np.float32), rng.integers(0, 3, size=6)
    jlogic = jengine.ClientLogic(jengine.from_flax(jmod), jengine.masked_cross_entropy)
    jst = jengine.create_train_state(jlogic, optax.sgd(0.5), jax.random.PRNGKey(3), x[:1])
    params = convert.flax_to_torch(jax.device_get(jst.params))
    ms = convert.flax_state_to_torch(jax.device_get(jst.model_state))
    tlogic = tengine.ClientLogic(tengine.from_module(tmod), tengine.masked_cross_entropy)
    tlogic.model = dataclasses.replace(tlogic.model, init=lambda g: dict(params),
                                       init_state=lambda g: ms)
    tst = tengine.create_train_state(tlogic, optim.sgd(0.5), trng.PRNGKey(3),
                                     torch.Generator(), torch.device("cpu"))
    mask = np.ones(6, np.float32)
    jnew, jout = jengine.make_train_step(jlogic, optax.sgd(0.5))(
        jst, None, jengine.Batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                 jnp.asarray(1.0)))
    tnew, tout = tengine.make_train_step(tlogic, optim.sgd(0.5))(
        tst, None, tengine.Batch(torch.tensor(x), torch.tensor(y), torch.tensor(mask),
                                 torch.tensor(1.0)))
    np.testing.assert_allclose(float(tout.losses["backward"]),
                               float(jout.losses["backward"]), atol=TOL)
    for k, v in convert.flax_to_torch(jax.device_get(jnew.params)).items():
        np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(), atol=TOL, err_msg=k)
    # the frozen collection is handed back, never written (no select either)
    assert all(a is b for a, b in zip(ptu.tree_leaves(tnew.model_state),
                                      ptu.tree_leaves(tst.model_state)))


def test_transplant_dense_weights_matches_jax():
    frozen = {"MaskedDense_0": {"kernel": np.zeros((4, 3), np.float32),
                                "bias": np.zeros(3, np.float32)},
              "MaskedDense_1": {"kernel": np.zeros((3, 2), np.float32)}}
    dense = {"Dense_0": {"kernel": np.full((4, 3), 2.0, np.float32),
                         "bias": np.ones(3, np.float32)},
             "Dense_1": {"kernel": np.ones((5, 2), np.float32)}}  # shape differs: kept
    want = jax.device_get(jm.transplant_dense_weights(dense, frozen))
    got = tm.transplant_dense_weights(convert.flax_to_torch(dense),
                                      convert.flax_state_to_torch(frozen))
    for mod, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(got[mod][k]), np.asarray(v))


# -- the draws ----------------------------------------------------------------

def test_the_frozen_weights_are_drawn_from_the_generator():
    """``create_train_state`` draws the frozen weights from the run's
    generator after the params, as JAX draws the ``frozen`` collection from
    the seed's init key: one seed repeats them, another does not."""
    logic = tfedpm.FedPmClientLogic(tengine.from_module(tm.MaskedMlp(8, (16,), 3)),
                                    tengine.masked_cross_entropy)

    def frozen(seed):
        return tengine.create_train_state(
            logic, optim.sgd(0.1), trng.PRNGKey(0), torch.Generator().manual_seed(seed),
            torch.device("cpu")).model_state["frozen"]

    a, b, c = frozen(1), frozen(1), frozen(2)
    assert all(torch.equal(x, y) for x, y in zip(ptu.tree_leaves(a), ptu.tree_leaves(b)))
    for layer in a:  # the kernels (the biases start at zero)
        assert not torch.equal(a[layer]["kernel"], c[layer]["kernel"])


def test_bernoulli_ste_draws_and_straight_through_gradient():
    probs = np.random.default_rng(3).uniform(size=(64, 33)).astype(np.float32)
    g = np.random.default_rng(4).normal(size=probs.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jdraw, jvjp = jax.vjp(lambda p: jm.bernoulli_ste(p, key), jnp.asarray(probs))
    tp = torch.tensor(probs, requires_grad=True)
    tdraw = tm.bernoulli_ste(tp, trng.PRNGKey(9))
    tdraw.backward(torch.tensor(g))
    np.testing.assert_array_equal(tdraw.detach().numpy(), np.asarray(jdraw))
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]))
    # under the client vmap and vmap(grad), one key a client
    keys = torch.stack([trng.PRNGKey(9), trng.PRNGKey(10)])
    stacked = torch.func.vmap(tm.bernoulli_ste, in_dims=(None, 0))(torch.tensor(probs), keys)
    np.testing.assert_array_equal(stacked[0].numpy(), np.asarray(jdraw))
    grads = torch.func.vmap(torch.func.grad(
        lambda p, k: (tm.bernoulli_ste(p, k) * torch.tensor(g)).sum()),
        in_dims=(None, 0))(torch.tensor(probs), keys)
    np.testing.assert_array_equal(grads[1].numpy(), probs * g)


def test_sample_masks_bit_for_bit():
    scores = {"a": np.asarray([-10.0, 10.0, 0.0], np.float32),
              "b": {"kernel": np.random.default_rng(5).normal(size=(40, 30)).astype(np.float32)}}
    want = jax.device_get(jfedpm.sample_masks(scores, jax.random.PRNGKey(0)))
    got = tfedpm.sample_masks(convert.flax_to_torch(scores), trng.PRNGKey(0))
    for k, v in convert.flax_to_torch(want).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    assert got["a"].tolist() == [0.0, 1.0, got["a"][2].item()]


def test_mask_bit_flips_are_counted():
    """Scores drawn wide, a million uniform draws: the masks from the
    port's sigmoid against XLA's logistic."""
    scores = np.random.default_rng(6).normal(scale=3.0, size=(1000, 1000)).astype(np.float32)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), scores.shape))
    jp = np.asarray(jax.nn.sigmoid(jnp.asarray(scores)))
    tp = torch.sigmoid(torch.tensor(scores)).numpy()
    departing = float((jp != tp).mean())
    flips = int(((u < jp) != (u < tp)).sum())
    assert departing < 0.01 and np.abs(jp - tp).max() <= 2.0 ** -23
    assert flips <= MAX_FLIPS_PER_MILLION


# -- the strategy ---------------------------------------------------------------

def _results(pkg, masks, mask=None):
    n = next(iter(masks.values())).shape[0]
    m = np.ones(n, np.float32) if mask is None else mask
    if pkg == "jax":
        return JFitResults(packets={k: jnp.asarray(v) for k, v in masks.items()},
                           sample_counts=jnp.ones(n), train_losses={}, train_metrics={},
                           mask=jnp.asarray(m))
    return TFitResults(packets={k: torch.tensor(v) for k, v in masks.items()},
                       sample_counts=torch.ones(n), train_losses={}, train_metrics={},
                       mask=torch.tensor(m))


@pytest.mark.parametrize("reset", [None, 1, 2])
def test_fedpm_aggregate_matches_jax(reset):
    """test_strategies.py's posterior case ([1, 1/3]) and its reset, then
    three more rounds over a masked-out client, against JAX's state."""
    rng = np.random.default_rng(7)
    js, ts = JFedPm(reset_frequency=reset), TFedPm(reset_frequency=reset)
    jstate = js.init({"w": jnp.full((2,), 0.5)})
    tstate = ts.init({"w": torch.full((2,), 0.5)})
    rounds = [{"w": np.asarray([[1.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)}]
    rounds += [{"w": rng.integers(0, 2, size=(3, 2)).astype(np.float32)} for _ in range(3)]
    for r, masks in enumerate(rounds, start=1):
        m = None if r == 1 else np.asarray([1.0, 0.0, 1.0], np.float32)
        jstate = js.aggregate(jstate, _results("jax", masks, m), r)
        tstate = ts.aggregate(tstate, _results("port", masks, m), r)
        for field in ("params", "alpha", "beta"):
            np.testing.assert_array_equal(getattr(tstate, field)["w"].numpy(),
                                          np.asarray(getattr(jstate, field)["w"]))
        assert int(tstate.rounds_since_reset) == int(jstate.rounds_since_reset)
        if r == 1 and reset is None:
            np.testing.assert_allclose(tstate.params["w"].numpy(), [1.0, 1 / 3], rtol=1e-5)


# -- end to end -------------------------------------------------------------------

def _arrays():
    out = []
    for i in range(2):
        x, y = synthetic_classification(jax.random.PRNGKey(i), 40, (8,), 3)
        x, y = np.asarray(x), np.asarray(y)
        out.append((x[:24], y[:24], x[24:], y[24:]))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """test_fedpm_end_to_end: MaskedMlp(16) over 2 clients, Adam 0.01,
    FedPm(reset_frequency=2), one local epoch, seed 5, 3 rounds."""
    js = jsim.FederatedSimulation(
        logic=jfedpm.FedPmClientLogic(jengine.from_flax(jm.MaskedMlp(features=(16,),
                                                                     n_outputs=3)),
                                      jengine.masked_cross_entropy),
        tx=optax.adam(0.01), strategy=JFedPm(reset_frequency=2),
        datasets=[jsim.ClientDataset(*a) for a in _arrays()], batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=5)
    init = convert.flax_to_torch(jax.device_get(js.global_params))
    ms = convert.flax_state_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[0], jax.device_get(js.client_states.model_state)))
    js.fit(3)
    return js, init, ms


def _port_sim(init, ms, mode):
    logic = tfedpm.FedPmClientLogic(tengine.from_module(tm.MaskedMlp(8, (16,), 3)),
                                    tengine.masked_cross_entropy)
    logic.model = dataclasses.replace(
        logic.model, init=lambda g: {k: v.clone() for k, v in init.items()},
        init_state=lambda g: ms)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.adam(0.01), strategy=TFedPm(reset_frequency=2),
        datasets=[tsim.ClientDataset(*a) for a in _arrays()], batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=5,
        execution_mode=mode, device="cpu")


@pytest.mark.parametrize("mode", ["pipelined", "chunked"])
def test_fedpm_end_to_end_matches_jax(jax_run, mode):
    js, init, ms = jax_run
    ts = _port_sim(init, ms, mode)
    hist = ts.fit(3)
    for j, t in zip(js.history, hist):
        for field in ("fit_losses", "eval_losses", "eval_metrics"):
            for k, v in getattr(j, field).items():
                np.testing.assert_allclose(getattr(t, field)[k], v, atol=TOL, err_msg=k)
    for field in ("params", "alpha", "beta"):
        want = convert.flax_to_torch(jax.device_get(getattr(js.server_state, field)))
        for k, v in want.items():
            np.testing.assert_allclose(getattr(ts.server_state, field)[k].numpy(),
                                       v.numpy(), atol=TOL, err_msg=f"{field} {k}")
    theta = torch.cat([v.reshape(-1) for v in ts.server_state.params.values()])
    assert float(theta.min()) >= 0.0 and float(theta.max()) <= 1.0
    # after the reset at round 2, alpha + beta - 2 counts round 3's clients
    for k, a in ts.server_state.alpha.items():
        assert torch.equal(a + ts.server_state.beta[k] - 2.0, torch.full_like(a, 2.0))


def test_fedpm_server_asserts_the_pairing(jax_run):
    from fl4health_tpu_torch.server.servers import FedPmServer
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    _, init, ms = jax_run
    sim = _port_sim(init, ms, "pipelined")
    assert FedPmServer(sim).sim is sim
    sim.strategy = FedAvg()
    with pytest.raises(AssertionError, match="FedPmServer requires the FedPm strategy"):
        FedPmServer(sim)
