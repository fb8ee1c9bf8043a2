"""The port's precision policy (``precision/policy.py`` and the engine's
loss scaling) against the JAX package on the CPU: the cases of
``tests/precision/test_policy.py`` that are not TPU-only, each run through
both packages; ``TinyCifarNet`` and ``MnistNet`` federated runs under bf16
and fp16 against JAX within ``CIFAR_BF16_LOSS_ATOL`` (the tolerance pinned
by ``tests/precision/test_precision_sim.py`` for bf16 against f32); f32
masters; and the reference's defect that the policy does not reach a model
that pins ``dtype=float32``, pinned in both packages."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.instance_level_dp import InstanceLevelDpClientLogic as JDpLogic
from fl4health_tpu.datasets.synthetic import synthetic_classification as jsynth
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import CifarNet as JCifarNet
from fl4health_tpu.models.cnn import MnistNet as JMnistNet
from fl4health_tpu.precision import PrecisionConfig as JPrecision
from fl4health_tpu.precision import policy as jpx
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic as TDpLogic
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import cnn as tcnn
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import LoraDense
from fl4health_tpu_torch.precision import PrecisionConfig as TPrecision
from fl4health_tpu_torch.precision import policy as tpx
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

from tests.precision.conftest import TinyCifarNet as JTinyCifarNet
from tests.precision.conftest import TinyNet as JTinyNet
from tests.precision.conftest import make_cifar_sim as jmake_cifar_sim
from tests.precision.test_precision_sim import CIFAR_BF16_LOSS_ATOL


class TinyNet(torch.nn.Module):
    """tests/precision/conftest.py's TinyNet: Dense(8), relu, Dense(2), every
    layer dtype=None."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = LoraDense(4, 8, dtype=None)
        self.Dense_1 = LoraDense(8, 2, dtype=None)

    def init_params(self, generator):
        return tcnn._init_params(self, generator)

    def forward(self, x):
        return {"prediction": self.Dense_1(F.relu(self.Dense_0(x)))}, {}


class TinyCifarNet(torch.nn.Module):
    """tests/precision/conftest.py's TinyCifarNet: two 3x3 stride-2 SAME
    convs (4 and 8 channels), Dense(32), Dense(10), every layer
    dtype=None."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = tcnn.Conv(3, 4, 3, dtype=None, stride=2)
        self.Conv_1 = tcnn.Conv(4, 8, 3, dtype=None, stride=2)
        self.Dense_0 = LoraDense(8 * 8 * 8, 32, dtype=None)
        self.Dense_1 = LoraDense(32, 10, dtype=None)

    def init_params(self, generator):
        return tcnn._init_params(self, generator)

    def forward(self, x):
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))))
        x = F.relu(self.Dense_0(tcnn._flatten_hwc(x)))
        return {"prediction": self.Dense_1(x)}, {}


def _batch(torch_side: bool):
    x, y = np.ones((4, 4), np.float32), np.zeros((4,), np.int32)
    if torch_side:
        return tengine.Batch(x=torch.tensor(x), y=torch.tensor(y), example_mask=torch.ones(4),
                             step_mask=torch.ones(()))
    return jengine.Batch(x=jnp.asarray(x), y=jnp.asarray(y), example_mask=jnp.ones((4,)),
                         step_mask=jnp.ones(()))


# ---------------------------------------------------------------------------
# The config and the cast helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alias,name", [("bf16", "bfloat16"), ("fp16", "float16"),
                                        ("f32", "float32"), ("bfloat16", "bfloat16"),
                                        (torch.bfloat16, "bfloat16"),
                                        (torch.float16, "float16")])
def test_dtype_aliases_canonicalize(alias, name):
    assert TPrecision(alias).compute_dtype_name == name
    if isinstance(alias, str):
        assert JPrecision(alias).compute_dtype_name == name


@pytest.mark.parametrize("bad", ["int8", torch.float64])
def test_unknown_dtype_rejected(bad):
    with pytest.raises(ValueError, match="compute_dtype"):
        TPrecision(bad)


@pytest.mark.parametrize("kw", [dict(compute_dtype="fp16"), dict(compute_dtype="bf16"),
                                dict(compute_dtype="f32"),
                                dict(compute_dtype="bf16", loss_scale="static")])
def test_loss_scale_resolution_and_describe(kw):
    t, j = TPrecision(**kw), JPrecision(**kw)
    assert t.resolved_loss_scale == j.resolved_loss_scale
    assert (t.active, t.casts_compute, t.scaling_active) == (j.active, j.casts_compute,
                                                             j.scaling_active)
    assert t.describe() == j.describe() == json.loads(json.dumps(t.describe()))
    assert (tpx.resolve(t) is None) == (jpx.resolve(j) is None)


@pytest.mark.parametrize("kw,match", [
    (dict(compute_dtype="f32", loss_scale="dynamic"), "no-op"),
    (dict(compute_dtype="bf16", keep_master_f32=False), "keep_master_f32"),
    (dict(compute_dtype="fp16", growth_factor=1.0), "growth_factor"),
    (dict(compute_dtype="fp16", growth_interval=0), "growth_interval"),
    (dict(compute_dtype="fp16", init_scale=0.0), "positive"),
    (dict(compute_dtype="fp16", loss_scale="sometimes"), "loss_scale"),
])
def test_invalid_configs_rejected_like_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        TPrecision(**kw)
    with pytest.raises(ValueError, match=match):
        JPrecision(**kw)


def test_f32_tolerates_keep_master_false_and_resolves_to_none():
    assert tpx.resolve(TPrecision("f32", keep_master_f32=False)) is None
    assert tpx.resolve(None) is None


def test_cast_floats_leaves_integers_alone():
    tree = {"w": torch.ones(2), "ids": torch.ones(2, dtype=torch.int32),
            "flag": torch.ones(2, dtype=torch.bool)}
    out = tpx.cast_floats(tree, torch.bfloat16)
    assert (out["w"].dtype, out["ids"].dtype, out["flag"].dtype) == (
        torch.bfloat16, torch.int32, torch.bool)


@pytest.mark.parametrize("dtypes", [("bfloat16",) * 3, ("bfloat16", "float32", "float32"),
                                    ("float16", "bfloat16", "float16"),
                                    ("float16",) * 3])
def test_conv_compute_dtype_rule_matches_jax(dtypes):
    got = tpx.conv_compute_dtype(*(getattr(torch, d) for d in dtypes))
    want = jpx.conv_compute_dtype(*(getattr(jnp, d) for d in dtypes))
    assert str(got).split(".")[-1] == jnp.dtype(want).name


def test_wrapped_model_casts_train_only():
    logic = tengine.ClientLogic(tengine.from_module(TinyNet()), tengine.masked_cross_entropy)
    wrapped = tpx.wrap_logic_compute(logic, torch.bfloat16)
    assert type(wrapped) is type(logic) and logic.model is not wrapped.model
    params = wrapped.model.init(torch.Generator().manual_seed(0))
    assert all(v.dtype == torch.float32 for v in params.values())
    x = torch.ones(2, 4)
    assert wrapped.model.apply(params, {}, x, train=True)[0][0]["prediction"].dtype == torch.bfloat16
    assert wrapped.model.apply(params, {}, x, train=False)[0][0]["prediction"].dtype == torch.float32


def test_grads_return_f32_at_master_boundary():
    logic = tengine.ClientLogic(tengine.from_module(TinyNet()), tengine.masked_cross_entropy)
    wrapped = tpx.wrap_logic_compute(logic, torch.bfloat16)
    st = tengine.create_train_state(wrapped, optim.sgd(0.1), rng.PRNGKey(0),
                                    torch.Generator().manual_seed(0), torch.device("cpu"))
    (loss, _), grads = wrapped.value_and_grads(st, None, _batch(True), rng.PRNGKey(2))
    assert {g.dtype for g in grads.values()} == {torch.float32}
    jlogic = jpx.wrap_logic_compute(jengine.ClientLogic(jengine.from_flax(JTinyNet()),
                                                        jengine.masked_cross_entropy),
                                    jnp.bfloat16)
    jst = jengine.create_train_state(jlogic, optax.sgd(0.1), jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4), jnp.float32))
    _, jgrads = jlogic.value_and_grads(jst, None, _batch(False), jax.random.PRNGKey(2))
    assert {str(g.dtype) for g in jax.tree_util.tree_leaves(jgrads)} == {"float32"}


# ---------------------------------------------------------------------------
# The loss-scale state
# ---------------------------------------------------------------------------

LS_CFG = dict(compute_dtype="fp16", init_scale=2.0 ** 10, growth_interval=2)


def _both_steps(cfg: dict, finites: list[float]):
    t, j = TPrecision(**cfg), JPrecision(**cfg)
    tls, jls = tpx.loss_scale_init(t), jpx.loss_scale_init(j)
    for f in finites:
        tls = tpx.loss_scale_step(tls, torch.tensor(f), t)
        jls = jpx.loss_scale_step(jls, jnp.asarray(f, jnp.float32), j)
        assert float(tls["scale"]) == float(jls["scale"])
        assert int(tls["growth"]) == int(jls["growth"])
        assert float(tls["skipped"]) == float(jls["skipped"])
    return tls


def test_loss_scale_init_structure():
    ls = tpx.loss_scale_init(TPrecision(**LS_CFG))
    assert float(ls["scale"]) == 2.0 ** 10 and int(ls["growth"]) == 0
    assert ls["growth"].dtype == torch.int32 and ls["skipped"].dtype == torch.float32
    assert tpx.loss_scale_init(TPrecision("bf16")) is None
    assert tpx.loss_scale_init(None) is None


def test_backoff_on_nonfinite():
    ls = _both_steps(LS_CFG, [0.0])
    assert float(ls["scale"]) == 2.0 ** 9 and float(ls["skipped"]) == 1.0


def test_growth_after_interval():
    ls = _both_steps(LS_CFG, [1.0, 1.0])
    assert float(ls["scale"]) == 2.0 ** 11 and int(ls["growth"]) == 0


def test_scale_clamped():
    cfg = dict(compute_dtype="fp16", init_scale=2.0, min_scale=1.0, growth_interval=1,
               max_scale=4.0)
    assert float(_both_steps(cfg, [1.0] * 5)["scale"]) == 4.0
    assert float(_both_steps(cfg, [1.0] * 5 + [0.0] * 5)["scale"]) == 1.0


def test_static_never_moves_but_counts_skips():
    ls = _both_steps(dict(compute_dtype="fp16", loss_scale="static", init_scale=8.0),
                     [0.0, 1.0, 0.0])
    assert float(ls["scale"]) == 8.0 and float(ls["skipped"]) == 2.0


def test_tree_all_finite():
    tree = {"a": torch.ones(3), "ids": torch.ones(2, dtype=torch.int32)}
    assert float(tpx.tree_all_finite(tree)) == 1.0
    assert float(tpx.tree_all_finite({**tree, "b": torch.tensor([1.0, float("inf")])})) == 0.0


# ---------------------------------------------------------------------------
# The engine step under scaling
# ---------------------------------------------------------------------------

class _OverflowLogic(tengine.ClientLogic):
    """A training loss whose gradient is not finite where ``ctx`` > 0."""

    def training_loss(self, preds, features, batch, params, state, ctx):
        loss, extra = super().training_loss(preds, features, batch, params, state, ctx)
        return loss * torch.where(ctx > 0, torch.tensor(float("inf")), torch.tensor(1.0)), extra


def _state_and_step(precision):
    logic = _OverflowLogic(tengine.from_module(TinyNet()), tengine.masked_cross_entropy)
    st = tengine.create_train_state(logic, optim.sgd(0.1), rng.PRNGKey(0),
                                    torch.Generator().manual_seed(0), torch.device("cpu"),
                                    precision=precision)
    return st, tengine.make_train_step(logic, optim.sgd(0.1), precision=precision)


def test_overflow_step_leaves_master_untouched():
    st, step = _state_and_step(TPrecision("fp16", init_scale=4.0))
    st2, _ = step(st, torch.ones(()), _batch(True))
    for a, b in zip(ptu.tree_leaves((st2.params, st2.opt_state)),
                    ptu.tree_leaves((st.params, st.opt_state))):
        assert torch.equal(a, b)
    assert float(st2.loss_scale["scale"]) == 2.0 and float(st2.loss_scale["skipped"]) == 1.0
    assert int(st2.step) == 0  # a skipped step is not an optimizer step
    assert not torch.equal(st2.rng, st.rng)  # the key still splits


def test_finite_step_moves_params_and_grows():
    st, step = _state_and_step(TPrecision("fp16", init_scale=4.0, growth_interval=1))
    st2, out = step(st, torch.zeros(()), _batch(True))
    assert any(not torch.equal(st2.params[k], st.params[k]) for k in st.params)
    assert float(st2.loss_scale["scale"]) == 8.0 and int(st2.step) == 1
    assert float(out.losses["backward"]) < 10.0  # the true, unscaled loss


def test_scaled_step_equals_unscaled_step_where_exact():
    """A power-of-two scale on a finite step moves the params as the
    unscaled step does: the unscale is exact."""
    st_s, step_s = _state_and_step(TPrecision("bf16", loss_scale="static",
                                              init_scale=2.0 ** 8))
    st_p, step_p = _state_and_step(TPrecision("bf16"))
    a, _ = step_s(st_s, torch.zeros(()), _batch(True))
    b, _ = step_p(st_p, torch.zeros(()), _batch(True))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_scaling_without_state_raises():
    logic = tengine.ClientLogic(tengine.from_module(TinyNet()), tengine.masked_cross_entropy)
    st = tengine.create_train_state(logic, optim.sgd(0.1), rng.PRNGKey(0),
                                    torch.Generator().manual_seed(0), torch.device("cpu"))
    step = tengine.make_train_step(logic, optim.sgd(0.1), precision=TPrecision("fp16"))
    with pytest.raises(ValueError, match="loss scaling needs"):
        step(st, None, _batch(True))


def test_dp_logic_rejected_under_scaling():
    logic = TDpLogic(tengine.from_module(TinyNet()), tengine.masked_cross_entropy,
                     clipping_bound=1.0, noise_multiplier=0.5)
    with pytest.raises(TypeError, match="loss scaling"):
        tengine.make_train_step(logic, optim.sgd(0.1), precision=TPrecision("fp16"))
    jlogic = JDpLogic(jengine.from_flax(JTinyNet()), jengine.masked_cross_entropy,
                      clipping_bound=1.0, noise_multiplier=0.5)
    with pytest.raises(TypeError, match="loss scaling"):
        jengine.make_train_step(jlogic, optax.sgd(0.1), precision=JPrecision("fp16"))
    # bf16 without scaling composes with DP
    tengine.make_train_step(logic, optim.sgd(0.1), precision=TPrecision("bf16"))


# ---------------------------------------------------------------------------
# Federated runs against JAX
# ---------------------------------------------------------------------------

def _port_sim_like(js, module, lr, precision, **kw):
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(module), tengine.masked_cross_entropy),
        tx=optim.sgd(lr), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*(np.asarray(a) for a in (d.x_train, d.y_train,
                                                                d.x_val, d.y_val)))
                  for d in js.datasets],
        metrics=TMetricManager(()), precision=precision, device="cpu", **kw)
    ts.set_global_params(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                      js.global_params)))
    return ts


def _mnist_sims(jprec, tprec):
    datasets = []
    for i in range(4):
        x, y = (np.asarray(a) for a in jsynth(jax.random.PRNGKey(70 + i), 40, (14, 14, 1), 10,
                                               class_sep=1.2))
        datasets.append(jsim.ClientDataset(x[:32], y[:32], x[32:], y[32:]))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMnistNet(hidden=32)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(), datasets=datasets, batch_size=8,
        metrics=JMetricManager(()), local_steps=3, seed=11, precision=jprec,
        execution_mode="pipelined")
    return js, _port_sim_like(js, tcnn.MnistNet(hidden=32, input_shape=(14, 14, 1)), 0.05,
                              tprec, batch_size=8, local_steps=3, seed=11)


def _cifar_sims(jprec, tprec):
    js = jmake_cifar_sim(precision=jprec, execution_mode="pipelined")
    return js, _port_sim_like(js, TinyCifarNet(), 0.05, tprec, batch_size=8, local_steps=2,
                              seed=11)


@pytest.mark.parametrize("model", ["tiny_cifar", "mnist"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_low_precision_runs_match_jax(model, dtype):
    make = _cifar_sims if model == "tiny_cifar" else _mnist_sims
    js, ts = make(JPrecision(dtype), TPrecision(dtype))
    jhist, thist = js.fit(4), ts.fit(4)
    for tr, jr in zip(thist, jhist, strict=True):
        for got, want in ((tr.fit_losses["backward"], jr.fit_losses["backward"]),
                          (tr.eval_losses["checkpoint"], jr.eval_losses["checkpoint"])):
            assert np.isfinite(got) and abs(got - want) < CIFAR_BF16_LOSS_ATOL, (tr.round,
                                                                                 got, want)
    assert thist[-1].fit_losses["backward"] < thist[0].fit_losses["backward"]
    # the masters stay f32: params, optimizer state and the server's copy
    for leaf in ptu.tree_leaves((ts.client_states.params, ts.client_states.opt_state,
                                 ts.global_params)):
        assert leaf.dtype == torch.float32
    if dtype == "fp16":
        ls = ts.client_states.loss_scale
        assert ls["scale"].dtype == torch.float32 and ls["scale"].shape == (4,)
        np.testing.assert_array_equal(ls["skipped"].numpy(),
                                      np.asarray(js.client_states.loss_scale["skipped"]))
    else:
        assert ts.client_states.loss_scale is None


@pytest.mark.parametrize("precision", [None, "f32"])
def test_precision_off_is_bit_identical(precision):
    js = jmake_cifar_sim(execution_mode="pipelined")
    base = _port_sim_like(js, TinyCifarNet(), 0.05, None, batch_size=8, local_steps=2,
                          seed=11).fit(2)
    off = _port_sim_like(js, TinyCifarNet(), 0.05,
                         TPrecision(precision) if precision else None, batch_size=8,
                         local_steps=2, seed=11).fit(2)
    assert [r.fit_losses for r in base] == [r.fit_losses for r in off]


def test_duck_typed_config_rejected():
    js = jmake_cifar_sim(execution_mode="pipelined")
    with pytest.raises(TypeError, match="PrecisionConfig"):
        _port_sim_like(js, TinyCifarNet(), 0.05, {"compute_dtype": "bfloat16"},
                       batch_size=8, local_steps=2, seed=11)


# ---------------------------------------------------------------------------
# Reference defect: the policy does not reach a model that pins f32
# ---------------------------------------------------------------------------

def _jax_op_dtypes(module, x) -> set:
    """The input dtypes of every conv and dot in the train-call jaxpr of
    ``module`` under the bf16 cast."""
    model = jpx.cast_model_def(jengine.from_flax(module), jnp.bfloat16)
    params, mstate = jengine.from_flax(module).init(jax.random.PRNGKey(0), x)
    jaxpr = jax.make_jaxpr(lambda p: model.apply(p, mstate, x, train=True)[0][0]
                           ["prediction"])(params)
    return {str(v.aval.dtype) for eqn in jaxpr.jaxpr.eqns
            if eqn.primitive.name in ("conv_general_dilated", "dot_general")
            for v in eqn.invars}


class _OpDtypes(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.conv2d, torch.matmul, torch.Tensor.__matmul__):
            self.dtypes.update(str(a.dtype).split(".")[-1] for a in args[:2]
                               if isinstance(a, torch.Tensor))
        return func(*args, **(kwargs or {}))


def _port_op_dtypes(module, x) -> set:
    model = tpx.cast_model_def(tengine.from_module(module), torch.bfloat16)
    params = module.init_params(torch.Generator().manual_seed(0))
    with _OpDtypes() as mode:
        model.apply(params, {}, x, train=True)
    return mode.dtypes


def test_policy_does_not_reach_a_pinned_f32_model():
    """Reference defect, pinned in both packages: ``CifarNet(dtype=float32)``
    casts its input back to f32 and its layers compute in their pinned
    dtype, so under the bf16 policy every conv and matmul of its train call
    runs in f32; ``MnistNet`` (``dtype=None``) computes in bf16. When the
    defect is fixed in both packages (the models' dtype defaulting to
    None), this test flips."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    assert _jax_op_dtypes(JCifarNet(), jnp.asarray(x)) == {"float32"}
    assert _port_op_dtypes(tcnn.CifarNet(), torch.tensor(x)) == {"float32"}
    xm = x[:, :28, :28, :1]
    assert _jax_op_dtypes(JMnistNet(), jnp.asarray(xm)) == {"bfloat16"}
    assert _port_op_dtypes(tcnn.MnistNet(), torch.tensor(xm)) == {"bfloat16"}
    xc = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    assert _jax_op_dtypes(JTinyCifarNet(), jnp.asarray(xc)) == {"bfloat16"}
    assert _port_op_dtypes(TinyCifarNet(), torch.tensor(xc)) == {"bfloat16"}


def test_strided_same_conv_matches_flax():
    """The stride-2 SAME padding of TinyCifarNet's convs (the odd row and
    column at the end, as flax pads)."""
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = JTinyCifarNet()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = TinyCifarNet()
    named = {k.replace("/", "."): v for k, v in convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    got = torch.func.functional_call(tm, named, (torch.tensor(x),))[0]["prediction"]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
