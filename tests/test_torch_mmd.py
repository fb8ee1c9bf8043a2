"""The MMD losses and clients in the port (``losses/mmd.py``,
``clients/mmd.py``) against the JAX package on the CPU.

- every MK-MMD statistic (full, linear, normalised, masked) at the
  reference's 1e-5, ``optimize_betas``' three branches (the QP, the
  maximising vertex, no positive ``hat_d``) at its 1e-3
  (``tests/losses/test_mmd.py``);
- the deep-kernel MMD from JAX's converted state: the value at 1e-5, the
  variance against its f64 value, the kernel's training steps in f64 (JAX
  under x64) to 1e-6 of their size, ``rng.permutation`` under the client
  vmap bit for bit;
- the four client logics on JAX's recipe (``tests/clients/
  test_mmd_clients.py``: 2 clients of 24 train and 16 val rows, ``Mlp(12)``,
  SGD 0.05, batch 8, one local epoch, seed 3) from JAX's converted init:
  each round's losses (every key), the eval losses and the kept state at
  5e-4 on the pipelined route, the chunked route bit for bit the
  pipelined one.

The deep kernel's t-statistic divides by a variance that is a difference
of two nearly equal f32 sums: its f32 gradient sits up to a few percent
from the f64 one in either package, and adamw turns an entry's flipped
sign into an lr-sized step, so f32 kernel training is held to JAX's own
one-ulp spread and the arithmetic in f64 (ROADMAP C)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients import mmd as jmmd
from fl4health_tpu.clients.ditto import KeepLocalExchanger as JKeepLocal
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.exchange.exchanger import FixedLayerExchanger as JFixedLayer
from fl4health_tpu.losses import mmd as J
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import bases as jbases
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import mmd as tmmd
from fl4health_tpu_torch.clients.ditto import KeepLocalExchanger as TKeepLocal
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger as TFixedLayer
from fl4health_tpu_torch.losses import mmd as T
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import bases as tbases
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

TOL = 5e-4  # runs, f32
STAT_TOL = 1e-5  # the reference's for an MMD value
BETA_TOL = 1e-3  # the reference's for the betas
# the betas of an end-to-end run and the MK-MMD term they weigh, where the
# QP is ill-conditioned: JAX's eager and jitted QPs part by 4.6e-3 on
# normalised samples, and JAX's own run moves the term by 2.1e-3 when its
# inputs move by one ulp (Ditto, interval -1, on this recipe); the port
# parts from JAX's by 2.0e-3 at most
QP_TOL = 2.5e-3
N_CLASSES, DIM, HIDDEN = 3, 8, 12


def _samples(seed=0, n=32, d=4, shift=0.0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    y = (r.normal(size=(n, d)) + shift).astype(np.float32)
    return x, y


def _mask(n, valid):
    m = np.zeros(n, np.float32)
    m[:valid] = 1.0
    return m


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


STAT_CASES = {
    "full": {}, "linear": dict(linear=True), "normalized": dict(normalize_features=True),
    "masked": dict(mask=_mask(32, 26)), "masked_linear": dict(mask=_mask(32, 26), linear=True),
}


def _kwargs(kw):
    jk = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tk = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return jk, tk


@pytest.mark.parametrize("case", sorted(STAT_CASES))
def test_mkmmd_matches_jax(case):
    jk, tk = _kwargs(STAT_CASES[case])
    x, y = _samples(shift=1.5)
    betas = np.random.default_rng(1).dirichlet(np.ones(19)).astype(np.float32)
    (jx, jy, jb), (tx, ty, tb) = _both(x, y, betas)
    assert T.default_gammas().numpy() == pytest.approx(np.asarray(J.default_gammas()), abs=0)
    want = float(J.mkmmd(jx, jy, jb, **jk))
    assert float(T.mkmmd(tx, ty, tb, **tk)) == pytest.approx(want, abs=STAT_TOL)


def test_identical_samples_give_zero_and_masked_rows_do_not_count():
    x, y = _samples(shift=1.5, n=24)
    tx, ty = torch.tensor(x), torch.tensor(y)
    u = T.uniform_betas(19)
    assert abs(float(T.mkmmd(tx, tx, u))) < STAT_TOL
    xp = torch.cat([tx, torch.zeros(8, 4)])
    yp = torch.cat([ty, torch.full((8, 4), 7.0)])
    mask = torch.tensor(_mask(32, 24))
    assert float(T.mkmmd(xp, yp, u, mask=mask)) == pytest.approx(float(T.mkmmd(tx, ty, u)),
                                                                 abs=STAT_TOL)
    np.testing.assert_allclose(T.optimize_betas(xp, yp, mask=mask).numpy(),
                               T.optimize_betas(tx, ty).numpy(), atol=BETA_TOL)


BETA_CASES = {
    "qp": dict(), "qp_linear": dict(linear=True), "qp_masked": dict(mask=_mask(32, 26)),
    "vertex": dict(minimize_type_two_error=False),
}


@pytest.mark.parametrize("case", sorted(BETA_CASES))
def test_optimize_betas_matches_jax(case):
    jk, tk = _kwargs(BETA_CASES[case])
    x, y = _samples(shift=2.0)
    (jx, jy), (tx, ty) = _both(x, y)
    want = np.asarray(J.optimize_betas(jx, jy, **jk))
    got = T.optimize_betas(tx, ty, **tk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BETA_TOL)
    assert got.min() >= 0.0 and got.sum() == pytest.approx(1.0, abs=1e-5)
    if case == "vertex":
        assert (got > 1e-6).sum() == 1 and got.argmax() == want.argmax()


def test_the_normalized_qp_stays_within_jaxs_own_rounding_spread():
    """On normalised features the QP is ill-conditioned in f32: JAX's eager
    and jitted programs part by more than the reference's 1e-3, and the
    port sits no further from the jitted result than the eager one does."""
    x, y = _samples(shift=1.5, n=24)
    (jx, jy), (tx, ty) = _both(x, y)
    eager = np.asarray(J.optimize_betas(jx, jy, normalize_features=True))
    jitted = np.asarray(jax.jit(J.optimize_betas, static_argnames=("normalize_features",))(
        jx, jy, normalize_features=True))
    got = T.optimize_betas(tx, ty, normalize_features=True).numpy()
    spread = float(np.abs(eager - jitted).max())
    assert spread > BETA_TOL
    assert float(np.abs(got - jitted).max()) <= spread


def test_optimize_betas_without_a_positive_hat_d_takes_the_extreme_kernel():
    # identical samples: every hat_d is 0, so the fallback one-hot decides
    x, _ = _samples()
    for minimize in (True, False):
        want = np.asarray(J.optimize_betas(jnp.asarray(x), jnp.asarray(x),
                                           minimize_type_two_error=minimize))
        got = T.optimize_betas(torch.tensor(x), torch.tensor(x),
                               minimize_type_two_error=minimize).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.max() == 1.0


def test_optimize_betas_runs_under_the_client_vmap():
    x, y = _samples(shift=2.0)
    xs = torch.stack([torch.tensor(x), torch.tensor(y)])
    ys = torch.stack([torch.tensor(y), torch.tensor(x) + 1.0])
    got = torch.func.vmap(lambda a, b: T.optimize_betas(a, b))(xs, ys)
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(J.optimize_betas(jnp.asarray(xs[i].numpy()),
                                                               jnp.asarray(ys[i].numpy()))),
                                   atol=BETA_TOL)


def _deep_pair(d=4, steps=2):
    dm = J.DeepMmd(input_size=d, optimization_steps=steps)
    state = dm.init(jax.random.PRNGKey(0))
    tdm = T.DeepMmd(d, optimization_steps=steps)
    return dm, state, tdm, convert.deep_mmd_state_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                                  state))


@pytest.mark.parametrize("masked", [False, True])
def test_deep_mmd_value_matches_jax(masked):
    dm, state, tdm, tstate = _deep_pair()
    x, y = _samples(shift=1.5, n=24)
    m = _mask(24, 20) if masked else None
    jm, tm = (jnp.asarray(m), torch.tensor(m)) if masked else (None, None)
    want = float(dm.value(state, jnp.asarray(x), jnp.asarray(y), mask=jm))
    assert float(tdm.value(tstate, torch.tensor(x), torch.tensor(y), mask=tm)) == pytest.approx(
        want, abs=STAT_TOL)
    assert abs(float(tdm.value(tstate, torch.tensor(x), torch.tensor(x)))) < STAT_TOL
    # the gradient reaches the inputs only
    g = torch.func.grad(lambda a: tdm.value(tstate, a, torch.tensor(y)))(torch.tensor(x))
    assert float(g.abs().max()) > 0.0


def test_deep_mmd_variance_is_held_to_its_f32_conditioning():
    """Var = v1 - v2 cancels: each package's f32 value sits a few percent
    from the f64 one, the two within the larger of their distances to it."""
    dm, state, tdm, tstate = _deep_pair()
    x, y = _samples(shift=1.5, n=24)
    m = _mask(24, 20)
    jm2, jv = dm._mmd_and_var(state.params, jnp.asarray(x), jnp.asarray(y), True,
                              jnp.asarray(m))
    tm2, tv = tdm._mmd_and_var(tstate.params, torch.tensor(x), torch.tensor(y), True,
                               torch.tensor(m))
    p64 = {k: v.double() for k, v in tstate.params.items()}
    _, v64 = tdm._mmd_and_var(p64, torch.tensor(x).double(), torch.tensor(y).double(), True,
                              torch.tensor(m).double())
    assert float(tm2) == pytest.approx(float(jm2), abs=STAT_TOL)
    j_err, t_err = abs(float(jv) - float(v64)), abs(float(tv) - float(v64))
    assert t_err <= max(2 * j_err, 1e-3 * float(v64)), (float(jv), float(tv), float(v64))


def test_deep_mmd_training_moves_the_kernel_as_jax_within_adams_step():
    """Two adamw steps from JAX's state in f32: each param within 2 * lr *
    steps of JAX's (Adam's largest move: an entry whose gradient sign the
    variance's rounding flips moves the other way, so f32 runs part by up
    to that much), the scalar bandwidth exactly where its gradient is far
    from noise. The gradient and the steps themselves are held in f64
    (``test_deep_mmd_sgd_steps_match_jax_in_f64``)."""
    dm, state, tdm, tstate = _deep_pair(steps=2)
    x, y = _samples(shift=1.5, n=24)
    m = _mask(24, 20)
    want = dm.train(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1),
                    mask=jnp.asarray(m))
    got = tdm.train(tstate, torch.tensor(x), torch.tensor(y), rng.PRNGKey(1),
                    mask=torch.tensor(m))
    want_p = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, want.params))
    assert set(want_p) == set(got.params)
    for k, v in want_p.items():
        assert float((got.params[k] - v).abs().max()) <= 2 * 0.001 * 2 + 1e-6, k
    assert float(got.params["log_epsilon"]) == pytest.approx(float(want_p["log_epsilon"]),
                                                             abs=1e-6)
    assert int(got.opt_state[0].count) == 2
    moved = max(float((got.params[k] - tstate.params[k]).abs().max()) for k in got.params)
    assert moved > 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_deep_mmd_sgd_steps_match_jax_in_f64(masked):
    """``DeepMmd.train``'s two steps (permutation, joint mask, the
    t-statistic's gradient) with plain SGD in f64 in both packages (JAX
    under x64): the moves agree to 1e-6 of their size. In f32 the gradient
    sits up to a few percent from its f64 value in either package (the
    variance cancels), so an f32 step is no parity test; f64 takes that
    rounding out and leaves the arithmetic. SGD, since adamw's first steps
    keep only the gradient's sign."""
    lr, steps = 0.001, 2
    dm, state, tdm, tstate = _deep_pair(steps=steps)
    dm.tx, tdm.tx = optax.sgd(lr), optim.sgd(lr)
    x, y = _samples(shift=1.5, n=24)
    m = _mask(24, 20) if masked else None
    p64 = {k: v.to(torch.float64) for k, v in tstate.params.items()}
    got = tdm.train(T.DeepMmdState(params=p64, opt_state=tdm.tx.init(p64)),
                    torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64),
                    rng.PRNGKey(1), mask=None if m is None else torch.tensor(m, dtype=torch.float64))
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                    state.params)
        want = dm.train(J.DeepMmdState(params=jp, opt_state=dm.tx.init(jp)),
                        jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                        jax.random.PRNGKey(1),
                        mask=None if m is None else jnp.asarray(m, jnp.float64))
        want_p = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, want.params))
    assert set(want_p) == set(got.params)
    for k, v in want_p.items():
        assert v.dtype == got.params[k].dtype == torch.float64, k
        dj, dt = (v - p64[k]).numpy(), (got.params[k] - p64[k]).numpy()
        np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-12, err_msg=k)
    assert float(np.abs(dj).max()) > 0.0


def test_permutation_under_the_client_vmap_is_jax_bit_for_bit():
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 24))(keys))
    tkeys = torch.tensor(np.asarray(keys).astype(np.int64))
    got = torch.func.vmap(lambda k: rng.permutation(k, 24), randomness="error")(tkeys)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The four client logics end to end
# ---------------------------------------------------------------------------

def _arrays(n_clients=2, n=40):
    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(jax.random.PRNGKey(i), n, (DIM,), N_CLASSES)
        x, y = np.asarray(x), np.asarray(y)
        out.append((x[: n - 16], y[: n - 16], x[n - 16:], y[n - 16:]))
    return out


def _jmlp():
    return JMlp(features=(HIDDEN,), n_outputs=N_CLASSES)


def _tmlp():
    return TMlp(DIM, (HIDDEN,), N_CLASSES)


def _logics(kind: str, **kw):
    """(jax logic, port logic, jax exchanger, port exchanger) of a kind."""
    ce_j, ce_t = jengine.masked_cross_entropy, tengine.masked_cross_entropy
    ditto = kind.startswith("ditto")
    if ditto:
        jm = jengine.from_flax(jbases.TwinModel(global_model=_jmlp(), personal_model=_jmlp()))
        tm = tengine.from_module(tbases.TwinModel(_tmlp(), _tmlp()))
        feats = dict(feature_model=jengine.from_flax(_jmlp())), dict(
            feature_model=tengine.from_module(_tmlp()))
        ex = (JFixedLayer(jbases.TwinModel.exchange_global_model),
              TFixedLayer(tbases.TwinModel.exchange_global_model))
    else:
        jm, tm = jengine.from_flax(_jmlp()), tengine.from_module(_tmlp())
        feats = {}, {}
        ex = JKeepLocal(), TKeepLocal()
    deep = "deep" in kind
    if deep:
        kw = dict(feature_sizes={"features": HIDDEN}, deep_mmd_loss_weight=1.0,
                  optimization_steps=1, **kw)
    else:
        kw = dict(mkmmd_loss_weight=1.0, **kw)
    jcls, tcls = {
        "ditto_mkmmd": (jmmd.DittoMkMmdClientLogic, tmmd.DittoMkMmdClientLogic),
        "mrmtl_mkmmd": (jmmd.MrMtlMkMmdClientLogic, tmmd.MrMtlMkMmdClientLogic),
        "ditto_deep_mmd": (jmmd.DittoDeepMmdClientLogic, tmmd.DittoDeepMmdClientLogic),
        "mrmtl_deep_mmd": (jmmd.MrMtlDeepMmdClientLogic, tmmd.MrMtlDeepMmdClientLogic),
    }[kind]
    jl = jcls(jm, ce_j, lam=0.5, **feats[0], **kw)
    tl = tcls(tm, ce_t, lam=0.5, **feats[1], **kw)
    if deep:
        # the port's kernels start from JAX's
        extra = jl.init_extra(None)
        kstates = {k: convert.deep_mmd_state_to_torch(jax.tree_util.tree_map(np.asarray, s))
                   for k, s in extra["deep_mmd"].items()}
        tl.init_extra = lambda params: {"deep_mmd": kstates}
    return jl, tl, *ex


def _nudged(arrays):
    """The training inputs one ulp up (a run's own sensitivity)."""
    return [(np.nextafter(a[0], np.float32(np.inf)), *a[1:]) for a in arrays]


RUN_KW = dict(batch_size=8, seed=3, local_epochs=1)


def _jax_run(jl, jex, arrays, rounds: int):
    js = JSim(logic=jl, tx=optax.sgd(0.05), strategy=JFedAvg(),
              datasets=[JDataset(*a) for a in arrays],
              metrics=JMetricManager((jefficient.accuracy(),)), exchanger=jex, **RUN_KW)
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    js.fit(rounds)
    return js, init


def _runs(kind: str, rounds: int = 2, modes=("pipelined",), **kw):
    """JAX's run, then the port's from its init, one a mode; a mode
    ``"jax_nudged"`` is JAX's run again on inputs one ulp up."""
    jl, tl, jex, tex = _logics(kind, **kw)
    arrays = _arrays()
    js, init = _jax_run(jl, jex, arrays, rounds)
    ports = []
    for mode in modes:
        if mode == "jax_nudged":
            ports.append(_jax_run(jl, jex, _nudged(arrays), rounds)[0])
            continue
        ts = TSim(logic=tl, tx=optim.sgd(0.05), strategy=TFedAvg(),
                  datasets=[TDataset(*a) for a in arrays],
                  metrics=TMetricManager((tefficient.accuracy(),)), exchanger=tex,
                  execution_mode=mode, device="cpu", **RUN_KW)
        ts.set_global_params(init)
        ts.fit(rounds)
        ports.append(ts)
    return js, ports


def _close_runs(js, ts, key, loose=()):
    """Every loss key at 5e-4, those in ``loose`` at ``QP_TOL``; the eval
    losses and the clients' params at 5e-4."""
    assert len(js.history) == len(ts.history)
    for j, t in zip(js.history, ts.history):
        assert set(t.fit_losses) == set(j.fit_losses) and key in t.fit_losses
        for k in t.fit_losses:
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0,
                                       atol=QP_TOL if k in loose else TOL,
                                       err_msg=f"round {t.round} {k}")
        np.testing.assert_allclose(t.eval_losses["checkpoint"], j.eval_losses["checkpoint"],
                                   rtol=0, atol=TOL)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.client_states.params))
    for k, v in want.items():
        np.testing.assert_allclose(ts.client_states.params[k].numpy(), v.numpy(), rtol=0,
                                   atol=TOL, err_msg=k)


def _histories_equal(a, b) -> bool:
    return all(x.fit_losses == y.fit_losses and x.eval_losses == y.eval_losses
               for x, y in zip(a.history, b.history, strict=True))


MKMMD_CASES = {
    # JAX's defaults (normalised features) with a refresh before every step
    "mrmtl_mkmmd-interval-1": ("mrmtl_mkmmd", dict(beta_global_update_interval=-1), ()),
    "mrmtl_mkmmd-interval2": ("mrmtl_mkmmd", dict(beta_global_update_interval=2), ()),
    "ditto_mkmmd-l2": ("ditto_mkmmd", dict(beta_global_update_interval=0,
                                           feature_l2_norm_weight=0.1), ()),
    # JAX's own test's Ditto: the personal and the frozen global model start
    # apart, and the QP on their features is ill-conditioned (ROADMAP C)
    "ditto_mkmmd-interval2": ("ditto_mkmmd", dict(beta_global_update_interval=2),
                              ("backward", "mkmmd")),
}


@pytest.mark.parametrize("case", sorted(MKMMD_CASES))
def test_mkmmd_clients_match_jax(case):
    kind, kw, loose = MKMMD_CASES[case]
    js, (pipelined, chunked) = _runs(kind, modes=("pipelined", "chunked"), **kw)
    _close_runs(js, pipelined, "mkmmd", loose)
    assert _histories_equal(pipelined, chunked)
    jb = np.asarray(js.client_states.extra["mkmmd_betas"]["features"])
    tb = pipelined.client_states.extra["mkmmd_betas"]["features"].numpy()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=QP_TOL)
    if kw.get("beta_global_update_interval", 0) != 0:
        assert float(np.abs(tb - 1.0 / 19).max()) > 1e-4  # the betas moved


DEEP_CASES = {
    # the penalty through the fixed (converted) kernel
    "ditto_deep_mmd-no_training": ("ditto_deep_mmd", dict(mmd_kernel_train_interval=0)),
    "mrmtl_deep_mmd-no_training": ("mrmtl_deep_mmd", dict(mmd_kernel_train_interval=0)),
}


@pytest.mark.parametrize("case", sorted(DEEP_CASES))
def test_deep_mmd_clients_match_jax(case):
    kind, kw = DEEP_CASES[case]
    js, (pipelined, chunked) = _runs(kind, modes=("pipelined", "chunked"), **kw)
    _close_runs(js, pipelined, "deep_mmd")
    assert _histories_equal(pipelined, chunked)


def _kernel_params(sim) -> dict:
    params = sim.client_states.extra["deep_mmd"]["features"].params
    if isinstance(params, dict) and all(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))


def _mean_gap(a: dict, b: dict) -> float:
    """The mean entry gap over the kernel's params, less the last layer's
    bias: it cancels in every feature distance, so its gradient is 0 in
    real arithmetic and adamw moves it by rounding alone."""
    last = max(k for k in a if k.startswith("featurizer/")).rsplit("/", 1)[0] + "/bias"
    gaps = [(a[k].to(torch.float64) - b[k].to(torch.float64)).abs().flatten()
            for k in a if k != last]
    return float(torch.cat(gaps).mean())


@pytest.mark.parametrize("kind,interval", [("ditto_deep_mmd", -1), ("mrmtl_deep_mmd", 2)])
def test_deep_mmd_clients_train_their_kernels(kind, interval):
    """With kernel training on: the training losses within 5e-4 of JAX's
    (measured 2.7e-5 and 7.5e-6), the chunked route equal to the pipelined
    one, the kernels moved off their shared init. The trained kernels part
    from JAX's where f32 rounding flips the sign of a gradient entry near 0
    and adamw turns it into an lr-sized step (the t-statistic divides by a
    variance that cancels in f32; ROADMAP C): each entry within Adam's
    reach of 2 lr a step, and the mean entry gap at most 4 times JAX's own
    when its inputs move by one ulp (measured 2.0 and 1.5 times). The
    training arithmetic itself is held in f64
    (``test_deep_mmd_sgd_steps_match_jax_in_f64``)."""
    js, (pipelined, chunked, jax_nudged) = _runs(
        kind, modes=("pipelined", "chunked", "jax_nudged"), mmd_kernel_train_interval=interval)
    assert _histories_equal(pipelined, chunked)
    for j, t in zip(js.history, pipelined.history):
        for k in ("backward", "deep_mmd"):
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0, atol=TOL,
                                       err_msg=f"round {t.round} {k}")
    got, want = _kernel_params(pipelined), _kernel_params(js)
    init = pipelined.logic.init_extra(None)["deep_mmd"]["features"].params
    steps = int(pipelined.client_states.extra["deep_mmd"]["features"].opt_state[0].count.max())
    assert steps > 0
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= 2 * 0.001 * steps + 1e-6, k
    own = _mean_gap(want, _kernel_params(jax_nudged))
    assert 0.0 < _mean_gap(got, want) <= 4 * own, (_mean_gap(got, want), own)
    assert max(float((got[k] - init[k]).abs().max()) for k in got) > 1e-8


def test_interval_refreshes_fire_after_the_second_step_as_jax():
    """The interval's due test over a round's steps, as JAX's counts them."""
    ctx = tmmd.DittoMmdContext(initial_global_params={}, drift_penalty_weight=None,
                               round_start_step=torch.tensor(6, dtype=torch.int32))
    fired = []
    for after in range(1, 8):
        state = dataclasses.replace(_dummy_state(), step=torch.tensor(6 + after,
                                                                      dtype=torch.int32))
        batch = tengine.Batch(x=None, y=None, example_mask=None, step_mask=torch.tensor(1.0))
        fired.append(bool(tmmd._interval_due(state, ctx, batch, 3)))
    assert fired == [False, True, False, False, True, False, False]


def _dummy_state():
    return tengine.TrainState(params={}, opt_state=(), model_state={},
                              rng=rng.PRNGKey(0), step=torch.tensor(0, dtype=torch.int32))


def test_bad_intervals_are_refused_as_in_jax():
    model = tengine.from_module(_tmlp())
    for pkg in (jmmd, tmmd):
        m = jengine.from_flax(_jmlp()) if pkg is jmmd else model
        ce = jengine.masked_cross_entropy if pkg is jmmd else tengine.masked_cross_entropy
        with pytest.raises(ValueError, match="beta_global_update_interval"):
            pkg.MrMtlMkMmdClientLogic(m, ce, beta_global_update_interval=-2)
        with pytest.raises(ValueError, match="mmd_kernel_train_interval"):
            pkg.MrMtlDeepMmdClientLogic(m, ce, {"features": HIDDEN},
                                        mmd_kernel_train_interval=-3)
