"""Client-level DP pieces of the port against the JAX package on the CPU:
``ClippingClientLogic.finalize_round`` (norm below, at and above the bound,
adaptive clipping on and off); ``ClientLevelDPFedAvgM.aggregate`` at nonzero
noise, weighted and unweighted x adaptive on and off, with a mask that drops
clients and with an empty cohort, within 5e-6 (the same noise through
``rng.py``, one key per leaf in JAX's leaf order); ``effective_noise_multiplier``
and ``bind_client_manager``'s errors; and the client-level accounting
(without-replacement RDP, trajectory composition, both accountants) at 1e-9."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.clipping import ClippingClientLogic as JClipLogic
from fl4health_tpu.clients.clipping import ClippingContext as JClipContext
from fl4health_tpu.exchange.packer import ClippingBitPacket as JPacket
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.privacy import accountants as jacc
from fl4health_tpu.privacy import rdp as jrdp
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM as JStrategy
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.clipping import ClippingClientLogic as TClipLogic
from fl4health_tpu_torch.clients.clipping import ClippingContext as TClipContext
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.exchange.packer import ClippingBitPacket as TPacket
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.privacy import accountants as tacc
from fl4health_tpu_torch.privacy import rdp as trdp
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM as TStrategy

AGG_TOL = 5e-6
# a Params dict whose init order is not JAX's sorted order, so a per-leaf key
# split in dict order would noise the wrong leaves
SHAPES = {"Dense_1/kernel": (6, 3), "Dense_1/bias": (3,), "Dense_0/kernel": (4, 6),
          "Dense_0/bias": (6,), "Conv_0/kernel": (3, 3, 1, 2)}


def _nested(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        a, b = path.split("/")
        out.setdefault(a, {})[b] = jnp.asarray(v)
    return out


def _flat_jax(tree) -> dict:
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _np_tree(seed, lead=(), scale=1.0):
    r = np.random.default_rng(seed)
    return {k: (r.standard_normal(lead + s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def test_flax_leaf_order_is_jax_flatten_order():
    flat = _np_tree(0)
    leaves, _ = jax.tree_util.tree_flatten(_nested(flat))
    order = ptu.flax_leaf_order(flat)
    assert order != list(flat)  # the dict's own order differs
    for k, leaf in zip(order, leaves):
        np.testing.assert_array_equal(flat[k], np.asarray(leaf))
    assert ptu.flax_leaf_order({"a/x": 0, "a.b/y": 0}) == ["a/x", "a.b/y"]


# ---------------------------------------------------------------------------
# the client: finalize_round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_finalize_round_matches_jax(where, adaptive):
    init = {"Dense_0/kernel": np.zeros((2, 1), np.float32),
            "Dense_0/bias": np.zeros((1,), np.float32)}
    # delta (3, 4 | 0): norm exactly 5 in f32
    trained = {"Dense_0/kernel": np.asarray([[3.0], [4.0]], np.float32),
               "Dense_0/bias": np.zeros((1,), np.float32)}
    bound = {"below": 6.0, "at": 5.0, "above": 2.0}[where]
    jlogic = JClipLogic(jengine.from_flax(JMlp(features=(), n_outputs=1)),
                        jengine.masked_cross_entropy, adaptive_clipping=adaptive)
    tlogic = TClipLogic(tengine.from_module(TMlp(2, (), 1)),
                        tengine.masked_cross_entropy, adaptive_clipping=adaptive)
    jstate = jengine.TrainState(params=_nested(trained), opt_state=(), model_state={},
                                rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32),
                                extra=jlogic.init_extra(_nested(trained)))
    jout = jlogic.finalize_round(
        jstate, JClipContext(_nested(init), jnp.asarray(bound, jnp.float32)), 1)
    tparams = {k: torch.tensor(v) for k, v in trained.items()}
    tstate = tengine.TrainState(params=tparams, opt_state={}, model_state={},
                                rng=rng.PRNGKey(0),
                                step=torch.zeros((), dtype=torch.int32),
                                extra=tlogic.init_extra(tparams))
    tout = tlogic.finalize_round(
        tstate, TClipContext({k: torch.tensor(v) for k, v in init.items()},
                             torch.tensor(bound)), torch.tensor(1.0))
    want_bit = float(jout.extra["clipping_bit"])
    assert float(tout.extra["clipping_bit"]) == want_bit
    assert want_bit == (1.0 if adaptive and where != "above" else 0.0)
    want = _flat_jax(jout.extra["delta"])
    for k in want:
        np.testing.assert_allclose(tout.extra["delta"][k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    packet = tlogic.pack(tout, tout.params, {})
    assert isinstance(packet, TPacket) and packet.params is tout.extra["delta"]
    norm = float(ptu.global_norm(tout.extra["delta"]))
    assert norm == pytest.approx(min(5.0, bound), rel=1e-6)


# ---------------------------------------------------------------------------
# the server: aggregate
# ---------------------------------------------------------------------------

def _strategies(weighted, adaptive, fraction):
    kw = dict(noise_multiplier=0.7, server_momentum=0.5, initial_clipping_bound=0.8,
              adaptive_clipping=adaptive, bit_noise_multiplier=1.0,
              clipping_learning_rate=0.2, clipping_quantile=0.5,
              weighted_aggregation=weighted, seed=11)
    js, ts = JStrategy(**kw), TStrategy(**kw)
    js.bind_client_manager(jcm.PoissonSamplingManager(5, fraction))
    ts.bind_client_manager(tcm.PoissonSamplingManager(5, fraction))
    return js, ts


def _results(mask, round_seed):
    deltas = _np_tree(round_seed, (5,), scale=0.1)
    bits = np.asarray([1, 0, 1, 1, 0], np.float32)
    counts = np.asarray([40, 12, 90, 7, 33], np.float32)
    jres = JFitResults(JPacket(_nested(deltas), jnp.asarray(bits)), jnp.asarray(counts),
                       {}, {}, jnp.asarray(mask))
    tres = TFitResults(TPacket({k: torch.tensor(v) for k, v in deltas.items()},
                               torch.tensor(bits)), torch.tensor(counts), {}, {},
                       torch.tensor(mask))
    return jres, tres


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("mask", [[1, 0, 1, 1, 0], [0, 0, 0, 0, 0]],
                         ids=["drops_clients", "empty_cohort"])
def test_aggregate_matches_jax(weighted, adaptive, mask):
    mask = np.asarray(mask, np.float32)
    js, ts = _strategies(weighted, adaptive, fraction=0.6)
    init = _np_tree(5)
    jstate = js.init(_nested(init))
    tstate = ts.init({k: torch.tensor(v) for k, v in init.items()})
    for rnd in (1, 2):  # two rounds: the state's key chains as JAX's does
        jres, tres = _results(mask, 100 + rnd)
        jstate = js.aggregate(jstate, jres, rnd)
        tstate = ts.aggregate(tstate, tres, rnd)
        np.testing.assert_array_equal(tstate.rng.numpy(), np.asarray(jstate.rng))
        for got, want in ((tstate.params, jstate.params),
                          (tstate.momentum, jstate.momentum)):
            want = _flat_jax(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=AGG_TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(float(tstate.clipping_bound),
                                   float(jstate.clipping_bound), atol=AGG_TOL, rtol=0)
    if mask.sum() == 0:  # an empty cohort holds everything
        for k, v in init.items():
            np.testing.assert_array_equal(tstate.params[k].numpy(), v)
        assert float(tstate.clipping_bound) == pytest.approx(0.8)
    else:
        assert any(not np.array_equal(tstate.params[k].numpy(), v) for k, v in init.items())


def test_payload_carries_params_and_bound():
    _, ts = _strategies(True, True, 0.6)
    state = ts.init({k: torch.tensor(v) for k, v in _np_tree(1).items()})
    payload = ts.client_payload(state, 1)
    assert payload.params is state.params
    assert float(payload.clipping_bound) == pytest.approx(0.8)


@pytest.mark.parametrize("z,z_bit,adaptive", [
    (0.1, 1.0, True), (0.7, 2.0, True), (0.7, 2.0, False), (0.0, 1.0, True),
    (1.0, 0.0, True)])
def test_effective_noise_multiplier(z, z_bit, adaptive):
    kw = dict(noise_multiplier=z, bit_noise_multiplier=z_bit, adaptive_clipping=adaptive)
    assert TStrategy(**kw).effective_noise_multiplier() == pytest.approx(
        JStrategy(**kw).effective_noise_multiplier(), rel=1e-12)


def test_construction_errors():
    with pytest.raises(ValueError, match="ill-related"):
        TStrategy(noise_multiplier=1.0, bit_noise_multiplier=0.4, adaptive_clipping=True)
    with pytest.raises(ValueError, match="must be positive"):
        TStrategy(weighted_aggregation=True, fraction_fit=0.0)


class _NoFraction(tcm.ClientManager):
    pass


@pytest.mark.parametrize("case", ["no_fraction", "nonpositive", "mismatch"])
def test_bind_client_manager_errors(case):
    if case == "no_fraction":
        strat, manager, match = TStrategy(weighted_aggregation=True), _NoFraction(4), \
            "exposes no sampling fraction"
    elif case == "nonpositive":
        strat, manager, match = TStrategy(weighted_aggregation=True), \
            tcm.PoissonSamplingManager(4, 0.0), "not positive"
    else:
        strat, manager, match = TStrategy(weighted_aggregation=True, fraction_fit=0.5), \
            tcm.PoissonSamplingManager(4, 0.25), "does not match"
    with pytest.raises(ValueError, match=match):
        strat.bind_client_manager(manager)


def test_bind_client_manager_derives_fraction():
    strat = TStrategy(weighted_aggregation=True)
    strat.bind_client_manager(tcm.FixedFractionManager(8, 0.25))
    assert strat.fraction_fit == 0.25
    unweighted = TStrategy()
    unweighted.bind_client_manager(_NoFraction(4))  # unweighted never divides by q
    assert unweighted.fraction_fit == 1.0


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

ORDERS = trdp.default_orders()


@pytest.mark.parametrize("sigma", [0.0, 0.3, 1.7])
def test_rdp_without_replacement_and_gaussian(sigma):
    for fn, args in ((trdp.rdp_gaussian, (sigma, ORDERS)),
                     (trdp.rdp_sampled_without_replacement_gaussian, (50, 10, sigma, ORDERS))):
        want = getattr(jrdp, fn.__name__)(*args)
        np.testing.assert_allclose(fn(*args), want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("fn", ["get_epsilon", "get_delta"])
def test_trajectory_composition(fn):
    value = 1e-5 if fn == "get_epsilon" else 2.0
    trajectories = [
        ([0.1, 0.3], [1.1, 0.8], [5, 2]),   # lists compose in sequence
        ([0.1, 0.3], 1.1, 4),               # scalars broadcast along the list
        (0.2, [1.1, 0.9], [3, 3]),
    ]
    for qs, sigma, steps in trajectories:
        def sampling(m):
            return ([m.PoissonSampling(q) for q in qs] if isinstance(qs, list)
                    else m.PoissonSampling(qs))
        got = getattr(tacc.MomentsAccountant(), fn)(sampling(tacc), sigma, steps, value)
        want = getattr(jacc.MomentsAccountant(), fn)(sampling(jacc), sigma, steps, value)
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want))
    mixed = [tacc.PoissonSampling(0.2), tacc.FixedSamplingWithoutReplacement(20, 5)]
    jmixed = [jacc.PoissonSampling(0.2), jacc.FixedSamplingWithoutReplacement(20, 5)]
    got = getattr(tacc.MomentsAccountant(), fn)(mixed, [1.0, 2.0], [3, 1], value)
    want = getattr(jacc.MomentsAccountant(), fn)(jmixed, [1.0, 2.0], [3, 1], value)
    assert abs(got - want) <= 1e-9 * max(1.0, abs(want))
    with pytest.raises(ValueError, match="equal length"):
        tacc.MomentsAccountant().get_epsilon(mixed, [1.0, 2.0, 3.0], 2, 1e-5)


@pytest.mark.parametrize("name,kw,rounds", [
    ("FlClientLevelAccountantPoissonSampling",
     dict(client_sampling_rate=0.25, noise_multiplier=0.1), 2),
    ("FlClientLevelAccountantPoissonSampling",
     dict(client_sampling_rate=0.5, noise_multiplier=1.2), 10),
    ("FlClientLevelAccountantPoissonSampling",
     dict(client_sampling_rate=[0.25, 0.5], noise_multiplier=[1.2, 0.9]), [3, 7]),
    ("FlClientLevelAccountantFixedSamplingNoReplacement",
     dict(n_total_clients=64, n_clients_sampled=16, noise_multiplier=1.5), 10),
    ("FlClientLevelAccountantFixedSamplingNoReplacement",
     dict(n_total_clients=64, n_clients_sampled=[16, 8], noise_multiplier=1.5), [3, 7]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_client_level_accountants(name, kw, rounds):
    t, j = getattr(tacc, name)(**kw), getattr(jacc, name)(**kw)
    for got, want in ((t.get_epsilon(rounds, 1 / 64), j.get_epsilon(rounds, 1 / 64)),
                      (t.get_delta(rounds, 3.0), j.get_delta(rounds, 3.0))):
        assert np.isfinite(got) and abs(got - want) <= 1e-9 * max(1.0, abs(want))


def test_chip_smoke_client_dp_epsilon():
    # the full-width client-level DP run of chip_smoke.py, whose epsilon it
    # checks on the card
    import chip_smoke

    q, sigma = chip_smoke.CDP_FRACTION, chip_smoke.CDP_STRATEGY["noise_multiplier"]
    delta = 1 / chip_smoke.CDP_CLIENTS
    got = tacc.FlClientLevelAccountantPoissonSampling(q, sigma).get_epsilon(
        chip_smoke.CDP_ROUNDS, delta)
    want = jacc.FlClientLevelAccountantPoissonSampling(q, sigma).get_epsilon(
        chip_smoke.CDP_ROUNDS, delta)
    assert abs(got - chip_smoke.CDP_EPSILON) <= 1e-9 and abs(want - got) <= 1e-9
