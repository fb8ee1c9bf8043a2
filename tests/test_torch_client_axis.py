"""The client axis: the simulation's ``torch.func.vmap`` over clients
(``vmap_clients``, the counterpart of JAX's ``vmap(client_fit)``) against its
plain version, the Python loop ``loop_clients``, on the same seed; and each
piece the vmap runs through, against its plain version on the CPU.

Tolerances:
- vmapped against looped runs, 1e-5 on losses and params: the two compute
  the same function, but batched and per-client reductions (the GEMMs,
  convolutions and sums under vmap) take their terms in another order, a few
  f32 ulps a step;
- the kernels' Functions under vmap against their plain versions, 1e-6
  (rtol and atol): on the CPU the rules fold the clients into the kernels'
  batch and call the plain versions, so only the summation order differs;
- random draws under vmap against the per-key loop: bit for bit.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import importlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.clipping import ClippingClientLogic
from fl4health_tpu_torch.clients.instance_level_dp import InstanceLevelDpClientLogic
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.kernels import dp_clip as dp
# the module: the package exports the function of that name, as JAX's does
fa = importlib.import_module("fl4health_tpu_torch.kernels.flash_attention")
from fl4health_tpu_torch.kernels.fold import fold_vmapped
from fl4health_tpu_torch.losses.containers import LossMeter
from fl4health_tpu_torch.metrics import efficient
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.models import cnn
from fl4health_tpu_torch.models import transformer as trm
from fl4health_tpu_torch.models.transformer import (TransformerClassifier, layer_norm,
                                                    layer_norm_clients)
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager
from fl4health_tpu_torch.strategies.client_dp_fedavgm import ClientLevelDPFedAvgM
from fl4health_tpu_torch.strategies.fedavg import FedAvg

AXIS_TOL = 1e-5
RULE_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The simulation: vmapped clients against the loop
# ---------------------------------------------------------------------------

def _images(n_clients, shape, seed=0):
    """Uneven clients of random images, 10 classes; the last client's final
    batch is ragged (example_mask zeros)."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_clients):
        n_train, n_val = 13 + 3 * i, 5
        x = r.standard_normal((n_train + n_val, *shape)).astype(np.float32)
        y = r.integers(0, 10, n_train + n_val).astype(np.int32)
        out.append(tsim.ClientDataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:]))
    return out


def _tokens(n_clients, seed=0, t=24, vocab=32):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_clients):
        n = 20 + 4 * i
        x = r.integers(1, vocab, size=(n, t)).astype(np.int32)
        x[np.arange(t)[None, :] >= r.integers(t // 2, t + 1, size=n)[:, None]] = 0
        y = r.integers(0, 3, n).astype(np.int32)
        out.append(tsim.ClientDataset(x[:n - 6], y[:n - 6], x[n - 6:], y[n - 6:]))
    return out


def _metrics():
    return MetricManager((efficient.accuracy(),))


def _fedavg_mlp():
    return tsim.FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(cnn.Mlp(6 * 6, (16,), 10)),
                                 engine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=FedAvg(), datasets=_images(3, (6, 6, 1)), batch_size=8,
        metrics=_metrics(), local_steps=3, seed=4, device="cpu")


def _transformer():
    module = TransformerClassifier(vocab_size=32, n_classes=3, d_model=16, n_heads=2,
                                   n_layers=2, d_ff=32, max_len=24, remat=True,
                                   attention_fn=fa.flash_attention)
    return tsim.FederatedSimulation(
        logic=engine.ClientLogic(engine.from_module(module), engine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=FedAvg(), datasets=_tokens(2), batch_size=8,
        metrics=_metrics(), local_steps=2, seed=7, device="cpu")


def _instance_dp():
    logic = InstanceLevelDpClientLogic(
        engine.from_module(cnn.CifarNet(input_shape=(8, 8, 3))), engine.masked_cross_entropy,
        clipping_bound=1.0, noise_multiplier=1.0)
    return tsim.FederatedSimulation(
        logic=logic, tx=optim.sgd(0.05), strategy=FedAvg(), datasets=_images(2, (8, 8, 3)),
        batch_size=8, metrics=_metrics(), local_steps=2, seed=5, device="cpu")


def _client_dp():
    data = _images(6, (5, 5, 1))
    strategy = ClientLevelDPFedAvgM(noise_multiplier=0.1, server_momentum=0.5,
                                    initial_clipping_bound=0.5, weighted_aggregation=True,
                                    adaptive_clipping=True, bit_noise_multiplier=1.0, seed=7)
    return tsim.FederatedSimulation(
        logic=ClippingClientLogic(engine.from_module(cnn.Mlp(25, (12,), 10)),
                                  engine.masked_cross_entropy, adaptive_clipping=True),
        tx=optim.sgd(0.05), strategy=strategy, datasets=data, batch_size=4,
        metrics=_metrics(), local_steps=3,
        client_manager=PoissonSamplingManager(len(data), 0.5), seed=11, device="cpu")


@pytest.mark.parametrize("build", [_fedavg_mlp, _transformer, _instance_dp, _client_dp],
                         ids=["fedavg_mlp", "transformer", "instance_dp_sigma1",
                              "client_dp_poisson"])
def test_vmapped_clients_match_the_loop(build):
    runs = []
    for axis in (tsim.vmap_clients, tsim.loop_clients):
        sim = build()
        sim._fit_round, sim._eval_round = sim._build_round_fns(axis)
        runs.append((sim.fit(2), sim.global_params, sim.client_states))
    (vh, vp, vs), (lh, lp, ls) = runs
    for a, b in zip(vh, lh):
        assert set(a.fit_losses) == set(b.fit_losses)
        for k in a.fit_losses:
            np.testing.assert_allclose(a.fit_losses[k], b.fit_losses[k], atol=AXIS_TOL, rtol=0)
        np.testing.assert_allclose(a.eval_losses["checkpoint"], b.eval_losses["checkpoint"],
                                   atol=AXIS_TOL, rtol=0)
    for k in vp:
        np.testing.assert_allclose(vp[k].numpy(), lp[k].numpy(), atol=AXIS_TOL, rtol=0,
                                   err_msg=k)
    # the clients' keys advance by the same splits on both axes
    assert torch.equal(vs.rng, ls.rng)
    assert torch.equal(vs.step, ls.step)


def test_client_keys_are_the_jax_simulations():
    sim = _fedavg_mlp()
    init_rng = rng.fold_in(rng.PRNGKey(4), 0)
    for i in range(sim.n_clients):
        assert torch.equal(sim.client_states.rng[i], rng.fold_in(init_rng, i + 1))


def test_the_main_path_runs_the_vmap(monkeypatch):
    """fit_round and eval_round make one vmapped call a round each, with
    randomness="error"; the loop is not called."""
    calls = []
    real = torch.func.vmap

    def counting(fn, **kwargs):
        vmapped = real(fn, **kwargs)

        def run(*args):
            calls.append((fn.__name__, kwargs["in_dims"], kwargs["randomness"]))
            return vmapped(*args)
        return run

    monkeypatch.setattr(torch.func, "vmap", counting)
    monkeypatch.setattr(tsim, "loop_clients", None)
    sim = _fedavg_mlp()
    sim.fit(2)
    assert calls == [("client_fit", (0, None, 0, 0, 0), "error"),
                     ("client_eval", (0, None, 0), "error")] * 2


# ---------------------------------------------------------------------------
# Pieces under the vmap
# ---------------------------------------------------------------------------

def test_train_state_is_a_torch_pytree():
    import torch.utils._pytree as torch_pytree

    state = engine.TrainState(params={"w": torch.ones(2)}, opt_state={}, model_state={},
                              rng=rng.PRNGKey(1), step=torch.zeros((), dtype=torch.int32))
    leaves, spec = torch_pytree.tree_flatten(state)
    assert [x.shape for x in leaves] == [(2,), (2,), ()]
    back = torch_pytree.tree_unflatten([x + 1 for x in leaves], spec)
    assert isinstance(back, engine.TrainState) and torch.equal(back.params["w"], 2 * leaves[0])
    assert torch.equal(ptu.tree_leaves(state)[1], state.rng)


def test_tree_map_refuses_a_dataclass_that_is_not_a_tree():
    @dataclasses.dataclass
    class Loose:
        x: torch.Tensor

    with pytest.raises(TypeError, match="tree_dataclass"):
        ptu.tree_map(lambda t: t, {"a": Loose(torch.ones(1))})


@pytest.mark.parametrize("fn", ["split", "fold_in", "normal", "uniform", "bits"])
def test_draws_under_vmap_equal_the_per_key_loop(fn):
    keys = rng.split(rng.PRNGKey(3), 5)
    draw = {"split": lambda k: rng.split(k, 3),
            "fold_in": lambda k: rng.fold_in(k, 2001),
            "normal": lambda k: rng.normal(k, (4, 7)),
            "uniform": lambda k: rng.uniform(k, (9,), -2.5, 3.0),
            "bits": lambda k: rng.bits(k, (6,))}[fn]
    got = vmap(draw, randomness="error")(keys)
    assert torch.equal(got, torch.stack([draw(k) for k in keys]))


def test_meter_and_metrics_under_vmap_equal_the_loop():
    mm = _metrics()

    def client(losses, weights, preds, targets, mask):
        meter, state = LossMeter.create(("backward",)), mm.init()
        for s in range(losses.shape[0]):
            meter = meter.update({"backward": losses[s]}, weight=weights[s])
            state = mm.update(state, preds[s], targets[s], mask[s])
        return meter.compute(), mm.compute(state)

    g = torch.Generator().manual_seed(0)
    args = (torch.rand((3, 4), generator=g), torch.tensor([[1., 1., 0., 1.]] * 3),
            torch.randn((3, 4, 5, 6), generator=g), torch.randint(0, 6, (3, 4, 5), generator=g),
            (torch.rand((3, 4, 5), generator=g) > 0.3).float())
    got = vmap(client, randomness="error")(*args)
    want = [client(*(a[i] for a in args)) for i in range(3)]
    for i, (losses, metrics) in enumerate(want):
        assert torch.allclose(got[0]["backward"][i], losses["backward"], **RULE_TOL)
        assert torch.allclose(got[1]["accuracy"][i], metrics["accuracy"], **RULE_TOL)


# ---------------------------------------------------------------------------
# K1 and K2: their Functions' vmap rules against the plain versions
# ---------------------------------------------------------------------------

def _leaves(lead, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((*lead, w), generator=g) for w in (7, 33, 12)]


def test_k1_rule_under_vmap():
    mats = _leaves((4, 5))  # 4 clients of [5, W_l]
    got = vmap(dp.per_example_tree_sq_norms, randomness="error")(mats)
    want = torch.stack([dp.per_example_tree_sq_norms_reference([m[i] for m in mats])
                        for i in range(4)])
    torch.testing.assert_close(got, want, **RULE_TOL)


def test_k2_rule_under_vmap_and_its_batched_plain_version():
    g = torch.Generator().manual_seed(1)
    mats, scale = torch.randn((4, 5, 33), generator=g), torch.rand((4, 5), generator=g)
    got = vmap(dp.scaled_masked_sum, randomness="error")(mats, scale)
    want = torch.stack([dp.scaled_masked_sum_reference(mats[i], scale[i]) for i in range(4)])
    torch.testing.assert_close(got, want, **RULE_TOL)
    torch.testing.assert_close(dp.scaled_masked_sum_reference(mats, scale), want, **RULE_TOL)
    # a scale shared by the clients comes in unbatched
    got = vmap(dp.scaled_masked_sum, in_dims=(0, None))(mats, scale[0])
    torch.testing.assert_close(got[2], dp.scaled_masked_sum_reference(mats[2], scale[0]),
                               **RULE_TOL)


def test_k1_and_k2_rules_under_nested_vmap_of_grad():
    """vmap(vmap(grad)) over 2 x 3 clients of a loss through both kernels'
    Functions (their backwards are plain tensor code), against the same
    loss through the plain versions."""
    g = torch.Generator().manual_seed(2)
    mats = torch.randn((2, 3, 5, 17), generator=g)
    scale = torch.rand((2, 3, 5), generator=g)

    def through_kernels(m, s):
        return (dp.per_example_sq_norms(m) * s).sum() + dp.scaled_masked_sum(m, s).pow(2).sum()

    def through_plain(m, s):
        return ((dp.per_example_sq_norms_reference(m) * s).sum()
                + dp.scaled_masked_sum_reference(m, s).pow(2).sum())

    got = vmap(vmap(grad(through_kernels, argnums=(0, 1))))(mats, scale)
    want = vmap(vmap(grad(through_plain, argnums=(0, 1))))(mats, scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **RULE_TOL)


@pytest.mark.parametrize("layout", ["clients", "rows"])
def test_fold_clients_is_a_view_in_either_layout(layout):
    """The rule's fold of the vmapped axis into the client axis never copies:
    ``[C, 1, B, W]`` (the public wrapper's one client, under a vmap over C)
    merges into ``[C, B, W]`` whatever the strides of C and B."""
    base = torch.randn((4, 5, 6)) if layout == "clients" else torch.randn((5, 4, 6))
    x = (base if layout == "clients" else base.transpose(0, 1))[:, None]  # [C, 1, B, W]
    folded = dp._fold_clients(x, 0, 4)
    assert folded.shape == (4, 5, 6)
    assert folded.data_ptr() == base.data_ptr() and folded._base is not None
    torch.testing.assert_close(folded, x[:, 0], rtol=0, atol=0)


def test_fused_clip_under_vmap_matches_the_plain_clip_per_client():
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn((3, 6, 4, 5), generator=g) * 0.3,
            "b": torch.randn((3, 6, 7), generator=g) * 0.3}
    mask = torch.tensor([[1, 0, 1, 1, 1, 1]] * 3, dtype=torch.float32)
    got, norms = vmap(lambda t, m: dp.fused_clipped_masked_sum(t, m, 0.8, return_norms=True),
                      randomness="error")(tree, mask)
    from fl4health_tpu_torch.privacy.dpsgd import clip_per_example
    for i in range(3):
        clipped, want_norms = clip_per_example({k: v[i] for k, v in tree.items()}, 0.8)
        torch.testing.assert_close(norms[i], want_norms, **RULE_TOL)
        for k in tree:
            want = (clipped[k] * mask[i].reshape(-1, *[1] * (clipped[k].ndim - 1))).sum(0)
            torch.testing.assert_close(got[k][i], want, **RULE_TOL)


# ---------------------------------------------------------------------------
# K3-K5: the attention Functions' vmap rules against the plain version
# ---------------------------------------------------------------------------

def _attention_inputs(lead, b=2, t=12, h=2, d=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((*lead, b, t, h, d), generator=g) for _ in range(3))
    lengths = torch.randint(1, t + 1, (*lead, b), generator=g)
    lengths.view(-1)[-1] = 0  # one batch element with no real key
    mask = (torch.arange(t) < lengths[..., None]).float()
    return q, k, v, mask


@pytest.mark.parametrize("mask_batched", [True, False])
def test_attention_rule_under_vmap(mask_batched):
    q, k, v, mask = _attention_inputs((3,))
    if not mask_batched:  # one mask that every client shares: expanded, not copied
        mask = mask[0]
    got_out, got_lse = vmap(fa.flash_attention_lse, in_dims=(0, 0, 0, 0 if mask_batched else None),
                            randomness="error")(q, k, v, mask)
    for i in range(3):
        want_out, want_lse = fa.flash_attention_reference(
            q[i], k[i], v[i], mask[i] if mask_batched else mask)
        torch.testing.assert_close(got_out[i], want_out, **RULE_TOL)
        torch.testing.assert_close(got_lse[i], want_lse, **RULE_TOL)


def test_unbatched_mask_folds_with_block_stride_zero():
    mask = torch.ones((1, 2, 12))
    folded, copied = fold_vmapped(mask, None, 3)
    assert folded.shape == (3, 2, 12) and folded.stride(0) == 0 and not copied
    assert folded.data_ptr() == mask.data_ptr()


def test_attention_rules_under_nested_vmap_of_grad():
    """vmap(vmap(grad)) of a loss on both outputs (out and lse) through
    _FlashAttention, whose backward runs _FlashAttentionGrads through its own
    rule, against autograd through the plain version."""
    q, k, v, mask = _attention_inputs((2, 3), seed=1)
    g = torch.Generator().manual_seed(5)
    w_out, w_lse = torch.randn(q.shape[2:], generator=g), torch.randn((2, 2, 12), generator=g)

    def through(attention):
        def loss(q, k, v, mask):
            out, lse = attention(q, k, v, mask)
            return (out * w_out).sum() + (torch.where(lse > -1e20, lse, 0.0) * w_lse).sum()
        return loss

    got = vmap(vmap(grad(through(fa.flash_attention_lse), argnums=(0, 1, 2))))(q, k, v, mask)
    want = vmap(vmap(grad(through(fa.flash_attention_reference), argnums=(0, 1, 2))))(
        q, k, v, mask)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_remat_under_vmap_of_grad_matches_no_remat():
    """The port's remat Function (forward without activations, backward
    recomputed under torch.func.vjp; a generated vmap rule) gives the plain
    gradient under vmap(grad) over clients and under eager backward."""
    cfg = dict(vocab_size=20, n_classes=3, d_model=8, n_heads=2, n_layers=2, d_ff=16,
               max_len=10, attention_fn=fa.flash_attention)
    remat, plain = TransformerClassifier(**cfg, remat=True), TransformerClassifier(**cfg)
    params = remat.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randint(1, 20, (3, 4, 10), generator=g)
    x[:, :, 7:] = 0

    def loss(module):
        def fn(p, xs):
            named = {k.replace("/", "."): t for k, t in p.items()}
            logits = torch.func.functional_call(module, named, (xs,))[0]["prediction"]
            return logits.pow(2).mean()
        return fn

    stacked = ptu.stack_clients([params] * 3)
    got = vmap(grad(loss(remat)))(stacked, x)
    want = vmap(grad(loss(plain)))(stacked, x)
    for name in params:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6)
    leaves = {name: t.clone().requires_grad_(True) for name, t in params.items()}
    loss(remat)(leaves, x[0]).backward()
    for name, t in leaves.items():
        torch.testing.assert_close(t.grad, want[name][0], rtol=1e-5, atol=1e-6)


def test_remat_backward_records_no_graph():
    """torch.func.grad differentiates with create_graph=True. The remat's
    backward must record nothing then, or every block's recomputed
    activations would stay alive to the end of the backward (flax's remat
    keeps one block's at a time): the blocks' parameter gradients come back
    without a graph, while the classifier's, outside the remat, carry one."""
    cfg = dict(vocab_size=20, n_classes=3, d_model=8, n_heads=2, n_layers=2, d_ff=16,
               max_len=10, attention_fn=fa.flash_attention, remat=True)
    module = TransformerClassifier(**cfg)
    params = {k: t.requires_grad_(True)
              for k, t in module.init_params(torch.Generator().manual_seed(0)).items()}
    x = torch.randint(1, 20, (4, 10), generator=torch.Generator().manual_seed(1))
    named = {k.replace("/", "."): t for k, t in params.items()}
    logits = torch.func.functional_call(module, named, (x,))[0]["prediction"]
    grads = dict(zip(params, torch.autograd.grad(logits.pow(2).mean(), list(params.values()),
                                                 create_graph=True)))
    assert grads["classifier/kernel"].grad_fn is not None
    for name, g in grads.items():
        if name.startswith("layer_"):
            assert g.grad_fn is None, name


# ---------------------------------------------------------------------------
# Layer norm: the client-batched Function and its rule
# ---------------------------------------------------------------------------

def _ln_inputs(k=3, seed=0, d=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, 4, 5, d), generator=g)
    scale = 1.0 + 0.5 * torch.randn((k, d), generator=g)
    bias = torch.randn((k, d), generator=g)
    w = torch.randn((5, d), generator=g)  # a loss weight: uneven cotangents
    return x, scale, bias, w


def _ln_loss(layer_norm):
    def loss(scale, bias, x, w):
        return (layer_norm(x, scale, bias).pow(2) * w).sum()
    return loss


def _plain_ln(x, scale, bias):
    return F.layer_norm(x, scale.shape, scale, bias, 1e-6)


def test_layer_norm_clients_matches_f_layer_norm_per_client():
    x, scale, bias, _ = _ln_inputs()
    got = layer_norm_clients(x, scale, bias)
    for i in range(3):
        torch.testing.assert_close(got[i], _plain_ln(x[i], scale[i], bias[i]), **RULE_TOL)


@pytest.mark.parametrize("transform", ["vmap", "vmap_no_grad", "vmap_grad",
                                       "vmap_vmap_grad"])
def test_layer_norm_rule_matches_f_layer_norm_per_client(transform):
    """The rule under vmap over clients, vmap(grad) and vmap(vmap(grad))
    (clients, then examples with the client's weights shared), and the plain
    ops under vmap without grad mode, against F.layer_norm and autograd
    client by client (and example by example)."""
    x, scale, bias, w = _ln_inputs(seed=1)
    if transform in ("vmap", "vmap_no_grad"):
        with torch.set_grad_enabled(transform == "vmap"):
            got = vmap(layer_norm)(x, scale, bias)
        for i in range(3):
            torch.testing.assert_close(got[i], _plain_ln(x[i], scale[i], bias[i]),
                                       **RULE_TOL)
        return
    argnums = (0, 1, 2)
    if transform == "vmap_grad":
        got = vmap(grad(_ln_loss(layer_norm), argnums), in_dims=(0, 0, 0, None))(
            scale, bias, x, w)
        want = [grad(_ln_loss(_plain_ln), argnums)(scale[i], bias[i], x[i], w)
                for i in range(3)]
    else:
        per_example = vmap(grad(_ln_loss(layer_norm), argnums), in_dims=(None, None, 0, None))
        got = vmap(per_example, in_dims=(0, 0, 0, None))(scale, bias, x, w)
        want = [[grad(_ln_loss(_plain_ln), argnums)(scale[i], bias[i], x[i, e], w)
                 for e in range(x.shape[1])] for i in range(3)]
        want = [tuple(torch.stack([per[e][j] for e in range(len(per))]) for j in range(3))
                for per in want]
    for i in range(3):
        for a, b in zip(got, want[i]):
            torch.testing.assert_close(a[i], b, **RULE_TOL)


def test_layer_norm_rule_folds_the_clients_inside_remat(monkeypatch):
    """Under vmap(grad) over 3 clients of a remat transformer, every layer
    norm that is differentiated (the remat's recompute inside its backward,
    and ln_final) runs forward and backward once for all clients: the rule
    folds them into its client axis and vmap's decomposition never runs; the
    remat's forward, under no_grad, takes the plain ops. The grads equal the
    loop's, where each client's layer norm runs alone."""
    seen = {"forward": [], "backward": []}
    for name, fn in (("forward", trm.layer_norm_clients_forward),
                     ("backward", trm.layer_norm_clients_backward)):
        def counting(*args, _fn=fn, _name=name):
            seen[_name].append(args[0].shape[0])
            return _fn(*args)
        monkeypatch.setattr(trm, f"layer_norm_clients_{name}", counting)
    cfg = dict(vocab_size=20, n_classes=3, d_model=8, n_heads=2, n_layers=2, d_ff=16,
               max_len=10, attention_fn=fa.flash_attention, remat=True)
    module = TransformerClassifier(**cfg)
    g = torch.Generator().manual_seed(3)
    stacked = ptu.stack_clients([module.init_params(g) for _ in range(3)])
    x = torch.randint(1, 20, (3, 4, 10), generator=g)

    def loss(p, xs):
        named = {k.replace("/", "."): t for k, t in p.items()}
        return torch.func.functional_call(module, named, (xs,))[0]["prediction"].pow(2).mean()

    got = vmap(grad(loss))(stacked, x)
    # 2 blocks x 2 norms in the recompute, and ln_final
    assert seen["forward"] == [3] * 5 and seen["backward"] == [3] * 5
    seen["forward"].clear()
    for i in range(3):
        want = grad(loss)(ptu.client_slice(stacked, i), x[i])
        for name, t in want.items():
            torch.testing.assert_close(got[name][i], t, rtol=1e-5, atol=1e-6)
    assert set(seen["forward"]) == {1}
