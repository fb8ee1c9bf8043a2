"""The port's optax transforms (``fl4health_tpu_torch/optim.py``) against
optax on the CPU: each transform over 20 steps of seeded random gradients
on a mixed tree (f32 leaves of several shapes), updates, params and the
final state within rtol/atol 1e-6; ``multi_transform``'s frozen label;
``inject_hyperparams``' state; and the optax-state converter."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.models import convert

TOL = 1e-6
STEPS = 20
SHAPES = {"dense": {"kernel": (6, 4), "bias": (4,)}, "conv": {"kernel": (3, 3, 2, 5)},
          "scale": (7,)}


def _tree(rng, scale=1.0):
    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return draw(SHAPES)


def _flat(tree) -> dict:
    return convert.flax_to_torch(tree)


def _leaf_mask(pred):
    """The same path predicate as a nested bool tree (optax) and a Params
    mask (the port)."""
    flat = _flat(_tree(np.random.default_rng(0)))
    port = {k: bool(pred(k)) for k in flat}
    nested = {}
    for k, v in port.items():
        *parents, leaf = k.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested, port


_JMASK, _TMASK = _leaf_mask(lambda k: not k.endswith("bias"))
_JLABELS = jax.tree_util.tree_map(lambda t: "train" if t else "freeze", _JMASK)

# name -> (optax transform, port transform)
CASES = {
    "adam": (optax.adam(0.01), optim.adam(0.01)),
    "adam_eps_root": (optax.adam(0.01, b1=0.8, b2=0.95, eps=1e-6, eps_root=1e-8),
                      optim.adam(0.01, b1=0.8, b2=0.95, eps=1e-6, eps_root=1e-8)),
    "adamw": (optax.adamw(0.01, weight_decay=0.05), optim.adamw(0.01, weight_decay=0.05)),
    "adamw_masked": (optax.adamw(0.01, weight_decay=0.05, mask=_JMASK),
                     optim.adamw(0.01, weight_decay=0.05, mask=_TMASK)),
    "yogi": (optax.yogi(0.05), optim.yogi(0.05)),
    "adagrad": (optax.adagrad(0.1), optim.adagrad(0.1)),
    "sgd": (optax.sgd(0.1), optim.sgd(0.1)),
    "sgd_momentum": (optax.sgd(0.1, momentum=0.9), optim.sgd(0.1, momentum=0.9)),
    "sgd_nesterov": (optax.sgd(0.1, momentum=0.9, nesterov=True),
                     optim.sgd(0.1, momentum=0.9, nesterov=True)),
    "clip_then_adam": (optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.01)),
                       optim.chain(optim.clip_by_global_norm(1.0), optim.adam(0.01))),
    "decayed_weights": (optax.chain(optax.add_decayed_weights(0.1), optax.sgd(0.1)),
                        optim.chain(optim.add_decayed_weights(0.1), optim.sgd(0.1))),
    "set_to_zero": (optax.set_to_zero(), optim.set_to_zero()),
    "multi_transform": (
        optax.multi_transform({"train": optax.adam(0.01), "freeze": optax.set_to_zero()},
                              _JLABELS),
        optim.multi_transform({"train": optim.adam(0.01), "freeze": optim.set_to_zero()},
                              {k: "train" if t else "freeze" for k, t in _TMASK.items()})),
    "inject_adam": (
        optax.inject_hyperparams(optax.adam, static_args=("b1", "b2", "eps", "eps_root"))(
            learning_rate=0.01, b1=0.9, b2=0.99, eps=1e-3),
        optim.inject_hyperparams(optim.adam, static_args=("b1", "b2", "eps", "eps_root"))(
            learning_rate=0.01, b1=0.9, b2=0.99, eps=1e-3)),
    "inject_sgd_momentum": (
        optax.inject_hyperparams(optax.sgd, static_args=("momentum", "nesterov"))(
            learning_rate=0.5, momentum=0.9),
        optim.inject_hyperparams(optim.sgd, static_args=("momentum", "nesterov"))(
            learning_rate=0.5, momentum=0.9)),
}


def _close(got: dict, want_tree, what: str):
    want = _flat(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {k}")


def _run(jtx, ttx, steps=STEPS, grad_scale=1.0):
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    tparams = _flat(jparams)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for s in range(steps):
        grads = _tree(rng, grad_scale * (1.0 + s % 3))
        jup, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        tup, tstate = ttx.update(_flat(grads), tstate, tparams)
        _close(tup, jup, f"step {s} updates")
        jparams = optax.apply_updates(jparams, jup)
        tparams = optim.apply_updates(tparams, tup)
        _close(tparams, jparams, f"step {s} params")
    return jstate, tstate, tparams


def _states_close(got, want):
    """Every tensor of a port state against the same state converted from
    optax."""
    conv = convert.optax_state_to_torch(jax.tree_util.tree_map(np.asarray, want))
    got_leaves, want_leaves = ptu.tree_leaves(got), ptu.tree_leaves(conv)
    assert len(got_leaves) == len(want_leaves)
    assert type(got) is type(conv)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_optax(name):
    jtx, ttx = CASES[name]
    jstate, tstate, _ = _run(jtx, ttx)
    _states_close(tstate, jstate)


@pytest.mark.parametrize("name", ["adam", "yogi", "adagrad"])
def test_small_gradients_match_optax(name):
    """Gradients near eps, where the denominators' terms are comparable."""
    jtx, ttx = CASES[name]
    _run(jtx, ttx, steps=10, grad_scale=1e-4)


def test_multi_transform_freezes_exactly():
    _, ttx = CASES["multi_transform"]
    rng = np.random.default_rng(1)
    params = _flat(_tree(rng))
    state = ttx.init(params)
    frozen = [k for k, t in _TMASK.items() if not t]
    assert frozen and not any(k in state.inner_states["train"].inner_state[0].mu
                              for k in frozen)  # no state for a frozen leaf
    for _ in range(3):
        updates, state = ttx.update(_flat(_tree(rng)), state, params)
        for k in frozen:
            assert torch.equal(updates[k], torch.zeros_like(updates[k]))
        assert all(updates[k].abs().sum() > 0 for k, t in _TMASK.items() if t)


def test_inject_hyperparams_holds_the_lr_as_a_tensor():
    static = ("b1", "b2", "eps", "eps_root")
    tx = optim.inject_hyperparams(optim.adam, static_args=static)(
        learning_rate=0.01, b1=0.9, b2=0.99, eps=1e-3)
    const = optim.adam(0.01, b1=0.9, b2=0.99, eps=1e-3)
    rng = np.random.default_rng(3)
    params = _flat(_tree(rng))
    s_inj, s_const = tx.init(params), const.init(params)
    lr = s_inj.hyperparams["learning_rate"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32 and lr.ndim == 0
    assert set(s_inj.hyperparams) == {"learning_rate"}  # betas and eps stay floats
    for _ in range(5):
        grads = _flat(_tree(rng))
        u_inj, s_inj = tx.update(grads, s_inj, params)
        u_const, s_const = const.update(grads, s_const, params)
        for k in grads:  # bit-identical to the constant build
            assert torch.equal(u_inj[k], u_const[k]), k
    assert int(s_inj.count) == 5
    # a new lr in the state moves the next update, with no rebuild
    s_new = optim.InjectHyperparamsState(count=s_inj.count,
                                         hyperparams={"learning_rate": 2 * lr},
                                         inner_state=s_inj.inner_state)
    grads = _flat(_tree(rng))
    u1, _ = tx.update(grads, s_inj, params)
    u2, _ = tx.update(grads, s_new, params)
    for k in grads:
        torch.testing.assert_close(u2[k], 2 * u1[k])


def test_bias_correction_power_matches_xla():
    """``1 - b ** count`` for int32 counts against JAX's f32 power."""
    counts = np.arange(1, 5001, dtype=np.int32)
    for b in (0.9, 0.99, 0.999):
        want = np.asarray(1 - b ** jnp.asarray(counts))
        got = (1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                             torch.tensor(counts).float())).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_converter_refuses_unknown_states():
    with pytest.raises(TypeError, match="no conversion"):
        convert.optax_state_to_torch(object())
