"""The port's ring attention (``parallel/ring_attention.py``) against dense
attention and the JAX package's rings: one 4-rank gloo world
(``torch_mesh_ranks``, spawned once for the module) runs the dense and the
flash rings over its 4 ranks and over the 2-rank ``seq`` axis of a (2, 2)
mesh, forward and backward, with pad masks spanning whole shards, an
all-padding row and bf16 inputs, at ``tests/parallel/test_ring_attention.py``'s
tolerances; the JAX rings run over this process's virtual CPU devices on the
same numpy inputs. The flash ring's local block is the port's
``flash_attention_lse`` (its plain version here; the kernels on the card),
and a transformer run whose attention is the flash ring trains through it
under the client vmap and grad."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_mesh_ranks as R
from fl4health_tpu.parallel import ring_attention as jring
from fl4health_tpu_torch.kernels.flash_attention import flash_attention
from fl4health_tpu_torch.parallel.ring_attention import _dense_attention

B, T, H, D = 2, 32, 4, 8
FWD_ATOL, BF16_ATOL = 1e-5, 3e-2
GRAD_ATOL = {"dense": 2e-4, "flash": 3e-4}
TRAJ_ATOL, TOL = 1e-5, 5e-4
RINGS = ("dense", "flash")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from fl4health_tpu_torch.models.transformer import TransformerClassifier

    rng = np.random.default_rng(0)
    qkv = [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3)]
    pad = np.ones((B, T), np.float32)
    pad[:, 20:] = 0.0  # the last three 8-token shards of the 4-rank ring
    allpad = np.ones((B, T), np.float32)
    allpad[1] = 0.0
    tinit = {k: v.numpy() for k, v in TransformerClassifier(**R.TRANSFORMER).init_params(
        torch.Generator().manual_seed(4)).items()}
    payload = dict(qkv=qkv, pad=pad, allpad=allpad, text_data=R.text_data(), text_init=tinit)
    ranks = R.spawn_world("ring", 4, payload, str(tmp_path_factory.mktemp("ring_world")))
    for r, res in enumerate(ranks):
        for name, got in res.items():
            if isinstance(got, dict) and "error" in got:
                pytest.fail(f"rank {r} scenario {name!r} raised:\n{got['error']}")
    return payload, ranks


def _jax_ring(name, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    fn = jring.ring_self_attention if name == "dense" else functools.partial(
        jring.ring_flash_attention, interpret=True)
    return functools.partial(fn, mesh=mesh)


def _dense_grads(q, k, v, pad=None, weight=None):
    """The yardstick: (out, dq, dk, dv) of dense attention in torch."""
    return R._ring_grads(lambda a, b, c: _dense_attention(a, b, c, pad), q, k, v, weight)


def _qkv(payload):
    return tuple(torch.tensor(a) for a in payload["qkv"])


@pytest.mark.parametrize("name", RINGS)
def test_forward_matches_dense_and_jax(world, name, eight_devices):
    payload, ranks = world
    q, k, v = _qkv(payload)
    ref = _dense_attention(q, k, v).numpy()
    want = np.asarray(jax.jit(_jax_ring(name, 4))(*(jnp.asarray(a) for a in payload["qkv"])))
    for res in ranks:
        out = res["ops"][name][0]
        np.testing.assert_allclose(out, ref, atol=FWD_ATOL)
        np.testing.assert_allclose(out, want, atol=FWD_ATOL)


@pytest.mark.parametrize("name", RINGS)
def test_pad_mask_rotates_with_kv(world, name):
    """Padding on other ranks' shards is excluded: the mask travels with its
    K/V block, and values under padded keys never contribute."""
    payload, ranks = world
    q, k, v = _qkv(payload)
    ref = _dense_attention(q, k, v, torch.tensor(payload["pad"])).numpy()
    for res in ranks:
        np.testing.assert_allclose(res["ops"][name + "_pad"][0], ref, atol=FWD_ATOL)
        np.testing.assert_allclose(res["ops"][name + "_poisoned"], ref, atol=FWD_ATOL)


@pytest.mark.parametrize("name", RINGS)
def test_all_padding_row_is_stable(world, name):
    for res in world[1]:
        out = res["ops"][name + "_allpad"]
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[1], 0.0, atol=1e-6)


@pytest.mark.parametrize("name", RINGS)
def test_bf16_inputs(world, name):
    payload, ranks = world
    ref = _dense_attention(*_qkv(payload)).numpy()
    for res in ranks:
        np.testing.assert_allclose(res["ops"][name + "_bf16"], ref, atol=BF16_ATOL)


@pytest.mark.parametrize("name", RINGS)
def test_two_rank_ring(world, name, eight_devices):
    payload, ranks = world
    q, k, v = (t[:, :16] for t in _qkv(payload))
    ref = _dense_attention(q, k, v).numpy()
    want = np.asarray(jax.jit(_jax_ring(name, 2))(*(jnp.asarray(a[:, :16])
                                                     for a in payload["qkv"])))
    for res in ranks:
        np.testing.assert_allclose(res["ops"][name + "_two"], ref, atol=FWD_ATOL)
        np.testing.assert_allclose(res["ops"][name + "_two"], want, atol=FWD_ATOL)


@pytest.mark.parametrize("name", RINGS)
def test_gradients_match_dense_and_jax(world, name, eight_devices):
    """dq, dk and dv through the ring (the flash ring: the lse cotangent
    through every hop's backward) against dense attention's and JAX's ring's."""
    payload, ranks = world
    ref = _dense_grads(*_qkv(payload))
    ring = _jax_ring(name, 4)

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(a)
                                                        for a in payload["qkv"]))
    for res in ranks:
        got = res["ops"][name]
        for g, r, w, what in zip(got[1:], ref[1:], want, "qkv"):
            np.testing.assert_allclose(g, r, atol=GRAD_ATOL[name], err_msg=f"d{what}")
            np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL[name],
                                       err_msg=f"d{what} vs JAX")


@pytest.mark.parametrize("name", RINGS)
def test_gradients_with_pad_mask(world, name):
    payload, ranks = world
    pad = torch.tensor(payload["pad"])
    ref = _dense_grads(*_qkv(payload), pad, pad[:, :, None, None])
    for res in ranks:
        got = res["ops"][name + "_pad"]
        for g, r, what in zip(got[1:], ref[1:], "qkv"):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, r, atol=GRAD_ATOL[name], err_msg=f"d{what}")


def test_degenerate_shrink_message_matches_jax(world, eight_devices):
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    z = jnp.zeros((1, 48, 1, 8))
    with pytest.raises(ValueError) as theirs:
        jring.ring_flash_attention(z, z, z, mesh, block_q=8, block_k=8)
    for res in world[1]:
        assert res["ops"]["degenerate"] == str(theirs.value)


def test_transformer_through_the_flash_ring(world):
    """A FedAvg run of the transformer with the 4-rank flash ring as its
    attention equals the unsharded flash run (every rank runs the whole
    simulation; the ring runs inside the client vmap and its grad)."""
    payload, ranks = world
    s = R.transformer_sim(payload["text_data"], payload["text_init"],
                          attention_fn=flash_attention)
    s.fit(2)
    want = R.history(s)
    for res in ranks:
        got = res["transformer"]["run"]
        np.testing.assert_allclose(got["fit"], want["fit"], atol=TRAJ_ATOL)
        np.testing.assert_allclose(got["eval"], want["eval"], atol=TRAJ_ATOL)
        for key, value in want["params"].items():
            np.testing.assert_allclose(got["params"][key], value, atol=TRAJ_ATOL,
                                       err_msg=key)
